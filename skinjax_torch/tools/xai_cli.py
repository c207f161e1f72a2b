"""XAI analyses from the command line (counterpart of
``skinjax/tools/xai_cli.py``, same flags plus ``--device``): the reference's
missing-data inference sweep (run_missing_data_inference.sh →
inference_all_folds.py) and its metadata flip-rate analysis (flip_rate.py).

  python -m skinjax_torch.tools.xai_cli missing-data --metadata-csv data/PAD-UFES-20/metadata.csv \\
      --images-dir data/PAD-UFES-20/images --checkpoint results/<cell>_fold_1/best
  python -m skinjax_torch.tools.xai_cli flip-rate --metadata-csv ... --images-dir ...
  python -m skinjax_torch.tools.xai_cli ... --device cpu     # without a card

It reads the CSV and the PNG images (as the train CLI does, no pandas, no
OpenCV), builds the model (``--backbone``, ``--mechanism``, ``--common-dim``,
``--num-heads``; fp32, as skinjax's CLI builds it) with the weights of
``--checkpoint`` (a checkpoint of the port's trainer, its directory or its
``state.pt``, or a ``torch.save``'d state_dict; random weights from seed 0
without it) and predicts through ``InferenceEngine.predict_probs`` in batches
of 64 rows, the images fixed and the metadata varied. Outputs, under
``--out``: ``missing-data`` appends its rows (fold, missing rate, accuracy,
balanced accuracy, precision, recall, F1, AUC) to
``missing_metadata_experiment.csv`` and prints them as JSON; ``flip-rate``
writes ``flip_rates.json`` (each intervention's flip rate and flip count)
and prints it.

``--device`` defaults to ``cuda`` and raises without CUDA unless ``cpu`` is
asked for.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

BATCH = 64


def load_engine(args):
    """(the ``InferenceEngine`` of the flags' model, the prepared dataset)."""
    import torch

    from skinjax_torch.data.schemas import prepare_dataset
    from skinjax_torch.models import MultimodalModel
    from skinjax_torch.models.weights import init_weights
    from skinjax_torch.serve.engine import InferenceEngine
    from skinjax_torch.serve.run_service import load_weights

    prepared = prepare_dataset(args.dataset, args.metadata_csv, featurizer_path=args.featurizer)
    model = MultimodalModel(
        num_classes=prepared.num_classes, num_heads=args.num_heads,
        cnn_model_name=args.backbone, common_dim=args.common_dim,
        vocab_size=prepared.feature_dim, attention_mechanism=args.mechanism,
    )
    if args.checkpoint:
        model.load_state_dict(load_weights(args.checkpoint))
    else:
        init_weights(model, seed=0)
    engine = InferenceEngine(model, prepared.featurizer, prepared.class_names,
                             device=torch.device(args.device))
    return engine, prepared


def batched_predictor(engine, images: np.ndarray, batch: int = BATCH):
    """features (N, F) → probs (N, K) with the images (N, H, W, 3) uint8
    fixed: ``engine.predict_probs`` ``batch`` rows at a time (the engine
    normalizes the uint8 images on its device)."""

    def predict(features: np.ndarray) -> np.ndarray:
        return np.concatenate([engine.predict_probs(images[s:s + batch], features[s:s + batch])
                               for s in range(0, len(features), batch)])

    return predict


def main(argv=None):
    p = argparse.ArgumentParser(description="skinjax_torch XAI analyses")
    p.add_argument("analysis", choices=["missing-data", "flip-rate"])
    p.add_argument("--dataset", default="pad-ufes-20")
    p.add_argument("--metadata-csv", required=True)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--featurizer", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--backbone", default="resnet-50")
    p.add_argument("--mechanism",
                   default="att-intramodal+residual+cross-attention-metadados")
    p.add_argument("--common-dim", type=int, default=512)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--fold", type=int, default=1)
    p.add_argument("--rates", nargs="+", type=float,
                   default=[0.0, 0.1, 0.2, 0.3, 0.5, 0.7])
    p.add_argument("--out", default="./results/xai")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} but CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from skinjax_torch.data.pipeline import ImageStore

    engine, prepared = load_engine(args)
    images = ImageStore(args.images_dir, cache=False).gather(prepared.image_files)
    predict = batched_predictor(engine, images)
    os.makedirs(args.out, exist_ok=True)

    if args.analysis == "missing-data":
        from skinjax_torch.xai import missing_data_sweep

        rows = missing_data_sweep(predict, prepared.raw, prepared.featurizer, prepared.labels,
                                  fold=args.fold, rates=args.rates)
        out_csv = os.path.join(args.out, "missing_metadata_experiment.csv")
        exists = os.path.exists(out_csv)
        with open(out_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if not exists:
                w.writeheader()
            w.writerows(rows)
        print(json.dumps(rows, indent=1, default=str))
        return rows
    from skinjax_torch.xai import run_flip_analysis

    res = run_flip_analysis(predict, prepared.raw, prepared.featurizer)
    summary = {k: {"flip_rate": v["flip_rate"], "n_flips": v["n_flips"]}
               for k, v in res["mutations"].items()}
    with open(os.path.join(args.out, "flip_rates.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
