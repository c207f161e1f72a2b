"""Training sweep from the command line (counterpart of
``skinjax/tools/train_cli.py``, same flags plus ``--device``).

  python -m skinjax_torch.tools.train_cli --dataset pad-ufes-20 \\
      --metadata-csv data/PAD-UFES-20/metadata.csv \\
      --images-dir data/PAD-UFES-20/images \\
      --mechanisms concatenation metablock --backbones resnet-50 --epochs 100
  python -m skinjax_torch.tools.train_cli --env conf/.env     # reference-style config
  python -m skinjax_torch.tools.train_cli --device cpu ...     # without a card

It reads the metadata CSV and the PNG images from disk, runs every
mechanism × backbone × heads cell through ``run_kfold`` and writes, under
``--results-dir``: ``preprocess_data/featurizer_<dataset>.json``, and per
cell ``model_metrics.csv`` and per fold the predictions, the audit arrays
and the checkpoint ``<cell>_fold_<k>/best/state.pt``, which
``python -m skinjax_torch.serve.run_service`` serves (``MODEL_CHECKPOINT``).
It prints one JSON line: the number of fold results and the results.

A sentence dataset (``--text-model bert-base-uncased`` or ``gpt2``, or
``TEXT_MODEL_NAME``) reads the CSV's ``sentence`` column, tokenized at
``MAX_SEQ_LENGTH`` with the vocabulary under ``TOKENIZERS_DIR/<text model>/``
(``vocab.txt``; ``vocab.json`` + ``merges.txt``), and trains the tokens model
with the ``sentence`` augment recipe. Its BERT or GPT-2 tower is drawn at
random (with a warning): no pretrained weights are read by the CLI yet.

``--device`` defaults to ``cuda`` and raises without CUDA unless ``cpu`` is
asked for. ``--mesh-data`` > 0 (mesh-parallel training) is not ported yet.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser(description="skinjax_torch training sweep")
    p.add_argument("--env", default=None, help=".env config file (reference format)")
    p.add_argument("--dataset", default="pad-ufes-20")
    p.add_argument("--metadata-csv", default=None)
    p.add_argument("--images-dir", default=None)
    p.add_argument("--results-dir", default="./results")
    p.add_argument("--mechanisms", nargs="+", default=["concatenation"])
    p.add_argument("--backbones", nargs="+", default=["resnet-50"])
    p.add_argument("--num-heads", nargs="+", type=int, default=[8])
    p.add_argument("--model-name", default="multimodal")
    p.add_argument("--text-model", default=None,
                   help="metadata tower: one-hot-encoder (default), or a sentence encoder "
                        "(bert-base-uncased, gpt2) on the CSV's sentence column; "
                        "default TEXT_MODEL_NAME")
    p.add_argument("--common-dim", type=int, default=512)
    p.add_argument("--k-folds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--unfreeze", default=None,
                   choices=["frozen_weights", "unfrozen_weights",
                            "last_layer_unfrozen_weights", "partial"])
    p.add_argument("--synthetic", action="store_true",
                   help="run on the synthetic fixture (smoke test, no data needed)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel axis size (0 = single device; not ported yet)")
    p.add_argument("--mesh-model", type=int, default=1, help="tensor-parallel axis size")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    if args.mesh_data:
        raise NotImplementedError("--mesh-data: mesh-parallel training is not ported to "
                                  "PyTorch yet (ROADMAP.md)")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} but CUDA is not available; pass "
                           "--device cpu to train on the CPU")

    from skinjax_torch.configs import load_env_config
    from skinjax_torch.tracking import Tracker
    from skinjax_torch.train.experiments import run_experiments

    cfg = load_env_config(args.env)
    cfg.dataset = args.dataset
    cfg.metadata_csv = args.metadata_csv
    cfg.images_dir = args.images_dir
    cfg.results_folder_path = args.results_dir
    cfg.attention_mechanisms = args.mechanisms
    cfg.cnn_model_names = args.backbones
    cfg.list_num_heads = args.num_heads
    cfg.model_name = args.model_name
    if args.text_model is not None:
        cfg.text_model_name = args.text_model
    cfg.common_dim = args.common_dim
    cfg.k_folds = args.k_folds
    cfg.train.device = args.device
    if args.epochs is not None:
        cfg.train.num_epochs = args.epochs
    if args.batch_size is not None:
        cfg.train.batch_size = args.batch_size
    if args.unfreeze is not None:
        cfg.train.unfreeze_weights = args.unfreeze

    tracker = Tracker(root=f"{cfg.results_folder_path}/tracking")
    tracker.set_experiment(f"skinjax-{cfg.dataset}")

    source = prepared = None
    if args.synthetic:
        import numpy as np

        from skinjax_torch.data.featurizer import MetadataFeaturizer
        from skinjax_torch.data.pipeline import synthetic_source
        from skinjax_torch.data.schemas import PreparedDataset

        src = synthetic_source(n=128, feature_dim=91, num_classes=6)
        fz = MetadataFeaturizer(categorical_cols=[], numerical_cols=[])
        fz.label_encoder.classes = ["ACK", "BCC", "MEL", "NEV", "SCC", "SEK"]
        prepared = PreparedDataset(
            name="synthetic", image_files=[str(i) for i in range(len(src))],
            features=src.features, labels=src.labels, groups=np.arange(len(src)),
            class_names=fz.label_encoder.classes, featurizer=fz, raw=None,
        )
        source = src

    metrics = run_experiments(cfg, source=source, prepared=prepared, tracker=tracker)
    print(json.dumps({"n_runs": len(metrics), "results": metrics}, default=str)[:2000])
    return metrics


if __name__ == "__main__":
    main()
