"""NAS from the command line (counterpart of ``skinjax/tools/nas_cli.py``,
the reference's nas/optimization_*_via_bash scripts as one command over the
strategy library: reinforce / bo / llm / random). skinjax's flags, without
``--fixed-envelope`` (an XLA compile economy), plus ``--device``.

  python -m skinjax_torch.tools.nas_cli --strategy reinforce --steps 50 \\
      --dataset pad-ufes-20 --metadata-csv ... --images-dir ...
  python -m skinjax_torch.tools.nas_cli --strategy random --steps 3 --synthetic
  python -m skinjax_torch.tools.nas_cli --device cpu ...     # without a card

It writes ``<results-dir>/best_config.json`` and prints one JSON line, the
best config and its reward; ``--retrain-best`` then runs the full k-fold on
it under ``<results-dir>/retrain`` and prints the folds' metrics.
``--population K`` trains K candidates a vmapped supernet step
(reinforce/random). ``--device`` defaults to ``cuda`` and raises without
CUDA unless ``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Returns (best_config, best_reward, step_log, retrain_metrics or None)."""
    p = argparse.ArgumentParser(description="skinjax_torch NAS search")
    p.add_argument("--strategy", default="reinforce",
                   choices=["reinforce", "bo", "llm", "random"])
    p.add_argument("--steps", type=int, default=None,
                   help="search steps (default: SEARCH_STEPS env or 500)")
    p.add_argument("--dataset", default="pad-ufes-20")
    p.add_argument("--metadata-csv", default=None)
    p.add_argument("--images-dir", default=None)
    p.add_argument("--results-dir", default="./results/nas")
    p.add_argument("--epochs", type=int, default=10,
                   help="inner-training epochs per candidate")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--llm-model", default=None)
    p.add_argument("--early-metric", default="val_bacc",
                   choices=["val_bacc", "val_loss"],
                   help="val_loss reproduces the controller-val-loss variant")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--population", type=int, default=0,
                   help="candidates per vmapped supernet step "
                        "(reinforce/random; 0 = sequential like the "
                        "reference)")
    p.add_argument("--no-memoize", action="store_true",
                   help="retrain repeated configs (reference behavior) "
                        "instead of reusing their deterministic reward")
    p.add_argument("--retrain-best", action="store_true",
                   help="full k-fold retrain of best_config.json afterwards")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import os

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} but CUDA is not available; pass "
                           "--device cpu to search on the CPU")

    from skinjax_torch.configs import load_env_config
    from skinjax_torch.nas import retrain_best, run_nas
    from skinjax_torch.tracking import Tracker
    from skinjax_torch.train.loop import TrainConfig

    env_cfg = load_env_config(None)
    steps = args.steps or env_cfg.search_steps

    if args.synthetic:
        from skinjax_torch.data.pipeline import synthetic_source

        source = synthetic_source(n=64, image_size=(32, 32), feature_dim=32,
                                  num_classes=6)
        num_classes = 6
        groups = None
        labels = source.labels
        class_names = [str(i) for i in range(6)]
    else:
        from skinjax_torch.data.schemas import prepare_dataset
        from skinjax_torch.train.experiments import build_source

        prepared = prepare_dataset(args.dataset, args.metadata_csv)
        source = build_source(prepared, args.images_dir)
        num_classes = prepared.num_classes
        groups = prepared.groups
        labels = prepared.labels
        class_names = prepared.class_names

    tracker = Tracker(root=os.path.join(args.results_dir, "tracking"))
    tracker.set_experiment(f"nas-{args.strategy}")

    train_cfg = TrainConfig(
        num_epochs=args.epochs, batch_size=args.batch_size,
        early_stopping_patience=5, early_stopping_metric=args.early_metric,
        device=args.device,
    )
    with tracker.start_run(f"{args.strategy}-{steps}steps"):
        best_cfg, best_reward, log = run_nas(
            source, num_classes, strategy=args.strategy, search_steps=steps,
            train_cfg=train_cfg, results_dir=args.results_dir,
            llm_model_name=args.llm_model, tracker=tracker,
            population_size=args.population, memoize=not args.no_memoize,
        )
    print(json.dumps({"best_config": best_cfg, "best_reward": best_reward},
                     default=str), flush=True)

    metrics = None
    if args.retrain_best:
        metrics = retrain_best(
            source, labels, groups, num_classes, class_names,
            os.path.join(args.results_dir, "best_config.json"),
            train_cfg=train_cfg,
            results_dir=os.path.join(args.results_dir, "retrain"),
        )
        print(json.dumps({"retrain_folds": metrics}, default=str), flush=True)
    return best_cfg, best_reward, log, metrics


if __name__ == "__main__":
    main()
