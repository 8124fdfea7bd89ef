"""Command-line trainer of the port (``mgat_graphsage_tpu/train/run.py`` on
PyTorch and CUDA).

    python -m mgat_graphsage_torch.train.run --preset flagship \\
        [--epochs N] [--batch-size B] [--lr LR] [--seed S] [--limit ROWS] \\
        [--ckpt-dir checkpoints] [--log metrics.jsonl] [--resume CKPT] \\
        [--mixed-precision] [--fast-optimizer] [--remat] \\
        [--dataset-storage float32|compact] [--device cuda|cpu]

trains on the bundled train and validation CSVs (or ``--train-csv``,
``--val-csv``) and writes ``<ckpt-dir>/<preset>/best_model.pt`` with its
JSON sidecar, which ``eval/predict.py`` serves.  It runs on CUDA unless
given ``--device cpu``, and raises without CUDA.  Every preset of
``train/config.py`` is offered: the flagship, the bf16 ones
(``flagship_bf16_bs1024_wc``, the production preset, among them), the
ablation ladder ``model1``-``model6``, the six baselines (``gcn``,
``graphsage``, ``gat``, ``gat_gcn``, ``gin``, ``chebnet``) and the
fingerprint suite (``morgan1024``, ``morgan2048``, ``ecfp2048``,
``fcfp``, ``maccs``, ``smifp``, ``bci``; the last three featurise in
Python, BCI at a few tens of molecules a second).
``--mixed-precision`` (bf16 compute), ``--fast-optimizer`` (bf16 Adam
moments), ``--remat`` and ``--dataset-storage`` set their config fields
as the reference's flags do; the reference's flags for meshes are
accepted and raise "not ported yet".
"""

from __future__ import annotations

import argparse
import os

from ..data import TRAIN_CSV, VAL_CSV, MolecularDataset, load_csv
from .config import PRESETS, get_config
from .trainer import Trainer

# flag -> the ROADMAP item (Queue 1) that brings it
_NOT_PORTED_FLAGS = {
    "data_parallel": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "model_parallel": "multi-GPU training (ROADMAP Queue 1 item 10)",
    "distributed": "multi-GPU training (ROADMAP Queue 1 item 10)",
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="flagship", choices=sorted(PRESETS))
    ap.add_argument("--train-csv", default=TRAIN_CSV)
    ap.add_argument("--val-csv", default=VAL_CSV)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--limit", type=int, default=None,
                    help="limit training rows (smoke runs)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--log", default=None, help="JSONL metrics log path")
    ap.add_argument("--resume", default=None, help="checkpoint to resume")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--fast-optimizer", action="store_true",
                    help="bf16 Adam moment storage (f32 arithmetic)")
    ap.add_argument("--mixed-precision", action="store_true",
                    help="bf16 compute in the forward and backward (f32 "
                         "master parameters and accumulation)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the forward's activations in the "
                         "backward (memory for FLOPs)")
    for flag in ("data-parallel", "distributed"):
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not ported yet")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="not ported yet")
    ap.add_argument("--dataset-storage", default=None,
                    choices=["float32", "compact"],
                    help="compact: the dataset packed on the device (int8 "
                         "nodes, uint8 edges, bit-packed fingerprints), "
                         "unpacked per batch to the same bits")
    args = ap.parse_args(argv)

    for dest, what in _NOT_PORTED_FLAGS.items():
        value = getattr(args, dest)
        if value != ap.get_default(dest):
            raise NotImplementedError(f"--{dest.replace('_', '-')}: {what} "
                                      "is not ported yet")

    overrides = {k: v for k, v in dict(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        seed=args.seed).items() if v is not None}
    if args.fast_optimizer:
        overrides["adam_moment_dtype"] = "bfloat16"
    if args.mixed_precision:
        overrides["compute_dtype"] = "bfloat16"
    if args.remat:
        overrides["remat"] = True
    if args.dataset_storage:
        overrides["dataset_storage"] = args.dataset_storage
    cfg = get_config(args.preset, **overrides)

    sm, y = load_csv(args.train_csv)
    vs, vy = load_csv(args.val_csv)
    if args.limit:
        sm, y = sm[:args.limit], y[:args.limit]
        vs, vy = vs[:max(args.limit // 4, 32)], vy[:max(args.limit // 4, 32)]

    train = MolecularDataset(sm, y, fit_scaler=cfg.scale_targets,
                             fingerprint=cfg.fingerprint,
                             featurizer=cfg.featurizer)
    val = MolecularDataset(vs, vy, scaler=train.scaler,
                           fingerprint=cfg.fingerprint,
                           featurizer=cfg.featurizer,
                           max_nodes=train.max_nodes,
                           max_edges=train.max_edges)

    ckpt_dir = os.path.join(args.ckpt_dir, cfg.name)
    trainer = Trainer(cfg, train, val, ckpt_dir=ckpt_dir,
                      log_path=args.log, device=args.device)

    state, start_epoch = None, 0
    if args.resume:
        state, meta = trainer.load(args.resume)
        start_epoch = int(meta.get("epoch", 0))
        print(f"resumed from {args.resume} at epoch {start_epoch}")

    trainer.fit(state=state, start_epoch=start_epoch)
    print(f"\nTraining completed, best "
          f"{cfg.select_metric}: {trainer.best_metric:.4f} "
          f"(normalized MSE {trainer.best_norm_mse:.4f})")
    print(f"Best checkpoint: {os.path.join(ckpt_dir, 'best_model.pt')}")


if __name__ == "__main__":
    main()
