"""Command-line trainer of the port (``mgat_graphsage_tpu/train/run.py`` on
PyTorch and CUDA).

    python -m mgat_graphsage_torch.train.run --preset flagship \\
        [--epochs N] [--batch-size B] [--lr LR] [--seed S] [--limit ROWS] \\
        [--ckpt-dir checkpoints] [--log metrics.jsonl] [--resume CKPT] \\
        [--mixed-precision] [--fast-optimizer] [--remat] \\
        [--dataset-storage float32|compact] [--device cuda|cpu] \\
        [--distributed [--dist-backend nccl|gloo]] [--data-parallel] \\
        [--model-parallel K]

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
as the reference's flags do.

Multi-GPU (``parallel/``): a PyTorch job is one process per GPU, where a
JAX process drives every local device, so a job on 8 local GPUs is 8
processes of this command, each with ``--distributed``:

    torchrun --nproc-per-node 8 -m mgat_graphsage_torch.train.run \\
        --preset flagship --distributed [--model-parallel 2]

(or 8 launches with ``MGAT_COORDINATOR=host:port``,
``MGAT_NUM_PROCESSES=8`` and ``MGAT_PROCESS_ID=0..7``).  Each rank takes
``cuda:{LOCAL_RANK}``; ``--distributed`` implies a mesh over every rank,
``--model-parallel k`` splits k ways every layer the reference's rule
splits (the CNN fc1; ``fc_g1`` of ``model1`` and ``gat_gcn``;
``combined.fc1`` of ``morgan2048`` and ``ecfp2048``, and the latter's CNN
fc2), and ``--data-parallel`` alone is a mesh over this one process.
``--dist-backend gloo`` runs several ranks on one card (NCCL refuses
that), for checks only.
"""

from __future__ import annotations

import argparse
import os

from ..data import TRAIN_CSV, VAL_CSV, MolecularDataset, load_csv
from .config import PRESETS, get_config
from .trainer import Trainer


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
    ap.add_argument("--data-parallel", action="store_true",
                    help="train on a mesh over every rank (its data axis)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="split every layer the reference's rule splits "
                         "(2-D weights of >= 2^20 elements whose output "
                         "width divides K) this many ways on a (data, "
                         "model) mesh")
    ap.add_argument("--distributed", action="store_true",
                    help="start the process group (coordinator from MGAT_* "
                         "or torchrun's environment); implies a mesh")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on CUDA, "
                         "gloo on the CPU); gloo runs several ranks on one "
                         "card")
    ap.add_argument("--dataset-storage", default=None,
                    choices=["float32", "compact"],
                    help="compact: the dataset packed on the device (int8 "
                         "nodes, uint8 edges, bit-packed fingerprints), "
                         "unpacked per batch to the same bits")
    args = ap.parse_args(argv)

    if args.distributed:
        from ..parallel import initialize_distributed

        initialize_distributed(backend=args.dist_backend)
    mesh = None
    # --distributed implies a mesh over every rank: without one, every
    # process would train its own copy and race on the checkpoint path
    if args.distributed or args.data_parallel or args.model_parallel > 1:
        from ..parallel import make_mesh

        mesh = make_mesh(model_parallel=args.model_parallel)

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
                             featurizer=cfg.featurizer,
                             structure=cfg.needs_structure)
    val = MolecularDataset(vs, vy, scaler=train.scaler,
                           fingerprint=cfg.fingerprint,
                           featurizer=cfg.featurizer,
                           max_nodes=train.max_nodes,
                           max_edges=train.max_edges,
                           structure=cfg.needs_structure)

    ckpt_dir = os.path.join(args.ckpt_dir, cfg.name)
    trainer = Trainer(cfg, train, val, ckpt_dir=ckpt_dir,
                      log_path=args.log, device=args.device, mesh=mesh)

    state, start_epoch = None, 0
    if args.resume:
        state, meta = trainer.load(args.resume)
        start_epoch = int(meta.get("epoch", 0))
        if trainer.is_primary:
            print(f"resumed from {args.resume} at epoch {start_epoch}")

    trainer.fit(state=state, start_epoch=start_epoch)
    if not trainer.is_primary:
        return
    print(f"\nTraining completed, best "
          f"{cfg.select_metric}: {trainer.best_metric:.4f} "
          f"(normalized MSE {trainer.best_norm_mse:.4f})")
    print(f"Best checkpoint: {os.path.join(ckpt_dir, 'best_model.pt')}")


if __name__ == "__main__":
    main()
