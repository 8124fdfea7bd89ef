"""One rank of a multi-process run of the port's mesh path on the CPU
(gloo), for ``tests/test_torch_parallel.py``.

    python tests/torch_mesh_worker.py RANK WORLD PORT OUT_DIR SCENARIO...

Each scenario runs in turn on every rank and writes
``OUT_DIR/<scenario>.<rank>.json`` (losses, ``val_mse``, predictions) and,
where asked, tensors as ``OUT_DIR/<scenario>.<rank>.pt``.  PyTorch runs
on one thread.
"""

import hashlib
import json
import os
import sys
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mgat_graphsage_torch.data import MolecularDataset  # noqa: E402
from mgat_graphsage_torch.models import Dropout  # noqa: E402
from mgat_graphsage_torch.parallel import (  # noqa: E402
    all_reduce_gradients,
    all_reduce_sum,
    copy_to_group,
    gather_columns,
    gather_rows,
    global_batch_from_local,
    host_row_slice,
    initialize_distributed,
    is_distributed,
    make_mesh,
    replicate,
)
from mgat_graphsage_torch.train import Trainer, get_config  # noqa: E402

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "c1ccncc1", "CCCC",
          "CC(C)O", "c1ccc(Cl)cc1", "CC(=O)Oc1ccccc1C(=O)O",
          "c1cc[nH]c1", "CS(=O)(=O)C", "CCOC(=O)C", "OCCO", "NCCN",
          "CCCCCC", "c1ccc(N)cc1"]
TARGETS = np.linspace(4.0, 9.0, len(SMILES)).astype(np.float32)


def dataset(cfg, fingerprint):
    return MolecularDataset(SMILES, TARGETS, fit_scaler=cfg.scale_targets,
                            fingerprint=fingerprint, max_nodes=16,
                            max_edges=32, verbose=False)


# scenario -> (preset, fingerprint, config overrides, model_parallel)
RUNS = {
    "graphsage_data": ("graphsage", None, dict(epochs=3), 1),
    "flagship_model": ("flagship", "ecfp1024",
                       dict(epochs=2, cnn_pallas_bwd=True), 0),
    "flagship_data_pallas": ("flagship", "ecfp1024",
                             dict(epochs=2, cnn_pallas_bwd=True), 1),
    # GIN at lr 1e-4 for one epoch, as its other parity runs: its f32
    # gradient is ill-conditioned (see test_gin_data2_global_batch_norm)
    "gin_data": ("gin", None, dict(epochs=1, lr=1e-4), 1),
    "factored_model": ("flagship", "ecfp1024",
                       dict(epochs=1, adam_factored_v=True), 0),
    # on 4 ranks: data=2 x model=2, the bf16 gradients summed over data
    "sr_model": ("flagship", "ecfp1024", dict(
        epochs=1, compute_dtype="bfloat16", adam_moment_dtype="bfloat16",
        master_dtype="bfloat16"), 2),
    # fc_g1 [1500, 700] split: the layers the reference's rule splits
    # outside the CNN branch
    "gat_gcn_model": ("gat_gcn", None, dict(epochs=2), 0),
    "model1_model": ("model1", None, dict(epochs=2), 0),
    # cnn.fc1 [256, 262144] and combined.fc1 [512, 2049], chained through
    # the KL latent
    "morgan2048_model": ("morgan2048", "morgan2048", dict(epochs=1), 0),
}


def write(out, name, rank, payload):
    with open(os.path.join(out, f"{name}.{rank}.json"), "w") as f:
        json.dump(payload, f)


def train(name, preset, fp, over, model_parallel, world, init=None,
          patch=None):
    """Fit on a mesh (``model_parallel`` 0: every rank on the model axis)
    and evaluate; the history, the predictions and the warnings."""
    k = world if model_parallel == 0 else model_parallel
    cfg = get_config(preset, batch_size=8, eval_batch_size=8, **over)
    ds = dataset(cfg, fp)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = Trainer(cfg, ds, ds, mesh=make_mesh(model_parallel=k),
                    device="cpu")
    if patch:
        patch(t)
    state = t.load(init)[0] if init else None
    final, _, hist = t.fit(state=state, verbose=False, save_best=False)
    ev = t.evaluate(final)
    return t, final, {
        "history": [{k2: r[k2] for k2 in ("train_loss", "val_mse",
                                            "original_mse")} for r in hist],
        "pred": ev["pred"].tolist(), "mesh": t.mesh.shape,
        "buffers": {n: b.tolist() for n, b in final.model.named_buffers()},
        "cnn_pallas_bwd": t.cfg.cnn_pallas_bwd,
        "warnings": [str(w.message) for w in caught]}


def collectives(rank, world):
    """all_reduce_sum, copy_to_group, gather_columns forward and backward,
    the bucketed gradient sum (f32 and bf16), host_row_slice and
    global_batch_from_local; values for the test to hold against their
    one-process ones."""
    g = torch.Generator().manual_seed(rank)
    x = torch.randn(3, 4, generator=g, requires_grad=True)
    y = all_reduce_sum(x)
    (y * torch.arange(12.0).view(3, 4)).sum().backward()
    c = torch.randn(2, 5, generator=g, requires_grad=True)
    z = copy_to_group(c)
    (z * (rank + 1.0)).sum().backward()
    cols = torch.full((2, 3), float(rank + 1), requires_grad=True)
    full = gather_columns(cols, None, 3 * rank, 3 * world)
    (full * torch.arange(3.0 * world)).sum().backward()
    p32 = torch.nn.Parameter(torch.zeros(7))
    p32.grad = torch.full((7,), rank + 0.5)
    p16 = torch.nn.Parameter(torch.zeros(5, dtype=torch.bfloat16))
    p16.grad = torch.full((5,), rank + 1.0, dtype=torch.bfloat16)
    all_reduce_gradients([p32, p16], None, bucket_elems=4)
    start, stop = host_row_slice(10)
    rows = global_batch_from_local(make_mesh(), {
        "a": np.arange(10, dtype=np.float32)[start:stop].reshape(-1, 1),
        "b": np.arange(10)[start:stop] % 2 == 0})
    layer = torch.nn.Linear(3, 2)
    with torch.no_grad():
        layer.weight.fill_(rank + 1.0)
    replicated = replicate(layer, make_mesh()).weight.tolist()
    try:
        make_mesh(model_parallel=world + 1)
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"x": x.detach().tolist(), "y": y.detach().tolist(),
            "x_grad": x.grad.tolist(), "c_grad": c.grad.tolist(),
            "full": full.detach().tolist(), "cols_grad": cols.grad.tolist(),
            "p32": p32.grad.tolist(), "p16": p16.grad.float().tolist(),
            "replicated": replicated, "is_distributed": is_distributed(),
            "slice": [start, stop], "rows_a": rows["a"].ravel().tolist(),
            "rows_b": rows["b"].tolist(), "rows_b_dtype": str(rows["b"].dtype),
            "refused": refused}


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"127.0.0.1:{port}", world, rank,
                           backend="gloo")
    for name in sys.argv[5:]:
        if name == "collectives":
            write(out, name, rank, collectives(rank, world))
        elif name in RUNS:
            t, final, res = train(name, *RUNS[name], world)
            if name == "sr_model":       # the whole fc1, from rank 0
                t.save(os.path.join(out, "sr_model.pt"), final, light=True)
            write(out, name, rank, res)
        elif name == "flagship_no_kl_share":
            # the trap: every rank adds the whole KL term
            _, _, res = train(name, "flagship", "ecfp1024",
                              dict(epochs=2, cnn_pallas_bwd=True), 1, world,
                              patch=lambda t: setattr(
                                  t, "_kl_weight",
                                  lambda: t.cfg.kl_lambda))
            write(out, name, rank, res)
        elif name == "jax_model":
            # from the JAX trainer's initial weights, dropout off on both
            # sides (the packages draw their masks differently)
            Dropout.forward = lambda self, x, generator=None: x
            _, _, res = train(name, "flagship", "ecfp1024", dict(epochs=1),
                              0, world, init=os.path.join(out, "jax_init.pt"))
            write(out, name, rank, res)
        elif name == "jax_grad":
            # the first step's gradients of the model=2 run from the JAX
            # weights (dropout off, as above), the split ones gathered
            write(out, name, rank, {})
            grads = first_gradients("flagship", "ecfp1024", dict(epochs=1),
                                    model_parallel=world,
                                    init=os.path.join(out, "jax_init.pt"))
            if rank == 0:
                torch.save(grads["grad"], os.path.join(out, "jax_grad.pt"))
        elif name == "ecfp2048_grad":
            # cnn.fc1 [512, 262144], cnn.fc2 [2048, 512] and combined.fc1
            # [512, 2049] split, at full width; the first step's gradients
            write(out, name, rank, {})
            grads = first_gradients("ecfp2048", "ecfp2048", dict(epochs=1),
                                    model_parallel=world)
            if rank == 0:
                torch.save(grads["grad"], os.path.join(out,
                                                       "ecfp2048_grad.pt"))
        elif name == "ecfp2048_save":
            write(out, name, rank, save_and_load(out))
        elif name == "jax_gat_gcn_grad":
            # from the JAX trainer's initial gat_gcn weights, dropout off
            Dropout.forward = lambda self, x, generator=None: x
            write(out, name, rank, {})
            grads = first_gradients("gat_gcn", None, dict(epochs=1),
                                    model_parallel=world,
                                    init=os.path.join(out,
                                                      "jax_gat_gcn_init.pt"))
            if rank == 0:
                torch.save(grads["grad"],
                           os.path.join(out, "jax_gat_gcn_grad.pt"))
        elif name == "gin_grad":
            write(out, name, rank, {})
            grads = first_gradients(*RUNS["gin_data"][:3])
            if rank == 0:
                torch.save(grads, os.path.join(out, "gin_grad.pt"))
        elif name == "cli":
            write(out, name, rank, cli(out))
        elif name == "round_trip":
            write(out, name, rank, round_trip(out, rank))
        else:
            raise ValueError(name)
    torch.distributed.destroy_process_group()


def first_gradients(preset, fp, over, model_parallel=1, init=None):
    """The gradients of the first step of epoch 0 on a mesh, summed over
    the data axis and the split ones gathered whole (the optimizer does
    not step), and the buffers after it (the batch norms' running
    statistics)."""
    cfg = get_config(preset, batch_size=8, eval_batch_size=8, **over)
    ds = dataset(cfg, fp)
    t = Trainer(cfg, ds, ds, mesh=make_mesh(model_parallel=model_parallel),
                device="cpu")
    state = t.load(init)[0] if init else t.init_state()
    state.optimizer.step = lambda *a, **k: None
    batch = next(t._batches(ds, cfg.batch_size,
                            np.random.default_rng(cfg.seed), shard=True))
    t.train_step(state, batch, t._dropout_generator(0))
    grads = {n: gather_rows(p.grad, t.mesh) if n in t._split else p.grad
             for n, p in state.model.named_parameters()}
    return {"grad": grads, "buffers": dict(state.model.named_buffers())}


def digest(t):
    """The SHA-1 of a tensor's bytes: equal digests are equal tensors, bit
    for bit."""
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def split_digests(t, state):
    """Each split parameter's local rows and its Adam moments, digested."""
    params = dict(state.model.named_parameters())
    out = {}
    for name in t._split:
        p = params[name]
        out[name] = digest(p)
        for k in ("exp_avg", "exp_avg_sq"):
            out[f"{name}:{k}"] = digest(state.optimizer.state[p][k])
    return out


def save_and_load(out):
    """ecfp2048 at model=2, full width: one optimizer step, a full
    checkpoint (every split layer and its moments gathered whole), and a
    fresh model=2 trainer that loads it; each rank's rows before the save
    and after the load, and the local shapes.  Also the flat offsets and
    groups ``TorchAdam`` is given for the split parameters (the bf16
    moment preset of the same model)."""
    cfg = get_config("ecfp2048", epochs=1, batch_size=8, eval_batch_size=8)
    ds = dataset(cfg, "ecfp2048")

    def trainer(c=cfg):
        return Trainer(c, ds, ds, mesh=make_mesh(model_parallel=2),
                       device="cpu")

    t = trainer()
    state = t.init_state()
    batch = next(t._batches(ds, cfg.batch_size,
                            np.random.default_rng(cfg.seed), shard=True))
    t.train_step(state, batch, t._dropout_generator(0))
    path = os.path.join(out, "ecfp2048.pt")
    t.save(path, state)
    torch.distributed.barrier()
    t2 = trainer()
    restored, _ = t2.load(path)
    params = dict(restored.model.named_parameters())
    bf16_moments = trainer(cfg.replace(
        adam_moment_dtype="bfloat16")).init_state()
    opt = bf16_moments.optimizer
    index = {n: i for i, (n, _) in enumerate(
        bf16_moments.model.named_parameters())}
    return {"split": t._split, "before": split_digests(t, state),
            "after": split_digests(t2, restored),
            "local": {n: list(params[n].shape) for n in t._split},
            "step": restored.step,
            "offsets": {n: opt.index_offsets.get(index[n]) for n in t._split},
            "ways": {n: opt.split_groups[index[n]][1] for n in t._split
                     if index[n] in opt.split_groups},
            "coords": t.mesh.coords}


def cli(out):
    """``train.run`` with ``--distributed --dist-backend gloo
    --model-parallel 2`` on this process group (the call is idempotent):
    what it prints and whether it wrote the checkpoint."""
    import contextlib
    import io

    from mgat_graphsage_torch.train.run import main as run_main

    buf = io.StringIO()
    ckpt = os.path.join(out, "cli")
    with contextlib.redirect_stdout(buf):
        run_main(["--preset", "flagship", "--limit", "16", "--epochs", "1",
                  "--batch-size", "8", "--device", "cpu", "--distributed",
                  "--dist-backend", "gloo", "--model-parallel", "2",
                  "--ckpt-dir", ckpt])
    torch.distributed.barrier()
    path = os.path.join(ckpt, "flagship", "best_model.pt")
    blob = torch.load(path) if os.path.exists(path) else {}
    return {"stdout": buf.getvalue(),
            "fc1": list(blob.get("state_dict", {}).get(
                "cnn.fc1.weight", torch.zeros(0)).shape)}


def round_trip(out, rank):
    """data=2 x model=2: 3 epochs uninterrupted; 2 epochs, a full
    checkpoint, a fresh trainer that loads it and runs epoch 3."""
    cfg = get_config("flagship", epochs=3, batch_size=8, eval_batch_size=8)
    ds = dataset(cfg, "ecfp1024")

    def trainer():
        return Trainer(cfg, ds, ds, mesh=make_mesh(model_parallel=2),
                       device="cpu")

    _, _, h_full = trainer().fit(verbose=False, save_best=False)
    t_a = trainer()
    state_a, _, h_a = t_a.fit(epochs=2, verbose=False, save_best=False)
    path = os.path.join(out, "mid.pt")
    t_a.save(path, state_a)
    torch.distributed.barrier()
    t_b = trainer()
    restored, _ = t_b.load(path)
    fc1 = restored.model.cnn.fc1.weight
    _, _, h_b = t_b.fit(epochs=3, state=restored, start_epoch=2,
                        verbose=False, save_best=False)
    keys = ("train_loss", "val_mse")
    return {"full": [[r[k] for k in keys] for r in h_full],
            "a": [[r[k] for k in keys] for r in h_a],
            "b": [[r[k] for k in keys] for r in h_b],
            "fc1_local": list(fc1.shape), "mesh": t_b.mesh.shape,
            "coords": t_b.mesh.coords}


if __name__ == "__main__":
    main()
