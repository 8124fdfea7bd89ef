"""The training engine of the port (``mgat_graphsage_tpu/train/trainer.py``
on PyTorch and CUDA).

Same semantics as the reference's ``Trainer``, in PyTorch idiom: the
dataset goes to the device once, and each epoch is a Python loop of train
steps over batches gathered on the device (the reference scans them in
one XLA program).

- loss = masked MSE + ``kl_lambda`` * KL over the hybrid's latent
  (reference ``train.py:244-246``); ``node_mask`` is multiplied by the
  batch's ``sample_mask``, so the rows padding the final batch are inert,
  in the batch norms' statistics too;
- every model of ``models/zoo.py`` trains here: the hybrid, the
  ``gat_graphsage`` ablations and the six baselines.  GIN's batch norms
  update their running statistics in the train step (the reference's
  ``batch_stats``) and :meth:`Trainer.evaluate` uses them; they are
  buffers, so checkpoints and the best state carry them;
- torch Adam with L2 coupled into the gradient (``train/optim.py``), the
  constant or warmup+cosine lr on the 1-based step count;
- ``dataset_storage="compact"`` keeps the dataset on the device packed
  (int8 nodes, uint8 edges, masks as counts, bit-packed fingerprints;
  ``data/packed.py``) and unpacks each batch there to the same bits, so
  the run is the float32 run's, bit for bit, in ~5x less device memory;
- the epoch permutation comes from ``np.random.default_rng(seed +
  epoch)`` and the final batch is padded with masked copies of row 0, so
  the batch order is the reference's, bit for bit;
- dropout masks come from a ``torch.Generator`` that the trainer owns,
  seeded per epoch, so a resumed run repeats an uninterrupted one;
- validation is the mean of per-batch MSEs on both scales (reference
  ``train.py:278``), with best-state selection on ``select_metric``;
- ``cfg.matmul_precision`` and ``cfg.compute_dtype`` set the numerics of
  the train step (forward and backward) and of :meth:`Trainer.evaluate`
  alike, through ``models/layers.py::matmul_precision``: IEEE f32 for f32
  compute, bf16 products with f32 accumulation for bf16 (``train/
  config.py``).

Mixed precision (``compute_dtype="bfloat16"``, reference ``trainer.py:
278-411``): the module keeps the f32 master parameters; the forward runs
on a bf16 working copy (``torch.func.functional_call``) with the inputs
cast to bf16 and its outputs cast back to f32 before the loss.  The
gradients land on the copy in bf16; the optimizer (``train/optim.py::
TorchAdam``) does its f32 math against the master and writes the new
master and the next step's copy in one pass, so the copy is carried from
step to step and the master is cast once per epoch.  With
``master_dtype="bfloat16"`` the module's parameters are themselves bf16
(the compute copy) and the update rounds them stochastically.  ``remat``
recomputes the forward in the backward (``torch.utils.checkpoint``), with
the same dropout masks.

Under a mesh (``mesh=`` or ``use_mesh=True``; ``parallel/mesh.py``) each
rank trains on its data shard's rows of every global batch and the run
is the 1-process run's up to the order of f32 sums, as the reference's
SPMD program is its single-device one: the masked MSE divides by the
global sample count, the KL term, GIN's batch norms and the dropout
masks are the global batch's (``parallel.batch_shard``), each rank adds
``kl_lambda * KL / P_data`` (the KL is replicated and its backward sums
over the ranks), and the gradients are summed over the data axis before
the optimizer step.  A ``model`` axis splits the CNN fc1 by columns
(``parallel.shard_state``); ``cnn_pallas_bwd`` is then turned off, with
a warning.  Evaluation runs every batch whole on every rank.  Only rank
0 prints and writes the log and the checkpoint; a checkpoint holds the
whole fc1, whatever the mesh.

On CUDA each step runs the adjacency kernel, the attention kernels
(forward and backward; the modified attention only) and, with
``cnn_pallas_bwd``, the CNN backward kernels (in the compute dtype, f32
or bf16, once a step, remat included).  The
baselines' layers are plain PyTorch after the adjacency kernel.  The
attention and the adjacency run in f32 inside the bf16 step too, as in
the reference.  Entry points run on CUDA unless given ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..data import MolecularDataset
from ..data.packed import gather_batch, pack_dataset, to_device
from ..device import resolve_device
from ..models import (
    adam_state_from_jax,
    build_model,
    kl_loss,
    reset_parameters,
)
from ..models.layers import frozen_running_stats, matmul_precision
from ..ops import dense_adjacency
from ..parallel import (
    all_reduce_gradients,
    batch_shard,
    gather_rows,
    make_mesh,
    param_shardings,
    shard_batch,
    shard_rows,
    shard_state,
)
from ..parallel.distributed import all_reduce_
from .checkpoint import load_checkpoint, save_checkpoint
from .config import TrainConfig
from .optim import (
    DTYPES,
    TorchAdam,
    check_ported,
    lr_schedule,
    make_optimizer,
    set_lr,
    step_salt,
)

__all__ = ["TrainState", "Trainer"]

_FIELDS = ("nodes", "edges", "node_mask", "edge_mask", "fp", "y", "y_orig")


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, and the number of optimizer steps taken."""
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def _masked_mse(pred: torch.Tensor, target: torch.Tensor,
                sample_mask: torch.Tensor,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked MSE over ``count`` samples (the mask's sum when None; the
    global batch's under a mesh)."""
    err = (pred.reshape(-1) - target.reshape(-1)) ** 2
    n = sample_mask.sum() if count is None else count
    return (err * sample_mask).sum() / torch.clamp_min(n, 1.0)


class Trainer:
    """End-to-end training loop for the presets the port can build."""

    def __init__(self, cfg: TrainConfig, train_ds: MolecularDataset,
                 val_ds: Optional[MolecularDataset] = None,
                 mesh=None, use_mesh: bool = False,
                 ckpt_dir: Optional[str] = None,
                 log_path: Optional[str] = None, device=None):
        check_ported(cfg)
        self.mesh = mesh if mesh is not None else \
            (make_mesh() if use_mesh else None)
        if cfg.cnn_pallas_bwd and self._model_ways > 1:
            warnings.warn("cnn_pallas_bwd is turned off under a mesh with a "
                          "model axis: the CNN kernels' backward does not "
                          "take the column-split fc1 (the reference turns it "
                          "off there too)", stacklevel=2)
            cfg = cfg.replace(cnn_pallas_bwd=False)
        self.cfg = cfg
        self._cdt = None if cfg.compute_dtype == "float32" \
            else DTYPES[cfg.compute_dtype]
        self._master_narrow = cfg.master_dtype != "float32"
        self.device = resolve_device(device)
        self.train_ds = train_ds
        self.val_ds = val_ds
        steps_per_epoch = max(-(-len(train_ds) // cfg.batch_size), 1)
        self._total_steps = cfg.epochs * steps_per_epoch
        self._lr = lr_schedule(cfg, self._total_steps)
        self.ckpt_dir = ckpt_dir
        self.log_path = log_path
        self.scaler = train_ds.scaler
        self._dev_cache: Dict[int, Dict[str, torch.Tensor]] = {}
        self.history: List[Dict] = []
        # names of the parameters split over the model axis (dim 0)
        self._split: List[str] = []

    # ------------------------------------------------------------------
    @property
    def _data_ways(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape.get("data", 1)

    @property
    def _model_ways(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape.get("model", 1)

    @property
    def is_primary(self) -> bool:
        """Rank 0 of the process group (or no group): the one that prints
        and writes."""
        return not (torch.distributed.is_available()
                    and torch.distributed.is_initialized()) \
            or torch.distributed.get_rank() == 0

    def _check_divides(self, name: str, size: int) -> None:
        if self.mesh is not None and size % self._data_ways:
            raise ValueError(f"{name} {size} not divisible by data-axis "
                             f"size {self._data_ways}")

    def _agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a decision that leads to
        collectives, such as saving a split checkpoint, must be one)."""
        if self.mesh is None or not torch.distributed.is_initialized():
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        torch.distributed.broadcast(t, src=0)
        return bool(t.item())

    def _kl_weight(self) -> float:
        """``kl_lambda``, and under a mesh this rank's share of it: the KL
        is the same on every rank of the data axis and the backward of its
        sums adds the ranks' gradients, so each rank adds ``1 / P_data``
        of the term."""
        return self.cfg.kl_lambda / self._data_ways

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Weights drawn from a ``torch.Generator`` seeded with
        ``cfg.seed`` (or ``seed``) on the CPU, so the same seed gives the
        same weights on every device."""
        gen = torch.Generator().manual_seed(
            self.cfg.seed if seed is None else seed)
        model = reset_parameters(build_model(self.cfg), gen).to(self.device)
        if self.mesh is not None:
            # every rank draws the same weights; a model axis keeps this
            # rank's rows of the split parameters
            self._split = [n for n, d in param_shardings(self.mesh,
                                                         model).items()
                           if d is not None]
            shard_state(model, self.mesh)
        if self._master_narrow:
            # drawn in f32, quantized once; every later update is rounded
            # stochastically (train/optim.py::TorchAdam)
            model.to(DTYPES[self.cfg.master_dtype])
        optimizer = make_optimizer(self.cfg, model)
        if self._split and isinstance(optimizer, TorchAdam):
            # a block of rows draws the unsplit parameter's rounding noise
            # and takes a factored moment's means over every rank's rows
            for i, (n, p) in enumerate(model.named_parameters()):
                if n in self._split:
                    optimizer.index_offsets[i] = \
                        self.mesh.coords["model"] * p.numel()
                    optimizer.split_groups[i] = (self.mesh.model_group,
                                                 self._model_ways)
        return TrainState(step=0, model=model, optimizer=optimizer)

    def _device_dataset(self, ds: MolecularDataset) -> Dict[str, torch.Tensor]:
        """A dataset's arrays on the device, uploaded once: the padded
        float32 arrays, or with ``dataset_storage="compact"`` their packed
        form (``data/packed.py``), unpacked per batch by :meth:`_batches`
        to the same bits."""
        if id(ds) not in self._dev_cache:
            host = pack_dataset(ds) if self.cfg.dataset_storage == "compact" \
                else {k: getattr(ds, k) for k in _FIELDS}
            self._dev_cache[id(ds)] = to_device(host, self.device)
        return self._dev_cache[id(ds)]

    @staticmethod
    def _epoch_indices(n: int, batch_size: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(perm [n_batches, B], sample_mask [n_batches, B]); the final
        partial batch is padded with index 0 rows masked out."""
        idx = np.arange(n) if rng is None else rng.permutation(n)
        n_batches = (n + batch_size - 1) // batch_size
        pad = n_batches * batch_size - n
        mask = np.ones(n_batches * batch_size, np.float32)
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
            mask[-pad:] = 0.0
        return (idx.reshape(n_batches, batch_size).astype(np.int64),
                mask.reshape(n_batches, batch_size))

    def _batches(self, ds: MolecularDataset, batch_size: int,
                 rng: Optional[np.random.Generator] = None,
                 shard: bool = False):
        """Yield batches gathered on the device, with ``sample_mask``; with
        ``shard``, this rank's data shard of each global batch."""
        data = self._device_dataset(ds)
        perm, smask = self._epoch_indices(len(ds), batch_size, rng)
        if shard and self.mesh is not None:
            perm, smask = (shard_batch(a.T, self.mesh).T
                           for a in (perm, smask))
        perm = torch.from_numpy(np.ascontiguousarray(perm)).to(self.device)
        smask = torch.from_numpy(np.ascontiguousarray(smask)).to(self.device)
        for i in range(perm.shape[0]):
            batch = gather_batch(data, perm[i], ds.fp.shape[1])
            batch["sample_mask"] = smask[i]
            yield batch

    def _forward(self, model: nn.Module, batch: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        """``(pred, latent)`` in f32.  Under bf16 compute the inputs go in
        as bf16 (the adjacency is built in f32 and cast after, as in the
        reference) and the model runs on ``params``, the working copy,
        when given."""
        adj = dense_adjacency(batch["edges"], batch["edge_mask"],
                              batch["nodes"].shape[1])
        node_mask = batch["node_mask"] * batch["sample_mask"].unsqueeze(1)
        nodes, fp = batch["nodes"], batch["fp"]
        if self._cdt is not None:
            nodes, adj, node_mask, fp = (t.to(self._cdt) for t in
                                         (nodes, adj, node_mask, fp))
        args = (nodes, adj, node_mask, fp, generator) if self.cfg.is_hybrid \
            else (nodes, adj, node_mask, generator)
        out = model(*args) if params is None \
            else functional_call(model, params, args)
        pred, latent = out if self.cfg.is_hybrid else (out, None)
        if self._cdt is not None:
            pred = pred.float()
            latent = None if latent is None else latent.float()
        return pred, latent

    def compute_copy(self, model: nn.Module, grad: bool = True
                     ) -> Optional[Dict[str, torch.Tensor]]:
        """The bf16 working copy of the f32 master (name -> leaf tensor that
        collects its gradient), or None where the forward runs on the
        module's own parameters (f32 compute, or the bf16 master)."""
        if self._cdt is None or self._master_narrow:
            return None
        return {n: p.detach().to(self._cdt).requires_grad_(grad)
                for n, p in model.named_parameters()}

    def _dropout_generator(self, epoch: int) -> torch.Generator:
        seed = np.random.SeedSequence([self.cfg.seed, 1234, epoch])
        return torch.Generator(device=self.device).manual_seed(
            int(seed.generate_state(1)[0]))

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   params_c: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the step's ``loss``, ``mse`` and
        ``kl`` as device tensors (no host sync).

        Under bf16 compute ``params_c`` is the working copy the forward runs
        on (:meth:`compute_copy`, made here when not given); the optimizer
        writes the next step's copy into it.  A bf16 master is rounded
        stochastically with the salt of this step's count
        (``train/optim.py::step_salt``)."""
        cfg, model = self.cfg, state.model
        model.train()
        if params_c is None:
            params_c = self.compute_copy(model)
        smask = batch["sample_mask"]
        count, shard_ctx = None, contextlib.nullcontext()
        if self.mesh is not None:
            group = self.mesh.data_group
            count = all_reduce_(smask.sum(), group)
            rows = smask.shape[0]
            shard_ctx = batch_shard(rows * self._data_ways,
                                    self.mesh.coords.get("data", 0) * rows,
                                    group)
        with matmul_precision(cfg.matmul_precision, cfg.compute_dtype), \
                shard_ctx:
            if cfg.remat:
                pred, latent = self._remat_forward(model, batch, generator,
                                                   params_c)
            else:
                pred, latent = self._forward(model, batch, generator,
                                             params_c)
            mse = _masked_mse(pred, batch["y"], smask, count)
            loss, kl = mse, torch.zeros((), device=mse.device)
            if cfg.is_hybrid and cfg.kl_lambda > 0:
                kl = kl_loss(latent, smask)
                loss = loss + self._kl_weight() * kl
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if self.mesh is not None:
            # the gradients of the global loss; the reported loss is the
            # global one, the same on every rank
            all_reduce_gradients(list(model.parameters()) if params_c is None
                                 else list(params_c.values()),
                                 self.mesh.data_group)
            mse = all_reduce_(mse.detach().clone(), self.mesh.data_group)
            loss = mse + cfg.kl_lambda * kl.detach() \
                if cfg.is_hybrid and cfg.kl_lambda > 0 else mse
        set_lr(state.optimizer, self._lr(state.step + 1)
               if callable(self._lr) else self._lr)
        if params_c is not None:
            state.optimizer.step(copies=list(params_c.values()))
        elif self._master_narrow:
            state.optimizer.step(salt=step_salt(cfg.seed, state.step))
        else:
            state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach(), "mse": mse.detach(),
                "kl": kl.detach()}

    def _remat_forward(self, model, batch, generator, params_c):
        """The forward under ``torch.utils.checkpoint``: its activations are
        recomputed in the backward.  The recompute restores the dropout
        generator to its state before the forward, so it draws the same
        masks and leaves the generator where the forward left it, and it
        holds the batch norms' running statistics still, so they update
        once a step."""
        start = None if generator is None else generator.get_state()
        runs = []

        def run():
            if not runs:
                runs.append(1)
                return self._forward(model, batch, generator, params_c)
            if generator is not None:
                generator.set_state(start)
            with frozen_running_stats(model):
                return self._forward(model, batch, generator, params_c)

        return checkpoint(run, use_reentrant=False)

    def train_epoch(self, state: TrainState, epoch: int
                    ) -> Tuple[TrainState, Dict]:
        self._check_divides("batch_size", self.cfg.batch_size)
        t0 = time.perf_counter()
        gen = self._dropout_generator(epoch)
        # the bf16 working copy: cast from the master once per epoch, then
        # carried (each step's optimizer writes the next step's copy)
        params_c = self.compute_copy(state.model)
        losses = [self.train_step(state, batch, gen, params_c)["loss"]
                  for batch in self._batches(
                      self.train_ds, self.cfg.batch_size,
                      np.random.default_rng(self.cfg.seed + epoch),
                      shard=True)]
        train_loss = float(torch.stack(losses).mean())   # one host sync
        dt = time.perf_counter() - t0
        n_mol = len(self.train_ds)
        return state, {"train_loss": train_loss, "epoch_time_s": dt,
                       "molecules_per_s": n_mol / dt if dt > 0 else 0.0}

    def evaluate(self, state: TrainState,
                 ds: Optional[MolecularDataset] = None) -> Dict:
        """Mean of per-batch MSEs for normalized and original-scale
        targets (reference ``train.py:278``), and the predictions.  Under a
        mesh every rank evaluates every batch whole (a split fc1 needs
        every rank of its model axis), so the results are the 1-process
        run's."""
        self._check_divides("eval_batch_size", self.cfg.eval_batch_size)
        ds = ds or self.val_ds
        model = state.model
        model.eval()
        mean = float(self.scaler.mean_)
        scale = float(self.scaler.scale_)
        preds, mses, omses, keeps = [], [], [], []
        with torch.inference_mode(), \
                matmul_precision(self.cfg.matmul_precision,
                                 self.cfg.compute_dtype):
            params_c = self.compute_copy(model, grad=False)
            for batch in self._batches(ds, self.cfg.eval_batch_size):
                pred, _ = self._forward(model, batch, params=params_c)
                pred = pred.reshape(-1)
                smask = batch["sample_mask"]
                mses.append(_masked_mse(pred, batch["y"], smask))
                denorm = pred * scale + mean
                omses.append(_masked_mse(denorm, batch["y_orig"], smask))
                preds.append(pred)
                keeps.append(smask > 0)
            keep = torch.cat(keeps)
            pred = torch.cat(preds)[keep]
            out = {"val_mse": torch.stack(mses).mean(),
                   "original_mse": torch.stack(omses).mean(),
                   "pred": pred, "pred_denorm": pred * scale + mean}
            out = {k: v.cpu() for k, v in out.items()}
        return {"val_mse": float(out["val_mse"]),
                "original_mse": float(out["original_mse"]),
                "pred": out["pred"].numpy(),
                "pred_denorm": out["pred_denorm"].numpy()}

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None,
            state: Optional[TrainState] = None, start_epoch: int = 0,
            verbose: bool = True, save_best: bool = True,
            save_min_interval_s: float = 60.0
            ) -> Tuple[TrainState, TrainState, List]:
        """Full training run; returns ``(final_state, best_state,
        history)``.  The best state is a deep copy (model and optimizer)
        kept on the device; it is written light at most every
        ``save_min_interval_s`` and in full once at the end, to
        ``<ckpt_dir>/best_model.pt``.  Under a process group every rank
        runs this; rank 0 alone prints and writes the log and the
        checkpoint, and its decisions (a new best, a save) hold on every
        rank."""
        cfg = self.cfg
        epochs = cfg.epochs if epochs is None else epochs
        if state is None:
            state = self.init_state()
        verbose = verbose and self.is_primary
        log_path = self.log_path if self.is_primary else None
        best_state = state
        best_metric = float("inf")
        best_norm_mse = float("inf")
        best_row: Dict = {}
        last_save = 0.0
        ckpt_path = os.path.join(self.ckpt_dir, "best_model.pt") \
            if self.ckpt_dir else None
        for epoch in range(start_epoch, epochs):
            state, tr = self.train_epoch(state, epoch)
            row = {"epoch": epoch + 1, **tr}
            if self.val_ds is not None:
                ev = self.evaluate(state)
                row["val_mse"] = ev["val_mse"]
                row["original_mse"] = ev["original_mse"]
                metric = ev.get(cfg.select_metric, ev["val_mse"])
                if self._agree(metric < best_metric):
                    best_metric = metric
                    best_norm_mse = ev["val_mse"]
                    best_state = copy.deepcopy(state)
                    best_row = row
                    row["new_best"] = True
                    now = time.perf_counter()
                    if save_best and ckpt_path and self._agree(
                            now - last_save > save_min_interval_s):
                        self.save(ckpt_path, best_state, row, light=True)
                        last_save = now
            self.history.append(row)
            if log_path:
                os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps(
                        {k: v for k, v in row.items()
                         if isinstance(v, (int, float, bool, str))}) + "\n")
            if verbose:
                msg = (f"Epoch {epoch + 1:4d} | Train Loss: "
                       f"{row['train_loss']:.4f}")
                if "val_mse" in row:
                    msg += (f" | Val MSE: {row['val_mse']:.4f} | "
                            f"Original MSE: {row['original_mse']:.4f}")
                if row.get("new_best"):
                    msg += "  *** new best ***"
                print(msg)
        if self.val_ds is None:
            best_state = state
        if save_best and ckpt_path and best_row:
            self.save(ckpt_path, best_state, best_row)
        self.best_metric = best_metric
        self.best_norm_mse = best_norm_mse
        return state, best_state, self.history

    # ------------------------------------------------------------------
    def save(self, path: str, state: TrainState,
             extra_meta: Optional[Dict] = None, light: bool = False) -> None:
        """Checkpoint with the reference's sidecar; ``light=True`` leaves
        the optimizer state out.  Under a mesh every rank calls it: a split
        fc1 and its Adam moments are gathered whole over the model axis,
        and rank 0 writes, so the file is the same whatever the mesh."""
        meta = {
            "config": dataclasses.asdict(self.cfg),
            "scaler": self.scaler.to_dict(),
            "max_nodes": self.train_ds.max_nodes,
            "max_edges": self.train_ds.max_edges,
        }
        if extra_meta:
            meta.update({k: v for k, v in extra_meta.items()
                         if isinstance(v, (int, float, bool, str))})
        sd = state.model.state_dict()
        opt = None if light else state.optimizer.state_dict()
        if self._split:
            sd = {k: gather_rows(v, self.mesh) if k in self._split else v
                  for k, v in sd.items()}
            if opt is not None:
                opt = self._split_optimizer_state(state.model, opt,
                                                  gather_rows)
        if self.is_primary:
            save_checkpoint(path, sd, meta, state.step, opt)

    def load(self, path: str) -> Tuple[TrainState, Dict]:
        """A fresh state with the checkpoint's weights, step and (from a
        full checkpoint) optimizer state; and the sidecar.  A reference
        package checkpoint (``.msgpack``) brings its Adam state across
        through ``models/convert.py::adam_state_from_jax``."""
        state = self.init_state()
        sd, step, meta, opt = load_checkpoint(path, with_optimizer=True)
        if self._split:           # this rank's rows of the split tensors
            sd = {k: shard_rows(v, self.mesh) if k in self._split else v
                  for k, v in sd.items()}
        state.model.load_state_dict(sd)
        if opt is not None:
            if path.endswith(".msgpack"):
                opt = adam_state_from_jax(opt, state.model, state.optimizer)
            if self._split:
                opt = self._split_optimizer_state(state.model, opt,
                                                  shard_rows)
            state.optimizer.load_state_dict(opt)
        state.step = step
        return state, meta

    def _split_optimizer_state(self, model: nn.Module, opt: Dict,
                               fn) -> Dict:
        """``opt`` (an optimizer ``state_dict``) with ``fn(tensor, mesh)``
        applied to the moments of the split parameters that follow their
        rows (``exp_avg``, ``exp_avg_sq``, a factored moment's row factor);
        the live state is left as it is."""
        index = {n: i for i, (n, _) in enumerate(model.named_parameters())}
        state = dict(opt["state"])
        for name in self._split:
            i = index[name]
            if i in state:
                state[i] = {k: fn(v, self.mesh) if k in (
                    "exp_avg", "exp_avg_sq", "exp_avg_sq_row") else v
                    for k, v in state[i].items()}
        return {**opt, "state": state}
