"""Optimizers and learning-rate schedule of the port's trainer (port of
``mgat_graphsage_tpu/train/trainer.py::make_optimizer`` and
``_lr_schedule``, and of ``train/optim.py``).

The reference's optimizer is torch's Adam: L2 weight decay added to the
gradient before the moments (not decoupled AdamW), bias corrections on
the 1-based step count.  For the all-f32 config ``torch.optim.Adam(lr,
weight_decay=...)`` has exactly these semantics, so the port uses it:
its foreach step takes less device time than :class:`TorchAdam`'s on the
f32 ``flagship`` (1.086 against 1.938 ms, H100 80GB HBM3 at 700 W,
``chip_smoke.py`` phase 11), whose passes keep the reference's order.
Every other config (bf16 compute, bf16 moments, the bf16 master) takes
:class:`TorchAdam`, the port's counterpart of the reference's
``torch_adam`` and ``torch_adam_sr_update``: the same math, all of it in
f32, with the moments *stored* in ``adam_moment_dtype``, the gradient
read from the bf16 working copy when there is one, and the new master
written together with the next step's working copy (or, for a bf16
master, stochastically rounded to bf16) in the same step.  Each operation
of the step is one ``torch._foreach_*`` pass over all the parameters, so
a step is a few dozen launches on the card rather than ~20 a parameter.

The schedule is the reference formula evaluated in f32 on the host once
per step.  The factored second moment (``adam_factored_v``) is ported
too.  :func:`check_ported` refuses the values and combinations of the
config that the reference's trainer refuses.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

__all__ = ["lr_schedule", "make_optimizer", "set_lr", "check_ported",
           "TorchAdam", "hash_noise16", "sr_to_bf16", "step_salt",
           "DTYPES", "FACTORED_V_MIN_SIZE"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# 2-D parameters with at least this many elements keep a factored second
# moment under adam_factored_v (reference trainer.py::make_optimizer)
FACTORED_V_MIN_SIZE = 1 << 20


def check_ported(cfg) -> None:
    """Raise ``ValueError`` for the config values and combinations the
    reference's trainer refuses."""
    if cfg.dataset_storage not in ("float32", "compact"):
        raise ValueError(f"dataset_storage={cfg.dataset_storage!r}; "
                         "expected 'float32' or 'compact'")
    for field in ("compute_dtype", "master_dtype", "adam_moment_dtype"):
        if getattr(cfg, field) not in DTYPES:
            raise ValueError(f"{field}={getattr(cfg, field)!r}; expected "
                             "'float32' or 'bfloat16'")
    if cfg.master_dtype == "bfloat16" and cfg.compute_dtype != "bfloat16":
        raise ValueError("master_dtype='bfloat16' requires compute_dtype="
                         "'bfloat16' (the bf16 master IS the compute copy)")
    if cfg.adam_factored_v and cfg.master_dtype == "bfloat16":
        raise ValueError("adam_factored_v is not supported with "
                         "master_dtype='bfloat16' (the fused SR update path "
                         "keeps a full v)")


def lr_schedule(cfg, total_steps: int) -> Union[float, Callable[[int], float]]:
    """cfg -> constant float lr, or a map from the 1-based step count to
    the lr.

    ``warmup_cosine``: linear warmup over ``cfg.warmup_steps`` steps, then
    cosine decay from ``cfg.lr`` to ``cfg.lr * cfg.lr_final_ratio`` over the
    remaining ``total_steps``: the reference formula, in f32 as the
    reference evaluates it."""
    if cfg.lr_schedule == "constant":
        return cfg.lr
    if cfg.lr_schedule != "warmup_cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                         "(expected 'constant' or 'warmup_cosine')")
    f32 = np.float32
    warm = max(int(cfg.warmup_steps), 1)
    floor = cfg.lr * cfg.lr_final_ratio
    span = max(int(total_steps) - warm, 1)

    def sched(count: int) -> float:
        c = f32(count)
        wlr = f32(cfg.lr) * np.minimum(c / f32(warm), f32(1.0))
        prog = np.clip((c - f32(warm)) / f32(span), f32(0.0), f32(1.0))
        clr = f32(floor) + f32(0.5 * (cfg.lr - floor)) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(wlr if c <= f32(warm) else clr)

    return sched


# ---------------------------------------------------------------------------
# stochastic rounding (reference train/optim.py::_hash_noise16, _sr_to_bf16)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2**32`` for int64 ``h`` in [0, 2**32): ``h``'s 16-bit
    halves times ``c`` stay below 2**49, so no product overflows int64."""
    lo = (h & 0xFFFF) * c
    hi = ((h >> 16) * (c & 0xFFFF)) << 16
    return (lo + hi) & _U32


def hash_noise16(n: int, salt: int, device=None) -> torch.Tensor:
    """16 uniform bits per element (int64 in [0, 2**16)) from the
    murmur3 finalizer of ``index ^ salt``: the reference's
    ``_hash_noise16`` bit for bit, in int64 arithmetic kept to its low 32
    bits."""
    h = torch.arange(n, dtype=torch.int64, device=device) ^ (int(salt) & _U32)
    h = _mul_u32(h ^ (h >> 16), 0x85EBCA6B)
    h = _mul_u32(h ^ (h >> 13), 0xC2B2AE35)
    return (h ^ (h >> 16)) & 0xFFFF


def sr_to_bf16(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Round f32 ``x`` to bf16 stochastically: add ``hash_noise16`` to the
    16 bits that bf16 drops, carry, truncate (the reference's
    ``_sr_to_bf16`` with its salt given).  Unbiased: E[result] = x."""
    bits = x.contiguous().view(torch.int32).reshape(-1).to(torch.int64) & _U32
    hi = ((bits + hash_noise16(bits.numel(), salt, x.device)) & _U32) >> 16
    hi = hi - ((hi >> 15) << 16)                     # as a signed 16-bit int
    return hi.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def step_salt(seed: int, step: int) -> int:
    """The uint32 salt of the stochastic rounding of optimizer step
    ``step`` (0-based count), from the run's seed, so a resumed run rounds
    as an uninterrupted one.  The reference salts from its JAX key; the
    port draws from its own seed stream, so the two round differently
    (each without bias)."""
    return int(np.random.SeedSequence([seed, 0x5E, step])
               .generate_state(1)[0])


def _leaf_salt(salt: int, index: int) -> int:
    """The reference's per-leaf salt: ``salt ^ (0x01000193 * (i + 1))``."""
    return (int(salt) ^ ((0x01000193 * (index + 1)) & _U32)) & _U32


# ---------------------------------------------------------------------------
# the port's Adam for narrow storage
# ---------------------------------------------------------------------------

def _as_f32(ts):
    """``ts`` with every non-f32 tensor replaced by an f32 copy (one
    ``_foreach_copy_`` for all of them); f32 tensors are returned as they
    are, so in-place updates reach them."""
    out = [t if t.dtype == torch.float32
           else torch.empty_like(t, dtype=torch.float32) for t in ts]
    narrow = [(o, t) for o, t in zip(out, ts) if o is not t]
    if narrow:
        torch._foreach_copy_([o for o, _ in narrow], [t for _, t in narrow])
    return out


def _store(dst, src) -> None:
    """Write the f32 ``src`` back into the storage tensors ``dst`` that
    :func:`_as_f32` copied (cast to their dtype)."""
    pairs = [(d, x) for d, x in zip(dst, src) if d is not x]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [x for _, x in pairs])


class TorchAdam(torch.optim.Optimizer):
    """torch Adam (L2 in the gradient) with f32 arithmetic and the moments
    stored in ``moment_dtype``: the reference's ``torch_adam`` and, for bf16
    parameters, ``torch_adam_sr_update``.

    Per parameter, in f32 and in the reference's order::

        g  = g + weight_decay * p
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        p  = p + (-lr) * (m2 / c1) / (sqrt(v2 / c2) + eps)

    with ``c1 = 1 - b1**t``, ``c2 = 1 - b2**t`` on the f32 1-based count.
    The state keeps Adam's names (``step``, ``exp_avg``, ``exp_avg_sq``), so
    ``state_dict()`` and checkpoints have Adam's layout.  With
    ``factored_v_min_size > 0``, 2-D parameters of at least that many
    elements keep ``exp_avg_sq_row`` and ``exp_avg_sq_col`` (f32 EMAs of
    the row and column means of ``g * g``) in place of ``exp_avg_sq``, and
    take ``v = outer(row, col) / mean(col)``: the reference's
    ``outer(r, c) / mean(r)`` on its ``[in, out]`` kernel, this
    ``[out, in]`` weight's transpose.

    :meth:`step` takes, optionally, ``copies``: one tensor per parameter
    (in parameter order) holding the working copy the forward ran on.
    The gradient is then read from ``copies[i].grad`` and the new master,
    cast, is written into ``copies[i]`` in the same step: the next step's
    working copy.  A bf16 parameter (the bf16 master) is rounded
    stochastically with the noise salted by ``salt`` (required then) and
    the parameter's index, as the reference salts its leaves.
    """

    def __init__(self, params, lr: float = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 moment_dtype: torch.dtype = torch.float32,
                 factored_v_min_size: int = 0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.moment_dtype = moment_dtype
        self.factored_v_min_size = factored_v_min_size

    def _factored(self, p: torch.Tensor) -> bool:
        return (self.factored_v_min_size > 0 and p.dim() == 2
                and p.numel() >= self.factored_v_min_size)

    def _init_state(self, p: torch.Tensor) -> Dict:
        mdt = self.moment_dtype
        st = {"step": torch.tensor(0.0),
              "exp_avg": torch.zeros_like(p, dtype=mdt,
                                          memory_format=torch.preserve_format)}
        if self._factored(p):
            st["exp_avg_sq_row"] = torch.zeros(p.shape[0], device=p.device)
            st["exp_avg_sq_col"] = torch.zeros(p.shape[1], device=p.device)
        else:
            st["exp_avg_sq"] = torch.zeros_like(
                p, dtype=mdt, memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, closure=None,
             copies: Optional[Sequence[torch.Tensor]] = None,
             salt: Optional[int] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        index = 0
        for group in self.param_groups:
            leaves = []
            for p in group["params"]:
                i, index = index, index + 1
                copy = None if copies is None else copies[i]
                g = p.grad if copy is None else copy.grad
                if g is None:
                    continue
                if p.dtype == torch.bfloat16 and salt is None:
                    raise ValueError("a bf16 parameter is rounded "
                                     "stochastically: step() needs salt")
                st = self.state[p]
                if not st:
                    st.update(self._init_state(p))
                st["step"] += 1
                leaves.append((i, p, g, copy, st))
            if leaves:
                self._update(group, leaves, salt)
        return loss

    @staticmethod
    def _update(group: Dict, leaves, salt: Optional[int]) -> None:
        """One step over ``leaves`` (index, parameter, gradient, copy,
        state).  Each operation is one ``torch._foreach_*`` call over all
        the leaves (a pass over a leaf list is a few launches on the card,
        where a loop over ~35 leaves launches ~20 kernels each), in f32
        and in the reference's order."""
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        f32 = np.float32
        count = [f32(st["step"].item()) for *_, st in leaves]
        c1 = [float(f32(1.0) - f32(b1) ** t) for t in count]
        c2 = [float(f32(1.0) - f32(b2) ** t) for t in count]
        ps = [leaf[1] for leaf in leaves]
        states = [leaf[4] for leaf in leaves]
        p32 = _as_f32(ps)
        g = _as_f32([leaf[2] for leaf in leaves])
        if wd:
            g = torch._foreach_add(g, torch._foreach_mul(p32, wd))
        m = _as_f32([st["exp_avg"] for st in states])
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        gg = torch._foreach_mul(g, g)
        v = [None] * len(leaves)
        full = [k for k, st in enumerate(states) if "exp_avg_sq" in st]
        if full:
            vf = _as_f32([states[k]["exp_avg_sq"] for k in full])
            torch._foreach_mul_(vf, b2)
            torch._foreach_add_(vf, torch._foreach_mul(
                [gg[k] for k in full], 1.0 - b2))
            _store([states[k]["exp_avg_sq"] for k in full], vf)
            for k, x in zip(full, vf):
                v[k] = x
        for k, st in enumerate(states):
            if "exp_avg_sq_row" in st:
                # the reference factors its kernel, this weight's
                # transpose: its row factor is this column factor, and it
                # normalises by that factor's mean
                row = st["exp_avg_sq_row"].mul_(b2).add_(
                    gg[k].mean(dim=1) * (1.0 - b2))
                col = st["exp_avg_sq_col"].mul_(b2).add_(
                    gg[k].mean(dim=0) * (1.0 - b2))
                v[k] = (col.unsqueeze(0) * row.unsqueeze(1)
                        / torch.clamp_min(col.mean(), 1e-30))
        _store([st["exp_avg"] for st in states], m)
        upd = torch._foreach_div(m, c1)
        torch._foreach_mul_(upd, -lr)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(upd, den)
        torch._foreach_add_(p32, upd)          # the f32 master in place
        for (i, p, *_), x in zip(leaves, p32):
            if p.dtype == torch.bfloat16:
                p.copy_(sr_to_bf16(x, _leaf_salt(salt, i)))
        copies = [leaf[3] for leaf in leaves if leaf[3] is not None]
        if copies:
            torch._foreach_copy_(copies, [leaf[1] for leaf in leaves
                                          if leaf[3] is not None])
            for c in copies:
                c.grad = None

    def load_state_dict(self, state_dict: Dict) -> None:
        """Adam's loader casts every floating state tensor to its
        parameter's dtype; the moments are put back in the storage dtype
        (from the saved tensors, so nothing is rounded twice)."""
        super().load_state_dict(state_dict)
        params = [p for g in self.param_groups for p in g["params"]]
        for i, saved in state_dict["state"].items():
            st = self.state[params[i]]
            for key in ("exp_avg", "exp_avg_sq"):
                if key in saved:
                    st[key] = saved[key].to(device=params[i].device,
                                            dtype=self.moment_dtype)
            for key in ("exp_avg_sq_row", "exp_avg_sq_col"):
                if key in saved:
                    st[key] = saved[key].to(device=params[i].device,
                                            dtype=torch.float32)


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """torch Adam with L2 coupled into the gradient: ``torch.optim.Adam``
    for the all-f32 config, :class:`TorchAdam` for every other."""
    check_ported(cfg)
    kw = dict(lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
              weight_decay=cfg.weight_decay)
    if (cfg.compute_dtype, cfg.master_dtype, cfg.adam_moment_dtype,
            cfg.adam_factored_v) == ("float32", "float32", "float32", False):
        return torch.optim.Adam(model.parameters(), **kw)
    return TorchAdam(model.parameters(),
                     moment_dtype=DTYPES[cfg.adam_moment_dtype],
                     factored_v_min_size=FACTORED_V_MIN_SIZE
                     if cfg.adam_factored_v else 0, **kw)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
