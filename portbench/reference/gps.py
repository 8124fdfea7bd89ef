"""Plain PyTorch reference of GraphGPS that the cell
``graphgps_medium.train`` runs (GPS-medium; Rampasek et al., "Recipe for a
General, Powerful, Scalable Graph Transformer", NeurIPS 2022,
arXiv:2205.12454; github.com/rampasek/GraphGPS, ``GPSLayer``,
``GatedGCNLayer`` and the PCQM4Mv2 ``GPS-medium+RWSE`` configuration): its
featurisation beside the atom features (bond types and the random-walk
encoding), its forward pass, the MSE loss, the gradients, and the dropout
masks replayed from the trainer's dropout generator.  A copy of
``mgat_graphsage_torch/compare/torch_ref_gps.py`` that takes the SMILES
parser and the atom features from ``reference/smiles.py`` and
``reference/featurize.py``, and Adam and the flags from
``reference/graphormer.py``: it imports nothing of the program.

It runs in f32 with TF32 off in cuBLAS and cuDNN (``ieee_flags``);
``q=`` rounds every operand of every product (the controls, one
precision below).  Its weights are a dict named as the program's
``state_dict`` names them, the batch norms' running statistics included
(``harness/weights_gps.py`` makes them).

The batch is a flat graph of the molecules' real atoms and real directed
bonds only, as PyG batches it: no padded atom or edge slot exists here.
The batch norms couple a batch's molecules, so a training step runs its
batch whole (not in blocks, as ``reference/graphormer.py`` may).

- Featurisation (:func:`graph`): the molecule's bonds both ways, sorted by
  (source, target); bond types 1 single, 2 double, 3 triple, 4 aromatic;
  RWSE (:func:`rwse`) the diagonals of ``torch.linalg.matrix_power(D^-1
  A, k)`` in f64 for k = 1..16, 0 for an isolated atom.
- Forward (:func:`forward`): ``h0 = cat(x W_atom, Linear(BN(rwse)))``,
  ``e0 = bond table[type]``; per layer the GatedGCN over the edge list
  (``index_add`` sums), the attention of each molecule over its own atoms
  (explicit softmax on the padded square, keys past the molecule at
  -inf), the batch norms over the batch's real atoms or edges (biased
  variance in training, the running statistics in evaluation), the FFN;
  the mean of each molecule's atoms, then ``384 -> 192 -> 96 -> 1`` with
  ReLU.
- Training (:func:`train_step`): the MSE, each parameter's gradient.

Departures from the publication (the configuration file lists them): the
atom encoder reads 35 one-hot features through a bias-free linear map to
364 (OGB's 9 categorical features are not reproduced); bond types are the
parser's four through a table of 4 rows (OGB's three bond features are not
used); the loss is MSE on standardised targets in place of PCQM4Mv2's L1;
no gradient-norm clipping; Adam with the L2 term in place of AdamW, both
at weight decay 0.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .featurize import atom_features_35
from .graphormer import (  # noqa: F401  (re-exported)
    Adam,
    adam_step,
    ieee_flags,
    masked_mse,
    parse_kept,
)

__all__ = ["RWSE_STEPS", "graph", "rwse", "parse_kept", "collate",
           "draw_masks", "forward", "masked_mse", "Adam", "adam_step",
           "train_step", "ieee_flags", "is_buffer"]

RWSE_STEPS = 16
EPS_BN = 1e-5


def _bond_type(bond) -> int:
    if bond.aromatic or bond.order == 1.5:
        return 4
    return int(bond.order)


def rwse(n: int, pairs: Sequence, steps: int = RWSE_STEPS) -> np.ndarray:
    """``[n, steps]`` f32: the return probabilities of the random walk,
    the diagonal of ``(D^-1 A)^k`` by ``matrix_power`` in f64."""
    a = torch.zeros(n, n, dtype=torch.float64)
    for i, j in pairs:
        a[i, j] = 1.0
    deg = a.sum(1, keepdim=True)
    p = torch.where(deg > 0, a / deg.clamp_min(1.0), torch.zeros_like(a))
    out = [torch.diagonal(torch.linalg.matrix_power(p, k))
           for k in range(1, steps + 1)]
    return torch.stack(out, 1).float().numpy()


def graph(mol):
    """``(features [n, 35], pairs [(source, target), ...], types [E],
    rwse [n, 16])`` of a parsed molecule; pairs sorted, both directions."""
    types: Dict = {}
    for b in mol.GetBonds():
        types.setdefault((b.a1, b.a2), _bond_type(b))
        types.setdefault((b.a2, b.a1), _bond_type(b))
    pairs = sorted(types)
    n = mol.GetNumAtoms()
    return (atom_features_35(mol), pairs,
            np.array([types[p] for p in pairs], np.int64), rwse(n, pairs))


def collate(mols: Sequence, rows: Sequence[int], max_nodes: int,
            max_edges: int, device) -> Dict[str, torch.Tensor]:
    """The flat batch of molecules ``mols``, which sit at rows ``rows`` of
    the program's padded batch (for the dropout masks): atom features
    ``x``, ``rwse``, edge ``src``/``dst`` (flat atom indices), ``etype``,
    each atom's molecule ``graph`` and its slot in a padded ``[B * N]``
    (``node_slot``), each edge's slot in a padded ``[B * E]``
    (``edge_slot``), each molecule's row (``rows``) and atom count
    (``sizes``)."""
    xs, pes, src, dst, et, gid, nslot, eslot, sizes = ([] for _ in range(9))
    base = 0
    for g, (mol, r) in enumerate(zip(mols, rows)):
        feats, pairs, types, pe = graph(mol)
        n = feats.shape[0]
        xs.append(feats)
        pes.append(pe)
        src += [base + i for i, _ in pairs]
        dst += [base + j for _, j in pairs]
        et.append(types)
        gid += [g] * n
        nslot += [r * max_nodes + a for a in range(n)]
        eslot += [r * max_edges + k for k in range(len(pairs))]
        sizes.append(n)
        base += n

    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return {"x": t(np.concatenate(xs), torch.float32),
            "rwse": t(np.concatenate(pes), torch.float32),
            "src": t(src, torch.long), "dst": t(dst, torch.long),
            "etype": t(np.concatenate(et) if et else [], torch.long),
            "graph": t(gid, torch.long), "node_slot": t(nslot, torch.long),
            "edge_slot": t(eslot, torch.long), "rows": t(rows, torch.long),
            "sizes": t(sizes, torch.long)}


def draw_masks(generator: Optional[torch.Generator], b: int, n: int, e: int,
               dim: int, heads: int, ffn: int, layers: int, p: float,
               p_attn: float, device) -> List:
    """The training step's dropout keep-masks on the program's padded
    shapes, in the order the port draws them: per layer the GatedGCN's
    node ``[b, n, dim]`` and edge ``[b, e, dim]`` states, the attention's
    ``[b, heads, n, n]``, its output ``[b, n, dim]``, the FFN's hidden
    ``[b, n, ffn]`` and output ``[b, n, dim]``; each ``bernoulli_(1 - p)``
    on an f32 tensor (None where the rate is 0)."""
    def draw(shape, rate):
        if rate == 0.0:
            return None
        return torch.empty(shape, dtype=torch.float32, device=device) \
            .bernoulli_(1.0 - rate, generator=generator) > 0

    return [(draw((b, n, dim), p), draw((b, e, dim), p),
             draw((b, heads, n, n), p_attn), draw((b, n, dim), p),
             draw((b, n, ffn), p), draw((b, n, dim), p))
            for _ in range(layers)]


def is_buffer(name: str) -> bool:
    """A batch norm's running statistic, not a parameter."""
    return name.endswith((".mean", ".var"))


Round = Callable[[torch.Tensor], torch.Tensor]


def forward(w: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
            heads: int, train: bool = True, masks: Optional[List] = None,
            p: float = 0.1, p_attn: float = 0.1,
            q: Optional[Round] = None) -> torch.Tensor:
    """Predictions ``[G]`` in f32 for the molecules of :func:`collate`.
    ``train`` takes the batch norms' statistics from the batch, else from
    ``w``'s running ones; ``masks`` (:func:`draw_masks`) applies the
    dropouts at the molecules' slots of the program's padded shapes (the
    slots :func:`collate` gives); None applies none.  ``q`` rounds each
    operand of each product (a control one precision below); None leaves
    them f32."""
    q = q or (lambda t: t)
    layers = len({k.split(".")[1] for k in w if k.startswith("layers.")})
    src, dst, nslot, eslot = g["src"], g["dst"], g["node_slot"], \
        g["edge_slot"]
    n_atoms = g["x"].shape[0]
    sizes, n_graphs = g["sizes"], g["sizes"].shape[0]
    width = max(int(sizes.max()), 1) if n_graphs else 1
    # each atom's place in the molecules' padded square, for the attention
    pos = torch.arange(n_atoms, device=src.device) \
        - torch.repeat_interleave(torch.cumsum(sizes, 0) - sizes, sizes)
    dense_at = g["graph"] * width + pos
    key_ok = torch.arange(width, device=src.device)[None, :] \
        < sizes[:, None]

    def lin(x, name, bias=True):
        return F.linear(q(x), q(w[name + ".weight"]),
                        w[name + ".bias"] if bias else None)

    def bn(x, name):
        if train:
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
        else:
            mean, var = w[name + ".mean"], w[name + ".var"]
        return (x - mean) / torch.sqrt(var + EPS_BN) * w[name + ".scale"] \
            + w[name + ".bias"]

    def drop(x, keep, slots, rate):
        if keep is None:
            return x
        return x * keep.reshape(-1, keep.shape[-1])[slots] / (1.0 - rate)

    h = torch.cat([lin(g["x"], "atom_encoder", bias=False),
                   lin(bn(g["rwse"], "rwse_norm"), "rwse_encoder")], 1)
    dim = h.shape[1]
    table = torch.cat([torch.zeros(1, dim, device=h.device),
                       w["bond_encoder.weight"]])
    e = table[g["etype"]]
    dh = dim // heads
    for i in range(layers):
        pre = f"layers.{i}."
        km = masks[i] if masks is not None else (None,) * 6
        # local: the GatedGCN over the real edges
        loc = pre + "local_model."
        e_hat = lin(h, loc + "D")[dst] + lin(h, loc + "E")[src] \
            + lin(e, loc + "C")
        gate = torch.sigmoid(e_hat)
        num = torch.zeros_like(h).index_add(0, dst,
                                            gate * lin(h, loc + "B")[src])
        den = torch.zeros_like(h).index_add(0, dst, gate)
        x = lin(h, loc + "A") + num / (den + 1e-6)
        x = drop(F.relu(bn(x, loc + "bn_node_x")), km[0], nslot, p)
        e = e + drop(F.relu(bn(e_hat, loc + "bn_edge_e")), km[1], eslot, p)
        h_local = bn(h + x, pre + "norm1_local")
        # global: each molecule's atoms attend to its own atoms
        def dense(t):
            out = t.new_zeros(n_graphs * width, dim)
            out[dense_at] = t
            return out.view(n_graphs, width, heads, dh).transpose(1, 2)

        qh, kh, vh = (dense(lin(h, pre + name))
                      for name in ("q_proj", "k_proj", "v_proj"))
        logits = torch.matmul(q(qh), q(kh).transpose(-1, -2)) \
            / math.sqrt(dh)
        logits = logits.masked_fill(~key_ok[:, None, None, :], float("-inf"))
        attn = torch.softmax(logits, dim=-1)
        if km[2] is not None:
            attn = attn * km[2][g["rows"], :, :width, :width] / (1.0 - p_attn)
        o = torch.matmul(q(attn), q(vh)).transpose(1, 2).reshape(-1, dim)
        o = lin(o[dense_at], pre + "out_proj")
        h_attn = bn(h + drop(o, km[3], nslot, p), pre + "norm1_attn")
        h2 = h_local + h_attn
        y = drop(F.relu(lin(h2, pre + "ff_linear1")), km[4], nslot, p)
        y = drop(lin(y, pre + "ff_linear2"), km[5], nslot, p)
        h = bn(h2 + y, pre + "norm2")
    pooled = torch.zeros(n_graphs, dim, device=h.device).index_add(
        0, g["graph"], h) / sizes.clamp_min(1)[:, None].float()
    y = F.relu(lin(pooled, "head_fc1"))
    return lin(F.relu(lin(y, "head_fc2")), "head_out").reshape(-1)


def train_step(w: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
               target, heads: int, masks: Optional[List] = None,
               p: float = 0.1, p_attn: float = 0.1,
               q: Optional[Round] = None):
    """``(loss, grads)`` of one training step: the MSE of :func:`forward`
    over the molecules of ``g`` (the batch's real rows) against
    ``target [G]``, and the gradient of each parameter, zero for those
    that reach no output (``w``'s running statistics are read by no
    training forward)."""
    leaves = {k: v.detach().clone().requires_grad_(not is_buffer(k))
              for k, v in w.items()}
    pred = forward(leaves, g, heads, True, masks, p, p_attn, q)
    loss = ((pred - target) ** 2).mean()
    names = [k for k in leaves if not is_buffer(k)]
    grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                allow_unused=True)
    # the last layer's edge stream reaches no output: its norm's gradient
    # is zero
    return loss.detach(), {k: torch.zeros_like(leaves[k]) if gr is None
                           else gr for k, gr in zip(names, grads)}
