"""Plain-PyTorch reference of EGT (``models/zoo.py::EGTNet``, preset
``egt_110m``): its featurisation beside the atom features (shortest-path
distances, the bond type of each bonded pair, the SVD encodings), its
forward pass, the MSE loss, the gradients, and the SVD sign flips and
dropout masks replayed from the trainer's dropout generator.

Written from Hussain, Zaki and Subramanian, "Global Self-Attention as a
Replacement for Graph Convolution" (KDD 2022, arXiv:2108.03348) and the
public code (github.com/shamim-hussain/egt_pytorch: ``EGT_Layer``,
``VirtualNodes``, ``EGT_MOL`` and the PCQM4Mv2 ``egt_110m``
configuration), not from the port: it imports no kernel, op or layer of
the port, only the SMILES parser, the 35-dim atom features and the
Graphormer reference's breadth-first search, Adam and flags.  It runs in
f32 with TF32 off in cuBLAS and cuDNN (``ieee_flags``), and takes its
weights as a dict named as the port's ``state_dict`` names them.

- Featurisation (:func:`pairs`): the distances of the Graphormer
  reference's breadth-first search (-1 between components), the bond type
  of each bonded pair (1 single, 2 double, 3 triple, 4 aromatic, 0 for no
  bond), and the SVD encodings ``[U sqrt(S), V sqrt(S)]`` of the top 8
  singular triplets of the adjacency, by NumPy's SVD in f64 on the
  adjacency built here (a repeated singular value leaves its vectors to
  the routine, so the reference calls the same one the port calls).
- Forward (:func:`forward`), on a dense ``[b, V + n, V + n]`` square with
  the ``V`` virtual nodes first and the atoms past each molecule masked:
  ``h0 = x W_atom + Linear(svd * signs)``; ``e0 = distance[min(d, 17)] +
  bond[t]`` (17 for further than 16 or unreachable), a virtual node's row
  and column its own pair embedding, half the sum of two between virtual
  nodes; per layer the equations of the public ``EGT_Layer``: ``H^ =
  clip(Q K^T / sqrt(d), -5, 5) + E``, ``A = softmax(H^ + mask) *
  sigmoid(G + mask)``, the attention dropout on ``A``, the output scaled
  by ``ln(1 + sum_j sigmoid(G))`` except on the virtual nodes, ``h += O_h``,
  ``h += FFN(LN(h))``, and but in the last layer ``e += O_e(H^)``, ``e +=
  FFN(LN(e))``, every FFN ``Linear -> ELU -> Linear``; the readout is the
  final layer norm of the virtual nodes' states, concatenated, through
  ``Linear -> ELU -> Linear -> ELU -> Linear``.
- Training (:func:`train_step`): masked MSE, each parameter's gradient;
  torch's Adam with the L2 term coupled into the gradient.

Departures from the publication, shared with the port (PERF.md, the
benchmark's configuration file): the atom encoder reads the port's 35
one-hot features through a bias-free linear map (OGB's 9 categorical
features are not reproduced); the bond embedding is a table of the
parser's four bond types (OGB's three bond features are not used); the
loss is MSE on standardised targets in place of PCQM4Mv2's L1; Adam with
the L2 term in place of AdamW, both at weight decay 0; the query, key and
value projections are three linear maps (the public code's one map has
their parameters in another order); no attention mask-out.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..chem.featurize import atom_features_35
from .torch_ref_graphormer import (  # noqa: F401  (re-exported)
    Adam,
    adam_step,
    ieee_flags,
    masked_mse,
    parse_kept,
    structure,
)

__all__ = ["SVD_RANK", "CLIP", "MAX_DISTANCE", "svd_encoding", "pairs",
           "arrays", "parse_kept", "draw_masks", "rows_of", "forward",
           "masked_mse", "Adam", "adam_step", "train_step", "ieee_flags"]

SVD_RANK = 8
CLIP = 5.0
MAX_DISTANCE = 16


def _bond_type(bond) -> int:
    if bond.aromatic or bond.order == 1.5:
        return 4
    return int(bond.order)


def svd_encoding(n: int, bonds: Sequence, rank: int = SVD_RANK
                 ) -> np.ndarray:
    """``[n, 2 rank]`` f32: ``[U sqrt(S), V sqrt(S)]`` of the top ``rank``
    singular triplets of the adjacency of the directed ``bonds``, zero past
    ``n`` of them."""
    a = np.zeros((n, n), np.float64)
    for i, j in bonds:
        a[i, j] = 1.0
    u, s, vh = np.linalg.svd(a)
    k = min(rank, n)
    out = np.zeros((n, 2 * rank), np.float64)
    out[:, :k] = u[:, :k] * np.sqrt(s[:k])
    out[:, rank:rank + k] = vh[:k].T * np.sqrt(s[:k])
    return out.astype(np.float32)


def pairs(mol):
    """``(features [n, 35], spd [n, n], bond [n, n], svd [n, 16])`` of a
    parsed molecule."""
    types: Dict = {}
    for b in mol.GetBonds():
        types.setdefault((b.a1, b.a2), _bond_type(b))
        types.setdefault((b.a2, b.a1), _bond_type(b))
    n = mol.GetNumAtoms()
    bond = np.zeros((n, n), np.int64)
    for (i, j), t in types.items():
        bond[i, j] = t
    spd = structure(mol, 1)[1]
    return atom_features_35(mol), spd, bond, svd_encoding(n, sorted(types))


def arrays(mols: Sequence, max_nodes: int) -> Dict[str, np.ndarray]:
    """``nodes [k, N, 35]``, ``node_mask [k, N]``, ``spd [k, N, N]`` (-1
    for padding), ``bond [k, N, N]`` and ``svd [k, N, 16]`` of parsed
    molecules, padded to ``N = max_nodes``."""
    k, n = len(mols), max_nodes
    out = {"nodes": np.zeros((k, n, 35), np.float32),
           "node_mask": np.zeros((k, n), np.float32),
           "spd": np.full((k, n, n), -1, np.int64),
           "bond": np.zeros((k, n, n), np.int64),
           "svd": np.zeros((k, n, 2 * SVD_RANK), np.float32)}
    for r, mol in enumerate(mols):
        a = mol.GetNumAtoms()
        feats, spd, bond, svd = pairs(mol)
        out["nodes"][r, :a], out["node_mask"][r, :a] = feats, 1.0
        out["spd"][r, :a, :a], out["bond"][r, :a, :a] = spd, bond
        out["svd"][r, :a] = svd
    return out


def draw_masks(generator: Optional[torch.Generator], b: int, n: int,
               virtual: int, dim: int, pair_dim: int, heads: int,
               layers: int, p_attn: float, p: float, device) -> Dict:
    """The training step's draws on the port's padded shapes (``N = virtual
    + n``), in the order the port draws them: ``signs [b, 8]``, each SVD
    triplet's sign kept (True) or flipped, ``bernoulli_(0.5)``; then per
    layer the attention's keep-mask ``[b, heads, N, N]``, the node
    stream's two ``[b, N, dim]`` and, but in the last layer, the pair
    stream's two ``[b, N, N, pair_dim]``, each ``bernoulli_(1 - rate)`` on
    an f32 tensor (None where the rate is 0)."""
    m = virtual + n

    def draw(shape, rate):
        if rate == 0.0:
            return None
        return torch.empty(shape, dtype=torch.float32, device=device) \
            .bernoulli_(1.0 - rate, generator=generator) > 0

    signs = draw((b, SVD_RANK), 0.5)
    out = []
    for i in range(layers):
        last = i == layers - 1
        out.append((draw((b, heads, m, m), p_attn), draw((b, m, dim), p),
                    draw((b, m, dim), p),
                    None if last else draw((b, m, m, pair_dim), p),
                    None if last else draw((b, m, m, pair_dim), p)))
    return {"signs": signs, "layers": out}


def rows_of(masks: Dict, rows) -> Dict:
    """``masks`` of :func:`draw_masks` for the batch's rows ``rows``."""
    def take(t):
        return None if t is None else t[rows]

    return {"signs": take(masks["signs"]),
            "layers": [tuple(take(t) for t in km) for km in masks["layers"]]}


Round = Callable[[torch.Tensor], torch.Tensor]


def _layer_norm(x, w, name):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-5)


def forward(w: Dict[str, torch.Tensor], inputs: Dict[str, torch.Tensor],
            heads: int, masks: Optional[Dict] = None, p_attn: float = 0.3,
            p: float = 0.0, q: Optional[Round] = None) -> torch.Tensor:
    """Predictions ``[b]`` in f32 for ``inputs`` (:func:`arrays` as tensors,
    any padded width ``n``).  ``masks`` (:func:`draw_masks` of these rows,
    at any width from ``V + n`` up: each is cut to the inputs' square)
    applies the sign flips and the dropouts; None is evaluation.  ``q``
    rounds each operand of each product (a control one precision below);
    None leaves them f32."""
    q = q or (lambda t: t)
    nodes, node_mask = inputs["nodes"], inputs["node_mask"]
    b, n, _ = nodes.shape
    v, dim = w["virtual_node.weight"].shape
    c = w["virtual_pair.weight"].shape[1]
    m, dh = v + n, dim // heads
    layers = len({k.split(".")[1] for k in w if k.startswith("layers.")})
    dev = nodes.device

    def lin(x, name, bias=True):
        return F.linear(q(x), q(w[name + ".weight"]),
                        w[name + ".bias"] if bias else None)

    def drop(x, keep, rate):
        if keep is None:
            return x
        keep = keep[:, :m, :m] if x.dim() == 4 else keep[:, :m]
        return x * keep / (1.0 - rate)

    svd = inputs["svd"]
    if masks is not None:
        sign = torch.where(masks["signs"], 1.0, -1.0).repeat(1, 2)
        svd = svd * sign[:, None, :]
    x = lin(nodes, "atom_encoder", bias=False) + lin(svd, "svd_encoder")
    h = torch.cat([w["virtual_node.weight"].expand(b, v, dim), x], 1)

    d = inputs["spd"].long()
    d = torch.where((d < 0) | (d > MAX_DISTANCE), MAX_DISTANCE + 1, d)
    bond = torch.cat([torch.zeros(1, c, device=dev), w["bond.weight"]])
    vp = w["virtual_pair.weight"]
    e = torch.zeros(b, m, m, c, device=dev)
    e[:, v:, v:] = w["distance.weight"][d] + bond[inputs["bond"].long()]
    e[:, :v, v:] = vp[:, None, :]
    e[:, v:, :v] = vp[None, :, :]
    e[:, :v, :v] = 0.5 * (vp[:, None, :] + vp[None, :, :])
    valid = torch.cat([torch.ones(b, v, dtype=torch.bool, device=dev),
                       node_mask > 0], 1)[:, None, None, :]
    fixed = torch.arange(m, device=dev) < v

    for i in range(layers):
        pre = f"layers.{i}."
        keep_a, keep_o, keep_f, keep_eo, keep_ef = \
            masks["layers"][i] if masks is not None else (None,) * 5
        y = _layer_norm(h, w, pre + "node_norm")
        qh, kh, vh = (lin(y, pre + name).view(b, m, heads, dh)
                      .transpose(1, 2)
                      for name in ("q_proj", "k_proj", "v_proj"))
        z = _layer_norm(e, w, pre + "pair_norm")
        bias = lin(z, pre + "E").permute(0, 3, 1, 2)
        gates = torch.sigmoid(lin(z, pre + "G").permute(0, 3, 1, 2)) * valid
        logits = torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(dh)
        h_hat = logits.clamp(-CLIP, CLIP) + bias
        attn = torch.softmax(h_hat.masked_fill(~valid, float("-inf")), -1) \
            * gates
        if keep_a is not None:
            attn = attn * keep_a[:, :, :m, :m] / (1.0 - p_attn)
        o = torch.matmul(q(attn), q(vh))
        scale = torch.where(fixed, 1.0, torch.log(1.0 + gates.sum(-1)))
        o = (o * scale.unsqueeze(-1)).transpose(1, 2).reshape(b, m, dim)
        h = h + drop(lin(o, pre + "out_proj"), keep_o, p)
        y = lin(F.elu(lin(_layer_norm(h, w, pre + "ffn_norm"), pre + "fc1")),
                pre + "fc2")
        h = h + drop(y, keep_f, p)
        if pre + "pair_out.weight" not in w:
            continue
        e = e + drop(lin(h_hat.permute(0, 2, 3, 1), pre + "pair_out"),
                     keep_eo, p)
        y = lin(F.elu(lin(_layer_norm(e, w, pre + "pair_ffn_norm"),
                          pre + "pair_fc1")), pre + "pair_fc2")
        e = e + drop(y, keep_ef, p)
    h = _layer_norm(h, w, "final_norm")[:, :v].reshape(b, v * dim)
    h = F.elu(lin(F.elu(lin(h, "head_fc1")), "head_fc2"))
    return lin(h, "head_out").reshape(-1)


def train_step(w: Dict[str, torch.Tensor], inputs: Dict, target,
               sample_mask, heads: int, masks: Optional[Dict] = None,
               p_attn: float = 0.3, p: float = 0.0,
               q: Optional[Round] = None):
    """``(loss, grads)`` of one training step: the masked MSE of
    :func:`forward` and each leaf's gradient."""
    leaves = {k: t.detach().clone().requires_grad_(True)
              for k, t in w.items()}
    pred = forward(leaves, inputs, heads, masks, p_attn, p, q)
    loss = masked_mse(pred, target, sample_mask)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
