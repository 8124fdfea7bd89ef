"""Plain-PyTorch reference of the graph transformer (``models/zoo.py::
GraphormerNet``, preset ``graphormer_base``): its featurisation beside
the atom features, its forward pass, the MSE loss, one Adam step, and
the dropout masks replayed from the trainer's dropout generator.

Written from Ying et al., "Do Transformers Really Perform Bad for Graph
Representation?" (NeurIPS 2021, arXiv:2106.05234) and the public code
(github.com/microsoft/Graphormer, ``graphormer_base``), not from the
port: it imports no kernel or layer of the port, only the SMILES parser
and the 35-dim atom features.  It runs in f32, with TF32 off in cuBLAS
and cuDNN (:func:`ieee_flags`), and takes its weights as a dict named as
the port's ``state_dict`` names them.

- Structure (:func:`structure`): its own breadth-first search over each
  molecule's bonds, neighbours in ascending atom order (the order of the
  port's sorted edge list), the first discoverer as the predecessor; the
  path to each atom is walked back through the predecessors.  Bond types:
  1 single, 2 double, 3 triple, 4 aromatic.
- Forward (:func:`forward`): ``h0 = x W_atom + Z_in[deg] + Z_out[deg]``
  with the graph token first; per layer ``h' = MHA(LN(h)) + h``, ``h =
  FFN(LN(h')) + h'``; the logits ``q k^T / sqrt(d) + b[phi] + c``, with
  ``c`` the mean over the first ``min(phi, 5)`` bonds of the path of
  ``edge_type[t] @ edge_hop[m]``, formed per pair as the paper writes it;
  padded keys at -inf; the readout of the graph token through
  ``Linear -> GELU -> LayerNorm -> Linear``.
- Training (:func:`train_step`): masked MSE over the batch, the gradient
  of every leaf, and one step of torch's Adam with the L2 term coupled
  into the gradient.

Departures from the publication, shared with the port (PERF.md, the
benchmark's configuration file): the atom encoder reads the port's 35
one-hot features through a bias-free linear map (OGB's 9 categorical
features are not reproduced); bond types are the parser's four (OGB's
three bond features are not used); the loss is MSE on standardised
targets; no gradient clipping; the public collator's cut of pairs
further apart than 20 bonds is not applied; the distance table takes
distances up to 510, and the last row stands for unreachable pairs.
"""

from __future__ import annotations

import contextlib
import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..chem.featurize import atom_features_35
from ..chem.smiles import parse_smiles

__all__ = ["HOPS", "structure", "parse_kept", "arrays", "featurize",
           "draw_masks", "forward", "masked_mse", "Adam", "adam_step",
           "train_step", "ieee_flags"]

HOPS = 5


@contextlib.contextmanager
def ieee_flags():
    """TF32 off in cuBLAS and cuDNN, bf16 split-K reduction off;
    restored after."""
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (mm.allow_tf32, cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = prev


def _bond_type(bond) -> int:
    if bond.aromatic or bond.order == 1.5:
        return 4
    return int(bond.order)


def structure(mol, hops: int = HOPS):
    """``(degree [n], spd [n, n], path_types [n, n, hops])`` of a parsed
    molecule, int64: -1 in ``spd`` for atoms in different components."""
    n = mol.GetNumAtoms()
    types: Dict = {}
    for b in mol.GetBonds():
        types.setdefault((b.a1, b.a2), _bond_type(b))
        types.setdefault((b.a2, b.a1), _bond_type(b))
    nbrs = [sorted({j for (i, j) in types if i == a}) for a in range(n)]
    degree = np.array([len(x) for x in nbrs], np.int64)
    spd = np.full((n, n), -1, np.int64)
    path = np.zeros((n, n, hops), np.int64)
    for s in range(n):
        pred = [-1] * n
        spd[s, s] = 0
        todo = deque([s])
        while todo:
            u = todo.popleft()
            for v in nbrs[u]:
                if spd[s, v] < 0:
                    spd[s, v] = spd[s, u] + 1
                    pred[v] = u
                    todo.append(v)
        for t in range(n):
            if spd[s, t] <= 0:
                continue
            walk = [t]
            while walk[-1] != s:
                walk.append(pred[walk[-1]])
            walk.reverse()
            for m in range(min(int(spd[s, t]), hops)):
                path[s, t, m] = types[(walk[m], walk[m + 1])]
    return degree, spd, path


def parse_kept(smiles: Sequence[str], max_nodes: int,
               max_edges: Optional[int] = None):
    """``(kept, mols)``: the indices and parsed molecules of the SMILES that
    parse and fit ``max_nodes`` atoms (and ``max_edges`` directed edges
    when given)."""
    kept, mols = [], []
    for i, smi in enumerate(smiles):
        try:
            mol = parse_smiles(smi)
        except ValueError:
            continue
        if mol.GetNumAtoms() <= max_nodes and (
                max_edges is None or 2 * len({frozenset((b.a1, b.a2))
                                              for b in mol.GetBonds()})
                <= max_edges):
            kept.append(i)
            mols.append(mol)
    return kept, mols


def arrays(mols: Sequence, max_nodes: int, hops: int = HOPS):
    """``(nodes [k, N, 35], node_mask [k, N], degree [k, N], spd [k, N, N],
    path_types [k, N, N, hops])`` of parsed molecules, padded to ``N =
    max_nodes`` (-1 in ``spd`` for padding)."""
    k, n = len(mols), max_nodes
    nodes = np.zeros((k, n, 35), np.float32)
    node_mask = np.zeros((k, n), np.float32)
    degree = np.zeros((k, n), np.int64)
    spd = np.full((k, n, n), -1, np.int64)
    path = np.zeros((k, n, n, hops), np.int64)
    for r, mol in enumerate(mols):
        a = mol.GetNumAtoms()
        deg, d, p = structure(mol, hops)
        nodes[r, :a], node_mask[r, :a] = atom_features_35(mol), 1.0
        degree[r, :a], spd[r, :a, :a], path[r, :a, :a] = deg, d, p
    return nodes, node_mask, degree, spd, path


def featurize(smiles: Sequence[str], max_nodes: int,
              max_edges: Optional[int] = None, hops: int = HOPS):
    """``(kept,) + arrays(...)`` of the SMILES that :func:`parse_kept`
    keeps."""
    kept, mols = parse_kept(smiles, max_nodes, max_edges)
    return (kept,) + arrays(mols, max_nodes, hops)


def draw_masks(generator: Optional[torch.Generator], b: int, n: int,
               heads: int, ffn: int, layers: int, p_attn: float,
               p_ffn: float, device) -> List:
    """The training step's dropout keep-masks, in the order the port draws
    them from its generator: per layer the attention's ``[b, heads, n + 1,
    n + 1]``, then the FFN's ``[b, n + 1, ffn]``, each ``bernoulli_(1 -
    p)`` on an f32 tensor (None where ``p`` is 0)."""
    def draw(shape, p):
        if p == 0.0:
            return None
        return torch.empty(shape, dtype=torch.float32, device=device) \
            .bernoulli_(1.0 - p, generator=generator) > 0

    out = []
    for _ in range(layers):
        out.append((draw((b, heads, n + 1, n + 1), p_attn),
                    draw((b, n + 1, ffn), p_ffn)))
    return out


Round = Callable[[torch.Tensor], torch.Tensor]


def _layer_norm(x, w, name):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-5)


def forward(w: Dict[str, torch.Tensor], nodes, node_mask, degree, spd,
            path_types, heads: int, masks: Optional[List] = None,
            p_attn: float = 0.1, p_ffn: float = 0.1,
            q: Optional[Round] = None) -> torch.Tensor:
    """Predictions ``[B]`` in f32.  ``masks`` (:func:`draw_masks`, the
    batch's rows) applies the dropouts; None is evaluation.  ``q`` rounds
    each operand of each product (a control computed one precision below);
    None leaves them f32."""
    q = q or (lambda t: t)
    b, n, _ = nodes.shape
    layers = len({k.split(".")[1] for k in w if k.startswith("layers.")})
    dim = w["atom_encoder.weight"].shape[0]
    dh = dim // heads

    def lin(x, name, bias=True):
        return F.linear(q(x), q(w[name + ".weight"]),
                        w[name + ".bias"] if bias else None)

    deg = degree.long().clamp_max(w["in_degree.weight"].shape[0] - 1)
    x = lin(nodes, "atom_encoder", bias=False) + w["in_degree.weight"][deg] \
        + w["out_degree.weight"][deg]
    x = torch.cat([w["graph_token.weight"].expand(b, 1, dim), x], dim=1)
    valid = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                  device=nodes.device), node_mask > 0], 1)

    # the structural bias, per pair as the paper writes it
    spatial = w["bias.spatial.weight"]
    d = spd.long()
    idx = torch.where(d < 0, spatial.shape[0] - 1,
                      d.clamp_max(spatial.shape[0] - 2))
    inner = spatial[idx]                                       # [B,n,n,H]
    emb = torch.cat([torch.zeros(1, heads, device=nodes.device),
                     w["bias.edge_type.weight"]])[path_types.long()]
    hop_w = w["bias.edge_hop.weight"]                          # [5, H, H]
    edge = torch.einsum("bijmh,mhk->bijk", q(emb), q(hop_w))
    inner = inner + edge / d.clamp(1, HOPS).unsqueeze(-1).float()
    t = w["bias.virtual_distance.weight"].reshape(heads)
    bias = torch.empty(b, n + 1, n + 1, heads, device=nodes.device)
    bias[:, 0, :] = t
    bias[:, 1:, 0] = t
    bias[:, 1:, 1:] = inner
    bias = bias.permute(0, 3, 1, 2)
    neg = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]

    for i in range(layers):
        pre = f"layers.{i}."
        y = _layer_norm(x, w, pre + "attn_norm")

        def heads_of(name):
            return lin(y, pre + name).view(b, n + 1, heads, dh) \
                .transpose(1, 2)

        qh, kh, vh = heads_of("q_proj"), heads_of("k_proj"), \
            heads_of("v_proj")
        logits = torch.matmul(q(qh), q(kh).transpose(-1, -2)) \
            / math.sqrt(dh) + bias + neg
        attn = torch.softmax(logits, dim=-1)
        keep_a, keep_f = masks[i] if masks is not None else (None, None)
        if keep_a is not None:
            attn = attn * keep_a / (1.0 - p_attn)
        o = torch.matmul(q(attn), q(vh)).transpose(1, 2).reshape(b, n + 1,
                                                                 dim)
        x = x + lin(o, pre + "out_proj")
        h = F.gelu(lin(_layer_norm(x, w, pre + "ffn_norm"), pre + "fc1"))
        if keep_f is not None:
            h = h * keep_f / (1.0 - p_ffn)
        x = x + lin(h, pre + "fc2")
    h = _layer_norm(F.gelu(lin(x[:, 0], "head_transform")), w, "head_norm")
    return lin(h, "head_out").reshape(-1)


def masked_mse(pred, target, sample_mask):
    err = (pred - target) ** 2
    return (err * sample_mask).sum() / torch.clamp_min(sample_mask.sum(), 1.0)


class Adam:
    """torch's Adam with the L2 term coupled into the gradient, in f32:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -= lr (m /
    c1) / (sqrt(v / c2) + eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 weight_decay: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.params = params
        self.wd, (self.b1, self.b2), self.eps = weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> Dict:
        """Update ``params`` in place; returns the gradients as taken
        (the L2 term included)."""
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        seen = {}
        for k, p in self.params.items():
            g = grads[k].float() + self.wd * p
            seen[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt()
                                            + self.eps))
        return seen


def adam_step(params: Dict[str, torch.Tensor], grads: Dict, lr: float,
              weight_decay: float = 0.0) -> Dict[str, torch.Tensor]:
    """The parameters after Adam's first step from ``params``."""
    new = {k: v.clone() for k, v in params.items()}
    Adam(new, weight_decay).step(grads, lr)
    return new


def train_step(w: Dict[str, torch.Tensor], inputs: Dict, target,
               sample_mask, heads: int, masks: Optional[List] = None,
               p_attn: float = 0.1, p_ffn: float = 0.1,
               q: Optional[Round] = None):
    """``(loss, grads)`` of one training step: the masked MSE of
    :func:`forward` on ``inputs`` (``nodes``, ``node_mask``, ``degree``,
    ``spd``, ``path_types``; padded rows' node masks zeroed by the caller)
    and each leaf's gradient."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in w.items()}
    pred = forward(leaves, inputs["nodes"], inputs["node_mask"],
                   inputs["degree"], inputs["spd"], inputs["path_types"],
                   heads, masks, p_attn, p_ffn, q)
    loss = masked_mse(pred, target, sample_mask)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))
