"""Checkpoint interchange with the reference's pickled ``best_model.pth``
(the port's copy of ``mgat_graphsage_tpu/compat.py``).

The reference saves a composite torch dict — three ``state_dict``s, the
optimizer state, both MSEs, and a pickled sklearn ``StandardScaler``
(``train.py:287-296``) — and every reference consumer (``test.py:160-164``,
``gnnexplainer.py:1352-1366``) reloads it with torch.  This module converts
such a checkpoint losslessly to the port's checkpoint (``torch.save`` of
the port's ``state_dict`` plus the JSON sidecar, ``train/checkpoint.py``),
so ``eval.predict``, the explain pipeline and serving take it unchanged:

    python -m mgat_graphsage_torch.compat import best_model.pth \\
        checkpoints/imported/best_model.pt --preset flagship

The reverse direction exports a hybrid checkpoint of the port as a
reference-format composite ``.pth`` that ``test.py``/``gnnexplainer.py``
consume unmodified (widths are inferred from the parameter shapes, so
every fingerprint-suite variant exports):

    python -m mgat_graphsage_torch.compat export \\
        checkpoints/flagship/best_model.pt best_model.pth

Both take ``--device`` (default: CUDA).  Import builds the preset's model
there and loads the converted weights into it, which checks every name
and shape; export loads the checkpoint there.

Weight layouts: the reference's ``state_dict``s are translated to the
flax-shaped tree of ``models/convert.py`` (the reference package's
translation, kept as it is) and from there to the port's ``state_dict``
(``params_from_jax``); export goes the other way through
``params_to_jax`` and the reference twins of ``compare/torch_ref.py``.

* ``nn.Linear``  weight ``[out, in]``  -> kernel ``[in, out]`` (transpose)
* ModifiedGAT center-tap convs ``conv3/conv5 -> {weight [out,in,k],
  bias}`` — direct copy
* ``nn.Conv1d`` (CNN branch) ``[out, in, k]`` -> kernel ``[k, in, out]``
* the CNN fc1 rows: torch's flatten is channel-major (``c*W + w``), the
  port's pos-major (``w*128 + c``, ``models/layers.py::CNNNet``)
* PyG ``SAGEConv`` ``lin_l`` (aggregated neighbors, bias) / ``lin_r``
  (root, no bias); the pre-2.0 PyG names ``lin_rel``/``lin_root`` are
  accepted as aliases.

The optimizer state is not imported (the reference itself never resumes):
the result is a light checkpoint.  Export writes a real sklearn scaler,
since the reference's consumers unpickle one; it needs ``scikit-learn``
(:func:`reference_state_dicts`, the tensors it writes, does not).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from .models.convert import params_from_jax, params_to_jax
from .models.layers import cnn_fc1_torch_to_pos_major

__all__ = ["import_reference_checkpoint", "export_reference_checkpoint",
           "reference_state_dicts", "reference_state_dicts_to_params",
           "import_baseline_checkpoint", "baseline_state_dict_to_params",
           "fingerprint_layout_warning", "main"]

# the reference's dynamic-shape torch graphs have no padding budget; these
# defaults cover its published molecule range (11-94 atoms, README.md:127)
DEFAULT_MAX_NODES = 96
DEFAULT_MAX_EDGES = 224


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy(), dtype=np.float32)


def _lin(sd: Dict, name: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if bias:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _sage_key(sd: Dict, prefix: str, modern: str, legacy: str) -> str:
    """Resolve PyG SAGEConv param naming across PyG versions."""
    if f"{prefix}.{modern}.weight" in sd:
        return f"{prefix}.{modern}"
    if f"{prefix}.{legacy}.weight" in sd:
        return f"{prefix}.{legacy}"
    raise KeyError(
        f"checkpoint has neither {prefix}.{modern}.weight nor "
        f"{prefix}.{legacy}.weight — not a GAT_GraphSAGE state dict? "
        f"keys: {sorted(sd)[:8]}...")


def reference_state_dicts_to_params(gat_sd: Dict, cnn_sd: Dict,
                                    comb_sd: Dict) -> Dict:
    """Three reference ``state_dict``s -> the hybrid's flax-shaped tree of
    numpy arrays (``models/convert.py``; ``params_from_jax`` of it is the
    port's ``state_dict``)."""
    conv1 = {}
    for name in ("query_transform", "key_transform", "value_transform",
                 "linear_transform"):
        conv1[name] = _lin(gat_sd, f"conv1.{name}")
    for cname in ("conv3", "conv5"):
        conv1[cname] = {"weight": _np(gat_sd[f"conv1.{cname}.weight"]),
                        "bias": _np(gat_sd[f"conv1.{cname}.bias"])}
    lin_l = _sage_key(gat_sd, "conv2", "lin_l", "lin_rel")
    lin_r = _sage_key(gat_sd, "conv2", "lin_r", "lin_root")
    gat = {
        "conv1": conv1,
        "conv2": {
            "lin_l": {"kernel": _np(gat_sd[f"{lin_l}.weight"]).T,
                      "bias": _np(gat_sd[f"{lin_l}.bias"])},
            "lin_r": {"kernel": _np(gat_sd[f"{lin_r}.weight"]).T},
        },
        "fc_g1": _lin(gat_sd, "fc_g1"),
        "fc_g2": _lin(gat_sd, "fc_g2"),
        "out": _lin(gat_sd, "out"),
    }
    cnn = {}
    for i in (1, 2, 3):
        w = _np(cnn_sd[f"conv{i}.weight"])  # [out, in, k]
        cnn[f"conv{i}"] = {"kernel": np.transpose(w, (2, 1, 0)),
                           "bias": _np(cnn_sd[f"conv{i}.bias"])}
    cnn["fc1"] = _lin(cnn_sd, "fc1")
    # torch's fc1 rows are channel-major (flatten order c*W + w);
    # CNNNet stores them pos-major (w*128 + c) — see models/layers.py.
    cnn["fc1"]["kernel"] = cnn_fc1_torch_to_pos_major(cnn["fc1"]["kernel"])
    cnn["fc2"] = _lin(cnn_sd, "fc2")
    combined = {"fc1": _lin(comb_sd, "fc1"), "fc2": _lin(comb_sd, "fc2")}
    return {"gat_graphsage": gat, "cnn": cnn, "combined": combined}


def _first_key(sd: Dict, prefix: str, *cands: str) -> str:
    """Resolve a PyG param name across PyG versions (first present)."""
    for c in cands:
        if f"{prefix}.{c}" in sd:
            return f"{prefix}.{c}"
    raise KeyError(f"none of {[f'{prefix}.{c}' for c in cands]} in "
                   f"checkpoint — keys: {sorted(sd)[:8]}...")


def _pyg_gat(sd: Dict, prefix: str) -> Dict:
    """PyG ``GATConv`` state-dict slice -> GATConv params.

    Accepts the linear under ``lin`` (PyG >=2.3) / ``lin_src`` (2.0-2.2)
    / ``lin_l`` (pre-2.0) and the attention vectors under
    ``att_src``/``att_dst`` (modern) or ``att_l``/``att_r`` (legacy);
    layouts are identical, only the names moved.
    """
    lin = _first_key(sd, prefix, "lin.weight", "lin_src.weight",
                     "lin_l.weight")[: -len(".weight")]
    att_s = _first_key(sd, prefix, "att_src", "att_l")
    att_d = _first_key(sd, prefix, "att_dst", "att_r")
    return {"lin": {"kernel": _np(sd[f"{lin}.weight"]).T},
            "att_src": _np(sd[att_s]),
            "att_dst": _np(sd[att_d]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _pyg_gcn(sd: Dict, prefix: str) -> Dict:
    """PyG ``GCNConv`` slice -> params.  Modern PyG stores the linear
    under ``lin.weight`` ([out, in]); pre-2.0 stored a bare ``weight`` in
    [in, out] layout (applied as x @ weight)."""
    if f"{prefix}.lin.weight" in sd:
        kernel = _np(sd[f"{prefix}.lin.weight"]).T
    else:
        kernel = _np(sd[f"{prefix}.weight"])
    return {"lin": {"kernel": kernel}, "bias": _np(sd[f"{prefix}.bias"])}


def _pyg_sage(sd: Dict, prefix: str) -> Dict:
    lin_l = _sage_key(sd, prefix, "lin_l", "lin_rel")
    lin_r = _sage_key(sd, prefix, "lin_r", "lin_root")
    return {"lin_l": {"kernel": _np(sd[f"{lin_l}.weight"]).T,
                      "bias": _np(sd[f"{lin_l}.bias"])},
            "lin_r": {"kernel": _np(sd[f"{lin_r}.weight"]).T}}


def baseline_state_dict_to_params(model_key: str, sd: Dict,
                                  attention: str = "modified"
                                  ) -> Tuple[Dict, Dict]:
    """A reference bare ``state_dict`` -> (params, batch_stats), the
    flax-shaped trees of ``models/convert.py``.

    Covers the six baseline GNNs (``gnn/gat.py:135`` saves
    ``model.state_dict()``; ``gnn/predict-*.py`` reload it) and the
    graph-only ablation models 1-3 (``ablation/model1.py:146``).
    ``model_key`` is ``TrainConfig.model``; for ``gat_graphsage`` the
    ``attention`` flavor picks plain PyG GATConv (model 1) vs the
    ModifiedGATLayer (models 2/3).
    """
    bs: Dict = {}
    if model_key == "sage":           # gnn/graphsage.py:50-75
        params = {"sage1": _pyg_sage(sd, "sage1"),
                  "sage2": _pyg_sage(sd, "sage2"),
                  "fc_g1": _lin(sd, "fc_g1"), "fc_g2": _lin(sd, "fc_g2"),
                  "out": _lin(sd, "out")}
    elif model_key == "gat":          # gnn/gat.py:51-71
        params = {"gcn1": _pyg_gat(sd, "gcn1"),
                  "gcn2": _pyg_gat(sd, "gcn2"),
                  "fc_g1": _lin(sd, "fc_g1"), "out": _lin(sd, "out")}
    elif model_key == "gcn":          # gnn/gcn.py:42-66
        params = {"conv1": _pyg_gcn(sd, "conv1"),
                  "conv2": _pyg_gcn(sd, "conv2"),
                  "conv3": _pyg_gcn(sd, "conv3"),
                  "fc_g1": _lin(sd, "fc_g1"), "fc_g2": _lin(sd, "fc_g2")}
    elif model_key == "gat_gcn":      # gnn/gat-gcn.py:53-76
        params = {"conv1": _pyg_gat(sd, "conv1"),
                  "conv2": _pyg_gcn(sd, "conv2"),
                  "fc_g1": _lin(sd, "fc_g1"), "fc_g2": _lin(sd, "fc_g2"),
                  "out": _lin(sd, "out")}
    elif model_key == "gin":          # gnn/gin.py:56-106
        params = {}
        for i in range(1, 6):
            # reference attribute names (conv1.nn.0 / bn1); the torch
            # oracle's ModuleList layout (convs.0.mlp.0 / bns.0) is
            # accepted as an alias
            conv = (f"conv{i}.nn" if f"conv{i}.nn.0.weight" in sd
                    else f"convs.{i - 1}.mlp")
            bn = f"bn{i}" if f"bn{i}.weight" in sd else f"bns.{i - 1}"
            params[f"conv{i}"] = {"mlp_0": _lin(sd, f"{conv}.0"),
                                  "mlp_1": _lin(sd, f"{conv}.2")}
            params[f"bn{i}"] = {"scale": _np(sd[f"{bn}.weight"]),
                                "bias": _np(sd[f"{bn}.bias"])}
            bs[f"bn{i}"] = {"mean": _np(sd[f"{bn}.running_mean"]),
                            "var": _np(sd[f"{bn}.running_var"])}
        for name in ("fc1_xd", "fc1", "fc2", "out"):
            params[name] = _lin(sd, name)
    elif model_key == "cheb":         # gnn/chebnet.py:50-96
        params = {"conv1": {"lin": _lin(sd, "conv1.lin")},
                  "conv2": {"lin": _lin(sd, "conv2.lin")},
                  "fc_g1": _lin(sd, "fc_g1"), "out": _lin(sd, "out")}
    elif model_key == "gat_graphsage":
        if attention == "gat10":      # ablation/model1.py:53-77
            conv1 = _pyg_gat(sd, "conv1")
        else:                         # ablation/model 2.py / model 3.py
            conv1 = {}
            for name in ("query_transform", "key_transform",
                         "value_transform", "linear_transform"):
                conv1[name] = _lin(sd, f"conv1.{name}")
            for cname in ("conv3", "conv5"):
                conv1[cname] = {
                    "weight": _np(sd[f"conv1.{cname}.weight"]),
                    "bias": _np(sd[f"conv1.{cname}.bias"])}
        params = {"conv1": conv1, "conv2": _pyg_sage(sd, "conv2"),
                  "fc_g1": _lin(sd, "fc_g1"), "fc_g2": _lin(sd, "fc_g2"),
                  "out": _lin(sd, "out")}
    else:
        raise ValueError(f"no baseline state-dict translation for "
                         f"model '{model_key}'")
    return params, bs


def _torch_load(path: str):
    """A reference checkpoint: a pickle (its scaler is an sklearn
    object), so not ``weights_only``."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _load_into_preset(cfg, state_dict: Dict, device) -> None:
    """Build ``cfg``'s model on ``device`` and load ``state_dict`` into it,
    strictly: a name or shape it does not hold means the wrong preset for
    this checkpoint (e.g. a morgan2048 run imported as flagship)."""
    from .device import resolve_device
    from .models import build_model

    model = build_model(cfg).to(resolve_device(device))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    if set(want) != set(got):
        raise ValueError(
            f"parameter names differ from preset '{cfg.name}': it expects "
            f"{sorted(set(want) - set(got))[:6]}, the checkpoint provides "
            f"{sorted(set(got) - set(want))[:6]}")
    for k in want:
        if want[k] != got[k]:
            raise ValueError(
                f"shape mismatch at '{k}': preset '{cfg.name}' expects "
                f"{want[k]}, checkpoint has {got[k]} — wrong --preset for "
                f"this checkpoint?")
    model.load_state_dict(state_dict, strict=True)


def import_baseline_checkpoint(
    pth_path: str,
    out_path: str,
    preset: str,
    max_nodes: int = DEFAULT_MAX_NODES,
    max_edges: int = DEFAULT_MAX_EDGES,
    device=None,
) -> Tuple[str, Dict]:
    """Convert a reference bare ``state_dict`` checkpoint (baseline GNNs
    ``gnn/*.py``, ablation models 1-3) to a light checkpoint of the port.

    The reference consumers rebuild the matching class and
    ``load_state_dict`` (``gnn/predict-gcn.py:79-120``); here the preset
    names the architecture.  Baselines train on raw targets
    (``scale_targets=False``), so the sidecar carries the identity
    scaler.
    """
    from .train.checkpoint import save_checkpoint
    from .train.config import get_config

    sd = _torch_load(pth_path)
    if not hasattr(sd, "items") or any(
            not hasattr(v, "detach") for v in sd.values()):
        raise ValueError(
            f"{pth_path} is not a bare state_dict (tensor-valued dict); "
            f"composite hybrid checkpoints import via "
            f"import_reference_checkpoint")
    cfg = get_config(preset)
    if cfg.is_hybrid:
        raise ValueError(
            f"preset '{preset}' is the hybrid — its composite checkpoint "
            f"imports via import_reference_checkpoint / the 'import' "
            f"subcommand")
    params, batch_stats = baseline_state_dict_to_params(
        cfg.model, sd, attention=cfg.attention)
    state_dict = params_from_jax(params, batch_stats)
    _load_into_preset(cfg, state_dict, device)
    meta = {
        "config": dataclasses.asdict(cfg),
        # baselines train on raw targets (gnn/*.py have no scaler)
        "scaler": {"mean": 0.0, "scale": 1.0},
        "max_nodes": int(max_nodes),
        "max_edges": int(max_edges),
        "imported_from": pth_path,
    }
    save_checkpoint(out_path, state_dict, meta)
    return out_path, meta


def fingerprint_layout_warning(preset: str, fingerprint: str) -> str:
    """Per-fingerprint interchange caveat text.

    Four classes of fingerprint, four messages:

    - **Morgan family** (``ecfp*``/``fcfp*``/``morgan*``): an escape
      hatch exists — ``fingerprint_layout='rdkit'`` feeds the imported
      model RDKit-layout bits.
    - **maccs**: no escape hatch — this repo uses its own key assignment
      (the true MACCS key SMARTS are proprietary; PARITY.md).
    - **bci**: no escape hatch — this repo reimplements the BCI fragment
      dictionary (PARITY.md).
    - **smifp**: no escape hatch *can* exist — the reference hashes
      substrings with Python's salted ``hash()``
      (``fingerprint/SMIFP.py:60-88``), so even the reference cannot
      reproduce its own checkpoints across processes; there is no
      stable layout to reproduce (docs/MIGRATION.md).
    """
    from .chem.fingerprints import FINGERPRINT_DIMS

    common = (
        f"importing a fingerprint-consuming preset "
        f"('{preset}', fingerprint={fingerprint}): if this "
        f".pth was trained with RDKit (as the reference's was, "
        f"train.py:58-63), its CNN branch learned RDKit's bit "
        f"POSITIONS, and this repo's default layout assigns the "
        f"same substructures to different positions — the imported "
        f"model would silently see permuted fingerprint inputs "
        f"and degrade. ")
    if f"{fingerprint}_rdkit" in FINGERPRINT_DIMS:
        detail = (
            "Escape hatch: pass fingerprint_layout='rdkit' (CLI: "
            "--fingerprint-layout rdkit) to feed it RDKit-layout "
            "Morgan bits (best-effort reimplementation; see "
            "chem/fingerprints.py and docs/MIGRATION.md).")
    elif fingerprint == "smifp":
        detail = (
            "No escape hatch exists for smifp — and none can: the "
            "reference hashes SMILES substrings with Python's "
            "SALTED hash() (fingerprint/SMIFP.py:60-88), so its "
            "own checkpoints are not reproducible across processes "
            "either; there is no stable layout to reproduce. See "
            "docs/MIGRATION.md.")
    elif fingerprint == "bci":
        detail = (
            "No RDKit-layout escape hatch exists for bci (this repo "
            "reimplements the BCI fragment dictionary and its bit "
            "order; see PARITY.md and docs/MIGRATION.md); validate "
            "imported-model predictions before use.")
    else:  # maccs: own key assignment, documented
        detail = (
            f"No RDKit-layout escape hatch exists for "
            f"{fingerprint} (this repo uses its own key "
            f"assignment — the true MACCS key SMARTS are "
            f"proprietary; see PARITY.md and docs/MIGRATION.md); "
            f"validate imported-model predictions before use.")
    return (common + detail + " Checkpoints trained by THIS "
            "framework's exporter are unaffected.")


def import_reference_checkpoint(
    pth_path: str,
    out_path: str,
    preset: str = "flagship",
    max_nodes: int = DEFAULT_MAX_NODES,
    max_edges: int = DEFAULT_MAX_EDGES,
    fingerprint_layout: str = "crc32",
    device=None,
) -> Tuple[str, Dict]:
    """Convert a reference ``best_model.pth`` to a light checkpoint of the
    port.

    Returns ``(out_path, sidecar_meta)``.  The output loads through
    ``eval.predict.load_model_from_checkpoint`` and the explain pipeline
    exactly like a checkpoint the port trained.

    ``fingerprint_layout``: bit-position scheme the imported model's CNN
    branch will be fed.  A checkpoint *actually trained with RDKit*
    (reference ``train.py:58-63``) learned weights over RDKit's Morgan
    bit positions; this repo's default layout hashes the same
    environments to DIFFERENT positions (CRC32 — documented divergence,
    ``chem/fingerprints.py``), so the default import emits a
    ``UserWarning``: predictions will be silently degraded for truly
    RDKit-trained weights (the bit densities match, the positions do
    not — a permuted input).  Pass ``"rdkit"`` to pin the imported
    config to the ``*_rdkit`` fingerprint variant.
    """
    from .chem.fingerprints import FINGERPRINT_DIMS
    from .train.checkpoint import save_checkpoint
    from .train.config import get_config

    ckpt = _torch_load(pth_path)
    for key in ("gat_graphsage_model_state_dict", "cnn_model_state_dict",
                "combined_model_state_dict", "scaler"):
        if key not in ckpt:
            raise KeyError(
                f"'{key}' missing from {pth_path} — not a reference "
                f"composite checkpoint (train.py:287-296)? "
                f"keys: {sorted(ckpt)}")
    params = reference_state_dicts_to_params(
        ckpt["gat_graphsage_model_state_dict"],
        ckpt["cnn_model_state_dict"],
        ckpt["combined_model_state_dict"])

    # the pickled sklearn scaler was fit on y.reshape(-1, 1): mean_/scale_
    # are shape-(1,) arrays
    sk_scaler = ckpt["scaler"]
    scaler_mean = float(np.asarray(sk_scaler.mean_).reshape(-1)[0])
    scaler_scale = float(np.asarray(sk_scaler.scale_).reshape(-1)[0])

    cfg = get_config(preset)
    if not cfg.is_hybrid:
        raise ValueError(
            f"preset '{preset}' is not a hybrid model; reference composite "
            f"checkpoints hold the 3-model hybrid")
    if fingerprint_layout not in ("crc32", "rdkit"):
        raise ValueError(
            f"fingerprint_layout must be 'crc32' or 'rdkit', "
            f"got {fingerprint_layout!r}")
    if fingerprint_layout == "rdkit":
        rd_name = f"{cfg.fingerprint}_rdkit"
        if rd_name not in FINGERPRINT_DIMS:
            raise ValueError(
                f"no RDKit-layout variant exists for "
                f"'{cfg.fingerprint}' (available for the Morgan family "
                f"only); import with the default layout instead")
        cfg = cfg.replace(fingerprint=rd_name)
    elif cfg.fingerprint is not None:
        warnings.warn(
            fingerprint_layout_warning(preset, cfg.fingerprint),
            UserWarning, stacklevel=2)
    state_dict = params_from_jax(params)
    _load_into_preset(cfg, state_dict, device)
    meta = {
        "config": dataclasses.asdict(cfg),
        "scaler": {"mean": scaler_mean, "scale": scaler_scale},
        "max_nodes": int(max_nodes),
        "max_edges": int(max_edges),
        "imported_from": pth_path,
        "reference_normalized_mse": _maybe_float(ckpt.get("normalized_mse")),
        "reference_original_mse": _maybe_float(ckpt.get("original_mse")),
    }
    save_checkpoint(out_path, state_dict, meta)
    return out_path, meta


def reference_state_dicts(ckpt_path: str, device=None
                          ) -> Tuple[Dict[str, Dict], object]:
    """The reference composite's three ``state_dict``s of a hybrid
    checkpoint of the port, keyed as ``train.py:287-296`` keys them, and
    the checkpoint's scaler: the tensors :func:`export_reference_checkpoint`
    writes.  They come from ``compare.torch_ref``'s reference twins, so
    their names and layouts are the reference's; widths (fingerprint size,
    CNN fc1 hidden, 35/5 features) are inferred from the parameter
    shapes."""
    from .compare.torch_ref import TorchHybrid, load_params_into_torch
    from .eval.predict import load_model_from_checkpoint

    model, cfg, scaler, _ = load_model_from_checkpoint(ckpt_path, device)
    params = params_to_jax(model)
    if not {"gat_graphsage", "cnn", "combined"} <= set(params):
        raise ValueError(
            f"only hybrid checkpoints export to the reference composite "
            f"format; '{cfg.name}' holds {sorted(params)} "
            f"(baseline GNNs have no reference composite equivalent)")
    feat = params["gat_graphsage"]["conv1"]["query_transform"][
        "kernel"].shape[0]
    fp_in = params["cnn"]["fc1"]["kernel"].shape[0] // 128
    fc_hidden = params["cnn"]["fc1"]["kernel"].shape[1]
    fp_out = params["cnn"]["fc2"]["kernel"].shape[1]
    tmodel = TorchHybrid(features=feat, fp_dim=fp_in,
                         cnn_fc_hidden=fc_hidden, cnn_out=fp_out)
    load_params_into_torch(params, tmodel)
    return {"gat_graphsage_model_state_dict": tmodel.graph.state_dict(),
            "cnn_model_state_dict": tmodel.cnn.state_dict(),
            "combined_model_state_dict": tmodel.combined.state_dict()}, \
        scaler


def export_reference_checkpoint(ckpt_path: str, out_pth: str,
                                device=None) -> Tuple[str, Dict]:
    """Export a hybrid checkpoint of the port as the reference's
    ``best_model.pth``.

    Writes the exact composite dict the reference trainer saves
    (``train.py:287-296``): the three ``state_dict``s of
    :func:`reference_state_dicts`, an empty optimizer state (the port's
    Adam moments are not the reference's optimizer object),
    ``normalized_mse``/``original_mse`` from the sidecar, and a real
    pickled sklearn ``StandardScaler`` — so the reference's own
    ``test.py`` and ``gnnexplainer.py`` load it unmodified.
    """
    from sklearn.preprocessing import StandardScaler as SkScaler

    state_dicts, scaler = reference_state_dicts(ckpt_path, device)
    # a REAL sklearn scaler, because reference consumers unpickle one
    # (test.py:164 calls scaler.inverse_transform)
    sk = SkScaler()
    sk.mean_ = np.array([float(scaler.mean_)], dtype=np.float64)
    sk.scale_ = np.array([float(scaler.scale_)], dtype=np.float64)
    sk.var_ = sk.scale_ ** 2
    sk.n_features_in_ = 1
    sk.n_samples_seen_ = 1

    sidecar = {}
    if os.path.exists(ckpt_path + ".json"):
        with open(ckpt_path + ".json") as f:
            sidecar = json.load(f)
    composite = {
        **state_dicts,
        "optimizer_state_dict": {},
        "normalized_mse": sidecar.get("val_mse"),
        "original_mse": sidecar.get("original_mse"),
        "scaler": sk,
    }
    os.makedirs(os.path.dirname(out_pth) or ".", exist_ok=True)
    torch.save(composite, out_pth)
    return out_pth, composite


def _maybe_float(v):
    try:
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Checkpoint interchange with the reference's "
                    "best_model.pth format")
    sub = p.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser(
        "import", help="reference .pth -> checkpoint of the port (.pt + "
                       "JSON sidecar)")
    imp.add_argument("pth", help="reference composite checkpoint (.pth)")
    imp.add_argument("out", help="output path (.pt)")
    imp.add_argument("--preset", default="flagship",
                     help="hybrid preset matching the checkpoint's "
                          "fingerprint/widths (default: flagship)")
    imp.add_argument("--max-nodes", type=int, default=DEFAULT_MAX_NODES)
    imp.add_argument("--max-edges", type=int, default=DEFAULT_MAX_EDGES)
    imp.add_argument("--fingerprint-layout", default="crc32",
                     choices=("crc32", "rdkit"),
                     help="bit-position scheme to feed the imported CNN "
                          "branch: 'rdkit' for checkpoints genuinely "
                          "trained with RDKit fingerprints (the default "
                          "warns about the layout mismatch; see "
                          "docs/MIGRATION.md)")
    impb = sub.add_parser(
        "import-baseline",
        help="reference bare state_dict (baseline GNNs / ablation "
             "models 1-3) -> checkpoint of the port")
    impb.add_argument("pth", help="bare state_dict checkpoint (.pth)")
    impb.add_argument("out", help="output path (.pt)")
    impb.add_argument("--preset", required=True,
                      help="matching non-hybrid preset (gcn, graphsage, "
                           "gat, gat_gcn, gin, chebnet, model1-3)")
    impb.add_argument("--max-nodes", type=int, default=DEFAULT_MAX_NODES)
    impb.add_argument("--max-edges", type=int, default=DEFAULT_MAX_EDGES)
    exp = sub.add_parser(
        "export", help="hybrid checkpoint of the port -> reference .pth")
    exp.add_argument("ckpt", help="checkpoint of the port (.pt)")
    exp.add_argument("out", help="output path (.pth)")
    for sp in (imp, impb, exp):
        sp.add_argument("--device", default=None,
                        help="torch device to load the model on (default: "
                             "CUDA; 'cpu' to run without a card)")
    args = p.parse_args(argv)
    if args.cmd == "import":
        out, meta = import_reference_checkpoint(
            args.pth, args.out, preset=args.preset,
            max_nodes=args.max_nodes, max_edges=args.max_edges,
            fingerprint_layout=args.fingerprint_layout, device=args.device)
        print(f"imported {args.pth} -> {out} (preset {args.preset}, "
              f"scaler mean={meta['scaler']['mean']:.4f} "
              f"scale={meta['scaler']['scale']:.4f})")
    elif args.cmd == "import-baseline":
        out, meta = import_baseline_checkpoint(
            args.pth, args.out, preset=args.preset,
            max_nodes=args.max_nodes, max_edges=args.max_edges,
            device=args.device)
        print(f"imported baseline {args.pth} -> {out} "
              f"(preset {args.preset}, model "
              f"{meta['config']['model']})")
    else:
        out, composite = export_reference_checkpoint(args.ckpt, args.out,
                                                     device=args.device)
        print(f"exported {args.ckpt} -> {out} (reference composite dict: "
              f"{len(composite['gat_graphsage_model_state_dict'])} graph + "
              f"{len(composite['cnn_model_state_dict'])} cnn + "
              f"{len(composite['combined_model_state_dict'])} combined "
              f"tensors)")


if __name__ == "__main__":
    main()
