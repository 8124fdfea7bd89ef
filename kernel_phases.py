#!/usr/bin/env python3
"""Where the time of kernels 1 to 5 goes, on one CUDA card.

    python3 kernel_phases.py [--seed 0] [--only k2] [--parent DIR]

Builds cut-down copies of ``csrc/adjacency.cu`` (kernel 1),
``csrc/attention.cu`` (kernel 2), ``csrc/attention_bwd.cu`` (kernel 3),
``csrc/cnn_dy3.cu`` (kernel 4 and its bf16 kernel 4b) and
``csrc/cnn_chain_bwd.cu`` (kernel 5 and its bf16 kernel 5b),
each with one part of the work removed, times every copy beside the full
kernel with ``chip_smoke.DeviceTimer``, and prints one line per copy (per
shape for kernels 1 and 2) with the card's name and power limit.  Shapes:
kernel 1 on the real edge lists of the first 64 test molecules (the serving
batch) and of the first 128 training molecules (the training batch) at the
(N, E) = (80, 176) budget; kernel 2 at the serving batch B=64 and the
training batch B=128 (N=80, F=35); the others at the training shape (B=128,
N=80, F=35; H=256, K=131072; W=1024), kernels 4b and 5b at the bf16
training shape (B=1024, W=1024, H=256).  A cut copy computes wrong numbers on
purpose; only its time is read.  The copies are written to and built in a
temporary directory, with ``csrc/`` on the include path for the headers
they include; the sources are not touched.

Kernel 1: the full kernel; returning at entry (the launch floor); stopped
after staging the molecule's edges in shared memory; the rows walked but
not stored; the full kernel at 1, 2, 3 and 4 row groups per molecule in
place of the launcher's rule, and at 1, 4 and 8 rows per warp in place of
2; the full kernel that walks only where the one edge of 32 on its rows is
the first (the scan without the walk).  Kernel 2: the full kernel;
returning at entry (the launch floor of back-to-back launches); stopped
after the molecule's load; stopped after the scores; after the scores and
the softmax; load, scores and softmax with attn in each half-warp's scratch
but no product; the full kernel normalising with a division per key (the
backward's way, the same bits) in place of one per row; the full kernel at
1, 2 and 3 row groups per molecule in place of the launcher's rule.  Kernel
3: the full kernel; stopped after the molecule's load; stopped after phase
A (attn and dscores in shared memory); phase A with the softmax replaced by
a scale.  Kernel 4: the full kernel; without the dy3 stores; with neither
stores nor ring refills (the FMAs on whatever the first chunks left in
shared memory).  Kernel 4b (``cnn_dy3_bf16_kernel``): the full kernel;
the producer warps' loads alone (the consumers wait for and release each
stage: no products, no epilogue); loads and products without the
epilogue; without its TMA stores; without the y3 stream and mask (mask all
ones); tiles of 64 columns in place of 128 (256 do not fit in shared
memory); one consumer warpgroup in place of two (no ping-pong); a y3 ring
of 4 stages in place of 2; and, for the practical floor of its byte
stream, a copy of y3 into dy3.  With ``--parent DIR`` (a checkout of an
earlier commit), the copies ``k4b-mma`` of that checkout's ``mma.sync``
design of kernel 4b (one 128 x 128 tile a block): the full kernel;
without its stores; without the y3 read (mask all ones); the main loop
alone; rings of 2 and 6 stages in place of 4.  Kernel 5: the full kernel;
each tile's staging alone (the
wait for its copies); staging and dw3, db3; staging and all of level 3 (d2
too); all but d1 and its sums; every phase without the refills (each tile
computes on whatever the first one left in shared memory).  Kernel 5b
(``cnn_chain_bwd_bf16_kernel``, cut on its own markers): the full kernel;
each tile's staging alone; staging and level 3 (dw3, db3, d2); all but d1
and its sums; every phase without the refills; the full kernel with d2 on
the core's column tiles only (the cost of its halo tile); and the full
kernel at tiles of 32 and 64 positions in place of 128, and at 64 with a
ring of 3 stages in place of 2 (the tile-width and stage sweep; 3 stages
of 128 do not fit); each prints its registers and spills (ptxas).
Kernels 5 and 5b's inputs have the ReLU pattern of real activations: y1,
y2 and d3 about half zero, the fingerprint's bits 0 or 1.  ``--only``
keeps the copies whose name starts with its argument (``--only k5b`` the
bf16 ones; ``--only k5`` both; ``--only k4b`` kernel 4b's and, with
``--parent``, the ``mma.sync`` design's).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(REPO, "mgat_graphsage_torch", "csrc")
# a kernel-3 copy returns here; the impossible store keeps the work alive
STOP = ("  if (residual >= 0) {\n    if (residual == 7) dv[threadIdx.x] = "
        "p_s[threadIdx.x] + d_s[threadIdx.x];\n    return;\n  }\n")
# the same for a kernel-2 copy after its load, and one that skips attn . v
K2_STOP = ("  if (residual >= 0) {\n    if (residual == 7) out[threadIdx.x] = "
           "q_s[threadIdx.x] + v_s[threadIdx.x] + m_s[threadIdx.x] + "
           "k_s[threadIdx.x];\n    return;\n  }\n")
K2_SKIP = ("    if (residual >= 0) {\n      if (residual == 7) "
           "out[threadIdx.x] = a_h[kg];\n      continue;\n    }\n")
# a kernel-2 copy that stops a half-warp's work after its scores (or its
# softmax): the tile's sum goes to the scratch, so the work stays alive
K2_SINK = ("    if (residual >= 0) {\n      float z = 0.0f;\n"
           "      for (int r = 0; r < kRows; ++r)\n"
           "        for (int t = 0; t < KPT; ++t) z += a[r][t];\n"
           "      a_h[kg] = z;\n      continue;\n    }\n")
K2_SCORES = ("    row_products<kRows, KPT>(k_s + il * fp, q_s, fp, f, n, kg, "
             "a);\n")
K2_SOFTMAX = "    softmax_rows<kRows, KPT, true>(a, m_s, n, kg, scale);\n"
# the launcher's row-group rule, which a kernel-2 copy replaces by a constant
K2_GROUPS = "  int groups = row_groups(batch, n, sms);"
# kernel 5b's tile width and ring depth, which the sweep's copies replace
K5B_TW = "constexpr int kBTW = 128;"
K5B_N2 = "constexpr int kBN2 = kBP2 / 8;"
K5B_STAGES = "constexpr int kBStages = 2;"
# kernel 4b's cuts: its products, its epilogue's staging loop, its TMA
# stores, its y3 stream and mask, its tile width and its consumer groups
K4B_PRODUCTS = "          wgmma_bf16<BN>(acc, da, db, ks > 0);"
K4B_STAGE = "        for (int i = 0; i < BN / 2; i += 2) {"
K4B_STORE = "            tma_store(&out_map,"
K4B_Y3_WARP = "    } else if (warp == 1 && lane == 0) {"
K4B_Y3_WAIT = "        mbar_wait(y3_full + 8 * ys, gc / kY3Stages & 1);\n"
K4B_MASK = "          const uint32_t m = lds32(yb + off);"
K4B_COLS = "int tile_cols(int h) { return h <= 256 ? 128 : 64; }"
K4B_GROUPS = "constexpr int kConsumers = 2;"
K4B_Y3_STAGES = "constexpr int kY3Stages = 2;"
# the same for the earlier design of kernel 4b (mma.sync, one 128 x 128
# tile a block), cut from a parent checkout's source (--parent)
K4B_OLD_STORE = "        *reinterpret_cast<__nv_bfloat162*>(out + at) = v;"
K4B_OLD_MASK = ("        const __nv_bfloat162 m =\n"
                "            *reinterpret_cast<const __nv_bfloat162*>"
                "(y3 + at);")
K4B_OLD_EPILOGUE = ("  // epilogue: round each sum once to bf16, keep it "
                    "where y3 > 0")
K4B_OLD_SINK = ("  if (batch < 0) {\n    float z = 0.0f;\n"
                "    for (int i = 0; i < 4; ++i)\n"
                "      for (int j = 0; j < 4; ++j)\n"
                "        for (int e = 0; e < 4; ++e) z += acc[i][j][e];\n"
                "    out[t] = __float2bfloat16(z);\n  }\n  return;\n")
K4B_OLD_STAGES = "constexpr int kHStages = 4;"


def nvcc_args(cu: str, so: str, csrc: str = CSRC) -> list:
    """nvcc's arguments for one copy: the port's flags, and ``csrc`` (the
    source's own directory) on the include path, so that a copy written
    elsewhere still finds the headers its source includes
    (``attention_common.cuh``)."""
    from mgat_graphsage_torch.ops import _build

    return [*_build.NVCC_FLAGS, "-I", csrc, "-o", so, cu]


def cut(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"kernel source changed: {old!r} not found")
    return src.replace(old, new)


# a kernel-1 copy that returns after staging its molecule's edges; the
# store fires only for a source index no real edge list holds
K1_STOP = ("  if (num_nodes > 0) {\n"
           "    if (kStaged && (int)threadIdx.x < 3 * e_n && "
           "smem[threadIdx.x] == -7)\n"
           "      out[threadIdx.x] = 0.0f;\n    return;\n  }\n")
# kernel 1's stores, and the same stores behind a test no mask >= 0 passes
K1_STORES = (("          *reinterpret_cast<float4*>(row + col) = v;",
              "          if (v.x == -2.0f) *reinterpret_cast<float4*>(row + "
              "col) = v;"),
             ("          if (col < n) row[col] = clamp1(acc[i][j]);",
              "          if (col < n && acc[i][j] == -2.0f) row[col] = "
              "clamp1(acc[i][j]);"))
# the launcher's row-group rule and kernel 1's rows per warp
K1_GROUPS = "  int groups = row_groups(batch, n, sms);"
K1_ROWS = "constexpr int kRowsPerWarp = 2;"
# kernel 1's walk over the set bits, which a copy runs only where the one
# set bit is edge 0 of its 32
K1_WALK = "      while (bits) {  // the warp's edges in ascending e"


def variants():
    """name -> (kernel source name, source text)."""
    k1 = open(os.path.join(CSRC, "adjacency.cu")).read()
    k2 = open(os.path.join(CSRC, "attention.cu")).read()
    k3 = open(os.path.join(CSRC, "attention_bwd.cu")).read()
    k4 = open(os.path.join(CSRC, "cnn_dy3.cu")).read()
    k5 = open(os.path.join(CSRC, "cnn_chain_bwd.cu")).read()

    def k5_upto(marker):   # each tile skips the rest of its work at marker
        return ("cnn_chain_bwd", cut(k5, marker, "    continue;\n" + marker))

    def k5b_set(old, new):  # a constant of the bf16 kernel changed
        return ("cnn_chain_bwd", cut(k5, old, new))

    def k4b(*cuts):        # kernel 4b with each (old, new) cut made
        src = k4
        for old, new in cuts:
            src = cut(src, old, new)
        return ("cnn_dy3", src)

    never = "if (batch < 0) "
    no_store = (K4B_STORE, K4B_STORE.replace("tma_store", never + "tma_store"))
    no_staging = (K4B_STAGE, K4B_STAGE.replace("i < BN / 2;",
                                               "i < BN / 2 && batch < 0;"))
    no_stores = ("            __stcs(", "            if (batch < 0) __stcs(")
    return {
        "k1 full": ("adjacency", k1),
        "k1 empty": ("adjacency", cut(k1, "  // ---- load",
                                      "  if (num_nodes > 0) return;\n"
                                      "  // ---- load")),
        "k1 load only": ("adjacency", cut(k1, "  // ---- rows",
                                          K1_STOP + "  // ---- rows")),
        "k1 no write-out": ("adjacency", cut(cut(k1, *K1_STORES[0]),
                                             *K1_STORES[1])),
        **{f"k1 G={g}": ("adjacency", cut(k1, K1_GROUPS,
                                          f"  int groups = {g};"))
           for g in (1, 2, 3, 4)},
        **{f"k1 R={r}": ("adjacency", cut(
            k1, K1_ROWS, f"constexpr int kRowsPerWarp = {r};"))
           for r in (1, 4, 8)},
        "k1 no walk": ("adjacency", cut(k1, K1_WALK, K1_WALK.replace(
            "while (bits)", "while (bits == 1u)"))),
        "k2 full": ("attention", k2),
        "k2 empty": ("attention", cut(k2, "  // ---- load",
                                      "  if (residual >= 0) return;\n"
                                      "  // ---- load")),
        "k2 load only": ("attention", cut(k2, "  // ---- phase A",
                                          K2_STOP + "  // ---- phase A")),
        "k2 load + scores": ("attention", cut(k2, K2_SCORES,
                                              K2_SCORES + K2_SINK)),
        "k2 load + scores + softmax": ("attention", cut(
            k2, K2_SOFTMAX, K2_SOFTMAX + K2_SINK)),
        "k2 load + softmax": ("attention", cut(
            k2, "    // ---- attn . v", K2_SKIP + "    // ---- attn . v")),
        "k2 division per key": ("attention", cut(
            k2, "softmax_rows<kRows, KPT, true>", "softmax_rows<kRows, KPT>")),
        **{f"k2 G={g}": ("attention", cut(k2, K2_GROUPS,
                                          f"  int groups = {g};"))
           for g in (1, 2, 3)},
        "k3 full": ("attention_bwd", k3),
        "k3 load only": ("attention_bwd",
                         cut(k3, "  // ---- phase A", STOP + "  // ---- phase A")),
        "k3 load + phase A": ("attention_bwd",
                              cut(k3, "  // ---- phase B", STOP + "  // ---- phase B")),
        "k3 load + phase A, no softmax": ("attention_bwd", cut(
            cut(k3, "  // ---- phase B", STOP + "  // ---- phase B"),
            "    softmax_rows<4, KPT>(a, m_s, n, kg, scale);",
            "    for (int r = 0; r < 4; ++r) a[r][0] *= scale;")),
        "k4 full": ("cnn_dy3", k4),
        "k4 no stores": ("cnn_dy3", cut(k4, *no_stores)),
        "k4 FMAs only": ("cnn_dy3", cut(
            cut(k4, *no_stores), "    issue_chunk(g + kStages - 1);\n", "")),
        "k4b full": ("cnn_dy3", k4),
        "k4b producer only": k4b(
            (K4B_PRODUCTS, "          " + never + K4B_PRODUCTS.lstrip()),
            no_staging, no_store),
        "k4b no epilogue": k4b(no_staging, no_store),
        "k4b no store": k4b(no_store),
        "k4b no mask": k4b(
            (K4B_Y3_WARP, K4B_Y3_WARP.replace(") {", " && batch < 0) {")),
            (K4B_Y3_WAIT, ""),
            (K4B_MASK, "          const uint32_t m = 0x3F803F80u;")),
        "k4b BN=64": k4b((K4B_COLS,
                          "int tile_cols(int h) { return 64; }")),
        "k4b one consumer": k4b((K4B_GROUPS,
                                 "constexpr int kConsumers = 1;")),
        "k4b y3 stages=4": k4b((K4B_Y3_STAGES, K4B_Y3_STAGES.replace(
            "2;", "4;"))),
        "k5 full": ("cnn_chain_bwd", k5),
        "k5 staging only": k5_upto("    // ---- level 3: dw3"),
        "k5 staging + dw3, db3": k5_upto("    // ---- level 3: d2"),
        "k5 staging + level 3": k5_upto("    // ---- level 2: dw2"),
        "k5 staging + level 3 + dw2": k5_upto("    // ---- level 2: d1"),
        "k5 no refills": ("cnn_chain_bwd", cut(
            k5, "    if (tile + (int)gridDim.x < ntiles)\n      stage_tile(",
            "    if (ntiles < 0)\n      stage_tile(")),
        "k5b full": ("cnn_chain_bwd", k5),
        "k5b staging only": k5_upto("    // ==== bf16 L3: dw3"),
        "k5b staging + level 3": k5_upto("    // ==== bf16 L2: dw2"),
        "k5b staging + level 3 + dw2": k5_upto("    // ==== bf16 L2: d1"),
        "k5b no refills": k5b_set(
            "      if (next < ntiles)\n        stage_tile_bf16(",
            "      if (ntiles < 0)\n        stage_tile_bf16("),
        "k5b d2 core tiles only": k5b_set(
            K5B_N2, "constexpr int kBN2 = kBTW / 8;"),
        **{f"k5b TW={tw}": k5b_set(K5B_TW, f"constexpr int kBTW = {tw};")
           for tw in (32, 64)},
        "k5b TW=64 stages=3": ("cnn_chain_bwd", cut(
            cut(k5, K5B_TW, "constexpr int kBTW = 64;"), K5B_STAGES,
            "constexpr int kBStages = 3;")),
    }


def parent_variants(root: str):
    """Copies of the earlier, ``mma.sync`` design of kernel 4b, cut from
    the ``cnn_dy3.cu`` of the checkout at ``root``: name -> (source, its
    csrc directory)."""
    csrc = os.path.join(root, "mgat_graphsage_torch", "csrc")
    old = open(os.path.join(csrc, "cnn_dy3.cu")).read()
    no_store = (K4B_OLD_STORE, "        if (batch < 0) " +
                K4B_OLD_STORE.lstrip())
    copies = {
        "k4b-mma full": old,
        "k4b-mma no store": cut(old, *no_store),
        "k4b-mma no mask read": cut(old, K4B_OLD_MASK,
                                     "        const __nv_bfloat162 m = "
                                     "__floats2bfloat162_rn(1.0f, 1.0f);"),
        "k4b-mma main loop only": cut(old, K4B_OLD_EPILOGUE,
                                       K4B_OLD_SINK + K4B_OLD_EPILOGUE),
        **{f"k4b-mma stages={n}": cut(old, K4B_OLD_STAGES,
                                       f"constexpr int kHStages = {n};")
           for n in (2, 6)},
    }
    return {name: (src, csrc) for name, src in copies.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="", help="name prefix, e.g. k5")
    ap.add_argument("--parent", default="",
                    help="a checkout of the parent commit: also time its "
                         "kernel 4b's copies (k4b-mma)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    from mgat_graphsage_torch.ops import _build

    card = chip_smoke.nvidia_smi_line() or torch.cuda.get_device_name(0)
    work = tempfile.TemporaryDirectory(prefix="kernel_phases-")
    procs = {}
    chosen = {n: (kernel, src, CSRC) for n, (kernel, src)
              in variants().items()}
    if args.parent:
        chosen.update({n: ("cnn_dy3", src, csrc) for n, (src, csrc)
                       in parent_variants(args.parent).items()})
    chosen = {n: v for n, v in chosen.items() if n.startswith(args.only)}
    for i, (name, (kernel, src, csrc)) in enumerate(chosen.items()):
        cu = os.path.join(work.name, f"v{i}.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        procs[name] = (kernel, cu[:-3] + ".so", subprocess.Popen(
            [_build._nvcc(), *nvcc_args(cu, cu[:-3] + ".so", csrc)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (kernel, so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        symbol, argtypes = _build.KERNELS[kernel]
        bf16 = {"k5b": "cnn_chain_bwd_bf16", "k4b": "cnn_dy3_bf16"}.get(
            name[:3])
        if bf16:
            kernel, symbol = bf16, bf16 + "_launch"
            argtypes = _build.ENTRIES[symbol]
        fn = getattr(ctypes.CDLL(so), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = (kernel, fn)
        _build.BUILD_LOGS[name] = out
        for line in _build.ptxas_report(name):
            if bf16 and bf16 in line:
                print(f"{name:<32} ptxas: {line}", flush=True)
        if "C7508" in out:   # ptxas ignored a setmaxnreg
            print(f"{name:<32} ptxas: setmaxnreg ignored", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    b, n, f = 128, 80, 35
    q, k, v, g = (rand(b, n, f) for _ in range(4))
    o = torch.empty_like(q)
    mask = np.zeros((b, n), np.float32)
    for i in range(b):
        mask[i, :int(rng.integers(20, n + 1))] = 1.0
    mask = torch.from_numpy(mask).to(dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dyt = rand(256, 128, scale=0.01)
    w, y3 = rand(256, 131072), rand(128, 1024, 128)
    out = torch.empty_like(y3)
    def relu(*shape):
        return rand(*shape).clamp_min_(0.0)

    cb, cw = 128, 1024
    d3, y2, y1 = relu(cb, cw, 128), relu(cb, 64, cw), relu(cb, 32, cw)
    fp = torch.from_numpy((rng.random((cb, cw)) < 0.1).astype(np.float32)
                          ).to(dev)
    w3, w2 = rand(128, 64, 3, scale=0.05), rand(64, 32, 3, scale=0.05)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partials = torch.empty(blocks, 31040, device=dev)
    sums = torch.empty(31040, device=dev)
    # kernel 5b at the bf16 training shape, made on the card
    b5, w5 = 1024, 1024
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def relu_bf16(*shape):
        return torch.randn(shape, device=dev, generator=gen).clamp_min_(
            0.0).to(torch.bfloat16)

    b16 = [relu_bf16(b5, w5, 128), relu_bf16(b5, 64, w5),
           relu_bf16(b5, 32, w5),
           (torch.rand((b5, w5), device=dev, generator=gen) < 0.1).to(
               torch.bfloat16),
           w3.to(torch.bfloat16), w2.to(torch.bfloat16)] if any(
               kern == "cnn_chain_bwd_bf16" for kern, _ in fns.values()) \
        else []
    # kernel 4b at the bf16 training shape (B=1024, H=256, W=1024), made on
    # the card: y3 with the ReLU pattern of real activations
    d4 = [(torch.randn((b5, 256), device=dev, generator=gen) * 0.01).to(
              torch.bfloat16),
          (torch.randn((256, w5 * 128), device=dev, generator=gen) * 0.01
           ).to(torch.bfloat16), relu_bf16(b5, w5, 128)] if any(
              kern == "cnn_dy3_bf16" for kern, _ in fns.values()) else []
    out4 = torch.empty_like(d4[2]) if d4 else None
    stream = torch.cuda.current_stream().cuda_stream
    def k1_call(csv, bb):
        """kernel 1 on the first ``bb`` molecules of ``csv`` at the (80,
        176) budget: real edge lists, padding at node 0 with mask 0"""
        from mgat_graphsage_torch.data import MolecularDataset, load_csv

        smiles, y = load_csv(csv)
        nn, ne = chip_smoke.BUDGET
        ds = MolecularDataset(smiles[:bb], y[:bb], max_nodes=nn, max_edges=ne,
                              verbose=False)
        assert len(ds) == bb, "a molecule fell outside the budget"
        ed = torch.from_numpy(ds.edges).to(dev)
        em = torch.from_numpy(ds.edge_mask).to(dev)
        adj = torch.empty(bb, nn, nn, device=dev)
        return lambda fn: fn(ed.data_ptr(), em.data_ptr(), adj.data_ptr(), bb,
                             ed.shape[2], nn, stream)

    def k2_call(bb):
        return lambda fn: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             mask.data_ptr(), o.data_ptr(), bb, n, f,
                             f ** -0.5, 1, stream)

    # kernel -> [(shape label, call)]: kernel 2 at the serving batch (the
    # first 64 molecules) and the training batch
    calls = {
        "attention": [("B=64", k2_call(64)), ("B=128", k2_call(b))],
        "attention_bwd": lambda fn: fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, n,
            f, f ** -0.5, 1, stream),
        "cnn_dy3": lambda fn: fn(dyt.data_ptr(), w.data_ptr(), y3.data_ptr(),
                                 out.data_ptr(), 128, 256, 131072, stream),
        "cnn_chain_bwd": lambda fn: fn(
            d3.data_ptr(), y2.data_ptr(), y1.data_ptr(), fp.data_ptr(),
            w3.data_ptr(), w2.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), cb, cw, blocks, stream),
        "cnn_dy3_bf16": lambda fn: fn(
            *(t.data_ptr() for t in d4), out4.data_ptr(), b5, 256, w5 * 128,
            stream),
        "cnn_chain_bwd_bf16": lambda fn: fn(
            *(t.data_ptr() for t in b16), partials.data_ptr(),
            sums.data_ptr(), b5, w5, blocks, stream)}
    if any(kern == "adjacency" for kern, _ in fns.values()):
        from mgat_graphsage_torch.data import TEST_CSV, TRAIN_CSV

        calls["adjacency"] = [("B=64", k1_call(TEST_CSV, 64)),
                              ("B=128", k1_call(TRAIN_CSV, 128))]
    timer = chip_smoke.DeviceTimer(torch)
    if d4:
        # the card's read + write stream on kernel 4b's bytes: y3 copied
        # into dy3 (537 MB), for the practical floor of the stream
        ms = timer(lambda: out4.copy_(d4[2]), iters=50)
        print(f"{'k4b floor: copy y3 -> dy3':<32} {ms * 1e3:9.2f} us  on "
              f"{card}", flush=True)
    for name, (kernel, fn) in fns.items():
        shapes = calls[kernel]
        if callable(shapes):
            shapes = [("", shapes)]
        for label, call in shapes:
            err = call(fn)
            if err:
                raise RuntimeError(f"{name}: launch failed, cudaError {err}")
            ms = timer(lambda: call(fn), iters=50)
            label = f"{name} {label}".strip()
            print(f"{label:<32} {ms * 1e3:9.2f} us  on {card}", flush=True)
    work.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
