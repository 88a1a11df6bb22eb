#!/usr/bin/env python3
"""Probe what bounds K1 (candidate_assign_tiled), K2 (center_sqdist), K3
(segmented_scan), K4 (candidate_assign_int8_tiled), K5 (distance_argmin),
K6 (cluster_attend), K7 (candidate_assign_rowwise), the rounding kernels
(exact_round: exact_cross at a predict batch's 8192 x 1000 and 8192 x
63) and the engine's ordered center sums (segment_sum_blocks) on one
CUDA card, at chip_smoke.py's shapes (n=60000, d=784, k=1000; bn=32; K1
also at the predict layout, bn=8), and what the correct rounding's tiers
cost.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/probe_kernels.py [--only KERNEL] [--root PATH]

``--only`` times one kernel and its variants (``distance_argmin``,
``segmented_scan``, ``candidate_assign_tiled``, ``exact_round``,
``center_sqdist``, ``segment_sum_blocks``, ``candidate_assign_int8_tiled``,
``cluster_attend``, ``candidate_assign_rowwise`` or ``all``, which leaves
out the last three). ``--root`` imports the kernels of another checkout
(say a parent's, unpacked with ``git archive``) and times them without
variants, except K7's where that checkout still holds the warp-a-row K7
of PR 20 and before: there the variants of ROOT_VARIANTS are built from
its sources.

``candidate_assign_int8_tiled`` (K4), ``cluster_attend`` (K6) and
``candidate_assign_rowwise`` (K7) replay chip_smoke.py's own inputs: K4
at the first int8 predict batch's layout after the same fit and model
(bn=8, kn_pad=32, d=784), K6 on layer 0's cluster-major tables at phase
2e's decode step after the same serve run (64 rows, p=16, cap 512, dh
128, bf16, sizes), K7 at phase 2d's assignment bench after the same fit
(the resident arena, bn=32, per-block lists ``graph[rowsel]`` with
kn=30, d=784, no block skipped; K1 timed beside it on the same lists).
Each gives the profiler's device time per call beside CUDA events over
back-to-back calls (K4, K7) or around each call with the L2 cache
flushed before it (K6), since events around such short kernels also
time their launchers' host work. K6 also reports how far its state, and
its plain version's, lie from the same softmax taken in f64.

``segment_sum_blocks`` is timed on the calls the main path makes: one
``fit(init="gdi", method="k2means")`` is run with the engine's calls
recorded (how many full recomputes over the arena and how many delta
calls over the moved rows, each segment's length in slots), then the
arena's first call and the fit's delta calls are each replayed under
``torch.profiler``, whose device time is split among the wrapper's
kernels (the sort and ``searchsorted`` of the block list where the
wrapper takes them, the sum kernel and the rest), beside CUDA-event times;
the arena is also replayed with its segments regrouped in three orders
(as laid out, longest first, shortest first) and with its longest
segment alone.

Each kernel is timed beside variants of its sources built by text
substitution, and K5 beside cuBLAS's f64 GEMM of the same product (with
the names of the kernels cuBLAS runs for it). Some variants give wrong
answers on purpose (MMAs fed constants, f32 values reinterpreted instead
of widened, MMAs dropped, copies or the epilogue left out, K5's screen or
its exact recompute of the pairs the screen flags left out): only their
times mean anything. The variants named "exact" (K2's tile shapes, the
variant without the double-double tier of ``common.cuh``) must give the
same answers, and are checked bit-equal. A variant is compiled from a
copy of ``src/repro_torch/kernels/csrc`` under ``build/probe/`` and
loaded in place of the kernels' libraries; the script fails when a
substitution no longer matches the source. The last line is one JSON
object of the times in ms.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

_LOADS = """        af[i][0] = p[0];
        af[i][1] = p[8 * LD];
        af[i][2] = p[4];
        af[i][3] = p[8 * LD + 4];"""
_BFRAG = "        const double bf[2] = {p[0], p[4]};"
_MMA = "        for (int i = 0; i < 2; ++i) dmma(acc[i][j], af[i], bf);"
_RECOMPUTE = "      recompute_flagged(flagged,"
_NO_RECOMPUTE = "      if (0) recompute_flagged(flagged,"


def _bits(a: str, b: str) -> str:
    return f"__hiloint2double(__float_as_int({a}), __float_as_int({b}))"


_K1_LOADS = """        bf[j][0] = p[0];
        bf[j][1] = p[4];"""
_K1_STAGE = "  for (int e = threadIdx.x; e < (BR + KC) * PER_ROW; e += NT) {"
_SSB_RING = ("constexpr int R = 8;            // slots a ring stage holds\n"
             "constexpr int STAGES = 3;")
_K2_LOADS = _LOADS.replace("LD", "T::LD")
_K2_CFG = "constexpr int CFG_BT = 32, CFG_S = 2, CFG_DC = 64;"

_K4_A = ("            for (int q = 0; q < 4; ++q) a[q] = lds16(sa + (g + 8 "
         "* q) * 64);")
_K4_B = "              const uint4 x = lds16(sb + (8 * ni + g) * 64);"
_CP16 = '    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"'
_K4_NW = "constexpr int NW = 4;                // warps (units) a CUDA block"
_K6_PLAN = "constexpr int MAX_SPLITS = 8;"
_K7_NO_EPI = "      // --- epilogue of chunk ci"
_K7_NO_EPI_SUB = "      if (acc[0][0][0] != -1.2345) continue;\n" + _K7_NO_EPI

# (kernel timed, source file, label) -> substitutions; "exact" variants
# must give the kernels' own answers
VARIANTS = {
    ("distance_argmin", "distance_argmin.cu", "MMAs fed constants"): {
        _LOADS: "\n".join(f"        af[i][{e}] = {e + 1}.0;"
                          for e in range(4)),
        _BFRAG: "        const double bf[2] = {1.0, 2.0};"},
    ("distance_argmin", "distance_argmin.cu",
     "f32 values reinterpreted, not widened"): {
        _LOADS: "\n".join(
            f"        af[i][{e}] = {_bits(u, v)};" for e, (u, v) in
            enumerate((("p[0]", "p[4]"), ("p[8 * LD]", "p[0]"),
                       ("p[4]", "p[8 * LD + 4]"),
                       ("p[8 * LD + 4]", "p[8 * LD]")))),
        _BFRAG: "        const double bf[2] = {"
                f"{_bits('p[0]', 'p[4]')}, {_bits('p[4]', 'p[0]')}}};"},
    ("distance_argmin", "distance_argmin.cu",
     "no MMAs (f64 adds keep the loads)"): {
        _MMA: "        for (int i = 0; i < 2; ++i) {"
              " acc[i][j][0] += af[i][0] + af[i][1];"
              " acc[i][j][1] += af[i][2] + af[i][3];"
              " acc[i][j][2] += bf[0]; acc[i][j][3] += bf[1]; }"},
    ("distance_argmin", "distance_argmin.cu",
     "no exact recompute of flagged pairs"): {_RECOMPUTE: _NO_RECOMPUTE},
    ("distance_argmin", "distance_argmin.cu",
     "no screen (f64 sums rounded to nearest)"): {
        _RECOMPUTE: _NO_RECOMPUTE,
        "            if (lo != up) {": "            if (false) {"},
    ("segmented_scan", "segmented_scan.cu", "50 KB tiles"): {
        "TILE_BYTES = 100 * 1024": "TILE_BYTES = 50 * 1024"},
    ("candidate_assign_tiled", "candidate_assign.cu", "MMAs fed constants"): {
        _LOADS: "\n".join(f"        af[i][{e}] = {e + 1}.0;"
                          for e in range(4)),
        _K1_LOADS: "        bf[j][0] = 1.0;\n        bf[j][1] = 2.0;"},
    ("candidate_assign_tiled", "candidate_assign.cu", "no MMAs"): {
        "        for (int j = 0; j < NJ; ++j) dmma(acc[i][j], af[i], bf[j]);":
        "        for (int j = 0; j < NJ; ++j) { acc[i][j][0] += af[i][0] +"
        " af[i][1]; acc[i][j][1] += af[i][2] + af[i][3]; acc[i][j][2] +="
        " bf[j][0]; acc[i][j][3] += bf[j][1]; }"},
    ("candidate_assign_tiled", "candidate_assign.cu",
     "slab rows not copied (x only)"): {
        _K1_STAGE: "  for (int e = threadIdx.x; e < BR * PER_ROW; e += NT) {"},
    ("candidate_assign_tiled", "candidate_assign.cu",
     "x rows not copied (slab only)"): {
        _K1_STAGE: "  for (int e = threadIdx.x + BR * PER_ROW; "
                   "e < (BR + KC) * PER_ROW; e += NT) {"},
    ("candidate_assign_tiled", "candidate_assign.cu",
     "no epilogue (copies and MMAs only)"): {
        "    if (kc != nkc - 1) continue;":
        "    if (kc != nkc - 1 || acc[0][0][0] != -1.2345) continue;"},
    ("exact_round", "exact_round.cu", "cross: MMAs fed constants"): {
        _LOADS: "\n".join(f"        af[i][{e}] = {e + 1}.0;"
                          for e in range(4)),
        _BFRAG: "        const double bf[2] = {1.0, 2.0};"},
    ("exact_round", "exact_round.cu",
     "cross: no epilogue (copies and MMAs only)"): {
        "    if (kc != nkc - 1) continue;":
        "    if (kc != nkc - 1 || acc[0][0][0] != -1.2345) continue;"},
    ("exact_round", "exact_round.cu",
     "cross: no exact recompute of flagged sums"): {
        "  recompute_marked(flags,": "  if (0) recompute_marked(flags,"},
    ("exact_round", "exact_round.cu",
     "exact: cross kernel one block an SM, no register cap"): {
        "__launch_bounds__(CrossTile<BN>::NT, 2)":
        "__launch_bounds__(CrossTile<BN>::NT, 1)"},
    ("exact_round", "exact_round.cu",
     "exact: cross at k <= 64 in 128-column tiles too"): {
        "  if (k <= 64)\n": "  if (false)\n"},
    ("center_sqdist", "center_knn.cu", "exact: 64 x 64 tiles, 4 warps"): {
        _K2_CFG: "constexpr int CFG_BT = 64, CFG_S = 1, CFG_DC = 64;"},
    ("center_sqdist", "center_knn.cu",
     "exact: 64 x 64 tiles, 16 warps"): {
        _K2_CFG: "constexpr int CFG_BT = 64, CFG_S = 4, CFG_DC = 64;"},
    ("center_sqdist", "center_knn.cu", "exact: 64 x 64 tiles, 8 warps"): {
        _K2_CFG: "constexpr int CFG_BT = 64, CFG_S = 2, CFG_DC = 64;"},
    ("center_sqdist", "center_knn.cu", "exact: 32 x 32 tiles, 4 warps"): {
        _K2_CFG: "constexpr int CFG_BT = 32, CFG_S = 4, CFG_DC = 128;"},
    ("center_sqdist", "center_knn.cu",
     "exact: 32 x 32 tiles, 2 warps, 128-float stages"): {
        _K2_CFG: "constexpr int CFG_BT = 32, CFG_S = 2, CFG_DC = 128;"},
    ("center_sqdist", "center_knn.cu", "exact: 32 x 32 tiles, 1 warp"): {
        _K2_CFG: "constexpr int CFG_BT = 32, CFG_S = 1, CFG_DC = 64;"},
    ("center_sqdist", "center_knn.cu", "exact: a ring of 3 stages"): {
        "constexpr int STAGES = 2;": "constexpr int STAGES = 3;"},
    ("center_sqdist", "center_knn.cu", "MMAs fed constants"): {
        _K2_LOADS: "\n".join(f"        af[i][{e}] = {e + 1}.0;"
                              for e in range(4)),
        _BFRAG: "        const double bf[2] = {1.0, 2.0};"},
    ("center_sqdist", "center_knn.cu", "no screen (copies, MMAs, stores)"):
        {"  if (grp == 0) {\n#pragma unroll":
         "  if (grp == 0 && acc[0][0][0] == -1.2345) {\n#pragma unroll"},
    ("segment_sum_blocks", "segment_sum.cu",
     "exact: ring of 8 stages of 4 slots"): {
        _SSB_RING: "constexpr int R = 4;            // slots a ring stage "
                   "holds\nconstexpr int STAGES = 8;"},
    ("segment_sum_blocks", "segment_sum.cu",
     "exact: ring of 6 stages of 8 slots"): {
        _SSB_RING: "constexpr int R = 8;            // slots a ring stage "
                   "holds\nconstexpr int STAGES = 6;"},
    ("segment_sum_blocks", "segment_sum.cu",
     "exact: ring of 4 stages of 16 slots"): {
        _SSB_RING: "constexpr int R = 16;           // slots a ring stage "
                   "holds\nconstexpr int STAGES = 4;"},
    ("segment_sum_blocks", "segment_sum.cu",
     "exact: one block an item (no persistent loop)"): {
        "(unsigned)max(1LL, min(items, slots));":
        "(unsigned)max(1LL, items);"},
    ("segment_sum_blocks", "segment_sum.cu", "rows not streamed"): {
        "          if (j < nst && mine) {": "          if (false) {"},
    ("segment_sum_blocks", "segment_sum.cu", "rows not added"): {
        "            add_chain(a, st[r * NT], wv);": "            (void)st;"},
    ("segment_sum_blocks", "segment_sum.cu",
     "rows neither streamed nor added"): {
        "          if (j < nst && mine) {": "          if (false) {",
        "            add_chain(a, st[r * NT], wv);": "            (void)st;"},
    ("segment_sum_blocks", "segment_sum.cu",
     "exact: ring of 2 stages of 8 slots"): {
        _SSB_RING: "constexpr int R = 8;            // slots a ring stage "
                   "holds\nconstexpr int STAGES = 2;"},
    ("segment_sum_blocks", "segment_sum.cu",
     "exact: ring of 4 stages of 8 slots"): {
        _SSB_RING: "constexpr int R = 8;            // slots a ring stage "
                   "holds\nconstexpr int STAGES = 4;"},
    ("candidate_assign_int8_tiled", "candidate_assign_int8.cu",
     "MMAs fed constants"): {
        _K4_A: "            for (int q = 0; q < 4; ++q) a[q] = "
               "make_uint4(q + 1, 2, 3, 4);",
        _K4_B: "              const uint4 x = make_uint4(1, 2, 3, ni + 1);"},
    ("candidate_assign_int8_tiled", "candidate_assign_int8.cu",
     "no epilogue (copies, MMAs and the tile store only)"): {
        "  for (int pass = 0; pass < 2; ++pass) {":
        "  for (int pass = 0; pass < 1; ++pass) {",
        "          if (row >= nrow) continue;\n          const float s =":
        "          if (row >= nrow || acc[0][0][0] != -12345) continue;\n"
        "          const float s ="},
    ("candidate_assign_int8_tiled", "candidate_assign_int8.cu",
     "exact: 2 warps a CUDA block"): {_K4_NW: _K4_NW.replace("4", "2")},
    **{("candidate_assign_int8_tiled", "candidate_assign_int8.cu",
        f"exact: {n} stages of {dc} bytes of d"): {
        "constexpr int DC = 64;": f"constexpr int DC = {dc};",
        "constexpr int STAGES = 4;": f"constexpr int STAGES = {n};"}
       for dc, n in ((128, 3), (64, 3), (64, 6))},
    ("candidate_assign_int8_tiled", "common.cuh",
     "exact: 16-byte cp.async with a 256-byte L2 prefetch"): {
        _CP16: _CP16.replace("global [", "global.L2::256B [")},
    ("cluster_attend", "cluster_attend.cu",
     "no combine (partials written; no ticket, no fold)"): {
        "  if (tid == 0) s_last = atomicAdd(tickets + row, 1) == S - 1;":
        "  if (tid == 0) s_last = 0;"},
    **{("cluster_attend", "cluster_attend.cu", f"S = {n}"): {
        _K6_PLAN: f"constexpr int MAX_SPLITS = {n};"}
       for n in (1, 2, 4, 8, 16)},
    ("cluster_attend", "cluster_attend.cu", "exact: 2 stages"): {
        "constexpr int STAGES = 3;": "constexpr int STAGES = 2;"},
    ("cluster_attend", "cluster_attend.cu", "exact: 4 stages"): {
        "constexpr int STAGES = 3;": "constexpr int STAGES = 4;"},
    ("cluster_attend", "cluster_attend.cu", "8 warps a CUDA block"): {
        "constexpr int NW = 4;": "constexpr int NW = 8;"},
    ("cluster_attend", "cluster_attend.cu", "tiles of 16 rows"): {
        "constexpr int TILE_BYTES = 2048;": "constexpr int TILE_BYTES = 4096;",
        "constexpr int MAX_STEPS = 4;": "constexpr int MAX_STEPS = 8;"},
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "MMAs fed constants"): {
        _LOADS.replace("        ", "            "): "\n".join(
            f"            af[i][{e}] = {e + 1}.0;" for e in range(4)),
        _K1_LOADS.replace("        ", "            "):
        "            bf[j][0] = 1.0;\n            bf[j][1] = 2.0;"},
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "no epilogue (copies and MMAs only)"): {_K7_NO_EPI: _K7_NO_EPI_SUB},
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "copies only (no fragments, MMAs or epilogue)"): {
        _K7_NO_EPI: _K7_NO_EPI_SUB,
        "          if (t0 + kk * 8 >= d) break;":
        "          if (t0 + kk * 8 >= -1) break;"},
    # (without the epilogue: stale rows would send every pair to the
    # exact recompute)
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "center rows not copied, no epilogue"): {
        _K7_NO_EPI: _K7_NO_EPI_SUB,
        _K1_STAGE: "  for (int e = threadIdx.x; e < BR * PER_ROW; e += NT) {"},
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "x rows not copied, no epilogue"): {
        _K7_NO_EPI: _K7_NO_EPI_SUB,
        _K1_STAGE: "  for (int e = threadIdx.x + BR * PER_ROW; "
                   "e < (BR + KC) * PER_ROW; e += NT) {"},
    **{("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
        f"exact: {n} stages"): {
        "constexpr int STAGES = 4;": f"constexpr int STAGES = {n};"}
       for n in (3,)},
    ("all", "common.cuh", "exact: no double-double tier"): {
        "  if (!k2_refine_dot_warp(pair, d, v)) v = k2_exact_dot_warp(pair, "
        "d);": "  v = k2_exact_dot_warp(pair, d);"},
}

# K7 as it stood up to PR 20 (one warp a row walking the list, f64 sums
# on the CUDA cores joined by xor shuffles, the screen in every lane),
# timed with --root on such a checkout (and skipped on any other): which
# of the shuffles and the screen hold it, or the list's rows read again
# for every row
_K7_SHFL = ("#pragma unroll\n  for (int o = 16; o > 0; o >>= 1) v += "
            "__shfl_xor_sync(0xffffffffu, v, o);\n")
_K7_XS2 = ("    const float xs2 = k2_round_sum_uniform(s2, k2_gamma(d) * s2, "
           "xr, 1, xr,\n                                           1, d);")
_K7_CROSS = ("      const float cross = k2_round_sum_uniform(\n"
             "          warp_sum_all(t), k2_gamma(d) * sqrt(s2 * "
             "k2_sqnorm_up(csq[ci])), xr,\n          1, cr, 1, d);")
ROOT_VARIANTS = {
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "no screen (f64 sums rounded to nearest)"): {
        _K7_XS2: "    const float xs2 = (float)s2;",
        _K7_CROSS: "      const float cross = (float)warp_sum_all(t);"},
    ("candidate_assign_rowwise", "candidate_assign_rowwise.cu",
     "no shuffles (each lane screens its own part; no exact recompute)"): {
        _K7_SHFL: "",
        _K7_XS2: "    float xs2;\n    k2_screen(s2, k2_gamma(d) * s2, xs2);",
        _K7_CROSS: "      float cross;\n      k2_screen(warp_sum_all(t), "
                   "k2_gamma(d) * sqrt(s2 * k2_sqnorm_up(csq[ci])), cross);"},
}


def _use_sources(build, csrc: pathlib.Path, build_dir: pathlib.Path) -> None:
    """Load the kernels from ``csrc``, built into ``build_dir`` on first
    use, from now on."""
    build.CSRC, build.BUILD_DIR = csrc, build_dir
    build._libs.clear()
    build._fns.clear()


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    only = args.only
    if args.root is not None:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms, time_ms
    from repro_torch.core import K2Step, center_knn_graph, engine, fit
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build, exact_round, ref
    from repro_torch.kernels.center_knn import center_sqdist
    from repro_torch.kernels.segment_sum import segment_sum_blocks
    from repro_torch.kernels.candidate_assign import (candidate_assign_tiled,
                                                      candidate_tables,
                                                      pad_candidates)
    from repro_torch.kernels.distance_argmin import distance_argmin
    from repro_torch.kernels.ops import (choose_group_bn,
                                         group_by_cluster_device)
    from repro_torch.kernels.segmented_scan import segmented_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    dev = torch.device("cuda")
    if only in _REPLAYED:
        out, timer, answers = _REPLAYED[only](torch, dev)
        timer()            # the card's clocks rise over the first timings
        out[only] = timer()
        return _finish(torch, _build, args, out, {only: timer}, answers)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = gmm_blobs(60000, 784, 128, generator=gen, device=dev)
    c = x[torch.randperm(60000, generator=gen, device=dev)[:1000]] \
        + 0.1 * torch.randn(1000, 784, generator=gen, device=dev)
    a0 = distance_argmin(x, c)[0]
    layouts = {}
    for label, a in (("1000 segments", a0),
                     ("one segment", torch.zeros(60000, dtype=torch.int32,
                                                 device=dev))):
        perm, b2s = group_by_cluster_device(a, int(a.max()) + 1, 32)
        layouts[label] = (x[perm.clamp(min=0).long()].contiguous(),
                          (perm >= 0).to(torch.float32), b2s)
    # K1 at the fit's arena (bn = 32) and at a predict batch grouped by
    # its nearest centers (bn = 8)
    graph = center_knn_graph(c, 30)
    cidx = pad_candidates(graph, 8).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    st = K2Step(k=1000, kn=30, bkn=8).init_resident(
        x, torch.ones(60000, device=dev), c, a0)
    k1_args = {}
    q = x[:8192] + 0.05 * torch.randn(8192, 784, generator=gen, device=dev)
    for label, rows, b2c, bn in (
            ("fit arena", st.xg, st.b2c, st.pid.shape[0] // st.b2c.shape[0]),
            ("predict layout", None, None, choose_group_bn(
                8192, 1000, 784, bkn=8, itemsize=4))):
        if rows is None:
            perm, b2c = group_by_cluster_device(distance_argmin(q, c)[0],
                                                1000, bn)
            rows = q[perm.clamp(min=0).long()].contiguous()
        nb = b2c.shape[0]
        skip = torch.zeros(nb, dtype=torch.int32, device=dev)
        zi = torch.zeros(nb * bn, dtype=torch.int32, device=dev)
        zf = torch.zeros(nb * bn, device=dev)
        k1_args[label] = ((rows, ctab, csqtab, cidx,
                           b2c.clamp(min=0).to(torch.int32).contiguous(),
                           skip, zi, zf, zf), bn)

    def k5():
        return time_ms(lambda: distance_argmin(x, c), torch, reps=20)

    def k3():
        return {label: time_ms(lambda: segmented_scan(*v, bn=32), torch,
                               reps=20) for label, v in layouts.items()}

    def k1():
        return {label: time_ms(lambda: candidate_assign_tiled(
            *args, bn=bn, bkn=8), torch, reps=20)
            for label, (args, bn) in k1_args.items()}

    def rounding():
        return {"exact_sqnorm (x)": time_ms(
                    lambda: exact_round.exact_sqnorm(x), torch, reps=20),
                "exact_cross (8192 x 1000)": time_ms(
                    lambda: exact_round.exact_cross(q, c.T), torch, reps=20),
                "exact_cross (8192 x 63)": time_ms(
                    lambda: exact_round.exact_cross(q, c[:63].T), torch,
                    reps=20)}

    def answers():
        return ([distance_argmin(x, c)]
                + [segmented_scan(*v, bn=32) for v in layouts.values()]
                + [candidate_assign_tiled(*args, bn=bn, bkn=8)
                   for args, bn in k1_args.values()]
                + [(exact_round.exact_sqnorm(x),
                    exact_round.exact_cross(q, c.T))])

    def k2():
        return {"center_sqdist (1000 x 784)": time_ms(
                    lambda: center_sqdist(c), torch, reps=50),
                "device": device_ms(lambda: center_sqdist(c), torch)}

    def k2_answers():
        got = center_sqdist(c)
        return [(got,), (ref.center_sqdist_ref(c), center_knn_graph(c, 30))]

    timers = {"distance_argmin": lambda: {"K5": k5()},
              "segmented_scan": lambda: {"K3": k3()},
              "candidate_assign_tiled": lambda: {"K1": k1()},
              "exact_round": lambda: {"rounding": rounding()},
              "center_sqdist": lambda: {"K2": k2()},
              "segment_sum_blocks": lambda: {"segment_sum_blocks": _ssb_times(
                  torch, time_ms, segment_sum_blocks, ssb_calls)},
              "all": lambda: {"K5": k5(), "K3": k3(), "K1": k1(),
                              "K2": k2(), "rounding": rounding()}}
    out = {}
    if only in (None, "all", "distance_argmin"):
        xd, cd = x.double(), c.double()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            xd @ cd.T
            torch.cuda.synchronize()
        out["cuBLAS f64 GEMM x @ c.T"] = time_ms(lambda: xd @ cd.T, torch)
        out["its kernels"] = sorted({e.key for e in prof.key_averages()
                                     if "gemm" in e.key.lower()})
        del xd, cd
    if only in (None, "all", "candidate_assign_tiled"):
        # what reusing a staged slab across a cluster's consecutive point
        # blocks could save: the share of blocks that name the previous
        # block's slab
        out["K1 blocks on the previous block's slab"] = {
            label: float((a[4][1:] == a[4][:-1]).float().mean())
            for label, (a, _) in k1_args.items()}
    if only == "center_sqdist":
        got, (want_k2, graph_k2) = k2_answers()
        out["K2 bit-equal to its plain version"] = bool(
            torch.equal(got[0], want_k2))
        out["K2 graph equal to the CPU's"] = bool(torch.equal(
            center_knn_graph(c.cpu(), 30), graph_k2.cpu()))
    ssb_calls = None
    if only == "segment_sum_blocks":
        ssb_calls, facts = _ssb_record(torch, fit, engine, x)
        out["segment_sum_blocks in one fit"] = facts
        out["segment_sum_blocks profiler split"] = _ssb_split(
            torch, profile, ProfilerActivity, segment_sum_blocks, ssb_calls)
        out["segment_sum_blocks ptxas"] = [
            ln.strip() for ln in _build.build_log("segment_sum").splitlines()
            if "registers" in ln or "spill" in ln]
        same = all(
            all(torch.equal(g, w) for g, w in zip(
                segment_sum_blocks(*a, **kw),
                ref.segment_sum_blocks_ref(*a, **kw)))
            for a, kw in ssb_calls.values())
        out["segment_sum_blocks bit-equal to its plain version"] = same
        if "arena" in ssb_calls:
            out["segment_sum_blocks by segment order"] = _ssb_order(
                torch, segment_sum_blocks, ssb_calls["arena"])
    if only == "center_sqdist":
        out["K2 ptxas"] = [
            ln.strip() for ln in _build.build_log("center_knn").splitlines()
            if "registers" in ln or "spill" in ln]
    out.update(timers[only or "all"]())
    if only == "center_sqdist":
        answers = k2_answers
    elif only == "segment_sum_blocks":
        def answers():
            return [segment_sum_blocks(*a, **kw)
                    for a, kw in ssb_calls.values()]
    return _finish(torch, _build, args, out, timers, answers)


def _finish(torch, _build, args, out, timers, answers) -> int:
    """Time the variants of the kernel ``--only`` names against the
    sources as they are (none with ``--root``), print, and return 0."""
    only = args.only
    variants = VARIANTS
    if args.root is not None:         # only where the checkout still
        variants = {                  # holds the kernel they were written for
            key: subs for key, subs in ROOT_VARIANTS.items()
            if (_build.CSRC / key[1]).is_file() and all(
                old in (_build.CSRC / key[1]).read_text() for old in subs)}
    takes = {n for n, _, _ in variants}
    if args.root is None:
        takes |= {None, "all"}
    if only not in takes:
        for key, val in out.items():
            print(f"{key}: {val}")
        print(json.dumps(out))
        return 0
    want = answers()
    orig = _build.CSRC, _build.BUILD_DIR
    try:
        for (name, fname, label), subs in variants.items():
            if only is not None and name != only:
                continue
            vdir = ROOT / "build" / "probe" / f"{name}-{len(out)}"
            shutil.rmtree(vdir, ignore_errors=True)
            shutil.copytree(orig[0], vdir)
            src = vdir / fname
            text = src.read_text()
            for old, new in subs.items():
                if old not in text:
                    raise RuntimeError(f"{fname}: '{label}' no longer "
                                       f"matches the source")
                text = text.replace(old, new)
            src.write_text(text)
            _use_sources(_build, vdir, vdir / "build")
            out[f"{name}: {label}"] = timers[name]()
            print(f"{name}: {label}: {out[f'{name}: {label}']}",
                  file=sys.stderr, flush=True)
            if name in _REPLAYED:
                out[f"{name}: {label}: ptxas"] = [
                    ln.strip() for ln in (vdir / "build" /
                                          f"{_REPLAYED_LIB[name]}.log")
                    .read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
            if label.startswith("exact"):
                same = all(torch.equal(g, w) for gs, ws in
                           zip(answers(), want) for g, w in zip(gs, ws))
                out[f"{name}: {label}: bit-equal"] = same
                if not same:
                    print(f"probe_kernels: {label} changed an answer",
                          file=sys.stderr)
                    return 1
            if only == "center_sqdist":
                out[f"{name}: {label}: ptxas"] = [
                    ln.strip() for ln in (vdir / "build" / "center_knn.log")
                    .read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
    finally:
        _use_sources(_build, *orig)
    # the sources as they are, timed again after the variants: the card's
    # clocks drift over a call, so compare a variant with both
    out["again, the sources as they are"] = timers[only or "all"]()
    for key, val in out.items():
        print(f"{key}: {val}")
    print(json.dumps(out))
    return 0


def _int8_predict(torch, dev):
    """K4 at chip_smoke.py's first int8 predict batch: the same rows, fit
    and model (deterministic from the seeds), grouped at bn=8. Returns
    (facts, timer, answers): the timer gives CUDA events over back-to-back
    calls and the profiler's device time per call."""
    from chip_smoke import (BATCH, BKN, D, K, KN, MAX_ITERS, N, NQ, SEED,
                            TRUE_K, device_ms, k4_inputs, time_ms)
    from repro_torch.core import KMeansModel, fit
    from repro_torch.core.model import _RESOLVE_RERANK as rerank
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.candidate_assign import \
        candidate_assign_int8_tiled
    allx = gmm_blobs(N + NQ, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    x, queries = allx[:N], allx[N:]
    res = fit(x, K, method="k2means", init="gdi", kn=KN,
              max_iters=MAX_ITERS, device=dev,
              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    model = KMeansModel.from_result(res, x, kn=KN, device=dev)
    args, bn, (b_ms, b_by) = k4_inputs(torch, model, queries[:BATCH])
    del allx, x, res

    def kern():
        return candidate_assign_int8_tiled(*args, bn=bn, bkn=BKN, r=rerank)
    skip, rowsel = args[-1], args[-2]
    live = skip == 0
    same = all(bool(torch.equal(g, w)) for g, w in zip(
        kern(), ref.candidate_assign_int8_tiled_ref(*args, bn, rerank)))
    out = {"K4 layout": dict(
        bn=bn, kn_pad=int(args[4].shape[1]), d=int(args[0].shape[1]),
        r=rerank, blocks=int(skip.numel()), live_blocks=int(live.sum()),
        distinct_slabs=int(torch.unique(rowsel[live]).numel()),
        on_previous_blocks_slab=float(
            (rowsel[1:] == rowsel[:-1]).float().mean()),
        bound_ms=b_ms, bound_by=b_by),
        "K4 bit-equal to its plain version": same,
        "K4 ptxas": [ln.strip() for ln in _build.build_log(
            "candidate_assign_int8").splitlines()
            if "registers" in ln or "spill" in ln]}

    def timer():
        return {"events": time_ms(kern, torch, reps=50),
                "device": device_ms(kern, torch, reps=50)}
    return out, timer, lambda: [kern()]


def _decode_step(torch, dev):
    """K6 at chip_smoke.py's phase-2e decode step: ``serve.run`` at the
    same config and seed, then layer 0's tables, query and selection.
    Returns (facts, timer, answers): the timer gives CUDA events and the
    profiler's device time per call with the L2 cache flushed before
    each call, and the device time with it warm."""
    import dataclasses
    from chip_smoke import (LM_ARCH, LM_BATCH, LM_DECODE, LM_FOLD,
                            LM_LAYERS, LM_PROMPT, SEED, device_ms, k6_inputs,
                            time_ms_cold)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cluster_attend import cluster_attend_partial
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                  decode_len=LM_DECODE, fold_every=LM_FOLD, device=dev,
                  seed=SEED, echo=lambda line: None)
    qf, kt, vt, sel, sizes = k6_inputs(torch, dict(r, cfg=cfg))
    del r

    def kern():
        return cluster_attend_partial(qf, kt, vt, sel, sizes=sizes)
    first, again = kern(), kern()
    n = sizes.long()[sel.long()]
    plain = ref.cluster_attend_ref(qf, kt, vt, sel, sizes=sizes)
    out = {"K6 inputs": dict(
        rows=int(qf.shape[0]), p=int(sel.shape[1]), cap=int(kt.shape[1]),
        dh=int(kt.shape[2]), table=str(kt.dtype),
        live_rows_per_query_row=float(n.sum(1).float().mean()),
        largest_block=int(n.max()),
        distinct_live_rows=int(sizes.long()[torch.unique(sel.long())]
                               .sum())),
        "K6 two launches bit-identical": all(
            bool(torch.equal(a, b)) for a, b in zip(first, again)),
        "K6 against an f64 softmax": _k6_f64_error(torch, first, qf, kt,
                                                   vt, sel, sizes),
        "K6 plain version against an f64 softmax": _k6_f64_error(
            torch, plain, qf, kt, vt, sel, sizes),
        "K6 ptxas": [ln.strip() for ln in _build.build_log(
            "cluster_attend").splitlines()
            if "registers" in ln or "spill" in ln]}

    def timer():
        return {"events, L2 flushed": time_ms_cold(kern, torch, reps=20),
                "device, L2 flushed": device_ms(kern, torch, flush=True),
                "device, L2 warm": device_ms(kern, torch)}
    return out, timer, lambda: [kern()]


def _k6_f64_error(torch, state, qf, kt, vt, sel, sizes) -> dict:
    """How far a K6 state (m, l, acc) lies from the same softmax taken in
    f64 over the same live rows: the largest |m - m64|, the largest
    relative error of l rescaled to m64, and the largest error of the
    output acc / l over the row's largest |output| in f64."""
    m, l, acc = (x.double() for x in state)
    s = sel.long()
    cap, dh = kt.shape[1], kt.shape[2]
    ok = torch.arange(cap, device=qf.device) < sizes.long()[s][..., None]
    lg = torch.einsum("nd,npcd->npc", qf.double(), kt[s].double()) \
        * dh ** -0.5
    lg = torch.where(ok, lg, -torch.inf).reshape(qf.shape[0], -1)
    m64 = torch.amax(lg, dim=-1)
    live = torch.isfinite(m64)
    w = torch.where(torch.isfinite(lg), torch.exp(lg - torch.where(
        live, m64, 0.0)[:, None]), 0.0)
    l64 = w.sum(-1)
    o64 = torch.einsum("nm,nmd->nd", w, vt[s].double().reshape(
        qf.shape[0], -1, dh)) / l64.clamp(min=1e-300)[:, None]
    o = acc / l.clamp(min=1e-300)[:, None]
    scale = o64[live].abs().amax(-1)
    return dict(
        rows=int(live.sum()),
        max_abs_m=float((m - m64)[live].abs().max()),
        max_rel_l=float(((l * torch.exp(m - m64))[live] / l64[live] - 1)
                        .abs().max()),
        max_rel_out=float(((o - o64)[live].abs().amax(-1) / scale).max()),
        mean_rel_out=float(((o - o64)[live].abs().amax(-1) / scale).mean()))


def _assign_bench(torch, dev):
    """K7 at chip_smoke.py's phase 2d: the same rows and fit
    (deterministic from the seeds), the resident arena over the final
    centers, the lists ``graph[rowsel]``, no block skipped. Returns
    (facts, timer, answers): the timer gives CUDA events over
    back-to-back calls and the profiler's device time per call, of K7
    and of K1 on the same lists."""
    from chip_smoke import (D, K, KN, MAX_ITERS, N, NQ, SEED, TRUE_K,
                            device_ms, k7_inputs, time_ms)
    from repro_torch.core import fit
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.candidate_assign import (
        candidate_assign_rowwise, candidate_assign_tiled)
    x = gmm_blobs(N + NQ, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)[:N]
    res = fit(x, K, method="k2means", init="gdi", kn=KN,
              max_iters=MAX_ITERS, device=dev,
              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    args1, args7, bn, (b_ms, b_by) = k7_inputs(
        torch, x, res.centers.contiguous(), res.assignment)
    del x, res

    def kern():
        return candidate_assign_rowwise(*args7, bn=bn)

    def k1():
        return candidate_assign_tiled(*args1, bn=bn, bkn=8)
    got, tiled = kern(), k1()
    out = {"K7 layout": dict(
        rows=int(args7[0].shape[0]), bn=bn, blocks=int(args7[2].shape[0]),
        kn=int(args7[2].shape[1]), d=int(args7[0].shape[1]),
        distinct_center_rows=int(torch.unique(args7[2]).numel()),
        bound_ms=b_ms, bound_by=b_by),
        "K7 bit-equal to its plain version": all(
            bool(torch.equal(g, w)) for g, w in zip(
                got, ref.candidate_assign_ref(*args7, bn))),
        "K7 equal to K1 on the same lists": bool(
            torch.equal(got[0], tiled[0]) and torch.equal(got[1], tiled[1])),
        "K7 ptxas": [ln.strip() for ln in _build.build_log(
            "candidate_assign_rowwise").splitlines()
            if "registers" in ln or "spill" in ln]}

    def timer():
        return {"events": time_ms(kern, torch, reps=50),
                "device": device_ms(kern, torch, reps=50),
                "K1 device, same lists": device_ms(k1, torch, reps=50)}
    return out, timer, lambda: [kern()]


# kernels timed on inputs that replay chip_smoke.py's own
_REPLAYED = {"candidate_assign_int8_tiled": _int8_predict,
             "cluster_attend": _decode_step,
             "candidate_assign_rowwise": _assign_bench}
_REPLAYED_LIB = {"candidate_assign_int8_tiled": "candidate_assign_int8",
                 "cluster_attend": "cluster_attend",
                 "candidate_assign_rowwise": "candidate_assign_rowwise"}


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _ssb_record(torch, fit, engine, x):
    """The main path's calls of ``segment_sum_blocks``: one
    ``fit(init="gdi", method="k2means")`` at chip_smoke's shape with the
    engine's calls recorded. Returns ({label: (args, kwargs)} for the
    arena's first call and for the delta call with the most moved rows,
    and the facts: calls per fit of each kind, segments and their
    lengths in slots)."""
    calls = []
    orig = engine.segment_sum_blocks

    def record(xx, b2s, k, bn, *, w=None, perm=None):
        calls.append(((xx.clone(), b2s.clone(), k, bn),
                      dict(w=None if w is None else w.clone(),
                           perm=None if perm is None else perm.clone())))
        return orig(xx, b2s, k, bn, w=w, perm=perm)
    engine.segment_sum_blocks = record
    try:
        dev = x.device
        fit(x, 1000, method="k2means", init="gdi", kn=30, max_iters=30,
            device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    finally:
        engine.segment_sum_blocks = orig
    full = [c for c in calls if c[0][3] > 1]
    delta = [c for c in calls if c[0][3] == 1]

    def lengths(call):
        (_, b2s, k, bn), kw = call
        seg = torch.repeat_interleave(b2s.long(), bn)
        live = seg >= 0
        if kw["perm"] is not None:
            live &= kw["perm"] >= 0
        n = torch.bincount(seg[live], minlength=k)
        n = n[n > 0].float()
        return dict(segments=k, nonempty=int(n.numel()),
                    slots=int(b2s.numel()) * bn,
                    median_slots=float(n.median()) if n.numel() else 0.0,
                    max_slots=float(n.max()) if n.numel() else 0.0)
    facts = dict(full_calls=len(full), delta_calls=len(delta),
                 arena=lengths(full[0]) if full else None,
                 deltas=[lengths(c) for c in delta])
    picked = {}
    if full:
        picked["arena"] = full[0]
    if delta:
        picked["delta (most moved rows)"] = max(
            delta, key=lambda c: lengths(c)["nonempty"])
    return picked, facts


def _ssb_split(torch, profile, activity, segment_sum_blocks, calls,
               reps: int = 20):
    """Each recorded call replayed ``reps`` times under the profiler: its
    device time per call, split among the sort and ``searchsorted`` of
    the block list, the sum kernel and the rest (fills, copies)."""
    out = {}
    for label, (a, kw) in calls.items():
        segment_sum_blocks(*a, **kw)
        torch.cuda.synchronize()
        with profile(activities=[activity.CUDA]) as prof:
            for _ in range(reps):
                segment_sum_blocks(*a, **kw)
            torch.cuda.synchronize()
        split = {"sort": 0.0, "searchsorted": 0.0, "sum kernel": 0.0,
                 "other": 0.0}
        names = {}
        for e in prof.key_averages():
            us = _dev_us(e)
            if us <= 0:
                continue
            key = e.key.lower()
            part = ("searchsorted" if "searchsorted" in key else
                    "sort" if "sort" in key else
                    "sum kernel" if "segment_sum" in key or "seg_sum" in key
                    else "other")
            split[part] += us / 1e3 / reps
            names[e.key[:70]] = round(us / 1e3 / reps, 5)
        split["total"] = sum(split.values())
        split["kernels"] = names
        out[label] = split
    return out


def _ssb_order(torch, segment_sum_blocks, call):
    """Does the order in which the kernel takes its segments matter? The
    arena's call is replayed with its blocks regrouped so that segments
    come in the block list as the layout has them, longest first, or
    shortest first (each segment keeps its blocks' order, so its sums
    keep their bits: checked), and with the longest segment alone. The
    kernel lists the segments about in the order of their first blocks
    (one thread a block appends with an atomic), and its persistent
    blocks take the listed items in turn. Device ms per call."""
    from chip_smoke import device_ms
    (xx, b2s, k, bn), kw = call
    dev, nb = b2s.device, b2s.numel()
    seg = b2s.long()
    live = (seg >= 0) & (seg < k)
    idx = torch.arange(nb, device=dev)
    nblk = torch.bincount(seg[live], minlength=k)
    firstb = torch.full((k,), nb, dtype=torch.long, device=dev).scatter_reduce(
        0, seg[live], idx[live], "amin")
    want = segment_sum_blocks(*call[0], **kw)

    def regroup(order):
        rank = torch.full((k + 1,), k, dtype=torch.long, device=dev)
        rank[order] = torch.arange(k, device=dev)
        blocks = torch.sort(rank[torch.where(live, seg, k)],
                            stable=True).indices
        kk = {n: None if v is None else
              v.view(nb, bn)[blocks].reshape(-1).contiguous()
              for n, v in kw.items()}
        x2 = xx
        if kw.get("perm") is None:     # slot s reads row s: move the rows
            x2 = xx.view(nb, bn, -1)[blocks].reshape(nb * bn, -1)
        return (x2.contiguous(), b2s[blocks].contiguous(), k, bn), kk

    out = dict(longest_blocks=int(nblk.max()), median_blocks=float(
        nblk[nblk > 0].float().median()))
    for label, order in (
            ("as laid out", torch.argsort(firstb, stable=True)),
            ("longest first", torch.argsort(-nblk, stable=True)),
            ("shortest first", torch.argsort(nblk, stable=True))):
        a, kw2 = regroup(order)
        got = segment_sum_blocks(*a, **kw2)
        out[label + ": bit-equal"] = all(
            torch.equal(g, w) for g, w in zip(got, want))
        out[label] = device_ms(lambda: segment_sum_blocks(*a, **kw2), torch)
    top = int(torch.argmax(nblk))
    alone = torch.where(seg == top, b2s, torch.full_like(b2s, -1))
    got = segment_sum_blocks(xx, alone, k, bn, **kw)
    out["longest alone: bit-equal"] = bool(
        torch.equal(got[0][top], want[0][top])
        and torch.equal(got[1][top], want[1][top]))
    out["longest alone"] = device_ms(
        lambda: segment_sum_blocks(xx, alone, k, bn, **kw), torch)
    return out


def _ssb_times(torch, time_ms, segment_sum_blocks, calls):
    from chip_smoke import device_ms
    out = {}
    for label, (a, kw) in calls.items():
        def fn():
            return segment_sum_blocks(*a, **kw)
        out[label] = time_ms(fn, torch, reps=50)
        out[label + ", device"] = device_ms(fn, torch)
    return out


if __name__ == "__main__":
    sys.exit(main())
