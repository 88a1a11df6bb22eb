#!/usr/bin/env python3
"""Probe what bounds K1 (candidate_assign_tiled), K3 (segmented_scan),
K5 (distance_argmin) and the rounding kernels (exact_round: exact_cross
at a predict batch's 8192 x 1000 and 8192 x 63) on one CUDA card, at
chip_smoke.py's shapes (n=60000, d=784, k=1000; bn=32; K1 also at the
predict layout, bn=8), and what the correct rounding's tiers cost.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/probe_kernels.py [--only KERNEL]

``--only`` keeps the variants of one timed kernel (``distance_argmin``,
``segmented_scan``, ``candidate_assign_tiled``, ``exact_round`` or
``all``).

Each kernel is timed beside variants of its sources built by text
substitution, and K5 beside cuBLAS's f64 GEMM of the same product (with
the names of the kernels cuBLAS runs for it). Some variants give wrong
answers on purpose (MMAs fed constants, f32 values reinterpreted instead
of widened, MMAs dropped, copies or the epilogue left out, K5's screen or
its exact recompute of the pairs the screen flags left out): only their
times mean anything. The variant without the double-double tier of
``common.cuh`` must give the same answers, and is checked bit-equal. A
variant is compiled from a copy of ``src/repro_torch/kernels/csrc`` under
``build/probe/`` and loaded in place of the kernels' libraries; the
script fails when a substitution no longer matches the source. The last
line is one JSON object of the times in ms.
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
    ("all", "common.cuh", "exact: no double-double tier"): {
        "  if (!k2_refine_dot_warp(pair, d, v)) v = k2_exact_dot_warp(pair, "
        "d);": "  v = k2_exact_dot_warp(pair, d);"},
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
    only = ap.parse_args().only
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import time_ms
    from repro_torch.core import K2Step, center_knn_graph
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build, exact_round
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

    timers = {"distance_argmin": lambda: {"K5": k5()},
              "segmented_scan": lambda: {"K3": k3()},
              "candidate_assign_tiled": lambda: {"K1": k1()},
              "exact_round": lambda: {"rounding": rounding()},
              "all": lambda: {"K5": k5(), "K3": k3(), "K1": k1(),
                              "rounding": rounding()}}
    xd, cd = x.double(), c.double()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        xd @ cd.T
        torch.cuda.synchronize()
    out = {"cuBLAS f64 GEMM x @ c.T": time_ms(lambda: xd @ cd.T, torch),
           "its kernels": sorted({e.key for e in prof.key_averages()
                                  if "gemm" in e.key.lower()}),
           "K5": k5(), "K3": k3(), "K1": k1(), "rounding": rounding(),
           # what reusing a staged slab across a cluster's consecutive
           # point blocks could save: the share of blocks that name the
           # previous block's slab
           "K1 blocks on the previous block's slab": {
               label: float((args[4][1:] == args[4][:-1]).float().mean())
               for label, (args, _) in k1_args.items()}}
    want = answers()
    orig = _build.CSRC, _build.BUILD_DIR
    try:
        for (name, fname, label), subs in VARIANTS.items():
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
            if label.startswith("exact"):
                same = all(torch.equal(g, w) for gs, ws in
                           zip(answers(), want) for g, w in zip(gs, ws))
                out[f"{name}: {label}: bit-equal"] = same
                if not same:
                    print(f"probe_kernels: {label} changed an answer",
                          file=sys.stderr)
                    return 1
    finally:
        _use_sources(_build, *orig)
    for key, val in out.items():
        print(f"{key}: {val}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
