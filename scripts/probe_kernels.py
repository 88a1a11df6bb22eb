#!/usr/bin/env python3
"""Probe what bounds K1 (candidate_assign_tiled), K2 (center_sqdist), K3
(segmented_scan), K5 (distance_argmin), the rounding kernels
(exact_round: exact_cross at a predict batch's 8192 x 1000 and 8192 x
63) and the engine's ordered center sums (segment_sum_blocks) on one
CUDA card, at chip_smoke.py's shapes (n=60000, d=784, k=1000; bn=32; K1
also at the predict layout, bn=8), and what the correct rounding's tiers
cost.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/probe_kernels.py [--only KERNEL] [--root PATH]

``--only`` times one kernel and its variants (``distance_argmin``,
``segmented_scan``, ``candidate_assign_tiled``, ``exact_round``,
``center_sqdist``, ``segment_sum_blocks`` or ``all``). ``--root`` imports
the kernels of another checkout (say a parent's, unpacked with ``git
archive``) and times them without variants.

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

    from chip_smoke import time_ms
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
                "device": _device_ms(torch, profile, ProfilerActivity,
                                     lambda: center_sqdist(c))}

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
                torch, profile, ProfilerActivity, segment_sum_blocks,
                ssb_calls["arena"])
    if only == "center_sqdist":
        out["K2 ptxas"] = [
            ln.strip() for ln in _build.build_log("center_knn").splitlines()
            if "registers" in ln or "spill" in ln]
    out.update(timers[only or "all"]())
    if args.root is not None or only not in (
            {None, "all"} | {n for n, _, _ in VARIANTS}):
        for key, val in out.items():
            print(f"{key}: {val}")
        print(json.dumps(out))
        return 0
    if only == "center_sqdist":
        answers = k2_answers
    elif only == "segment_sum_blocks":
        def answers():
            return [segment_sum_blocks(*a, **kw)
                    for a, kw in ssb_calls.values()]
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


def _device_ms(torch, profile, activity, fn, reps: int = 20) -> float:
    """The profiler's device time of ``fn`` per call, over ``reps``
    calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[activity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_dev_us(e) for e in prof.key_averages()) / 1e3 / reps


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


def _ssb_order(torch, profile, activity, segment_sum_blocks, call):
    """Does the order in which the kernel takes its segments matter? The
    arena's call is replayed with its blocks regrouped so that segments
    come in the block list as the layout has them, longest first, or
    shortest first (each segment keeps its blocks' order, so its sums
    keep their bits: checked), and with the longest segment alone. The
    kernel lists the segments about in the order of their first blocks
    (one thread a block appends with an atomic), and its persistent
    blocks take the listed items in turn. Device ms per call."""
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
        out[label] = _device_ms(torch, profile, activity,
                                lambda: segment_sum_blocks(*a, **kw2))
    top = int(torch.argmax(nblk))
    alone = torch.where(seg == top, b2s, torch.full_like(b2s, -1))
    got = segment_sum_blocks(xx, alone, k, bn, **kw)
    out["longest alone: bit-equal"] = bool(
        torch.equal(got[0][top], want[0][top])
        and torch.equal(got[1][top], want[1][top]))
    out["longest alone"] = _device_ms(
        torch, profile, activity,
        lambda: segment_sum_blocks(xx, alone, k, bn, **kw))
    return out


def _ssb_times(torch, time_ms, segment_sum_blocks, calls):
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, (a, kw) in calls.items():
        def fn():
            return segment_sum_blocks(*a, **kw)
        out[label] = time_ms(fn, torch, reps=50)
        out[label + ", device"] = _device_ms(torch, profile,
                                             ProfilerActivity, fn)
    return out


if __name__ == "__main__":
    sys.exit(main())
