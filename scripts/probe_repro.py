#!/usr/bin/env python3
"""Count, on one CUDA card, how often the port's values depend on the
order of a sum, at chip_smoke.py's shapes (n=60000, d=784, k=1000,
k_n=30):

- K1, K5 and K7 against their plain versions over many seeds: each seed
  draws the GMM rows, takes 1000 random rows as centers, assigns every
  row to its nearest one and moves each center to its members' mean,
  then runs K5 on the rows and those centers, and K1 and K7 over the
  resident arena built from that assignment (no block skipped, the
  centers' k_n-NN lists): rows whose outputs differ, counted per kernel;
- K3 launched several times on the same inputs (the seed's leaf-grouped
  layout, and one segment over every block): launches whose outputs are
  not bit-equal to the first;
- the whole fit (``fit(..., init="gdi")``) several times on seed 0's rows
  from one generator seed: runs whose assignments, centers, energy or
  iteration count differ from the first;
- with ``--deterministic``, one more fit under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
  torch operations it warns about.

Run from the root of the repository on a machine with one CUDA card:

    python3 scripts/probe_repro.py [--seeds 64] [--fits 3] [--deterministic]

The last line is one JSON object of the counts.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N, D, K, KN, TRUE_K, BKN = 60000, 784, 1000, 30, 128, 8


def _differ(got, want) -> int:
    """Rows at which any output of a kernel differs from its plain
    version's (outputs are per-row tensors of one length)."""
    bad = None
    for g, w in zip(got, want):
        ne = g != w
        bad = ne if bad is None else bad | ne
    return int(bad.sum())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--k3-launches", type=int, default=5)
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_repro: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import K2Step, center_knn_graph, fit
    from repro_torch.core.lloyd import update_centers
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.candidate_assign import (
        candidate_assign_rowwise, candidate_assign_tiled, candidate_tables,
        pad_candidates)
    from repro_torch.kernels.distance_argmin import distance_argmin
    from repro_torch.kernels.ops import group_by_cluster_device
    from repro_torch.kernels.segmented_scan import segmented_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    _build.build_all()
    dev = torch.device("cuda")
    out = {"seeds": args.seeds, "rows_per_seed": {"K5": N}}
    miss = {"K1": 0, "K5": 0, "K7": 0}
    seeds_hit = {"K1": 0, "K5": 0, "K7": 0}
    k3_bad = {"launches": 0, "elements": 0, "of": 0}
    t0 = time.perf_counter()
    for s in range(args.seeds):
        gen = torch.Generator(device=dev).manual_seed(1000 + s)
        x = gmm_blobs(N, D, TRUE_K, generator=gen, device=dev)
        c = x[torch.randperm(N, generator=gen, device=dev)[:K]].contiguous()
        a, _ = distance_argmin(x, c)
        c = update_centers(x, a, c).contiguous()
        counts = {}
        counts["K5"] = _differ(distance_argmin(x, c),
                               ref.distance_argmin_ref(x, c))
        a, _ = distance_argmin(x, c)
        st = K2Step(k=K, kn=KN, bkn=BKN).init_resident(
            x, torch.ones(N, device=dev), c, a)
        nb = st.b2c.shape[0]
        bn = st.pid.shape[0] // nb
        graph = center_knn_graph(c, KN)
        cidx = pad_candidates(graph, BKN).contiguous()
        ctab, csqtab = candidate_tables(c, cidx)
        rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
        cand = graph[rowsel.long()].contiguous()
        rows = st.pid.shape[0]
        zi = torch.zeros(rows, dtype=torch.int32, device=dev)
        zf = torch.zeros(rows, device=dev)
        noskip = torch.zeros(nb, dtype=torch.int32, device=dev)
        args1 = (st.xg, ctab, csqtab, cidx, rowsel, noskip, zi, zf, zf)
        counts["K1"] = _differ(candidate_assign_tiled(*args1, bn=bn, bkn=BKN),
                               ref.candidate_assign_tiled_ref(*args1, bn))
        args7 = (st.xg, c, cand, noskip, zi, zf)
        counts["K7"] = _differ(candidate_assign_rowwise(*args7, bn=bn),
                               ref.candidate_assign_ref(*args7, bn))
        for name, v in counts.items():
            miss[name] += v
            seeds_hit[name] += v > 0
        out["rows_per_seed"].update(K1=rows, K7=rows)
        del st, args1, args7, ctab
        for layout_a, k in ((a, K), (torch.zeros_like(a), 1)):
            perm, b2s = group_by_cluster_device(layout_a, k, bn)
            xg = x[perm.clamp(min=0).long()].contiguous()
            w = (perm >= 0).to(torch.float32)
            first = segmented_scan(xg, w, b2s, bn=bn)
            for _ in range(args.k3_launches - 1):
                again = segmented_scan(xg, w, b2s, bn=bn)
                ne = sum(int((f != g).sum()) for f, g in zip(first, again))
                k3_bad["launches"] += ne > 0
                k3_bad["elements"] += ne
                k3_bad["of"] += 1
        if s % 8 == 7:
            print(f"  after {s + 1} seeds ({time.perf_counter() - t0:.0f} s):"
                  f" rows differing {miss}, seeds with a difference "
                  f"{seeds_hit}, K3 {k3_bad}", flush=True)
    out.update(rows_differing=miss, seeds_with_a_difference=seeds_hit,
               k3_relaunches_not_bit_equal=k3_bad)

    gen0 = torch.Generator(device=dev).manual_seed(0)
    x = gmm_blobs(N, D, TRUE_K, generator=gen0, device=dev)
    runs = []
    for _ in range(args.fits):
        r = fit(x, K, method="k2means", init="gdi", kn=KN, max_iters=30,
                device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
        runs.append(r)
    base = runs[0]
    fits = []
    for r in runs[1:]:
        fits.append(dict(
            assignments_differing=int((r.assignment != base.assignment)
                                      .sum()),
            centers_bit_equal=bool(torch.equal(r.centers, base.centers)),
            energy=[base.energy, r.energy],
            iterations=[base.iterations, r.iterations]))
    out["fits_against_the_first"] = fits
    out["fits_bit_identical"] = all(
        f["assignments_differing"] == 0 and f["centers_bit_equal"]
        and f["energy"][0] == f["energy"][1]
        and f["iterations"][0] == f["iterations"][1] for f in fits)

    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fit(x, K, method="k2means", init="gdi", kn=KN, max_iters=30,
                device=dev,
                generator=torch.Generator(device=dev).manual_seed(1))
            torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
        out["deterministic_mode_warnings"] = sorted(
            {str(w.message).split("\n")[0][:200] for w in caught})
    for key, val in out.items():
        print(f"{key}: {val}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
