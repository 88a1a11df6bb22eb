#!/usr/bin/env python3
"""Time the rounding kernels of the main path on one CUDA card at
chip_smoke.py's shapes (n=60000, d=784, k=1000), for one checkout:

- GDI's split-score norms over one sweep's layout (K3's prefix sums of
  the rows grouped by the GDI init's 1,000 leaves, R = 92,000 rows): the
  two-call form (``exact_sqnorm`` of the prefixes, the (R, d) suffix
  ``tot[row_seg] - csum``, ``exact_sqnorm`` of it), each step and the
  whole span of the sweep's score lines, and, where the checkout has it,
  the one-pass ``exact_split_sqnorms`` and its span; with the span's peak
  device memory above what it starts from;
- ``exact_sqnorm`` of the 1000 x 784 centers alone;
- ``exact_cross`` of a predict batch (8192 x 784) with the 1000 centers
  and with 63 of them (the router's width), and ``quant.sqdist_exact``,
  the call predict makes, at both shapes.

Each is timed by ``torch.profiler`` (the device time of the kernels and
copies it launched, per call, and their names) and by CUDA events around
back-to-back calls (``chip_smoke.time_ms``). Run from the root of a
checkout on a machine with one CUDA card; to time another checkout (say a
parent's, unpacked with ``git archive``), name its root:

    python3 scripts/probe_rounding.py [--root PATH] [--label NAME]

The last line is one JSON object of the measurements.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
N, D, K, TRUE_K, BATCH, ROUTER = 60000, 784, 1000, 128, 8192, 63


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        print("probe_rounding: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import time_ms
    from repro_torch.core import OpCounter, initialize
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build, exact_round, quant
    from repro_torch.kernels.ops import (choose_group_bn,
                                         group_by_cluster_device)
    from repro_torch.kernels.segmented_scan import segmented_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    _build.build_all()
    dev = torch.device("cuda")
    allx = gmm_blobs(N + BATCH, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    x, q = allx[:N], allx[N:].contiguous()
    _, a0 = initialize(x, K, "gdi", torch.Generator(device=dev)
                       .manual_seed(1), OpCounter())
    bn = choose_group_bn(N, K, D)
    perm, b2s = group_by_cluster_device(a0, K, bn)
    xg = x[perm.clamp(min=0).long()].contiguous()
    w = (perm >= 0).to(torch.float32)
    csum, qsum, cnt = segmented_scan(xg, w, b2s, bn=bn)
    r = csum.shape[0]
    row_seg = torch.repeat_interleave(b2s.long(), bn)
    last = torch.full((K,), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, row_seg, torch.arange(r, device=dev), "amax")
    has, at = last >= 0, last.clamp(min=0)
    tot_s = torch.where(has[:, None], csum[at], 0.0)
    tot_q = torch.where(has, qsum[at], 0.0)
    tot_c = torch.where(has, cnt[at], 0.0)
    rem = tot_c[row_seg] - cnt
    del xg

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    def measure(fn, reps=args.reps):
        """(profiler device ms per call, {kernel: launches per call},
        CUDA-event ms per call, peak MiB above the start)."""
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_dev = [e for e in prof.key_averages()
                  if "CUDA" in str(getattr(e, "device_type", ""))]
        return dict(device_ms=sum(dev_us(e) for e in on_dev) / 1e3 / reps,
                    kernels={e.key[:60]: e.count / reps for e in on_dev},
                    event_ms=time_ms(fn, torch, reps=reps),
                    peak_mib=peak)

    def two_calls():
        phi_p = qsum - exact_round.exact_sqnorm(csum) \
            / torch.clamp(cnt, min=1.0)
        sfx = tot_s[row_seg] - csum
        phi_s = (tot_q[row_seg] - qsum) \
            - exact_round.exact_sqnorm(sfx) / torch.clamp(rem, min=1.0)
        return phi_p, phi_s

    sfx = tot_s[row_seg] - csum
    out = dict(label=args.label, rows=r, d=D, leaves=K, split={})
    split = out["split"]
    split["exact_sqnorm(csum)"] = measure(
        lambda: exact_round.exact_sqnorm(csum))
    split["sfx = tot[row_seg] - csum"] = measure(
        lambda: tot_s[row_seg] - csum)
    split["exact_sqnorm(sfx)"] = measure(lambda: exact_round.exact_sqnorm(sfx))
    del sfx
    split["span, two calls"] = measure(two_calls)
    if hasattr(exact_round, "exact_split_sqnorms"):
        def one_pass():
            sq_p, sq_s = exact_round.exact_split_sqnorms(csum, tot_s,
                                                         row_seg)
            return (qsum - sq_p / torch.clamp(cnt, min=1.0),
                    (tot_q[row_seg] - qsum)
                    - sq_s / torch.clamp(rem, min=1.0))
        split["exact_split_sqnorms"] = measure(
            lambda: exact_round.exact_split_sqnorms(csum, tot_s, row_seg))
        split["span, one pass"] = measure(one_pass)
        same = all(bool(torch.equal(a, b))
                   for a, b in zip(one_pass(), two_calls()))
        print(f"  one pass = two calls, bit for bit: {same}")
        out["one_pass_equals_two_calls"] = same
    del csum, qsum, cnt, row_seg, rem

    c = x[torch.randperm(N, generator=torch.Generator(device=dev)
                         .manual_seed(5), device=dev)[:K]].contiguous()
    out["exact_sqnorm(1000 x 784)"] = measure(
        lambda: exact_round.exact_sqnorm(c))
    cross = out["cross"] = {}
    for kk in (K, ROUTER):
        ck = c[:kk].contiguous()
        cross[f"exact_cross {BATCH}x{D} by {D}x{kk}"] = measure(
            lambda: exact_round.exact_cross(q, ck.T))
        cross[f"quant.sqdist_exact {BATCH}x{D} by {kk}x{D}"] = measure(
            lambda: quant.sqdist_exact(q, ck))

    print(f"{args.label}:")
    for group in (split, cross):
        for name, m in group.items():
            print(f"  {name}: device {m['device_ms']:.4f} ms, events "
                  f"{m['event_ms']:.4f} ms, peak +{m['peak_mib']:.1f} MiB, "
                  f"kernels {m['kernels']}")
    m = out["exact_sqnorm(1000 x 784)"]
    print(f"  exact_sqnorm(1000 x 784): device {m['device_ms']:.4f} ms, "
          f"events {m['event_ms']:.4f} ms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
