#!/usr/bin/env python3
"""Time the fit's two stages on one CUDA card at chip_smoke.py's shapes
(n=60000, d=784, k=1000, k_n=30), for one checkout of the repository:

- GDI (``initialize(..., "gdi")``) three times, then once under
  ``torch.profiler``: its device busy time and its kernels by device time;
- k²-means (``fit_k2means``) three times from one shared init: 1000
  random rows as centers, each row assigned to its nearest by K5, so two
  checkouts start from the same state: ms per iteration (the fit's wall
  time over its iterations), iterations and energy.

Run from the root of a checkout on a machine with one CUDA card; to time
another checkout (say a parent's, unpacked with ``git archive``), name
its root:

    python3 scripts/probe_fit.py [--root PATH] [--label NAME]

The last line is one JSON object of the measurements.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

N, D, K, KN, TRUE_K = 60000, 784, 1000, 30, 128


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__)
                                          .resolve().parents[1]))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_fit: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import OpCounter, fit_k2means, initialize
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build
    from repro_torch.kernels.distance_argmin import distance_argmin

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    _build.build_all()
    dev = torch.device("cuda")
    x = gmm_blobs(N, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)

    def gdi():
        return initialize(x, K, "gdi", torch.Generator(
            device=dev).manual_seed(1), OpCounter())
    gdi()
    torch.cuda.synchronize()
    gdi_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        gdi()
        torch.cuda.synchronize()
        gdi_s.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gdi()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",   # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    on_dev = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = [(e.key[:80], e.count, dev_us(e) / 1e3)
           for e in sorted(on_dev, key=dev_us, reverse=True)[:8]]

    gen = torch.Generator(device=dev).manual_seed(5)
    c0 = x[torch.randperm(N, generator=gen, device=dev)[:K]].contiguous()
    a0, _ = distance_argmin(x, c0)
    fit_k2means(x, c0, a0, kn=KN, max_iters=3, device=dev)
    torch.cuda.synchronize()
    fits = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = fit_k2means(x, c0, a0, kn=KN, max_iters=30, device=dev)
        torch.cuda.synchronize()
        fits.append(dict(ms_per_iteration=(time.perf_counter() - t0)
                         / r.iterations * 1e3,
                         iterations=r.iterations, energy=r.energy))
    out = dict(label=args.label, gdi_s=gdi_s, gdi_device_busy_ms=busy_ms,
               gdi_top_kernels=top, k2means_from_a_shared_init=fits)
    print(f"{args.label}: GDI {[round(s, 4) for s in gdi_s]} s (device busy "
          f"{busy_ms:.1f} ms); k2-means ms/iteration "
          f"{[round(f['ms_per_iteration'], 3) for f in fits]}")
    for name, count, ms in top:
        print(f"  {ms:9.3f} ms x{count:<5d} {name}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
