#!/usr/bin/env python3
"""Measure two things behind the fit API's host-drawn methods and the
ungrouped xla backend on one CUDA card:

- square roots: torch's f32 ``sqrt`` on the CPU against the card's and
  numpy's (the hardware's, correctly rounded) over 4 million f32 values
  (uniform on [0, 4000) and the integers below 5000, numpy seed 0), and
  over the candidate squared distances of ``data.rounding_fixture``'s
  rows (3,000 × 784, 64 centers, 30 random candidates a row, numpy seed
  6); and ``exact_round.sqrt_rn`` against both;
- MiniBatch at chip_smoke.py's mnist shape (n=60000, d=784, k=1000,
  batch 100, 1000 rows of the mixture as the centers): ms per
  ``minibatch_step`` (host clock over 50 steps ended by a sync), then
  20 steps under ``torch.profiler``: K5's device
  time per call, the device busy time per step and the kernel launches
  per step.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/probe_methods.py

The last line is one JSON object of the measurements.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

N, D, K, BATCH, TRUE_K = 60000, 784, 1000, 100, 128


def main() -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_methods: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import gather_candidate_sqdist
    from repro_torch.core.minibatch import minibatch_step
    from repro_torch.data import gmm_blobs, rounding_fixture
    from repro_torch.kernels import _build
    from repro_torch.kernels.exact_round import sqrt_rn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    _build.build_all()
    dev = torch.device("cuda")
    out = {}

    # --- square roots ---------------------------------------------------
    rng = np.random.RandomState(0)
    v = np.concatenate([rng.rand(2_000_000).astype(np.float32) * 4000,
                        rng.randint(0, 5000, 2_000_000).astype(np.float32)])
    t = torch.from_numpy(v)
    cpu, card = torch.sqrt(t).numpy(), torch.sqrt(t.to(dev)).cpu().numpy()
    rn_cpu, rn_card = sqrt_rn(t).numpy(), sqrt_rn(t.to(dev)).cpu().numpy()
    want = np.sqrt(v)
    out["sqrt_values"] = int(v.size)
    out["sqrt_cpu_differs_from_numpy"] = int((cpu != want).sum())
    out["sqrt_card_differs_from_numpy"] = int((card != want).sum())
    out["sqrt_rn_differs_from_numpy"] = [int((rn_cpu != want).sum()),
                                         int((rn_card != want).sum())]
    x, c, _ = rounding_fixture(3000, 64, 784, seed=5, device="cpu")
    cand = torch.tensor(np.random.RandomState(6).randint(0, 64, (3000, 30)),
                        dtype=torch.int32)
    sq = gather_candidate_sqdist(x, c, cand)
    sq_card = gather_candidate_sqdist(x.to(dev), c.to(dev), cand.to(dev))
    r_cpu, r_card = torch.sqrt(sq), torch.sqrt(sq_card).cpu()
    bad = torch.nonzero(r_cpu != r_card)
    out["fixture_sq_equal"] = bool(torch.equal(sq, sq_card.cpu()))
    out["fixture_roots"] = int(sq.numel())
    out["fixture_roots_differ"] = int(bad.shape[0])
    if bad.shape[0]:
        i, j = bad[0].tolist()
        out["fixture_first"] = [i, j, sq[i, j].item().hex(),
                                r_cpu[i, j].item().hex(),
                                r_card[i, j].item().hex()]
    out["fixture_sqrt_rn_equal"] = bool(torch.equal(
        sqrt_rn(sq), sqrt_rn(sq_card).cpu()))
    print(f"sqrt: torch CPU differs from numpy on "
          f"{out['sqrt_cpu_differs_from_numpy']} of {v.size}, the card on "
          f"{out['sqrt_card_differs_from_numpy']}; sqrt_rn on "
          f"{out['sqrt_rn_differs_from_numpy']}; fixture roots card vs CPU "
          f"{out['fixture_roots_differ']} of {out['fixture_roots']}")

    # --- MiniBatch steps at the mnist shape ------------------------------
    xm = gmm_blobs(N, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    cm, vm = xm[:K].clone(), torch.zeros(K, device=dev)
    g = torch.Generator().manual_seed(1)

    def step(cm, vm):
        idx = torch.randint(0, N, (BATCH,), generator=g).to(dev)
        return minibatch_step(xm[idx], cm, vm)
    for _ in range(5):
        cm, vm = step(cm, vm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        cm, vm = step(cm, vm)
    torch.cuda.synchronize()
    out["minibatch_step_ms"] = (time.perf_counter() - t0) / 50 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            cm, vm = step(cm, vm)
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)
    k5 = [e for e in ev if "distance_argmin" in e.key and dev_us(e) > 0]
    launches = sum(e.count for e in ev if e.key == "cudaLaunchKernel")
    out["minibatch_device_ms_per_step"] = sum(map(dev_us, ev)) / 20 / 1e3
    out["k5_device_ms_per_call"] = (sum(map(dev_us, k5))
                                    / max(sum(e.count for e in k5), 1)
                                    / 1e3)
    out["launches_per_step"] = launches / 20
    print(f"MiniBatch: {out['minibatch_step_ms']:.3f} ms a step (host "
          f"clock), device {out['minibatch_device_ms_per_step']:.3f} ms a "
          f"step, K5 {out['k5_device_ms_per_call']:.4f} ms a call at "
          f"{BATCH} x {K}, {out['launches_per_step']:.1f} launches a step")
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
