#!/usr/bin/env python3
"""Where a DeepSeek-V2-Lite decode step's time goes, on one CUDA card, at
``chip_smoke.py`` phase 2m's shape (2 requests, a 32,833-slot latent
cache, DeepSeek-V2-Lite's widths, random weights from seed 0):

- the pieces of ``mla_decode``'s absorbed attention over the live
  latent (2 x 32,833 x 576): the f32 copy of the live slots, the scores
  as ``bmm(q, liveᵀ)`` (the port's operand order before this probe) and
  as ``bmm(live, qᵀ)``, and the context product; CUDA events, 20 runs
  each after 2 warm-up runs;
- one layer's decode pieces, ``mla_decode`` and the MoE's ``moe_apply``
  on 2 tokens (64 experts, top-6, 2 shared), each as the host clock of
  one call ended by a sync beside the profiler's device time and kernel
  launches a call (mean over 20 calls).

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/probe_mla.py

The last line is one JSON object of the measurements.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

B, SLOTS, POS = 2, 32833, 32832


def _events_ms(torch, fn, reps=20, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_and_device(torch, fn, reps=20) -> dict:
    """Host ms a call (ended by a sync), the profiler's device ms a call
    and kernel launches a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",   # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    on_dev = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))]
    return dict(host_ms=host,
                device_ms=sum(dev_us(e) for e in on_dev) / 1e3 / reps,
                launches=sum(e.count for e in on_dev) / reps)


def main() -> int:
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_mla: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.models.attention import mla_decode, mla_init
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.transformer import mla_dims
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    cfg = get_config("deepseek-v2-lite-16b")
    dims = mla_dims(cfg)
    H, r = cfg.n_heads, dims.kv_lora
    gen = torch.Generator(device=dev).manual_seed(0)
    lat = torch.randn((B, SLOTS, r + dims.rope), generator=gen,
                      device=dev).bfloat16()
    qc = torch.randn((B, H, r + dims.rope), generator=gen, device=dev)
    live = lat.float()
    w = torch.softmax(torch.bmm(qc, live.transpose(1, 2)), -1)
    out = {"card": smi}
    out["cast_ms"] = _events_ms(torch, lambda: lat.float())
    out["scores_q_liveT_ms"] = _events_ms(
        torch, lambda: torch.bmm(qc, live.transpose(1, 2)))
    out["scores_live_qT_ms"] = _events_ms(
        torch, lambda: torch.bmm(live, qc.transpose(1, 2)))
    out["context_ms"] = _events_ms(torch, lambda: torch.bmm(w, live))
    live_bytes = live.numel() * 4
    out["live_f32_bytes_bound_ms"] = live_bytes / 3.35e12 * 1e3
    a = torch.bmm(qc, live.transpose(1, 2))
    b = torch.bmm(live, qc.transpose(1, 2)).transpose(1, 2)
    out["scores_orders_max_rel_diff"] = float((a - b).abs().max()
                                              / a.abs().max())
    del live, w, a, b

    d = cfg.d_model
    p = mla_init(gen, d, H, dims)
    x = torch.randn((B, 1, d), generator=gen, device=dev).bfloat16()
    out["mla_decode"] = _host_and_device(
        torch, lambda: mla_decode(p, x, lat, POS, n_heads=H, dims=dims))
    pm = moe_init(gen, d, cfg.moe_d_ff, cfg.n_experts,
                  cfg.n_shared_experts)
    out["moe_decode"] = _host_and_device(
        torch, lambda: moe_apply(pm, x, top_k=cfg.top_k))
    for k, v in out.items():
        print(f"{k}: {v}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
