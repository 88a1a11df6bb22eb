#!/usr/bin/env python3
"""Where one SSM layer's time goes, on one CUDA card, at ``chip_smoke.py``
phases 2n and 2o's shapes (2 requests, random weights and inputs from
seed 0):

- the scan kernels against their plain versions: ``wkv6_scan`` at
  RWKV6-3B's layer (40 heads of 64) and ``ssd_scan`` at Zamba2-7B's (32
  heads, P 224, N 64), at S = 1 (a decode step), 256 and the prefill's
  length (32,768 and 16,384; the kernel only: the plain version's loop
  of some 160,000 launches is timed at S = 256), CUDA events, each beside
  its bound (the f32 inputs and outputs once at 3.35 TB/s, or its FLOPs
  at 67 TFLOP/s FP32, the larger) and its time a step;
- one layer's mixer, ``rwkv6_apply`` / ``mamba2_apply`` over the prompt
  and ``rwkv6_decode`` / ``mamba2_decode`` for one token, each as the host
  clock of one call ended by a sync beside the profiler's device time,
  the scan's share of it and the launches a call (mean over 5 prefill or
  20 decode calls);
- K6 (``cluster_attend_partial``) at Zamba2's shared block (64 query rows,
  2 x 32 kv-heads x 256 clusters of cap 256, p = 16, bf16) at dh = 112
  beside the same tables at dh = 128, the profiler's device time with the
  L2 cache flushed before each call.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/probe_ssm.py [--out PATH]

The last line is one JSON object of the measurements (also written to
PATH with ``--out``).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 2
HBM, FP32 = 3.35e12, 67e12


def _events_ms(torch, fn, reps=10, warmup=2) -> float:
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


def _profile(torch, fn, reps, flush=False, match=None) -> dict:
    """Host ms a call (ended by a sync), the profiler's device ms a call,
    the device ms of the kernels whose name holds ``match`` and kernel
    launches a call. With ``flush`` the L2 cache is flushed before each
    call (the fill kernel is not counted)."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.empty((256 << 20) // 4, device="cuda") if flush else None
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
            if flush:
                buf.zero_()
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",   # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    on_dev = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))
              and not (flush and "FillFunctor" in e.key)]
    out = dict(host_ms=host,
               device_ms=sum(dev_us(e) for e in on_dev) / 1e3 / reps,
               launches=sum(e.count for e in on_dev) / reps)
    if match:
        out[f"{match}_device_ms"] = sum(dev_us(e) for e in on_dev
                                        if match in e.key) / 1e3 / reps
    return out


def _bound_ms(n_bytes, flops):
    return max(n_bytes / HBM, flops / FP32) * 1e3


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("probe_ssm: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.cluster_attend import cluster_attend_partial
    from repro_torch.kernels.ssm_scan import ssd_scan, wkv6_scan
    from repro_torch.models import ssm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    out = {"card": smi}

    # wkv6_scan at RWKV6-3B's layer
    rw = get_config("rwkv6-3b")
    H, dh = rw.n_heads, rw.d_model // rw.n_heads
    for S in (1, 256, 32768):
        r, k, v = rnd(B, S, H, dh), rnd(B, S, H, dh), rnd(B, S, H, dh)
        w = torch.exp(-torch.exp(rnd(B, S, H, dh) * 0.1 - 6.0))
        u = rnd(H, dh) * 0.1
        st = torch.zeros((B, H, dh, dh), device=dev)
        row = dict(kernel_ms=_events_ms(torch, lambda: wkv6_scan(
            r, k, v, w, u, st), reps=3 if S > 256 else 10))
        if S <= 256:
            row["plain_ms"] = _events_ms(torch, lambda: ref.wkv6_scan_ref(
                r, k, v, w, u, st), reps=3, warmup=1)
        row["bound_ms"] = _bound_ms(
            4.0 * (B * S * H * dh * 5 + H * dh + 2 * B * H * dh * dh),
            B * S * H * dh * (5.0 * dh + 5))
        row["us_a_step"] = row["kernel_ms"] / S * 1e3
        out[f"wkv6_scan_S{S}"] = row
        del r, k, v, w
    # ssd_scan at Zamba2-7B's layer
    zb = get_config("zamba2-7b")
    H, N = zb.n_heads, zb.ssm_state
    P = zb.ssm_expand * zb.d_model // H
    for S in (1, 256, 16384):
        x, Bm, Cm = rnd(B, S, H, P), rnd(B, S, N), rnd(B, S, N)
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        decay = torch.exp(-dt)
        D = torch.ones(H, device=dev)
        st = torch.zeros((B, H, P, N), device=dev)
        row = dict(kernel_ms=_events_ms(torch, lambda: ssd_scan(
            x, Bm, Cm, decay, dt, D, st), reps=3 if S > 256 else 10))
        if S <= 256:
            row["plain_ms"] = _events_ms(torch, lambda: ref.ssd_scan_ref(
                x, Bm, Cm, decay, dt, D, st), reps=3, warmup=1)
        row["bound_ms"] = _bound_ms(
            4.0 * (B * S * (2 * H * P + 2 * N + 2 * H) + 2 * B * H * P * N),
            B * S * H * P * (5.0 * N + 3))
        row["us_a_step"] = row["kernel_ms"] / S * 1e3
        out[f"ssd_scan_S{S}"] = row
        del x, Bm, Cm, dt, decay

    # one layer's mixer, prefill and decode
    g = torch.Generator(device=dev).manual_seed(1)
    p = ssm.rwkv6_init(g, rw.d_model, rw.n_heads)
    x = rnd(B, 32768, rw.d_model).bfloat16()
    out["rwkv6_apply_32768"] = _profile(
        torch, lambda: ssm.rwkv6_apply(p, x, n_heads=rw.n_heads), 5,
        match="wkv6")
    st = torch.zeros((B, rw.n_heads, dh, dh), device=dev)
    out["rwkv6_decode"] = _profile(
        torch, lambda: ssm.rwkv6_decode(p, x[:, :1], x[:, 1:2], st,
                                        n_heads=rw.n_heads), 20,
        match="wkv6")
    del p, x, st
    p = ssm.mamba2_init(g, zb.d_model, zb.n_heads, zb.ssm_state,
                        zb.ssm_expand)
    x = rnd(B, 16384, zb.d_model).bfloat16()
    out["mamba2_apply_16384"] = _profile(
        torch, lambda: ssm.mamba2_apply(p, x, n_heads=zb.n_heads), 5,
        match="ssd")
    st = torch.zeros((B, H, P, N), device=dev)
    out["mamba2_decode"] = _profile(
        torch, lambda: ssm.mamba2_decode(p, x[:, :1], st,
                                         n_heads=zb.n_heads), 20,
        match="ssd")
    del p, x, st

    # K6 at Zamba2's shared block: dh 112 beside 128
    hkv, kc, cap, tp = zb.n_kv_heads, 256, 256, 16
    rows = B * hkv * kc
    sizes = torch.randint(0, 2 * 64 + 1, (rows,), generator=gen, device=dev,
                          dtype=torch.int32)
    sel = (torch.randint(0, kc, (B * zb.n_heads, tp), generator=gen,
                         device=dev)
           + (torch.arange(B * zb.n_heads, device=dev)[:, None] * kc)
           ).to(torch.int32)
    for d_ in (112, 128):
        q = rnd(B * zb.n_heads, d_)
        kt = rnd(rows, cap, d_).bfloat16()
        vt = rnd(rows, cap, d_).bfloat16()
        m, l, acc = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
        m_p, l_p, acc_p = ref.cluster_attend_ref(q, kt, vt, sel, sizes=sizes)
        o = acc / torch.clamp(l, min=1e-30)[:, None]
        o_p = acc_p / torch.clamp(l_p, min=1e-30)[:, None]
        live = int(sizes.long()[sel.long()].sum())
        n_bytes = (int(sizes.long()[torch.unique(sel.long())].sum()) * d_ * 4
                   + q.numel() * 4 + sel.numel() * 4
                   + B * zb.n_heads * (d_ + 2) * 4)
        out[f"cluster_attend_dh{d_}"] = dict(
            _profile(torch, lambda: cluster_attend_partial(
                q, kt, vt, sel, sizes=sizes), 20, flush=True),
            events_ms=_events_ms(torch, lambda: cluster_attend_partial(
                q, kt, vt, sel, sizes=sizes), reps=20),
            plain_ms=_events_ms(torch, lambda: ref.cluster_attend_ref(
                q, kt, vt, sel, sizes=sizes), reps=5),
            bound_ms=_bound_ms(n_bytes, 4.0 * d_ * live),
            max_abs_err=float((o - o_p).abs().max()))
        del q, kt, vt
    for key, val in out.items():
        print(f"{key}: {val}")
    if "--out" in sys.argv[1:]:
        path = pathlib.Path(sys.argv[sys.argv.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
