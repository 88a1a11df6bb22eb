#!/usr/bin/env python3
"""Where a training step's time goes, on one CUDA card, at ``chip_smoke.py``
phase 2r's shape: Qwen3-8B at full width cut to 4 of 36 layers, B x S =
4 x 2048, remat "dots", q_chunk 512, random weights and tokens from seed
0 (``launch.train.make_train_step``).

- the step: the host clock of one step ended by a sync (after two warm-up
  steps) beside the profiler's device time, the device's busy share and
  launches; device time by kernel, the top kernels, and the sums over the
  f32 matrix-product kernels (names holding ``sgemm`` or ``f32f32``),
  cuBLAS's other matrix-product kernels (``gemm``, ``nvjet``: the bf16
  ones) and the rest;
- the unembedding alone at the step's shape, h (B S, d) f32 times the
  f32 copy of the tied table (V, d) and its two backward products, CUDA
  events, beside its FLOPs at the data sheet's 67 TFLOP/s FP32;
- the optimizer alone: ``clip_by_global_norm`` and ``adamw_update`` on
  gradients shaped as the params (CUDA events), beside their bytes (26 a
  parameter) at 3.35 TB/s.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/probe_train.py [--out PATH]

The last line is one JSON object of the measurements (also written to
PATH with ``--out``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, LAYERS = 4, 2048, 4
HBM, FP32 = 3.35e12, 67e12


def _events_ms(torch, fn, reps=5, warmup=1) -> float:
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_train: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train
    from repro_torch.optim import adamw_update, clip_by_global_norm, tree_map
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=LAYERS)
    box = [train.init_state(cfg, seed=0, device=dev)]
    batcher = train.batcher_for(cfg, B, S, seed=0)
    step = train.make_train_step(cfg, remat="dots", q_chunk=512)

    def run(i):
        state, m = step(box.pop(), batcher.batch_at(i))
        box.append(state)
        return m
    for i in range(2):
        run(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(2)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(3)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total",   # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    kern = [e for e in prof.key_averages()
            if "CUDA" in str(getattr(e, "device_type", ""))]
    total = sum(dev_us(e) for e in kern) / 1e3
    f32 = sum(dev_us(e) for e in kern if _f32_gemm(e.key)) / 1e3
    bf16 = sum(dev_us(e) for e in kern
               if _gemm(e.key) and not _f32_gemm(e.key)) / 1e3
    top = sorted(kern, key=dev_us, reverse=True)[:15]
    out = {"card": smi, "shape": f"B x S = {B} x {S}, {LAYERS} layers",
           "host_ms": host_ms, "device_ms": total,
           "busy": total / host_ms, "launches": sum(e.count for e in kern),
           "f32_gemm_ms": f32, "bf16_gemm_ms": bf16,
           "rest_ms": total - f32 - bf16,
           "top": [{"kernel": e.key[:90], "ms": dev_us(e) / 1e3,
                    "count": e.count} for e in top]}
    print(f"step: host {host_ms:.1f} ms, device {total:.1f} ms "
          f"({total / host_ms:.1%} busy), {out['launches']} launches; f32 "
          f"products {f32:.1f} ms, bf16 products {bf16:.1f} ms, the rest "
          f"{total - f32 - bf16:.1f} ms [{smi}]")
    for t in out["top"]:
        print(f"  {t['ms']:9.3f} ms  x{t['count']:<5} {t['kernel']}")

    # the unembedding alone: forward and its two backward products, f32
    d, V = cfg.d_model, cfg.vocab
    gen = torch.Generator(device=dev).manual_seed(0)
    h = torch.randn((B * S, d), generator=gen, device=dev)
    emb = torch.randn((V, d), generator=gen, device=dev)
    g = torch.randn((B * S, V), generator=gen, device=dev)

    def unembed():
        logits = h @ emb.T
        dh = g @ emb
        de = g.T @ h
        return logits, dh, de
    un_ms = _events_ms(torch, unembed)
    un_floor = 3 * 2 * B * S * d * V / FP32 * 1e3
    out.update(unembed_ms=un_ms, unembed_floor_ms=un_floor)
    print(f"unembedding forward + backward products in f32: {un_ms:.1f} ms "
          f"(floor {un_floor:.1f} ms at 67 TFLOP/s) [{smi}]")
    del h, emb, g

    # the optimizer alone on gradients shaped as the params
    params, opt = box[0]
    grads = tree_map(lambda p: torch.randn(
        p.shape, generator=gen, device=dev).to(p.dtype) * 1e-3, params)

    def update():
        gg, _ = clip_by_global_norm(grads)
        with torch.no_grad():
            return adamw_update(gg, opt, params)
    opt_ms = _events_ms(torch, update, reps=3)
    n = sum(t.numel() for t in _leaves(params))
    # bytes a parameter: clipping reads the bf16 gradient and writes it
    # scaled (4); the update reads it and the bf16 param (4), reads and
    # writes the f32 m and v (16) and writes the param (2)
    opt_floor = n * (4 + 4 + 16 + 2) / HBM * 1e3
    out.update(optimizer_ms=opt_ms, optimizer_floor_ms=opt_floor,
               params=n)
    print(f"clipping and AdamW over {n / 1e9:.4f} B parameters: "
          f"{opt_ms:.1f} ms (bytes floor {opt_floor:.1f} ms) [{smi}]")
    line = json.dumps(out)
    if "--out" in sys.argv[1:]:
        path = pathlib.Path(sys.argv[sys.argv.index("--out") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(line + "\n")
    print(line)
    return 0


def _f32_gemm(name: str) -> bool:
    return "sgemm" in name or "f32f32" in name


def _gemm(name: str) -> bool:
    """cuBLAS's matrix-product kernels: the SIMT and xmma GEMMs, and on
    Hopper its ``nvjet`` kernels (the bf16 products here)."""
    return "gemm" in name or name.startswith("nvjet")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
