#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of k²-means on one NVIDIA GPU.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build the three CUDA kernels from ``src/`` (one
   ``nvcc`` per source, in parallel);
2. run the port's main path, ``repro_torch.core.fit(x, 1000,
   method="k2means", init="gdi", kn=30, max_iters=30)``, at the paper's
   mnist shape (n=60000, d=784) on GMM data made on the card from a
   seed, with every kernel's launch count set to 0 just before and read
   just after; check that every kernel launched, that the energy
   history is finite and non-increasing (rel 1e-6) and ends below the
   GDI init's energy; check a small fit against the plain PyTorch path;
3. hold each kernel against its plain version on tensors of that run
   (K2 on the final centers, K1 over the final resident arena with no
   block skipped, K3 on the GDI leaf-grouped layout) and time both with
   CUDA events, beside one library call where one computes the same
   function and beside the least time the card could take (bytes over
   3.35 TB/s, FP32 FLOPs over 67 TFLOP/s: the H100 SXM data sheet);
4. print the kernels' JSON line, then ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` adds, after phase 3, a second fit
under ``torch.profiler``: device time by kernel, the device's busy share
of the host clock, and the count of host synchronisations.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N, D, K, KN, TRUE_K, MAX_ITERS, SEED = 60000, 784, 1000, 30, 128, 30, 0
BKN = 8
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, FP32 outside the tensor cores

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, torch, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, after warm-up."""
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


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import (K2Step, OpCounter, center_knn_graph,
                                      clustering_energy, fit, fit_k2means,
                                      initialize)
        from repro_torch.data import gmm_blobs
        from repro_torch.kernels import _build, ref
        from repro_torch.kernels.candidate_assign import (
            candidate_assign_tiled, candidate_tables, pad_candidates)
        from repro_torch.kernels.center_knn import center_sqdist
        from repro_torch.kernels.ops import (choose_group_bn,
                                             group_by_cluster_device)
        from repro_torch.kernels.segmented_scan import segmented_scan
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1

    # --- 1. the card, the versions, the build ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"phase 1: built {sorted(took)} in "
          f"{time.perf_counter() - t0:.1f} s (per source: "
          + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # --- 2. the main path -----------------------------------------------
    dev = torch.device("cuda")
    x = gmm_blobs(N, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    # the GDI init on its own: its energy is the bar the fit must clear;
    # it and two iterations from it warm the path up before the timed run
    c0, a0 = initialize(x, K, "gdi",
                        torch.Generator(device=dev).manual_seed(SEED + 1),
                        OpCounter())
    e_init = float(clustering_energy(x, c0, a0))
    fit_k2means(x, c0, a0, kn=KN, max_iters=2, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    res = fit(x, K, method="k2means", init="gdi", kn=KN,
              max_iters=MAX_ITERS, device=dev, profile=True,
              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    launches = _build.launches()
    hist = [e for _, e in res.history]
    print(f"phase 2: fit n={N} d={D} k={K} kn={KN}: GDI "
          f"{res.profile['init_s']:.3f} s, {res.iterations} iterations, "
          f"{res.profile['iterate_s'] / max(res.iterations, 1) * 1e3:.2f} "
          f"ms/iteration, energy {res.energy:.6g} (GDI init {e_init:.6g}), "
          f"launches {launches}")
    print(f"  counted ops {res.profile['total_ops']:.6g}, layout bytes "
          f"{res.profile['bytes_moved']:.6g}, resorts "
          f"{res.profile['resorts']:.0f}")
    for name, n_launch in launches.items():
        check(n_launch > 0, f"{name} launched in the main path ({n_launch})")
    check(res.centers.shape == (K, D) and res.assignment.shape == (N,),
          "result shapes")
    check(bool(torch.isfinite(res.centers).all()), "centers finite")
    a_min, a_max = int(res.assignment.min()), int(res.assignment.max())
    check(0 <= a_min and a_max < K, "assignment in [0, k)")
    check(len(hist) == res.iterations and all(map(_finite, hist)),
          "energy history finite, one entry per iteration")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(hist, hist[1:])),
          "energy history non-increasing (rel 1e-6)")
    check(res.energy < e_init, "final energy below the GDI init's")
    _small_fit_agrees(torch, dev, fit_k2means, check)

    # --- 3. each kernel against its plain version -----------------------
    kernels = []
    c = res.centers.contiguous()
    cmax = float((c * c).sum(1).max())

    # K2: center_sqdist on the final centers
    got = center_sqdist(c)
    want = ref.center_sqdist_ref(c)
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * cmax).all()),
          f"K2 center_sqdist vs plain: max abs err {err:.3g} "
          f"(rtol 1e-5, atol 1e-5*max|c|^2 = {1e-5 * cmax:.3g})")
    b_ms, b_by = bound((K * D + K * K) * 4.0, 2.0 * K * K * D + 2.0 * K * D)
    kernels.append(dict(
        name="center_sqdist", route="cuda",
        source="src/repro_torch/kernels/csrc/center_knn.cu",
        replaces="src/repro/kernels/center_knn.py:26",
        launches=launches["center_sqdist"], max_abs_err=err,
        ms=time_ms(lambda: center_sqdist(c), torch),
        plain_ms=time_ms(lambda: ref.center_sqdist_ref(c), torch),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.cdist(c, c) ** 2, torch)))

    # K1: candidate_assign_tiled over the final resident arena, no skips
    sb = K2Step(k=K, kn=KN, bkn=BKN)
    st = sb.init_resident(x, torch.ones(N, device=dev), c, res.assignment)
    nb = st.b2c.shape[0]
    bn = st.pid.shape[0] // nb
    cidx = pad_candidates(center_knn_graph(c, KN), BKN).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    s_rows = st.pid.shape[0]
    zi = torch.zeros(s_rows, dtype=torch.int32, device=dev)
    zf = torch.zeros(s_rows, device=dev)
    args = (st.xg, ctab, csqtab, cidx, rowsel,
            torch.zeros(nb, dtype=torch.int32, device=dev), zi, zf, zf)
    a_k, d1_k, d2_k = candidate_assign_tiled(*args, bn=bn, bkn=BKN)
    a_p, d1_p, d2_p = ref.candidate_assign_tiled_ref(*args, bn)
    tie = (d2_p - d1_p) <= 1e-5 * d1_p
    err = max(float((d1_k - d1_p).abs().max()),
              float((d2_k - d2_p).abs().max()))
    tol = lambda p: 1e-5 * p.abs() + 1e-5 * cmax    # noqa: E731
    check(bool(((a_k == a_p) | tie).all())
          and bool(((d1_k - d1_p).abs() <= tol(d1_p)).all())
          and bool(((d2_k - d2_p).abs() <= tol(d2_p)).all()),
          f"K1 candidate_assign_tiled vs plain over {s_rows} arena rows: "
          f"{int((a_k != a_p).sum())} assignment differences, all on "
          f"near-ties; max abs err {err:.3g} (rtol 1e-5, atol "
          f"{1e-5 * cmax:.3g})")
    knp = cidx.shape[1]
    rows_read = int(torch.unique(rowsel).numel())
    b_ms, b_by = bound(s_rows * D * 4.0 + rows_read * knp * (D + 2) * 4.0
                       + nb * 8.0 + s_rows * 12.0 * 2,
                       2.0 * s_rows * knp * D + 2.0 * s_rows * D)
    kernels.append(dict(
        name="candidate_assign_tiled", route="cuda",
        source="src/repro_torch/kernels/csrc/candidate_assign.cu",
        replaces="src/repro/kernels/candidate_assign.py:130",
        launches=launches["candidate_assign_tiled"], max_abs_err=err,
        ms=time_ms(lambda: candidate_assign_tiled(*args, bn=bn, bkn=BKN),
                   torch),
        plain_ms=time_ms(lambda: ref.candidate_assign_tiled_ref(*args, bn),
                         torch),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del st, args, ctab

    # K3: segmented_scan on the GDI leaf-grouped layout
    bn3 = choose_group_bn(N, K, D)
    perm, b2s = group_by_cluster_device(a0, K, bn3)
    xg = x[perm.clamp(min=0).long()].contiguous()
    w = (perm >= 0).to(torch.float32)
    cs_k, qs_k, cn_k = segmented_scan(xg, w, b2s, bn=bn3)
    cs_p, qs_p, cn_p = ref.segmented_scan_ref(xg, w, b2s, bn3)
    row_seg = torch.repeat_interleave(b2s.long(), bn3)
    xw = xg * w[:, None]
    seg_abs_x = torch.zeros(K, D, device=dev).index_add_(
        0, row_seg, xw.abs())[row_seg]
    seg_abs_q = torch.zeros(K, device=dev).index_add_(
        0, row_seg, (xw * xg).sum(1))[row_seg]
    err = max(float((cs_k - cs_p).abs().max()),
              float((qs_k - qs_p).abs().max()))
    check(bool(((cs_k - cs_p).abs()
                <= 1e-5 * cs_p.abs() + 1e-5 * seg_abs_x).all())
          and bool(((qs_k - qs_p).abs()
                    <= 1e-5 * qs_p.abs() + 1e-5 * seg_abs_q).all())
          and bool((cn_k == cn_p).all()),
          f"K3 segmented_scan vs plain on {xg.shape[0]} rows: max abs err "
          f"{err:.3g} (rtol 1e-5, atol 1e-5 * the segment's sum of "
          f"|.|); counts exact")
    r3 = xg.shape[0]
    b_ms, b_by = bound(r3 * D * 4.0 * 2 + r3 * 4.0 * 3 + b2s.shape[0] * 4.0,
                       3.0 * r3 * D)
    kernels.append(dict(
        name="segmented_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_scan.cu",
        replaces="src/repro/kernels/segmented_scan.py:60",
        launches=launches["segmented_scan"], max_abs_err=err,
        ms=time_ms(lambda: segmented_scan(xg, w, b2s, bn=bn3), torch),
        plain_ms=time_ms(lambda: ref.segmented_scan_ref(xg, w, b2s, bn3),
                         torch),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for kr in kernels:
        print(f"phase 3: {kr['name']}: {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']}, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), launches "
              f"{kr['launches']}")

    if "--profile" in sys.argv[1:]:
        _profile_fit(torch, fit, x, dev)

    # --- 4. result -------------------------------------------------------
    for kr in kernels:
        kr["status"] = "ok" if kr["launches"] > 0 else "not launched"
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _profile_fit(torch, fit, x, dev) -> None:
    """The main path once more under torch.profiler (CPU + CUDA): device
    time by kernel, the busy share, and the host synchronisations."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fit(x, K, method="k2means", init="gdi", kn=KN,
                  max_iters=MAX_ITERS, device=dev, profile=True,
                  generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",   # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    # device-side events only (kernels, copies, sets); op-level entries
    # repeat the time of the kernels they launched
    on_dev = [e for e in events if "CUDA" in str(getattr(e, "device_type",
                                                         ""))]
    busy = sum(dev_us(e) for e in on_dev) / 1e6
    print(f"profile: fit wall {wall:.3f} s under the profiler (GDI "
          f"{res.profile['init_s']:.3f} s, {res.iterations} iterations in "
          f"{res.profile['iterate_s']:.3f} s); device busy {busy:.3f} s = "
          f"{100 * busy / wall:.1f}% of the wall")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:25]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:100]}")
    for e in events:
        if "Synchronize" in e.key or "Memcpy" in e.key:
            print(f"  host calls: {e.key} x{e.count}")


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def _small_fit_agrees(torch, dev, fit_k2means, check) -> None:
    """A small fit through the kernels against the plain PyTorch path on
    the CPU, from one init: same iteration count, assignments and
    energies (rel 1e-5)."""
    g = torch.Generator().manual_seed(7)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    init = x[torch.randperm(3000, generator=g)[:24]]
    a0 = torch.cdist(x, init).argmin(1).to(torch.int32)
    r_gpu = fit_k2means(x, init, a0, kn=8, max_iters=30, device=dev)
    r_cpu = fit_k2means(x, init, a0, kn=8, max_iters=30, device="cpu")
    same = bool((r_gpu.assignment.cpu() == r_cpu.assignment).all())
    rel = abs(r_gpu.energy - r_cpu.energy) / abs(r_cpu.energy)
    check(same and r_gpu.iterations == r_cpu.iterations and rel <= 1e-5,
          f"small fit (n=3000, d=16, k=24) on the card equals the plain "
          f"CPU path: assignments {same}, iterations {r_gpu.iterations} "
          f"vs {r_cpu.iterations}, energy rel diff {rel:.2g}")


if __name__ == "__main__":
    sys.exit(main())
