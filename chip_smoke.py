#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of k²-means on one NVIDIA GPU.

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, without the final result line):
1. print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build the CUDA kernels from ``src/`` (the seven
   ports of the TPU kernels, the correct-rounding kernels of the torch
   paths and the ordered segment sums; one ``nvcc`` per source, in
   parallel);
2. run the port's main path, ``repro_torch.core.fit(x, 1000,
   method="k2means", init="gdi", kn=30, max_iters=30)``, at the paper's
   mnist shape (n=60000, d=784) on GMM data made on the card from a
   seed, with every kernel's launch count set to 0 just before and read
   just after; check that every kernel of the fit launched, that the
   energy history is finite and non-increasing (rel 1e-6) and ends below
   the GDI init's energy; fit once more from the same generator seed and
   check that the two fits are bit-identical (assignments, centers,
   energy, iterations); check a small fit from GDI against the plain
   PyTorch path;
2b. serve from that fit: ``KMeansModel.from_result(result, x)`` (K2
   builds the graph), then ``predict`` 65536 held-out rows of the same
   mixture at batch_size=8192 in f32 (resolution through K1) and in int8
   (K4 + an exact f32 re-rank), each after one warm-up call and with the
   counts set to 0 just before; check the launches, that the int8
   assignments equal the f32 ones, that every returned squared distance
   is the minimum over the routed center's neighborhood (rtol 1e-6), that
   the counted f32 distances per query stay within the dense budget, and
   a small predict against the plain PyTorch path; print queries/s,
   recall@1 against the brute-force argmin, host reads per call and peak
   device memory;
2c. the paper's baselines on the same rows: ``kmeanspp_init`` at k=1000,
   then ``fit(method="lloyd", init="kmeanspp")`` (every assignment step
   through K5) and ``fit(method="elkan", init="kmeanspp")`` for a few
   iterations, counts set to 0 just before each fit; print the k-means++
   seconds, ms per Lloyd iteration, the energies and the k²-means /
   Lloyd++ energy and counted-ops ratios, host reads per Lloyd iteration
   and inside the k-means++ loop; check that K5 launched once per Lloyd
   iteration, that Lloyd's energy history does not increase (rel 1e-6),
   ends at or below the k-means++ init's, that host reads are 1 per
   Lloyd iteration (+1 for the final energy) and 0 in k-means++, and that
   Elkan's first assignment equals Lloyd's first from the same centers;
2d. the assignment bench (the reference's ``benchmarks/assign_bench``
   check, on the card): K7 rowwise and K1 tiled over the k²-means fit's
   resident arena with the same per-block lists, counts set to 0 just
   before; check that both launched and agree;
2e. LM serving with k²-attention (``repro_torch.launch.serve.run``) at
   Qwen3-8B's full width (d_model 4096, 32 q-heads over 8 kv-heads,
   d_head 128, d_ff 12288, vocab 151,936, qk-norm) with the depth cut to
   4 of its 36 layers and random weights from a seed: 2 requests of a
   65,536-token random prompt are prefilled (chunked forward), decoded 64
   greedy tokens with full attention, then every layer's keys are
   clustered (kc 2048, cap 512) and the cache repacked cluster-major, and
   the same 64 tokens are decoded with k²-attention (top-p 16, ring 256,
   a fold of the ring every 32 steps), counts set to 0 just before; print
   the prefill and attach seconds, tokens dropped by full clusters, ms
   per decode token, token agreement, member rows absorbed by the folds,
   attention reads per token, peak device memory and host reads per
   decode step; check that K6 launched once per layer per clustered
   token and nothing else launched, that every logit is finite, that
   host reads are 1 per decode step, and that a small serve (the smoke
   config in f32) on the card agrees with the plain CPU path;
3. hold each kernel against its plain version on tensors of those runs
   (K2 on the final centers, K1 over the final resident arena with no
   block skipped and over one predict batch's grouped layout, K3 on the
   GDI leaf-grouped layout and on one segment over every block, each
   launched twice and held bit-equal to itself, K4 on one int8 predict
   batch, K5 on x and the Lloyd++ centers, K7 over the arena, K6 on
   layer 0's cluster-major tables at a decode step; K1, K5 and K7 also on
   ``data.rounding_fixture`` rows, whose own-center products sit at f32
   rounding midpoints; the rounding kernels on the final centers and a
   predict batch, the ordered segment sums over the final arena) and
   time both with CUDA events, beside one library call where one
   computes the same function and beside the least time the card could
   take (bytes over 3.35 TB/s, or operations over the H100 SXM data
   sheet's peak for their type: 67 TFLOP/s FP32, 1979 TOP/s int8); K6
   and its yardsticks are timed with the L2 cache flushed before each
   launch, as a decode step finds it (the other layers' weights pass
   through it in between);
4. print the kernels' JSON line, then ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --profile`` adds, after phase 3, the fit, one
predict in each precision, one Lloyd++ fit, and phase 2e's full and
k²-attention decode (8 steps each) and a ring fold under ``torch.profiler``:
device time by kernel, the device's busy share of the host clock, and
the host synchronisations.
"""
from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N, D, K, KN, TRUE_K, MAX_ITERS, SEED = 60000, 784, 1000, 30, 128, 30, 0
BKN = 8
NQ, BATCH = 65536, 8192            # held-out queries, predict batch size
LLOYD_ITERS, ELKAN_ITERS = 300, 5   # Lloyd++ runs to convergence here
# phase 2e: Qwen3-8B's width, depth cut to 4 of 36 layers
LM_ARCH, LM_LAYERS, LM_BATCH, LM_PROMPT, LM_DECODE, LM_FOLD = (
    "qwen3-8b", 4, 2, 65536, 64, 32)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12            # H100 SXM, FP32 outside the tensor cores
INT8_OP_PER_S = 1979e12            # H100 SXM, int8 tensor cores (dense)

FIT_KERNELS = ("center_sqdist", "candidate_assign_tiled", "segmented_scan",
               "segment_sum_blocks", "exact_sqnorm", "exact_rowdot")

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


def bound(n_bytes: float, ops: float,
          ops_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import (K2Step, KMeansModel, OpCounter,
                                      center_knn_graph, clustering_energy,
                                      fit, fit_elkan, fit_k2means, fit_lloyd,
                                      initialize, kmeanspp_init)
        from repro_torch.core.model import _RESOLVE_RERANK as rerank
        from repro_torch.data import gmm_blobs, rounding_fixture
        from repro_torch.kernels import _build, exact_round, quant, ref
        from repro_torch.kernels.candidate_assign import (
            candidate_assign_int8_tiled, candidate_assign_rowwise,
            candidate_assign_tiled, candidate_tables, pad_candidates)
        from repro_torch.kernels.center_knn import center_sqdist
        from repro_torch.kernels.distance_argmin import distance_argmin
        from repro_torch.kernels.ops import assign_nearest_kernel
        from repro_torch.kernels.ops import (choose_group_bn,
                                             group_by_cluster_device)
        from repro_torch.kernels.segment_sum import segment_sum_blocks
        from repro_torch.kernels.segmented_scan import segmented_scan
        from repro_torch.kernels.cluster_attend import cluster_attend_partial
        from repro_torch.launch import serve
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
    # the training rows and the held-out queries: one draw from the
    # mixture, split
    allx = gmm_blobs(N + NQ, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    x, queries = allx[:N], allx[N:]
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
    for name in FIT_KERNELS:
        check(launches[name] > 0,
              f"{name} launched in the fit ({launches[name]})")
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
    again = fit(x, K, method="k2means", init="gdi", kn=KN,
                max_iters=MAX_ITERS, device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    same = (bool(torch.equal(again.assignment, res.assignment))
            and bool(torch.equal(again.centers, res.centers))
            and again.energy == res.energy
            and again.iterations == res.iterations)
    check(same, f"the fit again from the same seed is bit-identical: "
                f"{int((again.assignment != res.assignment).sum())} "
                f"assignments differ, centers equal "
                f"{bool(torch.equal(again.centers, res.centers))}, energy "
                f"{again.energy:.9g} vs {res.energy:.9g}, iterations "
                f"{again.iterations} vs {res.iterations}")
    del again
    _small_fit_agrees(torch, dev, fit_k2means, check)
    _small_gdi_fit_agrees(torch, dev, fit_k2means, check)

    # --- 2b. the served model: predict in f32 and int8 ------------------
    torch.cuda.synchronize()
    _build.reset_launches()
    model = KMeansModel.from_result(res, x, kn=KN, device=dev)
    torch.cuda.synchronize()
    built = _build.launches()
    check(built["center_sqdist"] > 0,
          f"center_sqdist launched at the model build ({built})")
    dense = model.dense_distances_per_query()
    print(f"phase 2b: model k={model.k} kn={model.kn} route_groups="
          f"{model.route_groups} route_cap={model.route_cap} probes="
          f"{model.route_probes}, dense distances per query {dense}, arena "
          f"bn={model.bn} capacity={model.capacity}")
    served = {}
    for prec, kernel in (("f32", "candidate_assign_tiled"),
                         ("int8", "candidate_assign_int8_tiled")):
        model.predict(queries, batch_size=BATCH, precision=prec)  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counter = OpCounter()
        _build.reset_launches()
        t0 = time.perf_counter()
        a, dist = model.predict(queries, batch_size=BATCH, precision=prec,
                                counter=counter, return_sqdist=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = _build.launches()
        peak = torch.cuda.max_memory_allocated() - base
        reads = _host_reads(torch, lambda: model.predict(
            queries, batch_size=BATCH, precision=prec))
        served[prec] = dict(a=a, d=dist, counter=counter, launches=got)
        print(f"  predict {prec}: {NQ / secs:.1f} queries/s ({secs:.4f} s "
              f"for {NQ}, batch {BATCH}), counted f32 distances "
              f"{counter.distances / NQ:.3f}/query, int8 ops "
              f"{counter.int8_ops / NQ:.1f}/query, scan bytes "
              f"{counter.bytes_scanned / NQ:.1f}/query, host reads {reads} "
              f"per call, peak device memory +{peak / 2 ** 20:.1f} MiB, "
              f"launches {got}")
        check(got[kernel] > 0 and got["exact_cross"] > 0,
              f"{kernel} and exact_cross (the router's rounding) launched "
              f"by predict({prec}) ({got[kernel]}, {got['exact_cross']})")
        check(counter.distances / NQ <= dense,
              f"predict({prec}) counted f32 distances per query "
              f"{counter.distances / NQ:.3f} <= dense {dense}")
    f32, i8 = served["f32"], served["int8"]
    print(f"  int8 / f32 counted f32 distances: "
          f"{i8['counter'].distances / f32['counter'].distances:.4f}; scan "
          f"bytes {i8['counter'].bytes_scanned / f32['counter'].bytes_scanned:.4f}")
    check(bool(torch.equal(f32["a"], i8["a"])),
          f"int8 assignments equal the f32 ones "
          f"({int((f32['a'] != i8['a']).sum())} differ)")
    routed = model.route(queries)
    want_d = _neighborhood_min(torch, queries, model.centers,
                               model.neighbors[routed.long()])
    for prec in ("f32", "int8"):
        got_d = served[prec]["d"]
        rel = float(((got_d - want_d).abs() / want_d.clamp(min=1e-30)).max())
        check(bool(((got_d - want_d).abs() <= 1e-6 * want_d).all()),
              f"predict({prec}) distances are the minimum over the routed "
              f"neighborhood: max rel err {rel:.3g} (rtol 1e-6)")
    truth, _ = assign_nearest_kernel(queries, model.centers)
    print(f"  recall@1 against the brute-force argmin: "
          f"{float((f32['a'] == truth).float().mean()):.6f}")
    _small_predict_agrees(torch, dev, fit_k2means, KMeansModel, OpCounter,
                          check)

    # --- 2c. the paper's baselines: k-means++, Lloyd++ and Elkan --------
    def pp_gen():
        return torch.Generator(device=dev).manual_seed(SEED + 2)
    kmeanspp_init(x, 8, pp_gen())                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_pp = kmeanspp_init(x, K, pp_gen())
    torch.cuda.synchronize()
    pp_s = time.perf_counter() - t0
    pp_reads = _host_reads(torch, lambda: kmeanspp_init(x, K, pp_gen()))
    e_pp = float(assign_nearest_kernel(x, c_pp)[1].sum())
    # Lloyd's first assignment (and the warm-up of its path) and Elkan's
    # initial one, from the same centers
    lloyd1 = fit_lloyd(x, c_pp, max_iters=1, device=dev).assignment
    elkan0 = fit_elkan(x, c_pp, max_iters=0, device=dev).assignment
    torch.cuda.synchronize()
    _build.reset_launches()
    res_l = fit(x, K, method="lloyd", init="kmeanspp", max_iters=LLOYD_ITERS,
                device=dev, profile=True, generator=pp_gen())
    torch.cuda.synchronize()
    l_launch = _build.launches()
    hist_l = [e for _, e in res_l.history]
    lloyd_ms = res_l.profile["iterate_s"] / res_l.iterations * 1e3
    lloyd_reads = _host_reads(torch, lambda: fit_lloyd(x, c_pp, max_iters=3,
                                                       device=dev))
    torch.cuda.synchronize()
    _build.reset_launches()
    res_e = fit(x, K, method="elkan", init="kmeanspp", max_iters=ELKAN_ITERS,
                device=dev, profile=True, generator=pp_gen())
    torch.cuda.synchronize()
    e_launch = _build.launches()
    print(f"phase 2c: k-means++ k={K}: {pp_s:.4f} s "
          f"({res_l.profile['init_s']:.4f} s inside fit), host reads "
          f"{pp_reads} in the whole init; energy {e_pp:.6g}")
    print(f"  Lloyd++: {res_l.iterations} iterations (cap {LLOYD_ITERS}), "
          f"{lloyd_ms:.3f} ms/iteration, energy {res_l.energy:.6g}, counted "
          f"ops {res_l.ops:.6g}, host reads {lloyd_reads} for 3 iterations, "
          f"launches {l_launch}")
    ops_l = res_l.history[min(res_e.iterations, res_l.iterations) - 1][0]
    print(f"  Elkan++: {res_e.iterations} iterations, "
          f"{res_e.profile['iterate_s'] / max(res_e.iterations, 1) * 1e3:.3f} "
          f"ms/iteration, energy {res_e.energy:.6g}, counted ops "
          f"{res_e.ops:.6g} (Lloyd++ after as many iterations: "
          f"{ops_l:.6g}), launches {e_launch}")
    print(f"  k2-means (phase 2) / Lloyd++: energy "
          f"{res.energy / res_l.energy:.6f}, counted ops "
          f"{res.ops / res_l.ops:.6f}")
    # K5 once per Lloyd iteration, each with its |c|^2 rounding; the
    # k-means++ init rounds |x|^2 once and each chosen center's products
    # and norm once
    want_l = {"distance_argmin": res_l.iterations,
              "exact_sqnorm": res_l.iterations + K + 1, "exact_rowdot": K}
    check(all(l_launch[name] == v for name, v in want_l.items())
          and sum(l_launch.values()) == sum(want_l.values()),
          f"distance_argmin (K5) launched once per Lloyd iteration and "
          f"only the rounding kernels beside it ({l_launch} for "
          f"{res_l.iterations} iterations, k={K})")
    check(len(hist_l) == res_l.iterations and all(map(_finite, hist_l)),
          "Lloyd energy history finite, one entry per iteration")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(hist_l, hist_l[1:])),
          "Lloyd energy history non-increasing (rel 1e-6)")
    check(abs(hist_l[0] - e_pp) <= 1e-6 * e_pp,
          "the fit's k-means++ drew the same centers (first Lloyd energy = "
          "the init's, rel 1e-6)")
    check(res_l.energy <= e_pp, "Lloyd++ energy <= the k-means++ init's")
    check(pp_reads == 0, f"no host read inside k-means++ ({pp_reads})")
    check(lloyd_reads == 3 + 1, f"host reads: 1 per Lloyd iteration + 1 for "
                                f"the final energy ({lloyd_reads} for 3)")
    check(bool(torch.equal(lloyd1, elkan0)),
          f"Elkan's first assignment equals Lloyd's first from the same "
          f"centers ({int((lloyd1 != elkan0).sum())} differ)")
    check(_finite(res_e.energy) and res_e.assignment.shape == (N,),
          "Elkan's result finite and of the expected shape")

    # --- 2d. the assignment bench: K7 rowwise beside K1 tiled -----------
    c = res.centers.contiguous()
    sb = K2Step(k=K, kn=KN, bkn=BKN)
    st = sb.init_resident(x, torch.ones(N, device=dev), c, res.assignment)
    nb = st.b2c.shape[0]
    bn = st.pid.shape[0] // nb
    graph = center_knn_graph(c, KN)
    cidx = pad_candidates(graph, BKN).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    cand = graph[rowsel.long()].contiguous()
    s_rows = st.pid.shape[0]
    zi = torch.zeros(s_rows, dtype=torch.int32, device=dev)
    zf = torch.zeros(s_rows, device=dev)
    noskip = torch.zeros(nb, dtype=torch.int32, device=dev)
    args = (st.xg, ctab, csqtab, cidx, rowsel, noskip, zi, zf, zf)
    args7 = (st.xg, c, cand, noskip, zi, zf)
    torch.cuda.synchronize()
    _build.reset_launches()
    a_t, d_t, _ = candidate_assign_tiled(*args, bn=bn, bkn=BKN)
    a_r, d_r = candidate_assign_rowwise(*args7, bn=bn)
    torch.cuda.synchronize()
    bench = _build.launches()
    print(f"phase 2d: assignment bench over the resident arena ({s_rows} "
          f"rows, bn={bn}, {nb} blocks, kn={KN}): launches {bench}")
    check(bench["candidate_assign_rowwise"] == 1
          and bench["candidate_assign_tiled"] == 1,
          "candidate_assign_rowwise (K7) and candidate_assign_tiled (K1) "
          "launched by the bench")
    check(bool(torch.equal(a_t, a_r)) and bool(torch.equal(d_t, d_r)),
          f"K7 rowwise equals K1 tiled on the same lists (assign_bench's "
          f"check): {int((a_t != a_r).sum())} assignments differ")

    # --- 2e. LM serving with k²-attention at Qwen3-8B's width ----------
    t0 = time.perf_counter()
    lm = _lm_serve(torch, dev, serve, check)
    print(f"  phase 2e wall {time.perf_counter() - t0:.1f} s")

    # --- 3. each kernel against its plain version -----------------------
    kernels = []
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
    knp = cidx.shape[1]
    rows_read = int(torch.unique(rowsel).numel())
    kernels.append(_against_plain(
        torch, check, f"K1 over the final resident arena ({s_rows} rows, "
                      f"bn={bn}, no block skipped)",
        functools.partial(candidate_assign_tiled, *args, bn=bn, bkn=BKN),
        functools.partial(ref.candidate_assign_tiled_ref, *args, bn),
        dict(name="candidate_assign_tiled",
             source="src/repro_torch/kernels/csrc/candidate_assign.cu",
             replaces="src/repro/kernels/candidate_assign.py:130",
             launches=launches["candidate_assign_tiled"]),
        bound(s_rows * D * 4.0 + rows_read * knp * (D + 2) * 4.0
              + nb * 8.0 + s_rows * 12.0 * 2,
              2.0 * s_rows * knp * D + 2.0 * s_rows * D)))

    # K7: candidate_assign_rowwise over the same arena and lists
    rows7 = int(torch.unique(cand).numel())
    kernels.append(_against_plain(
        torch, check, f"K7 over the final resident arena ({s_rows} rows, "
                      f"bn={bn}, kn={KN})",
        functools.partial(candidate_assign_rowwise, *args7, bn=bn),
        functools.partial(ref.candidate_assign_ref, *args7, bn),
        dict(name="candidate_assign_rowwise",
             source="src/repro_torch/kernels/csrc/candidate_assign_rowwise.cu",
             replaces="src/repro/kernels/candidate_assign.py:401",
             launches=bench["candidate_assign_rowwise"]),
        bound(s_rows * D * 4.0 + rows7 * (D + 1) * 4.0 + nb * (KN + 1) * 4.0
              + s_rows * 8.0 * 2, 2.0 * s_rows * KN * D)))
    print(f"  tiled_vs_rowwise_wall (K7 ms / K1 ms over the arena): "
          f"{kernels[-1]['ms'] / kernels[-2]['ms']:.3f}")
    del st, args, args7, ctab

    # K3: segmented_scan on the GDI leaf-grouped layout, and on the first
    # GDI round's layout (one segment over every block: the longest chains
    # of the kernel's look-back)
    bn3 = choose_group_bn(N, K, D)
    perm, b2s = group_by_cluster_device(a0, K, bn3)
    xg = x[perm.clamp(min=0).long()].contiguous()
    w = (perm >= 0).to(torch.float32)
    err = _k3_agrees(torch, check, segmented_scan, ref, xg, w, b2s, bn3,
                     f"{K} segments")
    perm1, b2s1 = group_by_cluster_device(torch.zeros_like(a0), 1, bn3)
    x1 = x[perm1.clamp(min=0).long()].contiguous()
    w1 = (perm1 >= 0).to(torch.float32)
    _k3_agrees(torch, check, segmented_scan, ref, x1, w1, b2s1, bn3,
               "one segment")
    print(f"  K3 on one segment ({x1.shape[0]} rows, {b2s1.shape[0]} "
          f"blocks): "
          f"{time_ms(lambda: segmented_scan(x1, w1, b2s1, bn=bn3), torch):.4f}"
          f" ms")
    del x1, w1
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
    # K1 and K4 on the first predict batch, grouped by its routed centers
    # as bounded_predict_assign(_int8) groups it (bn=8 at this shape)
    qb = queries[:BATCH]
    cidx = pad_candidates(model.neighbors, BKN).contiguous()
    knp = cidx.shape[1]
    qg, b2c, skip, bnp, live, slabs = _predict_layout(
        torch, model, qb, "f32", choose_group_bn, group_by_cluster_device)
    ctab, csqtab = candidate_tables(c, cidx)
    zi = torch.zeros(qg.shape[0], dtype=torch.int32, device=dev)
    zf = torch.zeros(qg.shape[0], device=dev)
    args = (qg, ctab, csqtab, cidx, b2c, skip, zi, zf, zf)
    kernels.append(_against_plain(
        torch, check, f"K1 at the predict layout (bn={bnp})",
        functools.partial(candidate_assign_tiled, *args, bn=bnp, bkn=BKN),
        functools.partial(ref.candidate_assign_tiled_ref, *args, bnp),
        dict(name="candidate_assign_tiled[predict]",
             source="src/repro_torch/kernels/csrc/candidate_assign.cu",
             replaces="src/repro/kernels/candidate_assign.py:130",
             launches=served["f32"]["launches"]["candidate_assign_tiled"]),
        bound(live * D * 4.0 + slabs * knp * (D + 2) * 4.0
              + b2c.shape[0] * 8.0 + qg.shape[0] * 12.0 * 2,
              2.0 * live * knp * D + 2.0 * live * D)))
    del ctab, args

    qg, b2c, skip, bnp, live, slabs = _predict_layout(
        torch, model, qb, "int8", choose_group_bn, group_by_cluster_device)
    xq, xsc = quant.quantize_rows(qg)
    args = (xq, xsc, quant.residual_norm(qg, xq, xsc),
            *quant.quantized_candidate_slabs(model._quant_tables()[0], cidx),
            b2c, skip)
    kernels.append(_against_plain(
        torch, check, f"K4 at the predict layout (bn={bnp})",
        functools.partial(candidate_assign_int8_tiled, *args, bn=bnp,
                          bkn=BKN, r=rerank),
        functools.partial(ref.candidate_assign_int8_tiled_ref, *args, bnp,
                          rerank),
        dict(name="candidate_assign_int8_tiled",
             source="src/repro_torch/kernels/csrc/candidate_assign_int8.cu",
             replaces="src/repro/kernels/candidate_assign.py:282",
             launches=served["int8"]["launches"][
                 "candidate_assign_int8_tiled"]),
        bound(live * (D + 8.0) + slabs * knp * (D + 12.0)
              + b2c.shape[0] * 8.0 + xq.shape[0] * (4.0 * rerank + 8.0),
              2.0 * live * knp * D, INT8_OP_PER_S)))
    # K5: distance_argmin on x and the Lloyd++ centers
    c_l = res_l.centers.contiguous()
    kernels.append(_against_plain(
        torch, check, f"K5 on x and the Lloyd++ centers (n={N}, k={K}, "
                      f"d={D})",
        functools.partial(distance_argmin, x, c_l),
        functools.partial(ref.distance_argmin_ref, x, c_l),
        dict(name="distance_argmin",
             source="src/repro_torch/kernels/csrc/distance_argmin.cu",
             replaces="src/repro/kernels/distance_argmin.py:54",
             launches=l_launch["distance_argmin"]),
        bound((N * D + K * D + K) * 4.0 + N * 8.0, 2.0 * N * K * D),
        library=functools.partial(_cublas_argmin, torch, x, c_l)))
    kernels.append(_k6_entry(torch, check, lm, cluster_attend_partial, ref))
    _fixture_agrees(torch, dev, check, rounding_fixture, K2Step,
                    center_knn_graph, pad_candidates, candidate_tables,
                    candidate_assign_tiled, candidate_assign_rowwise,
                    distance_argmin, ref)

    # the kernels of the torch paths: the correct rounding of the centers'
    # norms (every iteration's candidate tables) and of a predict batch's
    # products with the centers (the router's distances), and the engine's
    # ordered center sums over the final arena
    kernels.append(_against_plain(
        torch, check, f"exact_sqnorm on the final centers ({K} x {D})",
        functools.partial(exact_round.exact_sqnorm, c),
        functools.partial(ref.exact_sqnorm, c),
        dict(name="exact_sqnorm",
             source="src/repro_torch/kernels/csrc/exact_round.cu",
             replaces="src/repro/kernels/candidate_assign.py:79",
             launches=launches["exact_sqnorm"]),
        bound(K * D * 4.0 + K * 4.0, 2.0 * K * D)))
    ct = c.T
    kernels.append(_against_plain(
        torch, check, f"exact_cross of a predict batch ({BATCH} x {D}) with "
                      f"the final centers",
        functools.partial(exact_round.exact_cross, qb, ct),
        functools.partial(ref.exact_cross, qb, ct),
        dict(name="exact_cross",
             source="src/repro_torch/kernels/csrc/exact_round.cu",
             replaces="src/repro/core/model.py:151",
             launches=served["f32"]["launches"]["exact_cross"]),
        bound((BATCH * D + K * D + BATCH * K) * 4.0, 2.0 * BATCH * K * D)))
    proj_dirs = (c - c.roll(1, 0)).contiguous()    # a direction per leaf
    kernels.append(_against_plain(
        torch, check, f"exact_rowdot of the rows ({N} x {D}) with their "
                      f"clusters' directions (GDI's projections)",
        functools.partial(exact_round.exact_rowdot, x, proj_dirs,
                          res.assignment),
        functools.partial(ref.exact_rowdot, x, proj_dirs, res.assignment),
        dict(name="exact_rowdot",
             source="src/repro_torch/kernels/csrc/exact_round.cu",
             replaces="src/repro/core/gdi.py:215",
             launches=launches["exact_rowdot"]),
        bound((N * D + K * D + N) * 4.0 + N * 8.0, 2.0 * N * D)))
    st = sb.init_resident(x, torch.ones(N, device=dev), c, res.assignment)
    nb, s_rows = st.b2c.shape[0], st.pid.shape[0]
    bn = s_rows // nb
    seg = torch.repeat_interleave(st.b2c.long(), bn)
    seg = torch.where((seg >= 0) & (st.wg > 0), seg, K)
    kernels.append(_against_plain(
        torch, check, f"segment_sum_blocks over the final arena ({s_rows} "
                      f"slots, bn={bn})",
        functools.partial(segment_sum_blocks, st.xg, st.b2c, K, bn,
                          w=st.wg),
        functools.partial(ref.segment_sum_blocks_ref, st.xg, st.b2c, K, bn,
                          w=st.wg),
        dict(name="segment_sum_blocks",
             source="src/repro_torch/kernels/csrc/segment_sum.cu",
             replaces="src/repro/core/engine.py:264",
             launches=launches["segment_sum_blocks"]),
        bound(s_rows * (D + 1) * 4.0 + nb * 4.0 + K * (D + 1) * 4.0,
              2.0 * s_rows * D),
        library=lambda: torch.zeros(K + 1, D, device=dev).index_add_(
            0, seg, st.xg * st.wg[:, None])))
    del st, seg
    for kr in kernels:
        print(f"phase 3: {kr['name']}: {kr['ms']:.4f} ms, plain "
              f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']}, bound "
              f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}), launches "
              f"{kr['launches']}")

    if "--profile" in sys.argv[1:]:
        _profile(torch, "fit", lambda: fit(
            x, K, method="k2means", init="gdi", kn=KN, max_iters=MAX_ITERS,
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1)))
        for prec in ("f32", "int8"):
            _profile(torch, f"predict {prec}", lambda: model.predict(
                queries, batch_size=BATCH, precision=prec))
        _profile(torch, "Lloyd++ fit", lambda: fit(
            x, K, method="lloyd", init="kmeanspp", max_iters=LLOYD_ITERS,
            device=dev, generator=pp_gen()))
        _profile_serve(torch, serve, lm)

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


def _profile(torch, label: str, fn) -> None:
    """``fn`` once more under torch.profiler (CPU + CUDA): device time by
    kernel, the busy share of the host clock, and the host calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    print(f"profile {label}: wall {wall:.4f} s under the profiler; device "
          f"busy {busy:.4f} s = {100 * busy / wall:.1f}% of the wall")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:25]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<6d} {e.key[:100]}")
    for e in events:
        if "Synchronize" in e.key or "Memcpy" in e.key:
            print(f"  host calls: {e.key} x{e.count}")


def _profile_serve(torch, serve, lm) -> None:
    """Phase 2e's decode under the profiler: 8 full-attention steps (over
    the flat cache's prompt, rewriting its decode slots), 8 k²-attention
    steps, and one fold of the ring they filled."""
    cfg, params = lm["cfg"], lm["params"]
    tok = lm["prompt"][:, -1:]
    _profile(torch, "full decode x8", lambda: serve.decode(
        cfg, params, lm["flat_cache"], tok, LM_PROMPT, 8))
    pos = LM_PROMPT + LM_DECODE + 2
    _profile(torch, "clustered decode x8", lambda: serve.decode(
        cfg, params, lm["cache"], tok, pos, 8))
    rows = int(lm["cache"]["stack"]["ring_fill"][0])
    _profile(torch, f"ring fold ({rows} rows x {LM_LAYERS} layers)",
             lambda: serve.fold_ring(lm["cache"], lm["counts"]))


def _predict_layout(torch, model, qb, prec, choose_group_bn,
                    group_by_cluster_device):
    """One predict batch grouped by its routed centers, as the model's
    resolution groups it: (grouped rows, b2c, skip, bn, live rows,
    distinct candidate lists that live blocks read)."""
    bn = choose_group_bn(qb.shape[0], model.k, model.d, bkn=BKN,
                         itemsize=1 if prec == "int8" else 4)
    routed = model.route_batch(qb, precision=prec)[0]
    perm, b2c = group_by_cluster_device(routed, model.k, bn)
    skip = (~(perm >= 0).reshape(-1, bn).any(1)).to(torch.int32)
    live = int((skip == 0).sum()) * bn
    slabs = int(torch.unique(b2c[skip == 0]).numel())
    return (qb[perm.clamp(min=0).long()].contiguous(), b2c, skip, bn, live,
            slabs)


def _against_plain(torch, check, what, kern, plain, entry, bound_ms_by,
                   library=None):
    """Hold a kernel bit-equal to its plain version on the same inputs
    and time both, and ``library`` (one PyTorch call computing the same
    function) where there is one: the kernels line's entry."""
    got, want = kern(), plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    pairs = [(g, w) for g, w in zip(got, want) if g is not None]
    same = all(bool(torch.equal(g, w)) for g, w in pairs)
    err = max(float((g.double() - w.double()).abs().max()) for g, w in pairs)
    check(same, f"{what} vs plain: bit-equal ({same}), max abs err "
                f"{err:.3g}")
    return dict(entry, route="cuda", max_abs_err=err,
                ms=time_ms(kern, torch), plain_ms=time_ms(plain, torch),
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                library_ms=None if library is None else time_ms(library,
                                                                torch))


def _k3_agrees(torch, check, segmented_scan, ref, xg, w, b2s, bn,
               what) -> float:
    """K3 against its plain version on one layout: on the CPU, where
    torch's cumsum adds in K3's order, bit-equal; on the card, rtol 1e-5
    plus 1e-5 times the segment's sum of |.|, counts exact; and against
    itself, a second launch bit-equal. Returns the max abs error against
    the CPU's plain version."""
    cs_k, qs_k, cn_k = segmented_scan(xg, w, b2s, bn=bn)
    cs_p, qs_p, cn_p = ref.segmented_scan_ref(xg, w, b2s, bn)
    again = segmented_scan(xg, w, b2s, bn=bn)
    check(all(bool(torch.equal(a, b))
              for a, b in zip(again, (cs_k, qs_k, cn_k))),
          f"K3 launched twice on {xg.shape[0]} rows, {what}: bit-equal")
    cpu = ref.segmented_scan_ref(xg.cpu(), w.cpu(), b2s.cpu(), bn)
    same = all(bool(torch.equal(a.cpu(), b))
               for a, b in zip((cs_k, qs_k, cn_k), cpu))
    cpu_err = max(float((a.cpu().double() - b.double()).abs().max())
                  for a, b in zip((cs_k, qs_k, cn_k), cpu))
    check(same, f"K3 on {xg.shape[0]} rows, {what}, vs its plain version "
                f"on the CPU: bit-equal ({same}), max abs err "
                f"{cpu_err:.3g}")
    nseg = int(b2s.max()) + 1
    row_seg = torch.repeat_interleave(b2s.long(), bn)
    xw = xg * w[:, None]
    seg_abs_x = torch.zeros(nseg, xg.shape[1], device=xg.device).index_add_(
        0, row_seg, xw.abs())[row_seg]
    seg_abs_q = torch.zeros(nseg, device=xg.device).index_add_(
        0, row_seg, (xw * xg).sum(1))[row_seg]
    err = max(float((cs_k - cs_p).abs().max()),
              float((qs_k - qs_p).abs().max()))
    check(bool(((cs_k - cs_p).abs()
                <= 1e-5 * cs_p.abs() + 1e-5 * seg_abs_x).all())
          and bool(((qs_k - qs_p).abs()
                    <= 1e-5 * qs_p.abs() + 1e-5 * seg_abs_q).all())
          and bool((cn_k == cn_p).all()),
          f"K3 segmented_scan vs plain on {xg.shape[0]} rows, {what}: max "
          f"abs err {err:.3g} (rtol 1e-5, atol 1e-5 * the segment's sum of "
          f"|.|); counts exact")
    return cpu_err


def _cublas_argmin(torch, x, c, chunk: int = 4096):
    """The f32 cuBLAS path the port's nearest-center assignment took
    before K5: ``x_sq - 2 x @ c.T + c_sq`` per 4096-row chunk, then
    ``torch.min``."""
    c_sq = (c * c).sum(1)
    return [torch.min(((xb * xb).sum(1)[:, None] - 2.0 * (xb @ c.T)
                       + c_sq).clamp(min=0.0), dim=1)
            for xb in torch.split(x, chunk)]


def _host_reads(torch, fn) -> int:
    """Device-to-host copies during one call of ``fn``: each drains the
    queue (a .item(), int(), bool() or .tolist() of a CUDA tensor)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("Memcpy DtoH"))


def _neighborhood_min(torch, q, c, nbh, chunk: int = 8192):
    """Plain PyTorch: each query's least squared distance over its
    candidate centers ``nbh`` (m, kn), by the oracle's formula with its
    norms and products rounded once from f64."""
    c64 = c.double()
    csq = (c64 * c64).sum(1).float()
    out = []
    for lo in range(0, q.shape[0], chunk):
        qd = q[lo:lo + chunk].double()
        ids = nbh[lo:lo + chunk]
        cross = torch.gather((qd @ c64.T).float(), 1, ids)
        sq = ((qd * qd).sum(1).float()[:, None] - 2.0 * cross
              + csq[ids]).clamp(min=0.0)
        out.append(sq.min(1).values)
    return torch.cat(out)


def time_ms_cold(fn, torch, reps: int = 10, warmup: int = 2,
                 flush_bytes: int = 256 << 20) -> float:
    """Mean device time of ``fn`` in ms from CUDA events around each
    launch, with the L2 cache flushed (a 256 MiB write, untimed) before
    each, after warm-up."""
    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _lm_serve(torch, dev, serve, check) -> dict:
    """Phase 2e: ``serve.run`` at Qwen3-8B's width, depth cut to
    LM_LAYERS, with every launch count set to 0 just before; prints and
    checks its measurements and returns its result."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    full_depth = get_config(LM_ARCH).n_layers
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _build.reset_launches()
    r = serve.run(cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                  decode_len=LM_DECODE, fold_every=LM_FOLD, device=dev,
                  seed=SEED, echo=lambda line: print(f"  serve: {line}"))
    torch.cuda.synchronize()
    launches = _build.launches()
    peak = torch.cuda.max_memory_allocated() - base
    st = r["cache"]["stack"]
    fill_after = int(st["ring_fill"].sum())
    tok = r["prompt"][:, -1:]
    pos = LM_PROMPT + LM_DECODE
    reads = _host_reads(torch, lambda: serve.decode(
        cfg, r["params"], r["cache"], tok, pos, 2))
    slots = LM_PROMPT * LM_BATCH * cfg.n_kv_heads * LM_LAYERS
    print(f"phase 2e: {cfg.name} cut to {LM_LAYERS} of {full_depth} layers "
          f"(d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, d_head "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), {LM_BATCH} "
          f"requests x {LM_PROMPT} prompt tokens, {LM_DECODE} decode tokens,"
          f" kc {cfg.kv_clusters}, cap {cfg.cluster_cap}, top-p "
          f"{cfg.cluster_top_p}, ring {cfg.cluster_ring}, fold every "
          f"{r['fold_every']}")
    print(f"  prefill {r['t_prefill']:.3f} s; attach (k2-means + repack of "
          f"{LM_LAYERS} layers) {r['t_attach']:.3f} s, tokens dropped by "
          f"full clusters {r['dropped']} of {slots} "
          f"({100.0 * r['dropped'] / slots:.3f}%)")
    print(f"  decode: full {r['t_full'] / LM_DECODE * 1e3:.3f} ms/token, "
          f"clustered {r['t_clus'] / LM_DECODE * 1e3:.3f} ms/token with "
          f"folds ({r['t_clus_loop'] / LM_DECODE * 1e3:.3f} in the loop "
          f"before the tail fold); token agreement {r['agreement']:.4f}")
    print(f"  folds: {r['folded']} ring slots, {r['sizes1'] - r['sizes0']} "
          f"member rows absorbed ({r['sizes0']} -> {r['sizes1']}); "
          f"attention reads/token: full {r['reads_full']}, clustered "
          f"{r['reads_clus']} ({r['reads_full'] / r['reads_clus']:.1f}x "
          f"fewer)")
    print(f"  peak device memory +{peak / 2 ** 30:.2f} GiB; host reads "
          f"{reads} for 2 decode steps; launches {launches}")
    want = LM_LAYERS * LM_DECODE
    check(launches["cluster_attend"] == want
          and r["launches"]["cluster_attend"] == want
          and sum(launches.values()) == want,
          f"cluster_attend (K6) launched once per layer per clustered token "
          f"and nothing else launched ({launches['cluster_attend']} for "
          f"{want})")
    for f in ("prefill_logits", "full_logits", "clus_logits"):
        check(tuple(r[f].shape) == (LM_BATCH, cfg.vocab)
              and bool(torch.isfinite(r[f]).all()),
              f"{f} finite, shape ({LM_BATCH}, {cfg.vocab})")
    check(r["folded"] == LM_DECODE * LM_LAYERS and 0 <= r["sizes1"]
          - r["sizes0"] <= r["folded"] * LM_BATCH * cfg.n_kv_heads
          and r["dropped"] >= 0 and fill_after == 0,
          f"the folds took {r['folded']} ring slots, one per layer per "
          f"decoded token, and left the ring empty")
    check(reads == 2, f"host reads: 1 per decode step ({reads} for 2)")
    _small_serve_agrees(torch, dev, serve, check)
    return dict(r, cfg=cfg, launches_all=launches)


def _small_serve_agrees(torch, dev, serve, check) -> None:
    """The smoke config's serve path in f32 on the card (K6) against the
    plain CPU path on the same params and prompt: prefill, clustering
    and 4 teacher-forced k²-attention decode steps; logits within 1e-4
    of their largest magnitude (f32, sums in other orders)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import init_cache, init_params, serve_step
    cfg = get_smoke_config(LM_ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")

    def f32(t, where):
        if isinstance(t, dict):
            return {k: f32(v, where) for k, v in t.items()}
        return (t.float() if t.is_floating_point() else t).to(where)
    prompt = torch.randint(0, cfg.vocab, (2, 48),
                           generator=torch.Generator().manual_seed(4))
    toks = torch.randint(0, cfg.vocab, (4, 2, 1),
                         generator=torch.Generator().manual_seed(5))
    out = {}
    for where in ("cpu", dev):
        p = f32(params, where)
        cache = f32(init_cache(cfg, 2, 48 + 5, clustered=False,
                               device="cpu"), where)
        logits, cache = serve.prefill_into_cache(cfg, p, cache,
                                                 prompt.to(where))
        cache = serve.attach_clusters(cfg, cache, length=48)
        steps = [logits]
        for i in range(4):
            logits, cache = serve_step(cfg, p, cache, toks[i].to(where),
                                       48 + i)
            steps.append(logits)
        out[str(where)] = [s.cpu() for s in steps]
    err = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(out[str(dev)], out["cpu"]))
    check(err <= 1e-4, f"small serve (smoke config in f32, 2 layers) on the "
                       f"card agrees with the plain CPU path: logits max "
                       f"rel err {err:.3g} (<= 1e-4)")


def _k6_entry(torch, check, lm, cluster_attend_partial, ref) -> dict:
    """K6 on layer 0's cluster-major tables at a decode step (the layer's
    query for the last decoded token, its top-p selection) against its
    plain version; its bound and SDPA over the pre-gathered blocks."""
    import torch.nn.functional as F
    from repro_torch.kernels.cluster_attend import select_clusters
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import layer_params
    cfg, params, st = lm["cfg"], lm["params"], lm["cache"]["stack"]
    B, Hkv, _, cap, dh = st["kt"].shape[1:]
    H, p = cfg.n_heads, cfg.cluster_top_p
    p0 = layer_params(params["stack"], 0)
    h = params["embed"][lm["prompt"][:, -1:].long()]
    pos = torch.full((B, 1), LM_PROMPT + LM_DECODE, device=h.device)
    q, _, _ = attn.gqa_project(p0["attn"], rmsnorm(p0["ln1"], h), H, Hkv, dh,
                               pos, cfg.rope_theta, cfg.qk_norm)
    sel = select_clusters(q[:, 0], st["cent"][0], p)  # the decode path's
    qf = q[:, 0].reshape(B * H, dh).float().contiguous()
    kt = st["kt"][0].reshape(-1, cap, dh)
    vt = st["vt"][0].reshape(-1, cap, dh)
    sizes = st["sizes"][0].reshape(-1)

    def kern():
        return cluster_attend_partial(qf, kt, vt, sel, sizes=sizes)

    def plain():
        return ref.cluster_attend_ref(qf, kt, vt, sel, sizes=sizes)
    (m, l, acc), (m_p, l_p, acc_p) = kern(), plain()
    acc_abs = ref.cluster_attend_ref(qf, kt, vt.abs(), sel, sizes=sizes)[2]
    empty = torch.isinf(m_p)
    live = ~empty
    res = torch.exp(m[live] - m_p[live])
    ok = bool(torch.equal(torch.isinf(m), empty)) \
        and bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all()) \
        and torch.allclose(m[live], m_p[live], rtol=1e-5, atol=1e-6) \
        and torch.allclose(l[live] * res, l_p[live], rtol=1e-5, atol=0.0) \
        and bool(((acc[live] * res[:, None] - acc_p[live]).abs()
                  <= 1e-5 * acc_abs[live] + 1e-6).all())
    out_k = acc / torch.clamp(l, min=1e-30)[:, None]
    out_p = acc_p / torch.clamp(l_p, min=1e-30)[:, None]
    err = float((out_k - out_p).abs().max())
    check(ok, f"K6 on layer 0's tables ({tuple(kt.shape)} bf16, {B * H} "
              f"rows, p={p}) vs plain: m, l within rtol 1e-5 (rescaled to "
              f"the plain max), acc within atol 1e-5 of the row's sum of "
              f"w|v|, empty rows exact; "
              f"attention output max abs err {err:.3g}")
    # bound: the distinct selected blocks' live rows of K and V (bf16),
    # q, sel and the sizes read, the outputs written; 4 dh FLOPs per
    # (query row, live row) pair
    ids = torch.unique(sel.long())
    live_rows = int(sizes.long()[ids].sum())
    pair_rows = int(sizes.long()[sel.long()].sum())
    n_bytes = (live_rows * dh * 2 * 2 + qf.numel() * 4 + sel.numel() * 4
               + ids.numel() * 4 + B * H * (dh + 2) * 4)
    b_ms, b_by = bound(n_bytes, 4.0 * dh * pair_rows)
    # SDPA over the pre-gathered blocks with the validity mask (the gather
    # is outside the timed call)
    s = sel.long()
    kk = kt[s].reshape(B * H, 1, p * cap, dh)
    vv = vt[s].reshape(B * H, 1, p * cap, dh)
    mask = (torch.arange(cap, device=h.device)
            < sizes.long()[s][..., None]).reshape(B * H, 1, 1, p * cap)
    qb = qf.to(torch.bfloat16).reshape(B * H, 1, 1, dh)
    print(f"  K6 at the decode step: {live_rows} distinct live rows in "
          f"{ids.numel()} selected blocks, {pair_rows} (row, block) reads, "
          f"mean block size {float(sizes.float().mean()):.2f} of {cap}")
    return dict(
        name="cluster_attend", route="cuda",
        source="src/repro_torch/kernels/csrc/cluster_attend.cu",
        replaces="src/repro/kernels/cluster_attend.py:67",
        launches=lm["launches_all"]["cluster_attend"], max_abs_err=err,
        ms=time_ms_cold(kern, torch), plain_ms=time_ms_cold(plain, torch),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms_cold(lambda: F.scaled_dot_product_attention(
            qb, kk, vv, attn_mask=mask), torch))


def _fixture_agrees(torch, dev, check, rounding_fixture, K2Step,
                    center_knn_graph, pad_candidates, candidate_tables,
                    candidate_assign_tiled, candidate_assign_rowwise,
                    distance_argmin, ref) -> None:
    """K5, K1 and K7 against their plain versions on rows whose products
    with their own centers sit just above f32 rounding midpoints (f64
    sums in different orders round them apart): bit-equal."""
    k, kn = 64, 8
    x, c, a = rounding_fixture(k * 40, k, D, seed=17, device=dev)
    same5 = all(bool(torch.equal(g, w)) for g, w in zip(
        distance_argmin(x, c), ref.distance_argmin_ref(x, c)))
    st = K2Step(k=k, kn=kn, bkn=BKN).init_resident(
        x, torch.ones(x.shape[0], device=dev), c, a)
    nb = st.b2c.shape[0]
    bn = st.pid.shape[0] // nb
    graph = center_knn_graph(c, kn)
    cidx = pad_candidates(graph, BKN).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    zi = torch.zeros(st.pid.shape[0], dtype=torch.int32, device=dev)
    zf = torch.zeros(st.pid.shape[0], device=dev)
    noskip = torch.zeros(nb, dtype=torch.int32, device=dev)
    args = (st.xg, ctab, csqtab, cidx, rowsel, noskip, zi, zf, zf)
    same1 = all(bool(torch.equal(g, w)) for g, w in zip(
        candidate_assign_tiled(*args, bn=bn, bkn=BKN),
        ref.candidate_assign_tiled_ref(*args, bn)))
    args7 = (st.xg, c, graph[rowsel.long()].contiguous(), noskip, zi, zf)
    same7 = all(bool(torch.equal(g, w)) for g, w in zip(
        candidate_assign_rowwise(*args7, bn=bn),
        ref.candidate_assign_ref(*args7, bn)))
    check(same5 and same1 and same7,
          f"K5, K1 and K7 on the rounding fixture ({x.shape[0]} rows at f32 "
          f"rounding midpoints, k={k}, d={D}) vs plain: bit-equal "
          f"({same5}, {same1}, {same7})")


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


def _small_gdi_fit_agrees(torch, dev, fit_k2means, check) -> None:
    """The small fit's rows again, from GDI (the same uniform draws on
    both devices) at k = 24 on 16 blobs, so that GDI splits blobs where
    rows score within rounding of each other: the card's GDI and
    k²-means against the plain CPU path, same GDI assignment, same
    iteration count and assignments, energies within rel 1e-5."""
    from repro_torch.core.gdi import gdi_device_init
    g = torch.Generator().manual_seed(7)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    draws = [(torch.rand(3000, generator=g), torch.rand(3000, generator=g))
             for _ in range(64)]
    out = {}
    for where in ("cpu", dev):
        c0, a0 = gdi_device_init(x, 24, draws=draws, device=where)
        out[str(where)] = (a0.cpu(), fit_k2means(x, c0, a0, kn=8,
                                                 max_iters=30, device=where))
    (a_cpu, r_cpu), (a_gpu, r_gpu) = out["cpu"], out[str(dev)]
    same_init = bool(torch.equal(a_cpu, a_gpu))
    same = bool((r_gpu.assignment.cpu() == r_cpu.assignment).all())
    rel = abs(r_gpu.energy - r_cpu.energy) / abs(r_cpu.energy)
    check(same_init and same and r_gpu.iterations == r_cpu.iterations
          and rel <= 1e-5,
          f"small fit from GDI (n=3000, d=16, k=24) on the card equals the "
          f"plain CPU path: GDI assignments {same_init}, k2-means "
          f"assignments {same}, iterations {r_gpu.iterations} vs "
          f"{r_cpu.iterations}, energy rel diff {rel:.2g}")


def _small_predict_agrees(torch, dev, fit_k2means, KMeansModel, OpCounter,
                          check) -> None:
    """A small served model through the kernels against the same model on
    the CPU's plain path: assignments, distances and counted charges in
    both precisions."""
    g = torch.Generator().manual_seed(11)
    mus = torch.randn(16, 16, generator=g) * 8
    x = mus[torch.randint(0, 16, (3000,), generator=g)] \
        + torch.randn(3000, 16, generator=g)
    q = mus[torch.randint(0, 16, (1000,), generator=g)] \
        + torch.randn(1000, 16, generator=g)
    init = x[torch.randperm(3000, generator=g)[:24]]
    a0 = torch.cdist(x, init).argmin(1).to(torch.int32)
    res = fit_k2means(x, init, a0, kn=8, max_iters=30, device="cpu")
    out = {}
    for where in ("cpu", dev):
        model = KMeansModel.from_result(res, x, kn=8, device=where)
        for prec in ("f32", "int8"):
            counter = OpCounter()
            a, d = model.predict(q, counter=counter, return_sqdist=True,
                                 batch_size=256, precision=prec)
            out[str(where), prec] = (a.cpu(), d.cpu(), counter.distances,
                                     counter.int8_ops, counter.bytes_scanned)
    for prec in ("f32", "int8"):
        cpu, gpu = out["cpu", prec], out[str(dev), prec]
        same = bool(torch.equal(cpu[0], gpu[0])) \
            and bool(torch.equal(cpu[1], gpu[1]))
        check(same and cpu[2:] == gpu[2:],
              f"small predict {prec} (n=1000, d=16, k=24) on the card equals "
              f"the plain CPU path: assignments and distances {same}, "
              f"charges {gpu[2:]} vs {cpu[2:]}")


if __name__ == "__main__":
    sys.exit(main())
