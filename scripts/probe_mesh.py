#!/usr/bin/env python3
"""Time the sharded k²-means fit across the cards of one host, on NCCL.

Run with one process per card, from the root of the repository:

    python3 -m torch.distributed.run --nproc_per_node 4 scripts/probe_mesh.py

Every rank works on ``cuda:<local rank>`` over one ``launch.mesh`` mesh of
the whole world and draws its data on its card from the seeds of
``chip_smoke.py`` (k=1000, k_n=30, d=784):

- strong scaling: phase 2's rows (n=60000) over P cards against one card.
  From phase 2's replicated GDI init centers (each rank draws them), the
  single-card ``fit_k2means`` (rank 0 alone, the others wait) and the
  sharded ``fit_distributed_k2means``: ms an iteration (host clock ended by
  a synchronize), iterations, energy, each rank's device busy time an
  iteration under ``torch.profiler`` (outside NCCL's kernels, and in
  them: an NCCL kernel's time includes its wait for the peers), rank 0's
  and the single card's top host and device entries, the bytes each rank
  sends an
  iteration (the mesh's gathers, less a one-iteration fit's, over the
  iterations after the first), the host
  reads an iteration (the profiler's device-to-host copies); then
  ``fit(mesh=, init="gdi")``, the sharded seed: its seconds, ms an
  iteration and energy; both fits again from 1000 random rows (which run
  to the iteration cap);
- weak scaling: 60000 rows a card (n = 60000 P) from the same mnist-shaped
  mixture (``data.synthetic.gmm_blobs``, seed 0): ``fit(mesh=,
  init="gdi")`` as above, then from its seed's centers the sharded fit
  and (rank 0 alone) the single-card fit at that n;
- the result against gloo: ROADMAP §3 entry 9's blobs (n=3000, d=16,
  k=48) fitted on the NCCL mesh on the cards and on a gloo mesh of the same
  ranks on the CPU, bit for bit.

Rank 0 prints the cards (``nvidia-smi`` name and power limit), one line a
measurement, and last one JSON object of them all, also written to
``chiprun_out/probe_mesh.json``.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, K, KN, TRUE_K, NQ, SEED, MAX_ITERS = 60000, 784, 1000, 30, 128, 65536, \
    0, 30


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("probe_mesh: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import _entry9_blobs
    from repro_torch.core import (OpCounter, assign_nearest, fit,
                                  fit_k2means, initialize, random_init)
    from repro_torch.core.distributed import fit_distributed_k2means
    from repro_torch.data import gmm_blobs
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import Mesh, init_process_group, make_mesh

    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    init_process_group("nccl", timeout=900)
    mesh = make_mesh(device=dev)
    P, me = mesh.size, mesh.index
    lead = me == 0
    out = {"cards": P}
    if lead:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        for line in smi:
            print(line)
        out["smi"] = smi
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, {P} ranks on NCCL")
    took = _build.build_all()
    if lead:
        print(f"built {sorted(took)}")
    barrier = torch.zeros((1,), device=dev)

    def sync():
        torch.cuda.synchronize(dev)
        mesh.sum(barrier)

    def device_busy(fn, tag=None) -> tuple[float, float, int]:
        """fn under the profiler: device busy seconds outside the
        collectives, the collectives' device seconds (an NCCL kernel
        also counts the time it waits for its peers), device-to-host
        copies; with ``tag``, the host's and the device's top entries."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(dev)
        busy, comm, reads = 0.0, 0.0, 0
        dev_us = lambda e: getattr(  # noqa: E731
            e, "self_device_time_total", getattr(e, "self_cuda_time_total",
                                                 0))
        events = prof.key_averages()
        on_dev = [e for e in events
                  if "CUDA" in str(getattr(e, "device_type", ""))]
        for e in on_dev:
            if "nccl" in e.key.lower():
                comm += dev_us(e) / 1e6
            else:
                busy += dev_us(e) / 1e6
        for e in events:
            if e.key.startswith("Memcpy DtoH"):
                reads += e.count
        if tag is not None:
            print(f"{tag}: the host's top entries by self time:")
            for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                            reverse=True)[:14]:
                print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  "
                      f"x{e.count:<6d} {e.key[:90]}")
            print(f"{tag}: the device's top entries:")
            for e in sorted(on_dev, key=dev_us, reverse=True)[:8]:
                print(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<6d} "
                      f"{e.key[:90]}")
        return busy, comm, reads

    def gathered(fn):
        g0, b0 = mesh.gathers, mesh.gathered_bytes
        r = fn()
        return r, mesh.gathers - g0, mesh.gathered_bytes - b0

    def sharded(x, c0, tag, detail=False):
        """The sharded fit from ``c0``: timed, traffic, profiled, and the
        card's memory it takes on each rank. Its rows are handed over on
        the host: each card takes its shard."""
        x = x.cpu()
        fit_distributed_k2means(x, K, KN, mesh, init_centers=c0,
                                max_iters=2)
        # the iterations after the first: a whole fit's gathers less a
        # one-iteration fit's (the same set-up and final gather)
        _, g_one, b_one = gathered(lambda: fit_distributed_k2means(
            x, K, KN, mesh, init_centers=c0, max_iters=1))
        sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        r, g, b = gathered(lambda: fit_distributed_k2means(
            x, K, KN, mesh, init_centers=c0, max_iters=MAX_ITERS,
            profile=True))
        peak = torch.cuda.max_memory_allocated(dev) - base
        it = max(r.iterations, 1)
        busy, comm, reads = device_busy(
            lambda: fit_distributed_k2means(x, K, KN, mesh, init_centers=c0,
                                            max_iters=MAX_ITERS),
            f"{tag}: sharded, rank 0" if lead and detail else None)
        each = mesh.gather(torch.tensor([busy / it, comm / it, peak],
                                        dtype=torch.float64,
                                        device=dev)).cpu()
        res = {"ms_per_iteration": r.profile["iterate_s"] / it * 1e3,
               "iterations": r.iterations, "energy": r.energy,
               "device_ms_per_iteration_by_rank":
                   [float(v) * 1e3 for v in each[:, 0]],
               "nccl_device_ms_per_iteration_by_rank":
                   [float(v) * 1e3 for v in each[:, 1]],
               "peak_mib_by_rank": [float(v) / 2**20 for v in each[:, 2]],
               "bytes_per_iteration": (b - b_one) / max(it - 1, 1),
               "gathers_per_iteration": (g - g_one) / max(it - 1, 1),
               "host_reads": reads, "a": r.assignment}
        if lead:
            busy_ms = [round(v, 4)
                       for v in res["device_ms_per_iteration_by_rank"]]
            comm_ms = [round(v, 4)
                       for v in res["nccl_device_ms_per_iteration_by_rank"]]
            print(f"{tag}: sharded over {P} cards: {r.iterations} "
                  f"iterations, {res['ms_per_iteration']:.3f} ms/iteration, "
                  f"energy {r.energy:.9g}, device ms/iteration by rank "
                  f"{busy_ms} (and in NCCL's kernels, waits included, "
                  f"{comm_ms}), {res['bytes_per_iteration']:.0f} bytes sent "
                  f"an iteration by each rank in "
                  f"{res['gathers_per_iteration']:.2f} gathers, host reads "
                  f"{reads} in {r.iterations} iterations (monitor every 1), "
                  f"the card's memory the fit takes by rank (peak above "
                  f"what was there before, its shard included) "
                  f"{[round(v, 3) for v in res['peak_mib_by_rank']]} MiB")
        return res

    def single(x, c0, tag, detail=False):
        """The single-card fit from ``c0`` on rank 0; the others wait."""
        res = None
        if lead:
            a0 = assign_nearest(x, c0)
            fit_k2means(x, c0, a0, kn=KN, max_iters=2, device=dev)
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            r = fit_k2means(x, c0, a0, kn=KN, max_iters=MAX_ITERS,
                            device=dev)
            torch.cuda.synchronize(dev)
            # the rows it was given on the card, and its own peak
            mib = (x.numel() * x.element_size()
                   + torch.cuda.max_memory_allocated(dev) - base) / 2**20
            it = max(r.iterations, 1)
            ms = (time.perf_counter() - t0) / it * 1e3
            busy, _, reads = device_busy(lambda: fit_k2means(
                x, c0, a0, kn=KN, max_iters=MAX_ITERS, device=dev),
                f"{tag}: one card" if detail else None)
            res = {"ms_per_iteration": ms, "iterations": r.iterations,
                   "energy": r.energy, "device_ms_per_iteration":
                       busy / it * 1e3, "host_reads": reads,
                   "mib": mib, "a": r.assignment}
            print(f"{tag}: one card: {r.iterations} iterations, {ms:.3f} "
                  f"ms/iteration (assignment included), energy "
                  f"{r.energy:.9g}, device {busy / it * 1e3:.4f} "
                  f"ms/iteration, host reads {reads}, the card's memory "
                  f"(its rows and the fit's peak) {mib:.3f} MiB")
        sync()
        return res

    def seeded(x, tag):
        x = x.cpu()                      # each card takes its shard
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        fit(x, K, mesh=mesh, init="gdi", kn=KN, max_iters=1,
            generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        sync()
        r = fit(x, K, mesh=mesh, init="gdi", kn=KN, max_iters=MAX_ITERS,
                profile=True, generator=gen)
        it = max(r.iterations, 1)
        res = {"seed_s": r.profile["init_s"], "iterations": r.iterations,
               "ms_per_iteration": r.profile["iterate_s"] / it * 1e3,
               "energy": r.energy}
        if lead:
            print(f"{tag}: fit(mesh=, init='gdi'): the sharded seed "
                  f"{res['seed_s']:.3f} s, {r.iterations} iterations, "
                  f"{res['ms_per_iteration']:.3f} ms/iteration, energy "
                  f"{r.energy:.9g}")
        return res

    def compare(tag, one, many):
        if lead:
            diff = int((one.pop("a") != many["a"]).sum())
            print(f"{tag}: {diff} of {many['a'].shape[0]} assignments "
                  f"differ between one card and {P}; ms/iteration "
                  f"{one['ms_per_iteration']:.3f} vs "
                  f"{many['ms_per_iteration']:.3f} (x"
                  f"{one['ms_per_iteration'] / many['ms_per_iteration']:.3f}"
                  f")")
            one["assignments_differ"] = diff
        many.pop("a")

    # --- strong scaling: phase 2's rows --------------------------------
    allx = gmm_blobs(N + NQ, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    x = allx[:N].clone()
    del allx
    t0 = time.perf_counter()
    c0, _ = initialize(x, K, "gdi",
                       torch.Generator(device=dev).manual_seed(SEED + 1),
                       OpCounter())
    torch.cuda.synchronize(dev)
    gdi_s = time.perf_counter() - t0
    same_c0 = mesh.gather(c0)
    if lead:
        print(f"strong (n={N}): replicated GDI on each card {gdi_s:.3f} s, "
              f"every card drew the same centers "
              f"{all(torch.equal(same_c0[i], c0) for i in range(P))}")
    out["strong"] = {"single": single(x, c0, "strong"),
                     "sharded": sharded(x, c0, "strong")}
    compare("strong", out["strong"]["single"], out["strong"]["sharded"])
    # from 1000 random rows (probe_fit.py's start) the fit runs to the
    # iteration cap: the steadier per-iteration comparison
    cr = random_init(x, K, torch.Generator(device=dev).manual_seed(SEED + 1))
    tag = "strong, random start"
    out["strong_random"] = {"single": single(x, cr, tag, detail=True),
                            "sharded": sharded(x, cr, tag, detail=True)}
    compare(tag, out["strong_random"]["single"],
            out["strong_random"]["sharded"])
    out["strong"]["seeded"] = seeded(x, "strong")
    del x, c0, cr

    # --- weak scaling: 60000 rows a card -------------------------------
    n_w = N * P
    xw = gmm_blobs(n_w, D, TRUE_K, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    # the rows on the host; only rank 0's single-card fit keeps them all
    # on its card
    xw_h = xw.cpu()
    if not lead:
        xw = None
    out["weak"] = {"n": n_w, "seeded": seeded(xw_h, f"weak (n={n_w})")}
    seed_fit = fit_distributed_k2means(
        xw_h, K, KN, mesh, torch.Generator(device=dev).manual_seed(SEED + 1),
        init="gdi", max_iters=0)
    cw = seed_fit.centers
    out["weak"]["single"] = single(xw, cw, f"weak (n={n_w})")
    out["weak"]["sharded"] = sharded(xw_h, cw, f"weak (n={n_w})")
    compare("weak", out["weak"]["single"], out["weak"]["sharded"])
    del xw, xw_h, cw, seed_fit

    # --- NCCL on the cards against gloo on the CPU ---------------------
    gloo = Mesh({"data": P}, range(P),
                dist.new_group(backend="gloo", timeout=mesh.timeout), "cpu",
                timeout=mesh.timeout)
    xs, init = _entry9_blobs(torch)
    got = {}
    for name, m in (("nccl", mesh), ("gloo", gloo)):
        r = fit_distributed_k2means(xs.to(m.device), 48, 8, m,
                                    init_centers=init.to(m.device),
                                    max_iters=20, backend="kernels")
        got[name] = (r.assignment.cpu(), r.centers.cpu(), r.energy,
                     r.iterations)
    (an, cn, en, itn), (ag, cg, eg, itg) = got["nccl"], got["gloo"]
    out["small_equal"] = bool(torch.equal(an, ag) and torch.equal(cn, cg)
                              and en == eg and itn == itg)
    if lead:
        print(f"entry 9's blobs (n=3000, d=16, k=48): NCCL on {P} cards "
              f"equals gloo on the CPU bit for bit: {out['small_equal']} "
              f"({itn} iterations, energy {en:.9g})")
        path = ROOT / "chiprun_out" / "probe_mesh.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(out, indent=1, default=float))
        print(json.dumps(out, default=float))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
