"""k2lint registries of the port: its hot-path entry points and its
launched kernels (DESIGN.md §15.2), the counterpart of
``repro.analysis.registry``.

``audit_entries()`` returns every hot-path entry the host-sync auditor
runs — the :class:`core.engine.K2Step` build products across backend ×
residency × precision × placement, the query-time stages of
:class:`core.model.KMeansModel`, the streaming delta update, arena
append and eviction, the GDI round step, and the LM's decode and
training steps. ``kernel_entries()`` returns one entry per key of
``kernels._build.LAUNCHES``: the seven ported TPU kernels and the
port-only ones, each with cases that reach every instantiation its
launcher can pick.

Registering a new entry point: append an :class:`EntryPoint` whose
``build(device)`` returns ``(fn, args)``; ``fn(*args)`` runs eagerly at
tiny shapes, so every run builds fresh inputs. Its budgets are declared
here, before the audit runs, from the design (DESIGN.md §3, §4.3, §7.2,
§13) and the port's ground rules, and are never raised to make a finding
go away: ``host_reads`` (device-to-host reads a call), ``dynamic_shape_ops``
(ops whose output shape depends on data), ``collectives`` (``Mesh``
collectives a call, sharded entries only), ``sanctioned_dequants``
(int8 -> f32 conversions a call) and ``f64_ok`` (``file::function`` ->
the reason f64 is part of the correct-rounding design there). Entries
with ``mesh=True`` run on a one-rank gloo mesh made in the auditor's own
process (:func:`mesh1`).

Registering a new kernel: append a :class:`KernelEntry` with cases
whose ``build(device)`` returns ``(fn, args, plan)``: ``fn(*args)``
launches the kernel, and ``plan()`` is the wrapper's ``plan_<kernel>``
at the same shapes, the plan its launcher launches by.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
import typing

import numpy as np

# representative shapes for the host-sync audit (tiny: CPU-runnable)
_N, _D, _K, _KN, _M = 256, 32, 16, 4, 64
_BN, _BKN = 64, 4
_P = "src/repro_torch/"

# f64 where the correct-rounding design puts it (ROADMAP §3 entries 7-10,
# 11 and 18): file::function -> reason
F64_ROOTS = {
    _P + "kernels/ref.py::sqrt_rn":
        "§3 entry 18: every f32 root of the port is the f64 root rounded "
        "once (torch's f32 sqrt on the CPU is not correctly rounded)",
}
F64_INT8 = {
    _P + "kernels/ref.py::exact_cross":
        "§3 entry 7: int8 products are summed exactly in f64 and rounded "
        "once (PyTorch has no integer matmul on the card; "
        "kernels/quant.py)",
    _P + "kernels/ref.py::exact_sqnorm":
        "§3 entry 7: int8 rows' squared norms are summed exactly in f64 "
        "and rounded once",
}
F64_DECAY = {
    _P + "core/engine.py::decay_pow":
        "§3 entry 11: decay^age by one fixed order of f64 products, "
        "rounded once to f32, so the card and the CPU agree",
}


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    name: str
    file: str                       # repo-relative file the entry lives in
    build: typing.Callable          # (device) -> (fn, args)
    host_reads: int = 0             # device-to-host reads a call
    dynamic_shape_ops: int = 0      # data-dependent output shapes a call
    collective_free: bool = True    # any Mesh collective -> finding
    collectives: int = 0            # Mesh collectives a call (sharded)
    int8_region: bool = False       # the dtype rule counts dequantizations
    sanctioned_dequants: int = 0    # allowed int8 -> f32 converts (§13)
    f64_ok: dict = dataclasses.field(default_factory=lambda: dict(F64_ROOTS))
    build_alt: typing.Callable | None = None   # args at a 2nd shape
    mesh: bool = False              # runs on a one-rank gloo mesh


@dataclasses.dataclass(frozen=True)
class KernelCase:
    label: str
    build: typing.Callable          # (device) -> (fn, args, plan)
    min_blocks_per_sm: int = 1      # resident blocks the design states
    scalar_ok: bool = False         # the case exercises the scalar path


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    name: str                       # key of kernels._build.LAUNCHES
    file: str                       # the wrapper
    source: str                     # the CUDA source
    lib: str                        # its library (kernels._build.SOURCES)
    symbol: str                     # the __global__ function's name
    cases: tuple
    pad_ok: tuple = ()              # plan axes the kernel guards itself


# ---------------------------------------------------------------------------
# audit entries (pass 1)
# ---------------------------------------------------------------------------


def _t(a, dev):
    import torch
    return torch.as_tensor(a, device=dev).contiguous()


def _points(dev, n=_N, d=_D, seed=0):
    import torch
    r = np.random.default_rng(seed)
    x = _t(r.standard_normal((n, d)).astype(np.float32), dev)
    return x, torch.ones((n,), dtype=torch.float32, device=dev)


def _seed_centers(x, k=_K):
    import torch
    c = x[:k].clone()
    a = (torch.arange(x.shape[0], device=x.device) % k).to(torch.int32)
    return c, a


_MESH: list = []


@contextlib.contextmanager
def mesh1(device):
    """A one-rank gloo mesh in this process (the counterpart of the
    reference's ``jax.make_mesh((1,), ("data",))``), the process group
    destroyed on exit; reused when a group is already up."""
    import torch.distributed as dist
    from ..launch import mesh as lmesh
    own = not dist.is_initialized()
    tmp = None
    if own:
        fd, tmp = tempfile.mkstemp(prefix="k2lint-gloo-")
        os.close(fd)
        os.unlink(tmp)
        lmesh.init_process_group("gloo", timeout=60.0,
                                 init_method=f"file://{tmp}", world_size=1,
                                 rank=0)
    try:
        _MESH.append(lmesh.make_mesh((1,), device=device))
        yield _MESH[-1]
    finally:
        _MESH.pop()
        if own:
            dist.destroy_process_group()
            if tmp and os.path.exists(tmp):
                os.unlink(tmp)


def _k2step(backend, residency, precision="f32", sharded=False):
    from ..core.engine import K2Step
    return K2Step(k=_K, kn=_KN, backend=backend,
                  mesh=_MESH[-1] if sharded else None, bn=_BN, bkn=_BKN,
                  residency=residency, precision=precision,
                  regroup_every=4, move_cap=64)


def _step_build(backend, residency, precision="f32", sharded=False, n=_N):
    def build(dev):
        from ..core import engine
        x, w = _points(dev, n=n)
        c, a = _seed_centers(x)
        step = _k2step(backend, residency, precision, sharded)
        fn = step.build(n, _D)
        if residency == "resident":
            st = step.init_resident(x, w, c, a)
        else:
            st = engine.init_state(c, a, _KN)
        return fn, (x, w, st)
    return build


def _router(c):
    from ..core.model import _build_router
    return _build_router(c, g=8, cap=8, iters=2)


def _neighbors(c):
    from ..core.engine import center_knn_graph
    return center_knn_graph(c, _KN)


def _route_build(probes, m=_M):
    def build(dev):
        from ..core.model import _route
        x, _ = _points(dev)
        c, _ = _seed_centers(x)
        q, _ = _points(dev, n=m, seed=1)
        return functools.partial(_route, probes=probes), (q, c, _router(c))
    return build


def _resolve_build(top2=False, n=_M):
    def build(dev):
        import torch
        from ..kernels.ops import (bounded_predict_assign,
                                   bounded_predict_assign_top2)
        x, _ = _points(dev)
        c, _ = _seed_centers(x)
        q, _ = _points(dev, n=n, seed=1)
        routed = (torch.arange(n, device=dev) % _K).to(torch.int32)
        fn = bounded_predict_assign_top2 if top2 else bounded_predict_assign
        return (functools.partial(fn, bn=_BN, bkn=_BKN),
                (q, c, _neighbors(c), routed))
    return build


def _resolve_int8_build(dev):
    import torch
    from ..kernels import quant
    from ..kernels.ops import bounded_predict_assign_int8
    x, _ = _points(dev)
    c, _ = _seed_centers(x)
    q, _ = _points(dev, n=_M, seed=1)
    routed = (torch.arange(_M, device=dev) % _K).to(torch.int32)
    fn = functools.partial(bounded_predict_assign_int8, bn=_BN, bkn=_BKN,
                           r=4, backend="kernels")
    return fn, (q, c, quant.center_quant(c), _neighbors(c), routed)


def _int8_rows(q):
    from ..kernels import quant
    xq, xsc = quant.quantize_rows(q)
    return xq, xsc, quant.residual_norm(q, xq, xsc)


def _route_groups_int8_build(dev):
    from ..core.model import _route_groups_int8
    from ..kernels import quant
    q, _ = _points(dev, n=_M, seed=1)
    gc, _ = _points(dev, n=8, d=_D, seed=2)
    xq, xsc, xerr = _int8_rows(q)
    return (functools.partial(_route_groups_int8, probes=2),
            (q, xq, xsc, xerr, gc, quant.center_quant(gc)))


def _route_members_int8_build(dev):
    import torch
    from ..core.model import _route_members_int8
    from ..kernels import quant
    x, _ = _points(dev)
    c, _ = _seed_centers(x)
    q, _ = _points(dev, n=_M, seed=1)
    xq, xsc, xerr = _int8_rows(q)
    cand = (torch.arange(_M * 8, device=dev).reshape(_M, 8) % _K
            ).to(torch.int32)
    return _route_members_int8, (q, xq, xsc, xerr, c,
                                 quant.center_quant(c), cand)


def _delta_update_build(dev):
    import torch
    from ..core.model import _delta_update
    x, w = _points(dev, n=_M)
    c, _ = _seed_centers(x, _K)
    sums = torch.zeros((_K, _D), dtype=torch.float32, device=dev)
    counts = torch.zeros((_K,), dtype=torch.float32, device=dev)
    ab = (torch.arange(_M, device=dev) % _K).to(torch.int32)
    return _delta_update, (c, sums, counts, x, w, ab, 0.99, 1e-3)


def _arena_append_build(dev):
    """One batch of 32 lanes, 24 live (padding lanes at weight 0) into the
    resident arena: the plan, then the append."""
    import torch
    from ..core.model import _append_plan, _arena_append, _batch_ids
    x, w = _points(dev)
    c, a = _seed_centers(x)
    step = _k2step("kernels", "resident")
    st = step.init_resident(x, w, c, a)
    cap = 2 * _N
    m, live = 32, 24
    xb, _ = _points(dev, n=m, seed=3)
    wb = (torch.arange(m, device=dev) < live).to(torch.float32)
    ab = (torch.arange(m, device=dev) % _K).to(torch.int32)
    ids = _batch_ids(wb, _N)

    def append(st, xb, wb, ab, ids):
        plan = _append_plan(st, wb, ab, bn=_BN)
        return _arena_append(st, xb, wb, ids, plan, cap=cap, n_live=live)
    return append, (st, xb, wb, ab, ids)


def _evict_build(dev):
    import torch
    from ..core.engine import resident_evict
    x, w = _points(dev)
    c, a = _seed_centers(x)
    st = _k2step("kernels", "resident").init_resident(x, w, c, a)
    eg = (torch.arange(st.pid.shape[0], device=dev) % 3).to(torch.int32)
    return resident_evict, (st, eg, 1, 2, 0.9, 0.0)


def _gdi_build(dev):
    import torch
    from ..core.gdi import gdi_round_step
    x, _ = _points(dev)
    nleaf = 4
    a = (torch.arange(_N, device=dev) % nleaf).to(torch.int32)
    centers = torch.zeros((_K, _D), dtype=torch.float32, device=dev)
    centers[:nleaf] = x[:nleaf]
    energies = torch.ones((_K,), dtype=torch.float32, device=dev)
    sizes = torch.full((_K,), _N // nleaf, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fn = functools.partial(gdi_round_step, k=_K, bn=_BN, generator=gen)
    return fn, (x, a, centers, energies, sizes,
                torch.tensor(nleaf, dtype=torch.int64, device=dev))


_LM_ARCH = "qwen3-8b"
_LM_B, _LM_PROMPT = 2, 24


def _decode_build(clustered: bool):
    """One decode step of qwen3-8b's smoke config as ``launch.serve.decode``
    drives it (its token read included), after a prefill, on a flat or
    a cluster-major (k²-attention, K6) cache."""
    def build(dev):
        import torch
        from ..configs.base import get_smoke_config
        from ..launch import serve
        from ..models.model import init_cache, init_params
        cfg = get_smoke_config(_LM_ARCH)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        prompt = torch.randint(0, cfg.vocab, (_LM_B, _LM_PROMPT),
                               generator=gen, device=dev, dtype=torch.int32)
        cache = init_cache(cfg, _LM_B, _LM_PROMPT + 4, clustered=False,
                           device=dev)
        _, cache = serve.prefill_into_cache(cfg, params, cache, prompt)
        if clustered:
            cache = serve.attach_clusters(cfg, cache, length=_LM_PROMPT)
        fn = functools.partial(serve.decode, cfg, params)
        return fn, (cache, prompt[:, -1:], _LM_PROMPT, 1)
    return build


def _train_build(dev):
    """One training step of qwen3-8b's smoke config through
    ``launch.train.MetricsStep`` (its one read of loss and norm)."""
    from ..configs.base import get_smoke_config
    from ..launch import train
    cfg = get_smoke_config(_LM_ARCH)
    state = train.init_state(cfg, seed=0, device=dev)
    batch = {k: v.to(dev) for k, v in
             train.batcher_for(cfg, 2, 16, seed=0).batch_at(0).items()}
    return train.MetricsStep(train.make_train_step(cfg)), (state, batch)


def audit_entries() -> list[EntryPoint]:
    """Every registered hot-path entry the auditor runs (at least 20)."""
    eng = _P + "core/engine.py"
    mod = _P + "core/model.py"
    ops = _P + "kernels/ops.py"
    int8 = {**F64_ROOTS, **F64_INT8}
    ents = [
        # --- K2Step build products (fit engines, DESIGN §8/§9/§13) -----
        # the rebuild step defers every read to the fit loop's flush
        EntryPoint("step/xla-rebuild-f32", eng,
                   _step_build("xla", "rebuild"),
                   build_alt=_step_build("xla", "rebuild", n=2 * _N)),
        EntryPoint("step/kernels-rebuild-f32", eng,
                   _step_build("kernels", "rebuild"),
                   build_alt=_step_build("kernels", "rebuild", n=2 * _N)),
        # the resident step's one read: overflow, any overflow, pool
        # exhausted and moved rows in one copy (engine.py, step 5)
        EntryPoint("step/xla-resident-f32", eng,
                   _step_build("xla", "resident"), host_reads=1),
        EntryPoint("step/kernels-resident-f32", eng,
                   _step_build("kernels", "resident"), host_reads=1,
                   build_alt=_step_build("kernels", "resident", n=2 * _N)),
        # §13 sanctioned dequants, two a step: the exact residual-norm
        # pass (quantized_scan_rerank's xerr) and center_quant's
        # round trip of the moved centers; the masters are never
        # dequantized
        EntryPoint("step/kernels-resident-int8", eng,
                   _step_build("kernels", "resident", "int8"), host_reads=1,
                   int8_region=True, sanctioned_dequants=2, f64_ok=int8),
        EntryPoint("step/xla-resident-int8", eng,
                   _step_build("xla", "resident", "int8"), host_reads=1,
                   int8_region=True, sanctioned_dequants=2, f64_ok=int8),
        # --- sharded placements (§7: the summed statistics) ------------
        # rebuild: the sums and the stats, one Mesh.sum each
        EntryPoint("step/kernels-rebuild-sharded", eng,
                   _step_build("kernels", "rebuild", sharded=True),
                   collective_free=False, collectives=2, mesh=True),
        # resident: the overflow flag, the sums and the stats (the
        # reference's three all_gathers an iteration, PERF.md §3)
        EntryPoint("step/kernels-resident-sharded", eng,
                   _step_build("kernels", "resident", sharded=True),
                   host_reads=1, collective_free=False, collectives=3,
                   mesh=True),
        # --- query-time stages (§10) + serve ladder rungs (§12) --------
        EntryPoint("model/route", mod, _route_build(probes=2),
                   build_alt=_route_build(probes=2, m=2 * _M)),
        EntryPoint("model/route-probe-shrink", mod, _route_build(probes=1)),
        EntryPoint("model/resolve", ops, _resolve_build(),
                   build_alt=_resolve_build(n=2 * _M)),
        EntryPoint("model/resolve-top2", ops, _resolve_build(top2=True)),
        # the callers hand in xerr, so these stages dequantize nothing;
        # the int8 products are exact f64 sums
        EntryPoint("model/route-groups-int8", mod,
                   _route_groups_int8_build, int8_region=True,
                   sanctioned_dequants=0, f64_ok=int8),
        EntryPoint("model/route-members-int8", mod,
                   _route_members_int8_build, int8_region=True,
                   sanctioned_dequants=0, f64_ok=int8),
        # §13 sanctioned dequant: one xerr residual-norm pass
        EntryPoint("model/resolve-int8", ops, _resolve_int8_build,
                   int8_region=True, sanctioned_dequants=1, f64_ok=int8),
        # --- streaming partial_fit internals (§14) ---------------------
        EntryPoint("model/delta-update", mod, _delta_update_build),
        EntryPoint("model/arena-append", mod, _arena_append_build),
        EntryPoint("step/resident-evict", eng, _evict_build,
                   f64_ok={**F64_ROOTS, **F64_DECAY}),
        # --- device-resident GDI init round (§5) -----------------------
        EntryPoint("init/gdi-round", _P + "core/gdi.py", _gdi_build),
        # --- the LM: one decode step, one training step ----------------
        # the step's token, read back to pick the next (serve.decode)
        EntryPoint("lm/decode-full", _P + "launch/serve.py",
                   _decode_build(False), host_reads=1),
        EntryPoint("lm/decode-k2attn", _P + "launch/serve.py",
                   _decode_build(True), host_reads=1),
        # the loss and gradient norm, one copy (train.MetricsStep)
        EntryPoint("lm/train-step", _P + "launch/train.py", _train_build,
                   host_reads=1),
    ]
    return ents


# ---------------------------------------------------------------------------
# kernel registry (pass 2)
# ---------------------------------------------------------------------------


def _rng(seed: int = 0):
    return np.random.default_rng(seed)


def _f32(dev, *shape, seed=0):
    return _t(_rng(seed).standard_normal(shape).astype(np.float32), dev)


def _i32(dev, a):
    return _t(np.asarray(a, np.int32), dev)


def _k1_case(bn, d):
    def build(dev):
        import torch
        from ..kernels import candidate_assign as ca
        nb, t, kn, bkn, k = 4, 3, 12, 8, 24
        x = _f32(dev, nb * bn, d)
        c = _f32(dev, k, d, seed=1)
        cidx = ca.pad_candidates(_i32(dev, _rng(2).integers(0, k, (t, kn))),
                                 bkn).contiguous()
        ctab, csq = ca.candidate_tables(c, cidx)
        rowsel = _i32(dev, np.arange(nb) % t)
        skip = _i32(dev, np.zeros(nb))
        pa = torch.zeros((nb * bn,), dtype=torch.int32, device=dev)
        pd = torch.zeros((nb * bn,), dtype=torch.float32, device=dev)
        fn = functools.partial(ca.candidate_assign_tiled, bn=bn, bkn=bkn)
        return (fn, (x, ctab, csq, cidx, rowsel, skip, pa, pd, pd),
                lambda: ca.plan_candidate_assign_tiled(nb, bn,
                                                       cidx.shape[1], d))
    return build


def _k4_case(bn, d):
    def build(dev):
        from ..kernels import candidate_assign as ca
        from ..kernels import quant
        nb, t, kn, bkn, k, r = 4, 3, 12, 8, 24, 4
        x = _f32(dev, nb * bn, d)
        c = _f32(dev, k, d, seed=1)
        cidx = ca.pad_candidates(_i32(dev, _rng(2).integers(0, k, (t, kn))),
                                 bkn).contiguous()
        xq, xsc = quant.quantize_rows(x)
        xerr = quant.residual_norm(x, xq, xsc)
        qtab, qsc, qerr, csq = quant.quantized_candidate_slabs(
            quant.center_quant(c), cidx)
        rowsel = _i32(dev, np.arange(nb) % t)
        skip = _i32(dev, np.zeros(nb))
        fn = functools.partial(ca.candidate_assign_int8_tiled, bn=bn,
                               bkn=bkn, r=r)
        return (fn, (xq.contiguous(), xsc, xerr, qtab, qsc, qerr, csq,
                     rowsel, skip),
                lambda: ca.plan_candidate_assign_int8_tiled(
                    nb, bn, cidx.shape[1], d, r))
    return build


def _k7_case(bn, d):
    def build(dev):
        import torch
        from ..kernels import candidate_assign as ca
        nb, kn, k = 3, 40, 48
        x = _f32(dev, nb * bn, d)
        c = _f32(dev, k, d, seed=1)
        cand = _i32(dev, _rng(2).integers(0, k, (nb, kn)))
        skip = _i32(dev, np.zeros(nb))
        pa = torch.zeros((nb * bn,), dtype=torch.int32, device=dev)
        pd = torch.zeros((nb * bn,), dtype=torch.float32, device=dev)
        fn = functools.partial(ca.candidate_assign_rowwise, bn=bn)
        return (fn, (x, c, cand, skip, pa, pd),
                lambda: ca.plan_candidate_assign_rowwise(nb, bn, kn, d))
    return build


def _k2_case(k, d):
    def build(dev):
        from ..kernels import center_knn
        return (center_knn.center_sqdist, (_f32(dev, k, d),),
                lambda: center_knn.plan_center_sqdist(k, d))
    return build


def _k5_case(n, k, d):
    def build(dev):
        from ..kernels import distance_argmin as da
        return (da.distance_argmin, (_f32(dev, n, d), _f32(dev, k, d, seed=1)),
                lambda: da.plan_distance_argmin(n, k, d))
    return build


def _k3_case(nb, bn, d):
    def build(dev):
        import torch
        from ..kernels import segmented_scan as sc
        x = _f32(dev, nb * bn, d)
        w = torch.ones((nb * bn,), dtype=torch.float32, device=dev)
        b2s = _i32(dev, np.arange(nb) // 2)
        return (functools.partial(sc.segmented_scan, bn=bn), (x, w, b2s),
                lambda: sc.plan_segmented_scan(nb, bn, d))
    return build


def _k6_case(dh, bf16, p=6):
    def build(dev):
        import torch
        from ..kernels import cluster_attend as kc
        bh, rows, cap = 8, 12, 16
        dt = torch.bfloat16 if bf16 else torch.float32
        q = _f32(dev, bh, dh)
        kt = _f32(dev, rows, cap, dh, seed=1).to(dt).contiguous()
        vt = _f32(dev, rows, cap, dh, seed=2).to(dt).contiguous()
        sizes = _i32(dev, _rng(3).integers(1, cap + 1, rows))
        sel = _i32(dev, _rng(4).integers(0, rows, (bh, p)))
        fn = functools.partial(kc.cluster_attend_partial, sizes=sizes)
        return (fn, (q, kt, vt, sel),
                lambda: kc.plan_cluster_attend(bh, rows, cap, dh, p,
                                               bf16=bf16))
    return build


def _sqnorm_case(rows, d):
    def build(dev):
        from ..kernels import exact_round as er
        return (er.exact_sqnorm, (_f32(dev, rows, d),),
                lambda: er.plan_exact_sqnorm(rows, d))
    return build


def _rowdot_case(rows, d):
    def build(dev):
        from ..kernels import exact_round as er
        idx = _t(_rng(2).integers(0, 9, rows).astype(np.int64), dev)
        return (er.exact_rowdot, (_f32(dev, rows, d), _f32(dev, 9, d, seed=1),
                                  idx),
                lambda: er.plan_exact_rowdot(rows, d))
    return build


def _split_case(rows, d):
    def build(dev):
        from ..kernels import exact_round as er
        seg = _t((np.arange(rows) % 5).astype(np.int64), dev)
        return (er.exact_split_sqnorms,
                (_f32(dev, rows, d), _f32(dev, 5, d, seed=1), seg),
                lambda: er.plan_exact_split_sqnorms(rows, d))
    return build


def _cross_case(t, m, k, d):
    """a (t, m, d) by b = c^T, c (t, k, d) contiguous: the transposed
    centers every caller passes (``exact_cross(x, c.T)``)."""
    def build(dev):
        from ..kernels import exact_round as er
        a = _f32(dev, t, m, d)
        b = _f32(dev, t, k, d, seed=1).transpose(-1, -2)
        strides = (*a.stride(), *b.stride())
        return (er.exact_cross, (a, b),
                lambda: er.plan_exact_cross(t, m, k, d, strides))
    return build


def _segsum_case(k, nb, bn, d):
    def build(dev):
        from ..kernels import segment_sum as ss
        x = _f32(dev, nb * bn, d)
        b2s = _i32(dev, np.arange(nb) % k)
        return (functools.partial(ss.segment_sum_blocks, k=k, bn=bn),
                (x, b2s), lambda: ss.plan_segment_sum_blocks(k, nb, bn, d))
    return build


def _wkv_args(dev, B, S, H, dh):
    import torch
    r, k, v = (_f32(dev, B, S, H, dh, seed=i) * 0.5 for i in range(3))
    w = torch.sigmoid(_f32(dev, B, S, H, dh, seed=3))
    u = _f32(dev, H, dh, seed=4) * 0.5
    st = _f32(dev, B, H, dh, dh, seed=5) * 0.1
    return r, k, v, w, u, st


def _ssd_args(dev, B, S, H, P, N):
    import torch
    x = _f32(dev, B, S, H, P)
    Bm, Cm = _f32(dev, B, S, N, seed=1), _f32(dev, B, S, N, seed=2)
    decay = torch.sigmoid(_f32(dev, B, S, H, seed=3))
    dt = torch.sigmoid(_f32(dev, B, S, H, seed=4))
    D = _f32(dev, H, seed=5)
    st = _f32(dev, B, H, P, N, seed=6) * 0.1
    return x, Bm, Cm, decay, dt, D, st


def _wkv_case(dh, S=40):
    def build(dev):
        from ..kernels import ssm_scan
        B, H = 2, 3
        return (ssm_scan.wkv6_scan, _wkv_args(dev, B, S, H, dh),
                lambda: ssm_scan.plan_wkv6_scan(B, S, H, dh))
    return build


def _ssd_case(P, N, S=40):
    def build(dev):
        from ..kernels import ssm_scan
        B, H = 2, 3
        return (ssm_scan.ssd_scan, _ssd_args(dev, B, S, H, P, N),
                lambda: ssm_scan.plan_ssd_scan(B, S, H, P, N))
    return build


def _wkv_bwd_case(dh, S=70):
    def build(dev):
        import torch
        from ..kernels import ssm_scan
        B, H = 2, 3
        r, k, v, w, u, st = _wkv_args(dev, B, S, H, dh)
        _, _, ckpt = ssm_scan.wkv6_scan_saving(r, k, v, w, u, st)
        dout = torch.ones_like(r)
        return (ssm_scan.wkv6_scan_bwd, (r, k, v, w, u, ckpt, dout),
                lambda: ssm_scan.plan_wkv6_scan_bwd(B, S, H, dh))
    return build


def _ssd_bwd_case(P, N, S=70):
    def build(dev):
        import torch
        from ..kernels import ssm_scan
        B, H = 2, 3
        x, Bm, Cm, decay, dt, D, st = _ssd_args(dev, B, S, H, P, N)
        _, _, ckpt = ssm_scan.ssd_scan_saving(x, Bm, Cm, decay, dt, D, st)
        dy = torch.ones_like(x)
        return (ssm_scan.ssd_scan_bwd, (x, Bm, Cm, decay, dt, D, ckpt, dy),
                lambda: ssm_scan.plan_ssd_scan_bwd(B, S, H, P, N))
    return build


def _case(label, build, **kw):
    return KernelCase(label, build, **kw)


def kernel_entries() -> list[KernelEntry]:
    """One entry per key of ``kernels._build.LAUNCHES``; each case's
    ``min_blocks_per_sm`` is what its source states (a comment or a
    ``static_assert``), 1 where it states nothing."""
    k = _P + "kernels/"
    cs = _P + "kernels/csrc/"
    ca = k + "candidate_assign.py"
    er = k + "exact_round.py"
    sm = k + "ssm_scan.py"
    return [
        # K1: Tile<NJ, RG> by bn (candidate_assign.cu: "two blocks an SM"
        # at bn = 32 and below), 16- and 4-byte copies
        KernelEntry("candidate_assign_tiled", ca, cs + "candidate_assign.cu",
                    "candidate_assign", "candidate_assign_tiled_kernel", (
                        _case("bn8", _k1_case(8, 64), min_blocks_per_sm=2),
                        _case("bn16", _k1_case(16, 64), min_blocks_per_sm=2),
                        _case("bn32", _k1_case(32, 64), min_blocks_per_sm=2),
                        _case("bn64", _k1_case(64, 64)),
                        _case("bn128", _k1_case(128, 64)),
                        _case("bn32-d33", _k1_case(32, 33),
                              min_blocks_per_sm=2, scalar_ok=True)),
                    pad_ok=("inner",)),
        # K4: units of 8, 16 or 32 rows by bn, 16-byte or byte copies
        KernelEntry("candidate_assign_int8_tiled", ca,
                    cs + "candidate_assign_int8.cu",
                    "candidate_assign_int8", "candidate_assign_int8_kernel", (
                        _case("bn8", _k4_case(8, 64)),
                        _case("bn16", _k4_case(16, 64)),
                        _case("bn64", _k4_case(64, 64)),
                        _case("bn64-d40", _k4_case(64, 40), scalar_ok=True)),
                    pad_ok=("cols", "inner")),
        # K7: "114,960 bytes ... two blocks an SM" (static_assert)
        KernelEntry("candidate_assign_rowwise", ca,
                    cs + "candidate_assign_rowwise.cu",
                    "candidate_assign_rowwise",
                    "candidate_assign_rowwise_kernel", (
                        _case("bn40", _k7_case(40, 64), min_blocks_per_sm=2),
                        _case("bn40-d33", _k7_case(40, 33),
                              min_blocks_per_sm=2, scalar_ok=True)),
                    pad_ok=("cols", "inner")),
        # K2: 32 x 32 tiles of 2 warps, "four an SM"
        KernelEntry("center_sqdist", k + "center_knn.py",
                    cs + "center_knn.cu", "center_knn",
                    "center_sqdist_kernel", (
                        _case("k100", _k2_case(100, 64),
                              min_blocks_per_sm=4),
                        _case("k100-d33", _k2_case(100, 33),
                              min_blocks_per_sm=4, scalar_ok=True)),
                    pad_ok=("inner",)),
        # K5: 108,288 bytes, "two blocks an SM"
        KernelEntry("distance_argmin", k + "distance_argmin.py",
                    cs + "distance_argmin.cu", "distance_argmin",
                    "distance_argmin_kernel", (
                        _case("n300", _k5_case(300, 200, 64),
                              min_blocks_per_sm=2),
                        _case("n300-d33", _k5_case(300, 200, 33),
                              min_blocks_per_sm=2, scalar_ok=True)),
                    pad_ok=("rows", "inner")),
        # K3: 100 KB tiles, "two blocks an SM"
        KernelEntry("segmented_scan", k + "segmented_scan.py",
                    cs + "segmented_scan.cu", "segmented_scan",
                    "segmented_scan_kernel", (
                        _case("d64", _k3_case(6, 32, 64)),
                        _case("d1100", _k3_case(6, 32, 1100)),
                        _case("d33", _k3_case(6, 32, 33), scalar_ok=True)),
                    pad_ok=("cols",)),
        # K6: 4 resident an SM at the decode step (cluster_attend.cu)
        KernelEntry("cluster_attend", k + "cluster_attend.py",
                    cs + "cluster_attend.cu", "cluster_attend",
                    "cluster_attend_kernel", (
                        _case("f32-dh64", _k6_case(64, False),
                              min_blocks_per_sm=4),
                        _case("bf16-dh128", _k6_case(128, True),
                              min_blocks_per_sm=4),
                        _case("f32-dh3", _k6_case(3, False),
                              min_blocks_per_sm=4, scalar_ok=True),
                        _case("bf16-dh4", _k6_case(4, True),
                              min_blocks_per_sm=4, scalar_ok=True)),
                    pad_ok=("inner",)),
        KernelEntry("exact_sqnorm", er, cs + "exact_round.cu", "exact_round",
                    "k2_exact_sqnorm_kernel", (
                        _case("rows100", _sqnorm_case(100, 50)),),
                    pad_ok=("rows", "inner")),
        KernelEntry("exact_split_sqnorms", er, cs + "exact_round.cu",
                    "exact_round", "exact_split_sqnorms_kernel", (
                        _case("d64", _split_case(100, 64)),
                        _case("d33", _split_case(100, 33), scalar_ok=True)),
                    pad_ok=("rows", "inner")),
        # exact_cross: column tiles of 64 (k <= 64) or 128, the batch on z
        KernelEntry("exact_cross", er, cs + "exact_round.cu", "exact_round",
                    "exact_cross_kernel", (
                        _case("k40", _cross_case(1, 70, 40, 64),
                              min_blocks_per_sm=2),
                        _case("k300-t3", _cross_case(3, 70, 300, 64),
                              min_blocks_per_sm=2),
                        _case("k300-d33", _cross_case(1, 70, 300, 33),
                              min_blocks_per_sm=2, scalar_ok=True),
                        _case("k40-d33", _cross_case(1, 70, 40, 33),
                              min_blocks_per_sm=2, scalar_ok=True)),
                    pad_ok=("rows", "cols", "inner")),
        KernelEntry("exact_rowdot", er, cs + "exact_round.cu", "exact_round",
                    "exact_rowdot_kernel", (
                        _case("rows100", _rowdot_case(100, 50)),),
                    pad_ok=("rows", "inner")),
        KernelEntry("segment_sum_blocks", k + "segment_sum.py",
                    cs + "segment_sum.cu", "segment_sum",
                    "segment_sum_kernel", (
                        _case("d64", _segsum_case(5, 12, 8, 64)),
                        _case("d600", _segsum_case(5, 12, 8, 600)),
                        _case("d33", _segsum_case(5, 12, 8, 33),
                              scalar_ok=True)),
                    pad_ok=("cols", "inner")),
        # the scans: MAXDH / MAXN 16 or 64
        KernelEntry("wkv6_scan", sm, cs + "ssm_scan.cu", "ssm_scan",
                    "wkv6_kernel", (
                        _case("dh16", _wkv_case(16)),
                        _case("dh64", _wkv_case(64))),
                    pad_ok=("inner",)),
        KernelEntry("ssd_scan", sm, cs + "ssm_scan.cu", "ssm_scan",
                    "ssd_kernel", (
                        _case("N8", _ssd_case(32, 8)),
                        _case("N64", _ssd_case(64, 64))),
                    pad_ok=("inner",)),
        KernelEntry("wkv6_scan_bwd", sm, cs + "ssm_scan.cu", "ssm_scan",
                    "wkv6_bwd_kernel", (
                        _case("dh16", _wkv_bwd_case(16)),
                        _case("dh64", _wkv_bwd_case(64))),
                    pad_ok=("inner",)),
        KernelEntry("ssd_scan_bwd", sm, cs + "ssm_scan.cu", "ssm_scan",
                    "ssd_bwd_kernel", (
                        _case("N8", _ssd_bwd_case(32, 8)),
                        _case("N64", _ssd_bwd_case(64, 64))),
                    pad_ok=("inner",)),
    ]
