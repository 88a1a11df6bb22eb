"""The port's fault tolerance (``repro_torch.ft``: the chaos injector, the
invariant guards and the repair lattice, the runtime) against the JAX
reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
reference's fits run its Pallas kernels in interpret mode (its
``backend="pallas"``, the port's one grouped path). The injector draws
every row, slot and center on the host from the same numpy generators in
both packages, so the same seed and schedule corrupt the same entries
and record the same ``events``. The split rung's member draws are the
reference's, handed to the port through ``gdi._split_draws``
(``test_torch_stream._draw_recorder``). Tolerances: assignments, slot
arrays, events and repair counts are equal; centers, whose sums the two
packages take in other orders, within rtol 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import fit_k2means as jax_fit_k2means
from repro.core import init_state as jax_init_state
from repro.core.engine import K2Step as JaxK2Step
from repro.ft import FaultInjector as JaxInjector
from repro.ft import FitCheckpointer as JaxCheckpointer
from repro.ft import Preemption as JaxPreemption
from repro.ft import chaos as jax_chaos
from repro.ft.invariants import heal_fit as jax_heal_fit
from repro.ft.invariants import make_guard as jax_make_guard
from repro.ft.invariants import \
    recover_assignment_np as jax_recover_assignment
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.core import K2Step, OpCounter, fit_k2means, init_state
from repro_torch.ft import (FaultInjector, FaultTolerantLoop, FitCheckpointer,
                            HeartbeatMonitor, Preemption, StragglerPolicy,
                            TransientError, plan_remesh, poisson_trace,
                            retry_transient)
from repro_torch.ft import chaos
from repro_torch.ft.invariants import (heal_fit, k2_violations, make_guard,
                                       recover_assignment_np,
                                       resident_violations)

from test_torch_stream import _draw_recorder

_N, _D, _K, _KN = 2048, 16, 32, 8


def T(v, dtype=None):
    return torch.tensor(np.asarray(v), dtype=dtype)


def N(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _data(seed=0, n=_N, d=_D, k=_K, true_k=20):
    """test_ft_selfheal's shapes: blobs drawn with numpy, k rows as the
    init and their nearest-center assignment (the reference's)."""
    from repro.core import assign_nearest as jax_assign_nearest
    rng = np.random.RandomState(seed)
    mus = rng.randn(true_k, d) * 4.0
    x = (mus[rng.choice(true_k, n)] + rng.randn(n, d)).astype(np.float32)
    c0 = x[rng.choice(n, k, replace=False)]
    a0 = np.asarray(jax_assign_nearest(jnp.asarray(x), jnp.asarray(c0)))
    return x, c0, a0.astype(np.int32)


def _same_state(st_t, st_j, names, context=""):
    for name in names:
        np.testing.assert_array_equal(N(getattr(st_t, name)),
                                      N(getattr(st_j, name)),
                                      err_msg=f"{context} {name}")


# -- the injector --------------------------------------------------------

_SCHEDULE = dict(nan_rows={2: 5}, inf_rows={2: 3, 4: 1}, dup_rows={3: 7},
                 poison_centers={2: 2}, poison_bounds={3: 9},
                 poison_slots={4: 3}, exhaust_pool=(5,))


def test_injector_corrupts_what_the_reference_corrupts():
    """Input and state faults over five iterations of a resident arena:
    the same rows, slots, centers and bound lanes corrupted, the arena's
    mirror of the rows, and the same events."""
    x, c0, a0 = _data(1)
    kw = dict(k=_K, kn=_KN, residency="resident")
    sj, st = JaxK2Step(backend="pallas", **kw), K2Step(**kw)
    xj, wj = jnp.asarray(x), jnp.ones((_N,), jnp.float32)
    xt, wt = T(x), torch.ones(_N)
    state_j = sj.init_resident(xj, wj, jnp.asarray(c0), jnp.asarray(a0))
    state_t = st.init_resident(xt, wt, T(c0), T(a0))
    inj_j, inj_t = JaxInjector(seed=3, **_SCHEDULE), \
        FaultInjector(seed=3, **_SCHEDULE)
    for it in range(1, 6):
        xj, wj, state_j = jax_chaos.apply_fit_faults(inj_j, it, xj, wj,
                                                     state_j, True)
        xt, wt, state_t = chaos.apply_fit_faults(inj_t, it, xt, wt, state_t,
                                                 True)
        np.testing.assert_array_equal(N(xt), N(xj), err_msg=f"it {it}")
        _same_state(state_t, state_j, ("xg", "pid", "b2c", "c", "ug"),
                    f"it {it}")
    assert inj_t.events == inj_j.events
    assert {e[1] for e in inj_t.events} == {
        "nan", "inf", "dup", "poison_centers", "poison_bounds",
        "poison_slots", "exhaust_pool"}
    # the caller's tensors are never written
    assert torch.isfinite(T(x)).all() and torch.equal(T(x), torch.tensor(x))


def test_stream_and_serving_faults_match_the_reference():
    """The streaming and serving faults (late delivery, drift bursts,
    floods, NaN batches, poisoned queries, stalls, transient failures,
    preemption) and the Poisson trace, draw for draw."""
    rng = np.random.RandomState(5)
    batches = [rng.randn(32, 8).astype(np.float32) for _ in range(6)]
    sched = dict(nan_batches={1: 4}, drift_burst={2: 3.0},
                 dup_flood={3: 6}, epoch_skew={4: 2},
                 poison_queries={7: 5}, slow_consumer={2: 0.004},
                 fail_calls={"predict": (1, 3)}, preempt_at=4)
    inj_j, inj_t = JaxInjector(seed=9, **sched), FaultInjector(seed=9, **sched)
    for xb in batches:
        got = inj_t.corrupt_batch(torch.tensor(xb))
        want = inj_j.corrupt_batch(jnp.asarray(xb))
        np.testing.assert_array_equal(N(got), N(want))
    q = rng.randn(16, 8).astype(np.float32)
    for rid in (6, 7):
        np.testing.assert_array_equal(inj_t.corrupt_queries(rid, q),
                                      inj_j.corrupt_queries(rid, q))
    for b in range(4):
        assert inj_t.consume_stall(b) == inj_j.consume_stall(b)
    for _ in range(5):
        outcomes = []
        for inj, err in ((inj_j, jax_chaos.TransientError),
                         (inj_t, TransientError)):
            try:
                inj.maybe_fail("predict")
                outcomes.append("ok")
            except err:
                outcomes.append("fail")
        assert outcomes[0] == outcomes[1]
    for it in range(1, 6):
        outcomes = []
        for inj, err in ((inj_j, JaxPreemption), (inj_t, Preemption)):
            try:
                inj.check_preempt(it)
                outcomes.append("ok")
            except err:
                outcomes.append("preempted")
        assert outcomes[0] == outcomes[1]
    assert inj_t.events == inj_j.events
    kw = dict(rate=900.0, horizon=0.5, rows=16, bursts=((0.1, 0.2, 4.0),),
              pf_every=5, priority_levels=2)
    assert poisson_trace(4, **kw) == jax_chaos.poisson_trace(4, **kw)


def test_injectors_do_not_nest():
    with FaultInjector(seed=0):
        assert chaos.active() is not None
        with pytest.raises(RuntimeError, match="nest"):
            with FaultInjector(seed=1):
                pass
    assert chaos.active() is None


# -- guards ----------------------------------------------------------------


def test_guards_count_what_the_reference_counts():
    """``resident_violations`` (through ``make_guard``) and
    ``k2_violations`` on clean and poisoned states: the same lanes."""
    x, c0, a0 = _data(2)
    kw = dict(k=_K, kn=_KN, residency="resident")
    sj, st = JaxK2Step(backend="pallas", **kw), K2Step(**kw)
    state_j = sj.init_resident(jnp.asarray(x), jnp.ones((_N,), jnp.float32),
                               jnp.asarray(c0), jnp.asarray(a0))
    state_t = st.init_resident(T(x), torch.ones(_N), T(c0), T(a0))
    gj, gt = jax_make_guard(sj, _N), make_guard(st, _N)
    assert N(gt(state_t)).tolist() == N(gj(state_j)).tolist() == [0] * 4
    inj_j = JaxInjector(seed=4, poison_centers={1: 3}, poison_bounds={1: 5},
                        poison_slots={1: 4}, exhaust_pool=(1,))
    inj_t = FaultInjector(seed=4, poison_centers={1: 3},
                          poison_bounds={1: 5}, poison_slots={1: 4},
                          exhaust_pool=(1,))
    state_j = inj_j.corrupt_state(1, state_j, True)
    state_t = inj_t.corrupt_state(1, state_t, True)
    vio = N(gt(state_t))
    assert vio.tolist() == N(gj(state_j)).tolist()
    assert vio[0] > 0 and vio[2] > 0 and vio[3] > 0
    sums_bad = state_t._replace(counts=-state_t.counts)
    assert N(resident_violations(sums_bad, n=_N))[1] == _K
    # the rebuild residency's lanes
    kj = jax_init_state(jnp.asarray(c0), jnp.asarray(a0), _KN)
    kt = init_state(T(c0), T(a0), _KN)
    kj = kj._replace(c=kj.c.at[3].set(jnp.nan), u=kj.u.at[7].set(jnp.inf),
                     a=kj.a.at[11].set(_K))
    kt = kt._replace(c=kt.c.clone(), u=kt.u.clone(), a=kt.a.clone())
    kt.c[3], kt.u[7], kt.a[11] = float("nan"), float("inf"), _K
    gj = jax_make_guard(JaxK2Step(backend="pallas", k=_K, kn=_KN), _N)
    gt = make_guard(K2Step(k=_K, kn=_KN, residency="rebuild"), _N)
    assert N(gt(kt)).tolist() == N(gj(kj)).tolist() == [_D, 1, 1, 0]
    assert N(k2_violations(kt, n=_N)).tolist() == [_D, 1, 1, 0]


def test_recover_assignment_matches_the_reference():
    x, c0, a0 = _data(3)
    st = K2Step(k=_K, kn=_KN).init_resident(T(x), torch.ones(_N), T(c0),
                                            T(a0))
    pid = N(st.pid).copy()
    owned = np.flatnonzero(pid >= 0)
    pid[owned[5]] = pid[owned[9]]            # one row claimed twice
    pid[owned[20]] = -1                      # one row claimed by no slot
    b2c = N(st.b2c).copy()
    bn = pid.shape[0] // b2c.shape[0]
    got = recover_assignment_np(pid, b2c, bn, _N)
    np.testing.assert_array_equal(got, jax_recover_assignment(pid, b2c, bn,
                                                              _N))
    assert (got == -1).sum() == 3


# -- the repair lattice ----------------------------------------------------


def test_heal_regroup_matches_the_reference():
    """test_ft_selfheal's arena poison: slot-ownership corruption of a
    settled resident arena; both healers rebuild the same arena from the
    same recovered assignment (the regroup rung), guard-clean."""
    x, c0, a0 = _data()
    kw = dict(k=_K, kn=_KN, residency="resident", regroup_every=100,
              move_cap=256)
    sj, st = JaxK2Step(backend="pallas", **kw), K2Step(**kw)
    step_j, step_t = sj.build(_N, _D), st.build(_N, _D)
    xj, wj = jnp.asarray(x), jnp.ones((_N,), jnp.float32)
    xt, wt = T(x), torch.ones(_N)
    state_j = sj.init_resident(xj, wj, jnp.asarray(c0), jnp.asarray(a0))
    state_t = st.init_resident(xt, wt, T(c0), T(a0))
    for _ in range(6):
        state_j, _s = step_j(xj, wj, state_j)
        state_t, _s = step_t(xt, wt, state_t)
    a_before = N(st.final_assignment(state_t, _N))
    pid = N(state_t.pid).copy()
    owned = np.flatnonzero(pid >= 0)
    pid[owned[3]] = pid[owned[11]]
    state_j = state_j._replace(pid=jnp.asarray(pid))
    state_t = state_t._replace(pid=torch.tensor(pid))
    vio_j = N(jax_make_guard(sj, _N)(state_j))
    vio_t = N(make_guard(st, _N)(state_t))
    assert vio_t.tolist() == vio_j.tolist() and vio_t[3] > 0
    cj, ct = JaxCounter(), OpCounter()
    _, _, healed_j = jax_heal_fit(xj, wj, state_j, sj, _N, cj,
                                  jax.random.PRNGKey(9), vio_j)
    _, _, healed_t = heal_fit(xt, wt, state_t, st, _N, ct,
                              torch.Generator().manual_seed(9), vio_t)
    assert ct.repairs == cj.repairs and ct.repairs["regroup"] == 1
    assert ct.distances == cj.distances
    _same_state(healed_t, healed_j, ("pid", "b2c", "fill", "openb", "xg"))
    assert healed_t.first
    assert int(N(make_guard(st, _N)(healed_t)).sum()) == 0
    np.testing.assert_array_equal(N(st.final_assignment(healed_t, _N)),
                                  a_before)


def test_heal_split_matches_the_reference(monkeypatch):
    """test_ft_selfheal's dying center: a NaN center on the rebuild
    residency is re-seated by one split of the highest-energy donor
    (the reference's draws), then the untrusted rows are re-assigned:
    the same healed assignment and repair counts."""
    calls, used = _draw_recorder(monkeypatch)
    x, c0, a0 = _data()
    kj = jax_init_state(jnp.asarray(c0), jnp.asarray(a0), _KN)
    kj = kj._replace(c=kj.c.at[5].set(jnp.nan))
    kt = init_state(T(c0), T(a0), _KN)
    kt = kt._replace(c=kt.c.clone())
    kt.c[5] = float("nan")
    sj = JaxK2Step(backend="pallas", k=_K, kn=_KN)
    st = K2Step(k=_K, kn=_KN, residency="rebuild")
    vio_j, vio_t = N(jax_make_guard(sj, _N)(kj)), N(make_guard(st, _N)(kt))
    assert vio_t.tolist() == vio_j.tolist() and vio_t[0] > 0
    cj, ct = JaxCounter(), OpCounter()
    w = np.ones(_N, np.float32)
    _, _, hj = jax_heal_fit(jnp.asarray(x), jnp.asarray(w), kj, sj, _N, cj,
                            jax.random.PRNGKey(2), vio_j)
    _, _, ht = heal_fit(T(x), T(w), kt, st, _N, ct, torch.Generator(), vio_t)
    assert len(calls) == len(used) == 1
    assert ct.repairs == cj.repairs
    assert ct.repairs["split"] == 1 and ct.repairs["bound_reset"] == 1
    assert ct.distances == cj.distances
    np.testing.assert_array_equal(N(ht.a), N(hj.a))
    np.testing.assert_allclose(N(ht.c), N(hj.c), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(ht.c).all() and int((ht.a == 5).sum()) > 0
    assert int(N(make_guard(st, _N)(ht)).sum()) == 0


def test_heal_bound_reset_rung():
    """Only the bound lanes poisoned: the cheapest rung, loose bounds and
    a full recompute, nothing else touched."""
    x, c0, a0 = _data(4)
    st = K2Step(k=_K, kn=_KN)
    state = st.init_resident(T(x), torch.ones(_N), T(c0), T(a0))
    state = st.build(_N, _D)(T(x), torch.ones(_N), state)[0]
    ug = state.ug.clone()
    ug[[1, 50]] = float("nan")
    state = state._replace(ug=ug)
    vio = N(make_guard(st, _N)(state))
    assert vio.tolist() == [0, 0, 2, 0]
    ct = OpCounter()
    _, _, healed = heal_fit(T(x), torch.ones(_N), state, st, _N, ct, None,
                            vio)
    assert ct.repairs["bound_reset"] == 1 and ct.total_repairs == 1
    assert healed.first and float(healed.ug.abs().sum()) == 0.0
    assert torch.equal(healed.pid, state.pid)


def _chaos_fits(sched, monkeypatch=None, max_iters=14):
    """The reference's and the port's guarded resident fits under one
    schedule (n=1024, d=16, k=24, kn=6), with the reference's split
    draws handed to the port when ``monkeypatch`` is given: ((result,
    counter, injector) of each, draws used)."""
    calls, used = _draw_recorder(monkeypatch) if monkeypatch else ([], [])
    x, c0, a0 = _data(5, n=1024, k=24)
    kw = dict(kn=6, max_iters=max_iters, residency="resident", guards=True)
    cj, ct = JaxCounter(), OpCounter()
    with JaxInjector(seed=11, **sched) as inj_j:
        rj = jax_fit_k2means(jnp.asarray(x), jnp.asarray(c0),
                             jnp.asarray(a0), backend="pallas", counter=cj,
                             key=jax.random.PRNGKey(3), **kw)
    with FaultInjector(seed=11, **sched) as inj_t:
        rt = fit_k2means(T(x), T(c0), T(a0), counter=ct, device="cpu",
                         key=3, **kw)
    assert len(used) == len(calls)
    return (rj, cj, inj_j), (rt, ct, inj_t), len(used)


def test_guarded_chaos_fit_matches_the_reference(monkeypatch):
    """A guarded resident fit under duplicate rows, poisoned slots and
    bounds, a poisoned center and an exhausted pool: the same events,
    repairs (regroup and split among them), final assignment and
    iterations as the reference's fit."""
    sched = dict(dup_rows={2: 9}, poison_slots={3: 3}, poison_centers={4: 1},
                 poison_bounds={5: 4}, exhaust_pool=(7,))
    (rj, cj, inj_j), (rt, ct, inj_t), splits = _chaos_fits(sched,
                                                          monkeypatch)
    assert inj_t.events == inj_j.events
    assert {e[1] for e in inj_t.events} == {
        "dup", "poison_slots", "poison_centers", "poison_bounds",
        "exhaust_pool"}
    assert ct.repairs == cj.repairs
    assert ct.repairs["regroup"] >= 1 and ct.repairs["split"] == splits >= 1
    np.testing.assert_array_equal(N(rt.assignment), N(rj.assignment))
    assert rt.iterations == rj.iterations
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)


def test_guarded_chaos_fit_heals_nan_rows():
    """NaN rows, then a poisoned center: both fits fire the same faults,
    quarantine the same 6 rows and heal by regroup and split, and the
    port ends guard-clean with a finite energy. Where the NaN rows sit
    between their injection and the heal, the two part (ROADMAP §3 entry
    14): the reference's kernel gives a row with no finite distance
    center 0, the port's keeps its block's first candidate, so other
    centers are poisoned and split."""
    sched = dict(nan_rows={2: 6}, poison_centers={5: 1})
    (rj, cj, inj_j), (rt, ct, inj_t), _ = _chaos_fits(sched)
    assert inj_t.events == inj_j.events
    assert ct.sanitized_rows == cj.sanitized_rows == 6
    assert ct.repairs["regroup"] >= 1 and ct.repairs["split"] >= 1
    assert cj.repairs["regroup"] >= 1 and cj.repairs["split"] >= 1
    assert np.isfinite(rt.energy) and torch.isfinite(rt.centers).all()
    st = K2Step(k=24, kn=6)
    x, _, _ = _data(5, n=1024, k=24)
    w = torch.from_numpy(np.isfinite(N(x)).all(1).astype(np.float32))
    clean = st.init_resident(T(x), w, rt.centers, rt.assignment)
    assert int(N(make_guard(st, 1024)(clean)).sum()) == 0


# -- checkpoints and resume ------------------------------------------------


def test_kill_and_resume_single_device_bitexact(tmp_path):
    """test_ft_selfheal's kill-and-resume on the port: a checkpointing
    rebuild fit preempted before iteration 7 and resumed from step 6
    equals the uninterrupted fit bit for bit (its bounds ride the
    checkpoint) and counts one restore."""
    x, c0, a0 = _data()
    kw = dict(kn=_KN, max_iters=12, residency="rebuild", device="cpu")
    base = fit_k2means(T(x), T(c0), T(a0), **kw)
    d = str(tmp_path / "ckpt")
    with pytest.raises(Preemption):
        with FaultInjector(seed=0, preempt_at=7):
            fit_k2means(T(x), T(c0), T(a0), ckpt_dir=d, ckpt_every=3, **kw)
    assert latest_step(d) == 6
    ctr = OpCounter()
    r = fit_k2means(T(x), T(c0), T(a0), ckpt_dir=d, ckpt_every=3,
                    resume=True, counter=ctr, **kw)
    assert torch.equal(r.assignment, base.assignment)
    assert torch.equal(r.centers, base.centers)
    assert r.energy == base.energy
    assert ctr.profile()["repairs"]["restore"] == 1


def test_resident_resume_is_of_equivalent_quality(tmp_path):
    """A resident resume rebuilds loose bounds (DESIGN.md §11.3): its
    energy is within 1e-3 of the uninterrupted fit's, no claim more."""
    x, c0, a0 = _data(6)
    kw = dict(kn=_KN, max_iters=12, device="cpu")
    base = fit_k2means(T(x), T(c0), T(a0), **kw)
    d = str(tmp_path / "ckpt")
    with pytest.raises(Preemption):
        with FaultInjector(seed=0, preempt_at=5):
            fit_k2means(T(x), T(c0), T(a0), ckpt_dir=d, ckpt_every=2, **kw)
    ctr = OpCounter()
    r = fit_k2means(T(x), T(c0), T(a0), ckpt_dir=d, ckpt_every=2,
                    resume=True, counter=ctr, **kw)
    assert ctr.repairs["restore"] == 1
    assert r.energy == pytest.approx(base.energy, rel=1e-3)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_fit_checkpoint_resumes_across_packages(tmp_path, writer):
    """A rebuild fit killed before iteration 7 by one package resumes in
    the other from its checkpoint (centers, assignment and bounds) and
    ends where the resuming package's uninterrupted fit ends."""
    x, c0, a0 = _data(7)
    d = str(tmp_path / "ckpt")
    jkw = dict(kn=_KN, max_iters=12, backend="pallas", residency="rebuild")
    tkw = dict(kn=_KN, max_iters=12, residency="rebuild", device="cpu")
    xj, cj0, aj0 = jnp.asarray(x), jnp.asarray(c0), jnp.asarray(a0)
    if writer == "reference":
        with pytest.raises(JaxPreemption):
            with JaxInjector(seed=0, preempt_at=7):
                jax_fit_k2means(xj, cj0, aj0, ckpt_dir=d, ckpt_every=3,
                                **jkw)
        base = fit_k2means(T(x), T(c0), T(a0), **tkw)
        ctr = OpCounter()
        r = fit_k2means(T(x), T(c0), T(a0), ckpt_dir=d, ckpt_every=3,
                        resume=True, counter=ctr, **tkw)
    else:
        with pytest.raises(Preemption):
            with FaultInjector(seed=0, preempt_at=7):
                fit_k2means(T(x), T(c0), T(a0), ckpt_dir=d, ckpt_every=3,
                            **tkw)
        base = jax_fit_k2means(xj, cj0, aj0, **jkw)
        ctr = JaxCounter()
        r = jax_fit_k2means(xj, cj0, aj0, ckpt_dir=d, ckpt_every=3,
                            resume=True, counter=ctr, **jkw)
    assert ctr.repairs["restore"] == 1
    np.testing.assert_array_equal(N(r.assignment), N(base.assignment))
    assert r.iterations == base.iterations - 6      # run after the restore


def test_fit_checkpointer_roundtrip_and_gc(tmp_path):
    """test_checkpoint_ft's FitCheckpointer case on the port: cadence,
    payloads, keep-window GC, the optional bounds, and a reference
    checkpointer reading the port's files."""
    n, k, d_, kn = 12, 3, 4, 2
    ck = FitCheckpointer(str(tmp_path / "fit"), every=2, keep=2)
    assert ck.due(2) and not ck.due(3) and not ck.due(0)
    c = torch.arange(k * d_, dtype=torch.float32).reshape(k, d_)
    a = torch.arange(n, dtype=torch.int32) % k
    ck.save(2, c, a)
    u = torch.arange(n, dtype=torch.float32)
    nb = torch.arange(kn, dtype=torch.int32).repeat(k, 1)
    ck.save(4, c + 1, a, u=u, lo=u * 0.5, nb=nb)
    ck.save(6, c + 2, a, u=u, lo=u * 0.5, nb=nb)
    it, c_got, a_got, bounds = ck.latest(n, k, d_)
    assert it == 6
    np.testing.assert_array_equal(c_got, N(c) + 2)
    np.testing.assert_array_equal(a_got, N(a))
    assert bounds is not None and bounds["nb"].shape == (k, kn)
    np.testing.assert_array_equal(bounds["u"], N(u))
    assert sorted(os.listdir(str(tmp_path / "fit"))) == \
        ["step-%09d" % 4, "step-%09d" % 6]
    it_j, c_j, a_j, b_j = JaxCheckpointer(str(tmp_path / "fit")).latest(
        n, k, d_)
    assert it_j == 6 and (c_j == c_got).all() and (b_j["lo"] == N(u) *
                                                    0.5).all()
    ck2 = FitCheckpointer(str(tmp_path / "fit2"))
    ck2.save(1, c, a)
    it2, _, _, bounds2 = ck2.latest(n, k, d_)
    assert it2 == 1 and bounds2 is None
    assert FitCheckpointer(str(tmp_path / "none")).latest(n, k, d_) is None


# -- the runtime ----------------------------------------------------------


def test_retry_transient_counts_and_propagates():
    ctr = OpCounter()
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) < 3:
            raise TransientError("flaky")
        return 7
    assert retry_transient(flaky, retries=3, base_delay=0.0,
                           counter=ctr) == 7
    assert ctr.retries == 2
    with pytest.raises(TransientError):
        retry_transient(lambda: (_ for _ in ()).throw(TransientError("x")),
                        retries=2, base_delay=0.0, counter=ctr)
    assert ctr.retries == 4
    with pytest.raises(ValueError):          # not transient: no retry
        retry_transient(lambda: (_ for _ in ()).throw(ValueError("x")),
                        retries=5, base_delay=0.0, counter=ctr)
    assert ctr.retries == 4


def test_straggler_policy_escalates():
    p = StragglerPolicy(slack=2.0, window=10, patience=2)
    for _ in range(8):
        assert p.observe(0.1) == "ok"
    assert p.observe(0.5) == "straggler"
    assert p.observe(0.5) == "escalate"
    assert p.escalations == 1


def test_heartbeat_dead_host():
    t = [0.0]
    hb = HeartbeatMonitor(["h0", "h1"], timeout=10, clock=lambda: t[0])
    t[0] = 5.0
    hb.beat("h0")
    t[0] = 12.0
    assert hb.dead_hosts() == ["h1"]


def test_plan_remesh_keeps_tp():
    plan = plan_remesh(512 - 64, model_parallel=16)
    assert (plan["model"], plan["data"], plan["chips"]) == (16, 16, 256)
    assert plan["accum_factor_vs"](32) == 2
    with pytest.raises(RuntimeError):
        plan_remesh(8, model_parallel=16)


class _Batcher:
    """A deterministic replay batcher: ``batch_at(step)`` from the step
    index alone (numpy, seeded per step)."""

    def batch_at(self, step):
        rng = np.random.default_rng([3, step])
        return {"tokens": torch.from_numpy(rng.integers(0, 50, (2, 4)))}


def test_loop_restart_after_preemption(tmp_path):
    """test_checkpoint_ft's restart on the port: the loop killed at step
    10 and resumed from its last checkpoint equals the uninterrupted
    run (an additive step over replayed batches)."""
    from repro_torch.checkpoint import AsyncCheckpointer
    d = str(tmp_path / "ckpt")

    def step_fn(state, batch):
        return state + torch.sum(batch["tokens"]).to(torch.float32)

    def run(fail_at):
        ck = AsyncCheckpointer(d)
        loop = FaultTolerantLoop(step_fn, _Batcher(), ck, ckpt_every=4,
                                 fail_at_step=fail_at)
        state = torch.zeros(())
        try:
            state, _ = loop.run(state, 0, 16)
        except RuntimeError:
            ck.wait()
            last = latest_step(d)
            state = restore_checkpoint(d, last, state, device="cpu")
            ck2 = AsyncCheckpointer(d)
            loop2 = FaultTolerantLoop(step_fn, _Batcher(), ck2, ckpt_every=4)
            state, _ = loop2.run(state, last, 16 - last)
            ck2.wait()
        else:
            ck.wait()
        return float(state)

    assert run(fail_at=None) == run(fail_at=10)


# -- the chaos hooks of the served model -----------------------------------


def test_predict_retries_as_the_reference():
    """``predict`` under scheduled transient failures: each failed batch
    is retried and counted, the answer is the fault-free one, and an
    exhausted budget propagates the error."""
    from test_torch_stream import _windowed_model
    jm, pm = _windowed_model(window=0)
    q = np.random.RandomState(2).randn(96, pm.d).astype(np.float32) * 4.0
    cj, ct = JaxCounter(), OpCounter()
    with JaxInjector(seed=0, fail_calls={"predict": (0, 2, 3)}) as ij:
        a_j = N(jm.predict(jnp.asarray(q), batch_size=32, counter=cj))
    with FaultInjector(seed=0, fail_calls={"predict": (0, 2, 3)}) as it:
        a_t = N(pm.predict(torch.tensor(q), batch_size=32, counter=ct))
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(a_t, N(pm.predict(torch.tensor(q))))
    assert ct.retries == cj.retries == 3
    assert it.events == ij.events
    with FaultInjector(seed=0, fail_calls={"predict": (0, 1)}):
        with pytest.raises(TransientError):
            pm.predict(torch.tensor(q), retries=1)


def test_partial_fit_chaos_hooks_match_the_reference():
    """``partial_fit`` under NaN batches, duplicate floods, late delivery
    and an exhausted arena: the same quarantined rows, events, batch
    assignments, arena, statistics and re-sorts as the reference's
    folds."""
    from test_torch_stream import _batches, _windowed_model, assert_same_model
    jm, pm = _windowed_model(window=0, cap=1024)
    sched = dict(nan_batches={1: 3, 4: 2}, dup_flood={2: 5},
                 epoch_skew={3: 2}, exhaust_arena=(4,))
    with JaxInjector(seed=6, **sched) as ij, \
            FaultInjector(seed=6, **sched) as it:
        for i, xb in enumerate(_batches(8, 6, 32, pm.d)):
            cj, ct = JaxCounter(), OpCounter()
            a_j = N(jm.partial_fit(jnp.asarray(xb), counter=cj,
                                   validate="sanitize"))
            a_t = N(pm.partial_fit(torch.tensor(xb), counter=ct,
                                   validate="sanitize"))
            np.testing.assert_array_equal(a_t, a_j, err_msg=f"b{i}")
            assert_same_model(jm, pm, context=f"b{i}")
            for lane in ("sanitized_rows", "additions", "bytes_gathered",
                         "bytes_sorted", "degraded_folds"):
                assert getattr(ct, lane) == getattr(cj, lane), (i, lane)
    assert it.events == ij.events
    assert {e[1] for e in it.events} == {"nan_batch", "dup_flood",
                                         "epoch_skew", "exhaust_arena"}
    assert pm.n_rows == jm.n_rows


def test_scatter_from_grouped_with_duplicated_slots():
    """A corrupted arena names a point from several slots: the scatter
    back to point order takes the last of them, as the reference's
    row-order scatter does (and the same on every device, ROADMAP §3
    entry 15)."""
    from repro.kernels.ops import scatter_from_grouped as jax_scatter
    from repro_torch.kernels.ops import scatter_from_grouped
    rng = np.random.RandomState(3)
    perm = rng.permutation(64).astype(np.int32)
    perm[[5, 17, 40]] = perm[9]
    perm[[2, 30]] = -1
    vals = rng.randn(64).astype(np.float32)
    prev = np.full(64, -7.0, np.float32)
    got = scatter_from_grouped(T(perm), T(vals), T(prev))
    want = jax_scatter(jnp.asarray(perm), jnp.asarray(vals),
                       jnp.asarray(prev))
    np.testing.assert_array_equal(N(got), N(want))
    assert N(got)[perm[9]] == vals[40]
