"""The port's serving plane (``repro_torch.serve``: bounded admission with
typed backpressure, pad-to-bucket micro-batching, the hysteretic
degradation ladder, typed load shedding, chaos traffic and the replay
determinism contract) on the CPU: every case of
``tests/test_serve_executor.py`` run on the port, and one trace with one
chaos seed through both executors over one model.

The port's model is fitted by the port from numpy data; the
cross-package case carries the reference's model across with
``convert.model_from_reference``. The executor's clock is virtual (an
analytic service model), so a trace gives both packages the same
timeline; the arithmetic is each package's own.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import OpCounter, fit
from repro_torch.core.model import KMeansModel
from repro_torch.ft import FaultInjector, poisson_trace
from repro_torch.serve import (FULL, INT8_SCAN, PROBE_SHRINK, ROUTE_ONLY,
                               SHED, BucketLadder, DegradeConfig,
                               DegradeLadder, Overloaded, ServeConfig,
                               ServeExecutor, requests_from_trace)

KN = 8


def _blobs(seed, n, d, true_k):
    rng = np.random.RandomState(seed)
    mus = rng.randn(true_k, d) * 4.0
    return (mus[rng.choice(true_k, n)] + rng.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """One converged port fit; each test builds its own model from the
    result (from_result is deterministic, so rebuilds are bit-identical:
    the replay tests depend on that)."""
    allx = _blobs(0, 2048 + 1024, 16, 32)
    x, q = allx[:2048], allx[2048:]
    res = fit(x, 32, kn=KN, max_iters=10, seed=0, device="cpu")
    return res, q


def _executor(res, **over):
    model = KMeansModel.from_result(res, kn=KN, device="cpu")
    kw = dict(queue_bound=64, ladder=(32, 64, 128), deadline=1e-3)
    kw.update(over)
    ex = ServeExecutor(model, ServeConfig(**kw), OpCounter())
    ex.warmup()
    return ex


# -- units: bucket ladder + degradation ladder ---------------------------


def test_bucket_ladder():
    b = BucketLadder((64, 256, 1024))
    assert b.bucket_for(1) == 64
    assert b.bucket_for(64) == 64
    assert b.bucket_for(65) == 256
    assert b.bucket_for(1024) == 1024
    with pytest.raises(ValueError):
        b.bucket_for(1025)
    padded = b.pad_rows(np.ones((3, 4), np.float32), 64)
    assert padded.shape == (64, 4)
    assert padded[3:].sum() == 0


def test_degrade_ladder_hysteresis():
    lad = DegradeLadder(DegradeConfig())
    assert lad.observe(99.0, 0.0) == INT8_SCAN
    assert lad.observe(99.0, 1.0) == PROBE_SHRINK
    assert lad.observe(99.0, 2.0) == ROUTE_ONLY
    assert lad.observe(99.0, 3.0) == SHED
    assert lad.observe(99.0, 4.0) == SHED
    assert lad.observe(0.0, 5.0) == SHED
    assert lad.observe(0.0, 6.0) == ROUTE_ONLY
    assert lad.observe(0.9, 7.0) == ROUTE_ONLY
    assert lad.observe(0.0, 8.0) == ROUTE_ONLY
    assert lad.observe(0.0, 9.0) == PROBE_SHRINK
    assert lad.observe(0.0, 10.0) == PROBE_SHRINK
    assert lad.observe(0.0, 11.0) == INT8_SCAN
    assert lad.observe(0.0, 12.0) == INT8_SCAN
    assert lad.observe(0.0, 13.0) == FULL
    assert [(o, n) for _, o, n, _ in lad.transcript] == [
        (0, 1), (1, 2), (2, 3), (3, 4), (4, 3), (3, 2), (2, 1), (1, 0)]
    with pytest.raises(ValueError, match="hysteresis"):
        DegradeConfig(up=(0.5, 0.5, 0.5, 0.5), down=(0.6, 0.1, 0.1, 0.1))


# -- admission control ----------------------------------------------------


def test_bounded_queue_typed_backpressure(served):
    """Flooding far beyond the bound: depth never exceeds it, overflow
    is rejected with a typed reason, and every request is answered."""
    res, q = served
    ex = _executor(res, queue_bound=8)
    rate = 50 * ex.sustainable_qps() / 32
    trace = poisson_trace(1, rate=rate, horizon=60 / rate, rows=32,
                          deadline=1e-3)
    reqs = requests_from_trace(trace, q, default_deadline=1e-3)
    resps = ex.run_trace(reqs)
    assert len(resps) == len(reqs)
    assert ex.queue.max_depth <= 8
    rej = [r for r in resps if r.status == "rejected"]
    assert rej and all(r.reason == "queue_full" for r in rej)
    assert all(r.status in ("ok", "rejected", "overloaded") for r in resps)
    st = ex.stats()
    assert st["responses_ok"] + st["responses_overloaded"] == st["admitted"]


def test_shed_rung_typed_overloaded(served):
    """Sustained 3x overload under a tight deadline drives the ladder to
    the shed rung: sheds are typed Overloaded, counted on the degrade
    lane, and lowest-priority requests go first."""
    res, q = served
    ex = _executor(res, queue_bound=64, deadline=2e-4)
    rate = 3 * ex.sustainable_qps() / 32
    trace = poisson_trace(2, rate=rate, horizon=400 / rate, rows=32,
                          deadline=2e-4, priority_levels=2)
    reqs = requests_from_trace(trace, q, default_deadline=2e-4)
    resps = ex.run_trace(reqs)
    shed = [r for r in resps if r.status == "overloaded"]
    assert shed, "overload never reached the shed rung"
    assert all(isinstance(r, Overloaded) and r.reason == "shed"
               and r.rung == SHED for r in shed)
    assert ex.counter.degrades["shed"] == len(shed)
    by_rid = {r.rid: r for r in reqs}
    p_shed = [by_rid[r.rid].priority for r in shed]
    assert p_shed.count(0) >= p_shed.count(1)
    assert len(resps) == len(reqs)


# -- micro-batching / the shapes run ----------------------------------------


def test_jit_cache_bounded_by_ladder(served):
    """Ragged request sizes never bring a new shape: after warmup,
    serving adds no (kind, bucket, rung) shape, and the shapes stay
    within ladder x rungs."""
    res, q = served
    ex = _executor(res)
    before = ex.jit_cache_sizes()
    assert before == {"predict": 4 * len(ex.buckets),
                      "partial_fit": len(ex.buckets)}
    rng = np.random.default_rng(0)
    t, trace = 0.0, []
    for _ in range(60):
        t += 1e-4
        trace.append({"t": t, "kind": "predict",
                      "rows": int(rng.integers(1, 129))})
    reqs = requests_from_trace(trace, q, default_deadline=1e-3)
    ex.run_trace(reqs)
    assert ex.jit_cache_sizes() == before
    assert len(ex.compiled_shapes) <= len(ex.buckets)
    assert ex.stats()["compiled_shapes"] <= len(ex.buckets)


# -- degraded rungs still assign correctly -------------------------------


def test_degraded_rungs_quality(served):
    """Degraded rungs under overload agree with brute force on >= 95% of
    rows; the int8_scan rung equals FULL bit for bit."""
    from repro_torch.kernels.ops import assign_nearest_kernel
    res, q = served
    ex = _executor(res, queue_bound=64, deadline=5e-4)
    a_true = assign_nearest_kernel(torch.tensor(q), res.centers)[0].numpy()
    a_full = ex.model.predict(torch.tensor(q)).numpy()
    rate = 2 * ex.sustainable_qps() / 32
    trace = poisson_trace(3, rate=rate, horizon=300 / rate, rows=32,
                          deadline=5e-4)
    reqs = requests_from_trace(trace, q, default_deadline=5e-4)
    resps = ex.run_trace(reqs)
    correct = total = 0
    for r, req in zip(resps, reqs):
        if r.ok and r.rung in (INT8_SCAN, PROBE_SHRINK, ROUTE_ONLY):
            correct += int((np.asarray(r.result) == a_true[req.meta]).sum())
            total += len(req.meta)
        if r.ok and r.rung in (FULL, INT8_SCAN):
            np.testing.assert_array_equal(r.result, a_full[req.meta])
    assert total, "overload never degraded"
    assert correct / total >= 0.95
    assert ex.counter.degrades["int8_scan"] \
        + ex.counter.degrades["probe_shrink"] \
        + ex.counter.degrades["route_only"] > 0


# -- chaos: bursts, poison, slow consumer, fold-during-burst -------------

_CHAOS = dict(poison_queries={3: 4, 17: 2}, slow_consumer={5: 0.004},
              fail_calls={"serve_predict": (2,)})


def _chaos_trace(ex, q):
    rate = 1.5 * ex.sustainable_qps() / 32
    hz = 300 / rate
    trace = poisson_trace(5, rate=rate, horizon=hz, rows=32, deadline=1e-3,
                          bursts=((0.3 * hz, 0.6 * hz, 3.0),), pf_every=9,
                          pf_rows=32)
    return requests_from_trace(trace, q, default_deadline=1e-3)


def _chaos_run(res, q):
    ex = _executor(res, queue_bound=64, deadline=1e-3)
    reqs = _chaos_trace(ex, q)
    with FaultInjector(seed=7, **_CHAOS) as inj:
        resps = ex.run_trace(reqs)
        vio = ex.guard()
    return ex, reqs, resps, inj, vio


def test_chaos_burst_poison_stall_fold(served):
    res, q = served
    ex, reqs, resps, inj, vio = _chaos_run(res, q)
    assert len(resps) == len(reqs)
    assert ex.counter.sanitized_rows == 6
    assert resps[3].ok and resps[17].ok
    assert ex.counter.retries >= 1
    assert any(e[1] == "slow_consumer" for e in ex.events)
    assert ex.ladder.transcript, "burst never moved the ladder"
    pf = [r for r in resps if r.kind == "partial_fit"]
    pf_ok = [r for r in pf if r.ok]
    assert pf_ok and all(r.status in ("ok", "rejected") for r in pf)
    assert 1 <= ex.model.batches_seen <= len(pf_ok)
    assert not vio.any()
    assert not any(e[1] == "heal" for e in ex.events)
    assert ex.stats()["wall_s"] > 0.0


def _same_responses(r1, r2):
    assert len(r1) == len(r2)
    for a, b in zip(r1, r2):
        assert (a.rid, a.status, a.rung, a.t_arrival, a.t_done,
                a.reason) == (b.rid, b.status, b.rung, b.t_arrival,
                              b.t_done, b.reason)
        if a.result is None:
            assert b.result is None
        else:
            assert np.array_equal(np.asarray(a.result), np.asarray(b.result))


def test_chaos_replay_bit_deterministic(served):
    """Same trace + same seeds => bit-identical responses (status, rung,
    virtual timestamps, result arrays) and an identical transcript."""
    res, q = served
    ex1, _, r1, _, _ = _chaos_run(res, q)
    ex2, _, r2, _, _ = _chaos_run(res, q)
    _same_responses(r1, r2)
    assert ex1.ladder.transcript == ex2.ladder.transcript
    assert ex1.counter.degrades == ex2.counter.degrades
    assert ex1.counter.sanitized_rows == ex2.counter.sanitized_rows
    assert ex1.events == ex2.events


def test_ladder_recovers_after_stall(served):
    res, q = served
    ex = _executor(res, queue_bound=64, deadline=1e-3)
    rate = 0.3 * ex.sustainable_qps() / 32
    trace = poisson_trace(6, rate=rate, horizon=400 / rate, rows=32,
                          deadline=1e-3)
    reqs = requests_from_trace(trace, q, default_deadline=1e-3)
    with FaultInjector(seed=8, slow_consumer={3: 0.006}):
        ex.run_trace(reqs)
    ups = [(o, n) for _, o, n, _ in ex.ladder.transcript if n > o]
    assert ups, "stall never raised the ladder"
    assert ex.ladder.rung == FULL, "ladder never recovered"
    assert all(r.ok for r in ex.responses.values())


# -- generic ops + guard/heal --------------------------------------------


def test_generic_call_retry_and_unknown_kind(served):
    res, q = served
    ex = _executor(res)
    calls = []
    ex.register("echo", lambda p: calls.append(p) or p * 2,
                cost=lambda p: 1e-4)
    with FaultInjector(seed=9, fail_calls={"echo": (0,)}):
        resp = ex.call("echo", 21)
    assert resp.ok and resp.result == 42
    assert ex.counter.retries == 1
    assert len(calls) == 1
    bad = ex.call("nope", None)
    assert bad.status == "rejected" and bad.reason == "unknown_kind"
    with pytest.raises(ValueError, match="built-in"):
        ex.register("predict", lambda p: p)


def test_guard_heals_poisoned_center(served):
    res, q = served
    ex = _executor(res)
    m = ex.model
    c = m.state.c.clone()
    c[0] = float("nan")
    m.state = m.state._replace(c=c)
    vio = ex.guard()
    assert vio.any()
    assert ex.counter.repairs.get("regroup", 0) == 1
    assert any(e[1] == "heal" for e in ex.events)
    assert torch.isfinite(m.state.c).all()
    a = m.predict(torch.tensor(q[:64]))
    assert a.shape == (64,)


def test_guard_heals_a_poisoned_arena(served):
    """An arena model (built over the training rows) with a NaN mirror
    row and a duplicated slot: the guard's arena lane fires, the heal
    quarantines the row and re-sorts the arena, and the guard is clean
    after."""
    res, q = served
    x = _blobs(0, 2048 + 1024, 16, 32)[:2048]
    model = KMeansModel.from_result(res, x, kn=KN, device="cpu")
    ex = ServeExecutor(model, ServeConfig(ladder=(32, 64)), OpCounter())
    pid = model.state.pid.clone()
    owned = torch.nonzero(pid >= 0).flatten()
    pid[owned[3]] = pid[owned[7]]
    model.state = model.state._replace(pid=pid)
    model.x_pts[5] = float("nan")
    vio = ex.guard()
    assert vio[3] > 0
    assert ex.counter.sanitized_rows == 1
    assert ex.counter.repairs["regroup"] == 1
    assert not ex.guard().any()


# -- the two packages on one trace ------------------------------------------


def test_one_trace_one_seed_through_both_executors():
    """The reference's model carried across, one chaos trace with one
    seed through both executors: identical responses (status, rung,
    virtual times, assignments), rung transcripts, events and counters,
    the f32 distance charge within 1e-4 (ROADMAP §3 entries 3 and 12)."""
    import jax
    from repro.core import OpCounter as JaxCounter
    from repro.core import fit as jax_fit
    from repro.core.model import KMeansModel as JaxModel
    from repro.ft import FaultInjector as JaxInjector
    from repro.serve import ServeConfig as JaxConfig
    from repro.serve import ServeExecutor as JaxExecutor
    from repro.serve import requests_from_trace as jax_requests
    from repro_torch.convert import model_from_reference
    allx = _blobs(1, 2048 + 1024, 16, 32)
    x, q = allx[:2048], allx[2048:]
    res = jax_fit(x, 32, kn=KN, max_iters=10, key=jax.random.PRNGKey(0))
    kw = dict(queue_bound=64, ladder=(32, 64, 128), deadline=1e-3)
    jm = JaxModel.from_result(res, kn=KN, backend="xla")
    ex_j = JaxExecutor(jm, JaxConfig(**kw), JaxCounter())
    ex_t = ServeExecutor(model_from_reference(jm, device="cpu"),
                         ServeConfig(**kw), OpCounter())
    ex_j.warmup()
    ex_t.warmup()
    reqs_t = _chaos_trace(ex_t, q)
    rate = 1.5 * ex_j.sustainable_qps() / 32
    hz = 300 / rate
    trace = poisson_trace(5, rate=rate, horizon=hz, rows=32, deadline=1e-3,
                          bursts=((0.3 * hz, 0.6 * hz, 3.0),), pf_every=9,
                          pf_rows=32)
    reqs_j = jax_requests(trace, q, default_deadline=1e-3)
    with JaxInjector(seed=7, **_CHAOS):
        r_j = ex_j.run_trace(reqs_j)
        vio_j = ex_j.guard()
    with FaultInjector(seed=7, **_CHAOS):
        r_t = ex_t.run_trace(reqs_t)
        vio_t = ex_t.guard()
    _same_responses(r_t, r_j)
    assert ex_t.ladder.transcript == ex_j.ladder.transcript
    assert ex_t.ladder.transcript
    assert ex_t.events == ex_j.events
    assert vio_t.tolist() == np.asarray(vio_j).tolist()
    for lane in ("int8_ops", "retries", "sanitized_rows", "additions",
                 "degraded_folds"):
        assert getattr(ex_t.counter, lane) == getattr(ex_j.counter, lane), \
            lane
    # the f32 route's charge parts on rows within rounding of a pruning
    # boundary (ROADMAP §3 entries 3 and 12): at most 1e-4 of the total
    dj, dt = ex_j.counter.distances, ex_t.counter.distances
    assert abs(dt - dj) <= 1e-4 * dj
    assert ex_t.counter.degrades == ex_j.counter.degrades
    assert ex_t.counter.repairs == ex_j.counter.repairs
