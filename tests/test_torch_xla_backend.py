"""The port's ungrouped ``xla`` backend against the JAX reference's, on
the CPU: the distance helpers of ``core.distance``, the k²-means fit in
the rebuild, resident and int8 residencies, and the served model's
``predict``.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: assignments, iteration counts and every counted lane are
equal; centers and energies within rtol 1e-5 (the two packages take the
center sums in other orders). The port's (point, center) values are the
correctly rounded ones of ``quant.sqdist_exact``, bit for bit; the
reference's are XLA's f32 sums, equal to them on integer data and within
rtol 1e-6 of the expansion's terms otherwise. Port ``xla`` against port
``kernels`` from one init: identical assignments, centers and
iterations.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import fit as jax_fit
from repro.core import fit_k2means as jax_fit_k2means
from repro.core import distance as jd
from repro.ft import FaultInjector as JaxInjector
from repro_torch.convert import from_reference, model_from_reference
from repro_torch.core import (KMeansModel, KMeansResult, OpCounter,
                              chunked_argmin_sqdist,
                              chunked_candidate_argmin,
                              chunked_candidate_top2, fit, fit_k2means,
                              gather_candidate_sqdist, pairwise_sqdist)
from repro_torch.ft import FaultInjector, Preemption
from repro_torch.kernels import exact_round, quant, ref
from repro_torch.kernels.ref import PAD_SQDIST

from test_torch_fit import assert_same_charges, blobs, reference_init
from test_torch_quant import assert_sq_close
from test_torch_stream import _draw_recorder

T = torch.tensor


def _pairs(seed, n=300, d=12, k=40, kn=7, integer=False):
    """Rows, centers and per-row candidate lists (distinct ids)."""
    rng = np.random.RandomState(seed)
    if integer:
        x = rng.randint(-9, 10, (n, d)).astype(np.float32)
        c = rng.randint(-9, 10, (k, d)).astype(np.float32)
    else:
        x = (rng.randn(n, d) * 3).astype(np.float32)
        c = (rng.randn(k, d) * 3).astype(np.float32)
    cand = np.stack([rng.choice(k, kn, replace=False) for _ in range(n)])
    return x, c, cand.astype(np.int32)


# -- the distance helpers ------------------------------------------------


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "integer"])
def test_candidate_helpers_are_sqdist_exact_columns(integer):
    """Every helper's value of a (row, candidate) pair is the pair's
    ``quant.sqdist_exact`` value bit for bit (its square root for
    ``chunked_candidate_top2``), at any chunk size; -1 reads
    PAD_SQDIST."""
    x, c, cand = _pairs(1, integer=integer)
    full = quant.sqdist_exact(T(x), T(c))
    cols = torch.gather(full, 1, T(cand).long())
    assert torch.equal(pairwise_sqdist(T(x), T(c)), full)
    holes = cand.copy()
    holes[::3, 2] = -1
    for chunk in (1, 64, 2048):
        got = gather_candidate_sqdist(T(x), T(c), T(holes), chunk=chunk)
        assert torch.equal(got, torch.where(T(holes) >= 0, cols,
                                            PAD_SQDIST)), chunk
        a, dmin = chunked_candidate_argmin(T(x), T(c), T(cand), chunk=chunk)
        loc = torch.argmin(cols, 1, keepdim=True)
        assert torch.equal(a.long(), torch.gather(T(cand).long(), 1,
                                                  loc)[:, 0])
        assert torch.equal(dmin, torch.gather(cols, 1, loc)[:, 0])
        a2, d1, d2 = chunked_candidate_top2(T(x), T(c), T(cand), chunk=chunk)
        dist = exact_round.sqrt_rn(cols)
        loc2 = torch.argmin(dist, 1, keepdim=True)
        assert torch.equal(a2.long(), torch.gather(T(cand).long(), 1,
                                                   loc2)[:, 0])
        srt = torch.sort(dist, 1).values
        assert torch.equal(d1, srt[:, 0]) and torch.equal(d2, srt[:, 1])
    a5, d5 = chunked_argmin_sqdist(T(x), T(c))
    assert torch.equal(a5.long(), torch.argmin(full, 1))
    assert torch.equal(d5, torch.amin(full, 1))


def test_sqrt_rn_is_correctly_rounded():
    """``exact_round.sqrt_rn`` against numpy's f32 root (the hardware's,
    correctly rounded) and XLA's, over 10^6 values and one where torch's
    CPU root is one ulp off (1421: 37.69615... rounds up)."""
    rng = np.random.RandomState(0)
    v = np.concatenate([rng.rand(500_000).astype(np.float32) * 4000,
                        rng.randint(0, 5000, 500_000).astype(np.float32),
                        np.float32([1421.0, 0.0, 3.4e38])])
    got = exact_round.sqrt_rn(T(v)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(v))
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(v))))
    assert float(got[-3]).hex() == "0x1.2d91ba0000000p+5"


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "integer"])
def test_candidate_helpers_match_reference(integer):
    """The helpers against the reference's: the same assignments and
    top-2 ids; values bit-equal on integer data (XLA's f32 sums are exact
    there), within rtol 1e-6 of the expansion's terms otherwise."""
    x, c, cand = _pairs(2, integer=integer)
    xj, cj, candj = jnp.asarray(x), jnp.asarray(c), jnp.asarray(cand)
    a_t, d_t = chunked_candidate_argmin(T(x), T(c), T(cand), chunk=128)
    a_j, d_j = jd.chunked_candidate_argmin(xj, cj, candj, chunk=128)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    t_t = chunked_candidate_top2(T(x), T(c), T(cand), chunk=128)
    t_j = jd.chunked_candidate_top2(xj, cj, candj, chunk=128)
    np.testing.assert_array_equal(t_t[0].numpy(), np.asarray(t_j[0]))
    g_t = gather_candidate_sqdist(T(x), T(c), T(cand))
    g_j = np.asarray(jd.gather_candidate_sqdist(xj, cj, candj))
    p_t = pairwise_sqdist(T(x), T(c))
    p_j = np.asarray(jd.pairwise_sqdist(xj, cj))
    am_t, _ = chunked_argmin_sqdist(T(x), T(c))
    np.testing.assert_array_equal(
        am_t.numpy(), np.asarray(jd.chunked_argmin_sqdist(xj, cj)[0]))
    if integer:
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(g_t.numpy(), g_j)
        np.testing.assert_array_equal(p_t.numpy(), p_j)
        for u, v in zip(t_t[1:], t_j[1:]):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))
    else:
        assert_sq_close(d_t.numpy(), np.asarray(d_j), x, c, a_t.numpy())
        assert_sq_close(g_t.numpy(), g_j, x, c, cand)
        assert_sq_close(p_t.numpy(), p_j, x, c,
                        np.broadcast_to(np.arange(c.shape[0]), p_j.shape))
        for u, v in zip(t_t[1:], t_j[1:]):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-5)


def test_candidate_ties_go_to_the_first_in_list_order():
    """Two candidates at one distance: the first listed wins, in the
    argmin and in the top-2 (whose two distances are then equal)."""
    x = np.zeros((2, 3), np.float32)
    c = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 3]], np.float32)
    cand = np.array([[1, 0, 2], [0, 1, 2]], np.int32)
    a, d = chunked_candidate_argmin(T(x), T(c), T(cand))
    assert a.tolist() == [1, 0] and d.tolist() == [1.0, 1.0]
    a2, d1, d2 = chunked_candidate_top2(T(x), T(c), T(cand))
    assert a2.tolist() == [1, 0] and d1.tolist() == d2.tolist() == [1.0, 1.0]
    aj = jd.chunked_candidate_top2(jnp.asarray(x), jnp.asarray(c),
                                   jnp.asarray(cand))
    assert np.asarray(aj[0]).tolist() == [1, 0]


def test_candidate_helpers_form_no_dense_product(monkeypatch):
    """The candidate helpers never call the (m, k) product: with
    ``exact_cross`` made to raise they still give the same values."""
    x, c, cand = _pairs(3)
    want = gather_candidate_sqdist(T(x), T(c), T(cand))

    def refuse(*a, **kw):
        raise AssertionError("dense product formed")
    monkeypatch.setattr(exact_round, "exact_cross", refuse)
    monkeypatch.setattr(ref, "exact_cross", refuse)
    assert torch.equal(gather_candidate_sqdist(T(x), T(c), T(cand)), want)
    chunked_candidate_argmin(T(x), T(c), T(cand))
    chunked_candidate_top2(T(x), T(c), T(cand))


# -- the fit ---------------------------------------------------------------

_FITS = [{"residency": "rebuild"}, {"residency": "resident"},
         {"residency": "resident", "precision": "int8"},
         {"residency": "rebuild", "monitor_every": 4}]
_FIT_IDS = ["rebuild", "resident", "int8", "monitor4"]


def _fit_data():
    """test_torch_fit's convergence configuration (n=1500, d=24, k=50)."""
    x = blobs(0, 1500, 24, 15)
    init, a0 = reference_init(x, 50, 7)
    return x, init, a0


@pytest.mark.parametrize("kw", _FITS, ids=_FIT_IDS)
def test_xla_fit_matches_reference(kw):
    """fit_k2means(backend="xla") against the reference's xla fit to the
    fixed point: identical assignments and iterations, centers and
    energies within rtol 1e-5, equal counted lanes."""
    x, init, a0 = _fit_data()
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit_k2means(jnp.asarray(x), jnp.asarray(init), jnp.asarray(a0),
                         kn=8, max_iters=40, backend="xla", counter=cj, **kw)
    c0, a0_t = from_reference(init, a0, device="cpu")
    rt = fit_k2means(T(x), c0, a0_t, kn=8, max_iters=40, backend="xla",
                     counter=ct, device="cpu", **kw)
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.iterations == rj.iterations
    assert len(rt.history) == len(rj.history)
    for (_, et), (_, ej) in zip(rt.history, rj.history):
        assert et == pytest.approx(ej, rel=1e-5)
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               rtol=1e-5, atol=1e-4)
    assert_same_charges(cj, ct)
    if kw.get("precision") == "int8":
        assert ct.int8_ops == cj.int8_ops > 0


@pytest.mark.parametrize("kw", _FITS[:3], ids=_FIT_IDS[:3])
def test_xla_fit_equals_kernels_fit(kw):
    """Port xla against port kernels from one init, in one residency:
    identical assignments, centers and iterations (both rank the same
    correctly rounded distances). The kernels path recomputes whole
    blocks, so its counted distances may differ."""
    x, init, a0 = _fit_data()
    args = (T(x), T(init), T(a0))
    rx = fit_k2means(*args, kn=8, max_iters=40, backend="xla", device="cpu",
                     **kw)
    rk = fit_k2means(*args, kn=8, max_iters=40, backend="kernels",
                     device="cpu", **kw)
    assert torch.equal(rx.assignment, rk.assignment)
    assert torch.equal(rx.centers, rk.centers)
    assert rx.iterations == rk.iterations and rx.energy == rk.energy


def test_xla_residency_resolves_as_the_reference():
    """residency=None: rebuild on xla (no layout traffic), resident on
    kernels and under int8."""
    x, init, a0 = _fit_data()
    args = (T(x), T(init), T(a0))
    counters = {}
    for name, kw in (("xla", {"backend": "xla"}), ("kernels", {}),
                     ("xla_int8", {"backend": "xla", "precision": "int8"})):
        counters[name] = OpCounter()
        fit_k2means(*args, kn=8, max_iters=6, counter=counters[name],
                    device="cpu", **kw)
    assert counters["xla"].rows_moved == 0 and counters["xla"].resorts == 0
    assert 0 < counters["kernels"].rows_moved < 6 * x.shape[0]
    assert 0 < counters["xla_int8"].rows_moved < 6 * x.shape[0]
    with pytest.raises(ValueError, match="backend"):
        fit_k2means(*args, kn=8, backend="pallas", device="cpu")


def test_xla_kill_and_resume_bitexact(tmp_path):
    """The checkpointing rebuild fit on xla, preempted before iteration 7
    and resumed from step 6, equals the uninterrupted fit bit for bit."""
    from repro_torch.checkpoint import latest_step
    x, init, a0 = _fit_data()
    kw = dict(kn=8, max_iters=12, backend="xla", device="cpu")
    base = fit_k2means(T(x), T(init), T(a0), **kw)
    d = str(tmp_path / "ckpt")
    with pytest.raises(Preemption):
        with FaultInjector(seed=0, preempt_at=7):
            fit_k2means(T(x), T(init), T(a0), ckpt_dir=d, ckpt_every=3, **kw)
    assert latest_step(d) == 6
    ctr = OpCounter()
    r = fit_k2means(T(x), T(init), T(a0), ckpt_dir=d, ckpt_every=3,
                    resume=True, counter=ctr, **kw)
    assert torch.equal(r.assignment, base.assignment)
    assert torch.equal(r.centers, base.centers)
    assert ctr.repairs["restore"] == 1


@pytest.mark.parametrize("residency", ["rebuild", "resident"])
def test_xla_guarded_chaos_fit_matches_reference(residency, monkeypatch):
    """A guarded xla fit under duplicate rows, poisoned slots, bounds and
    a center, with the reference's split draws: the same events, repairs,
    final assignment and iterations as the reference's guarded xla
    fit."""
    calls, used = _draw_recorder(monkeypatch)
    sched = dict(dup_rows={2: 9}, poison_centers={4: 1},
                 poison_bounds={5: 4})
    if residency == "resident":
        sched["poison_slots"] = {3: 3}
    x = blobs(5, 1024, 16, 20)
    init, a0 = reference_init(x, 24, 5)
    kw = dict(kn=6, max_iters=14, residency=residency, guards=True)
    cj, ct = JaxCounter(), OpCounter()
    with JaxInjector(seed=11, **sched) as inj_j:
        rj = jax_fit_k2means(jnp.asarray(x), jnp.asarray(init),
                             jnp.asarray(a0), backend="xla", counter=cj,
                             key=jax.random.PRNGKey(3), **kw)
    with FaultInjector(seed=11, **sched) as inj_t:
        rt = fit_k2means(T(x), T(init), T(a0), backend="xla", counter=ct,
                         device="cpu", key=3, **kw)
    assert len(used) == len(calls)
    assert inj_t.events == inj_j.events
    assert ct.repairs == cj.repairs and sum(ct.repairs.values()) >= 1
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.iterations == rj.iterations
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)


# -- the served model on the xla backend ----------------------------------


@pytest.fixture(scope="module")
def xla_models():
    """test_torch_predict's fixture (4096 + 2048 GMM rows, d=16, k=48,
    k_n=8) through the reference's default fit, whose model resolves on
    ``backend="xla"``: (x, queries, the reference's fit result, its
    model, the port's copy of the model)."""
    from repro.data import gmm_blobs
    key = jax.random.PRNGKey(0)
    allx = gmm_blobs(key, 4096 + 2048, 16, true_k=48)
    x, q = np.array(allx[:4096]), np.array(allx[4096:])
    res, jm = jax_fit(jnp.asarray(x), 48, kn=8, max_iters=25, key=key,
                      return_model=True)
    assert jm.backend == "xla"
    return x, q, res, jm, model_from_reference(jm, device="cpu")


@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_xla_predict_matches_reference(xla_models, prec):
    """predict on the xla backend against the reference's xla model: the
    same assignments, distances within rtol 1e-6 of the terms, equal
    int8 charges; and the kernels backend's assignments and distances
    bit for bit."""
    _, q, _, jm, pm = xla_models
    assert pm.backend == "xla"
    cj, ct = JaxCounter(), OpCounter()
    a_j, d_j = (np.asarray(v) for v in jm.predict(
        jnp.asarray(q), counter=cj, return_sqdist=True, precision=prec))
    a_t, d_t = pm.predict(q, counter=ct, return_sqdist=True, precision=prec)
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    assert_sq_close(d_t.numpy(), d_j, q, np.asarray(jm.centers), a_j)
    assert ct.int8_ops == cj.int8_ops
    if prec == "int8":
        assert ct.distances == cj.distances
        assert ct.bytes_scanned == cj.bytes_scanned
    pk = dataclasses.replace(pm, backend="kernels")
    a_k, d_k = pk.predict(q, return_sqdist=True, precision=prec)
    assert torch.equal(a_k, a_t) and torch.equal(d_k, d_t)


def test_xla_predict_stream_matches_reference(xla_models):
    """predict(stream=) cold then warm on the xla model: the reference's
    assignments both times, and the warm call charging what the
    reference's warm call charges."""
    _, q, _, jm, pm = xla_models
    qb = q[:1024]
    charges = {}
    for call in ("cold", "warm"):
        cj, ct = JaxCounter(), OpCounter()
        a_j = np.asarray(jm.predict(jnp.asarray(qb), counter=cj,
                                    stream="s"))
        a_t = pm.predict(qb, counter=ct, stream="s")
        np.testing.assert_array_equal(a_t.numpy(), a_j, err_msg=call)
        charges[call] = (ct.distances, cj.distances)
    assert charges["warm"][0] == charges["warm"][1] < charges["cold"][0]


def test_xla_partial_fit_matches_reference_and_kernels(xla_models):
    """partial_fit on a fresh xla model, batch by batch: the reference's
    xla model's assignments, and the kernels model's assignments and
    arena bit for bit."""
    from repro.core.model import KMeansModel as JaxModel
    x, q, res, _, _ = xla_models
    jm = JaxModel.from_result(res, jnp.asarray(x), kn=8)
    r = KMeansResult(T(np.asarray(res.centers)), T(np.asarray(
        res.assignment)), 0.0, 0, 0.0, [])
    mx = KMeansModel.from_result(r, x, kn=8, backend="xla", device="cpu")
    mk = KMeansModel.from_result(r, x, kn=8, device="cpu")
    for i in range(3):
        xb = q[i * 256:(i + 1) * 256]
        a_j = np.asarray(jm.partial_fit(jnp.asarray(xb)))
        a_x = mx.partial_fit(xb)
        np.testing.assert_array_equal(a_x.numpy(), a_j, err_msg=str(i))
        assert torch.equal(a_x, mk.partial_fit(xb))
    for f in ("c", "sums", "counts", "pid", "b2c", "xg"):
        assert torch.equal(getattr(mx.state, f), getattr(mk.state, f)), f


def _small_model():
    """A small model pair (n=512, d=8, k=12): queries, the reference's
    xla model and the port's copy."""
    x = blobs(11, 512, 8, 6)
    _, jm = jax_fit(jnp.asarray(x), 12, kn=4, max_iters=8,
                    key=jax.random.PRNGKey(1), return_model=True)
    return blobs(12, 64, 8, 6), jm, model_from_reference(jm, device="cpu")


@pytest.mark.parametrize("backend", ["kernels", "xla"])
def test_model_checkpoint_records_its_backend(tmp_path, backend):
    """_config writes the model's backend under the reference's name
    ("pallas" or "xla"), the reference restores it so, and the port's
    restore of either package's checkpoint gives the model its
    backend."""
    from repro.core.model import KMeansModel as JaxModel
    q, _, pm = _small_model()
    m = dataclasses.replace(pm, backend=backend)
    name = {"kernels": "pallas", "xla": "xla"}[backend]
    assert m._config()["backend"] == name
    d = str(tmp_path / "ckpt")
    m.save(d)
    back = KMeansModel.restore(d, device="cpu")
    assert back.backend == backend
    jm = JaxModel.restore(d)
    assert jm.backend == name
    jm.save(d, step=1)
    assert KMeansModel.restore(d, step=1, device="cpu").backend == backend
    assert torch.equal(back.predict(q), m.predict(q))


def test_fit_return_model_takes_the_fit_backend():
    """fit(return_model=True) gives the model the backend the fit ran on;
    the xla fit from host GDI equals the kernels rebuild fit from the
    same GDI."""
    x = blobs(13, 800, 8, 10)
    rx, mx = fit(x, 16, init="gdi_host", backend="xla", kn=4, max_iters=15,
                 device="cpu", return_model=True)
    rk, mk = fit(x, 16, init="gdi_host", kn=4, max_iters=15, device="cpu",
                 return_model=True, residency="rebuild")
    assert mx.backend == "xla" and mk.backend == "kernels"
    assert torch.equal(rx.assignment, rk.assignment)
    assert torch.equal(rx.centers, rk.centers)
    assert torch.equal(mx.predict(x), mk.predict(x))
