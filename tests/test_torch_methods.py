"""The port's host-loop and round-parallel GDI, MiniBatch and AKM against
the JAX reference, on the CPU, and ``api.fit`` over every method and
init the port has.

Inputs are drawn with numpy from a seed and handed to both packages.
``jax.random`` draws cannot be made with a ``torch.Generator``, so the
reference's are injected: ``gdi_init``'s split members through
``core.gdi._split_draws`` (``test_torch_stream._draw_recorder``),
``gdi_parallel_init``'s round uniforms through ``draws=``, MiniBatch's
batch rows through ``batches=`` and AKM's group seeds through
``group_draws=``. Tolerances: assignments, iteration and history counts
and every counted lane are equal; centers and energies within rtol 1e-5
(atol 1e-4 for centers near 0). GDI's and AKM's centers are means the
two packages sum in other orders. MiniBatch's are the same sequence of
f32 operations, which XLA on the CPU contracts into a fused
multiply-add: one step from one state differs by one rounding of the
update's terms, and the differences compound over the run (ROADMAP §3
entry 17; :func:`test_minibatch_step_differs_only_by_the_contraction`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import fit as jax_fit
from repro.core import gdi_init as jax_gdi_init
from repro.core import gdi_parallel_init as jax_gdi_parallel_init
from repro.core.akm import fit_akm as jax_fit_akm
from repro.core.lloyd import fit_lloyd as jax_fit_lloyd
from repro.core.minibatch import fit_minibatch as jax_fit_minibatch
from repro_torch.core import (INITS, METHODS, OpCounter, fit, fit_akm,
                              fit_minibatch, gdi_init, gdi_parallel_init)
from repro_torch.core.api import host_generator

from test_torch_fit import assert_same_charges, blobs, jax_draws
from test_torch_stream import _draw_recorder

T = torch.tensor


# -- GDI ------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k,true_k,seed", [(1200, 16, 24, 10, 0),
                                               (600, 8, 13, 5, 1)])
def test_gdi_init_with_reference_draws(monkeypatch, n, d, k, true_k, seed):
    """The host loop with the reference's split members: the same leaf of
    every split (each draw's mask checked by the recorder), identical
    assignments, centers within rtol 1e-5, equal charges."""
    calls, used = _draw_recorder(monkeypatch)
    x = blobs(seed, n, d, true_k)
    cj, ct = JaxCounter(), OpCounter()
    c_j, a_j = jax_gdi_init(jnp.asarray(x), k, jax.random.PRNGKey(seed),
                            counter=cj)
    c_t, a_t = gdi_init(T(x), k, counter=ct, device="cpu")
    assert len(used) == len(calls) == k - 1
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-4)
    assert_same_charges(cj, ct)


def test_gdi_init_splits_down_to_singletons(monkeypatch):
    """k = n with repeated rows: every leaf ends a singleton (a leaf of
    equal rows still splits), as in the reference, draw for draw."""
    calls, used = _draw_recorder(monkeypatch)
    x = np.repeat(np.eye(4, 3, dtype=np.float32), 3, axis=0)
    c_j, a_j = jax_gdi_init(jnp.asarray(x), 12, jax.random.PRNGKey(0))
    c_t, a_t = gdi_init(T(x), 12, device="cpu")
    assert len(used) == len(calls) == 11
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert sorted(a_t.tolist()) == list(range(12))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("k", [16, 20, 1])
def test_gdi_parallel_init_with_reference_draws(k):
    """Blind doubling over 2^ceil(log2 k) slots with the reference's round
    draws: identical assignments (at k = 20 after keeping the 20
    highest-energy leaves and sending the rest to the nearest kept center
    through K5), centers within rtol 1e-5, equal charges."""
    n, d = 1024, 12
    x = blobs(3, n, d, 12)
    key = jax.random.PRNGKey(5)
    cj, ct = JaxCounter(), OpCounter()
    c_j, a_j = jax_gdi_parallel_init(jnp.asarray(x), k, key, counter=cj,
                                     bn=8, impl="xla")
    c_t, a_t = gdi_parallel_init(T(x), k, counter=ct, bn=8,
                                 draws=jax_draws(key, n, 8), device="cpu")
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5,
                               atol=1e-4)
    assert_same_charges(cj, ct)
    assert c_t.shape == (k, d) and int(a_t.max()) < k


def test_gdi_parallel_keep_breaks_energy_ties_to_the_lower_slot():
    """Leaves of equal energy: the k kept are the lowest slots among the
    ties, as ``lax.top_k`` keeps them. Eight translated copies of one
    integer blob split into eight leaves whose energies are computed
    exactly, so they tie; k = 6 keeps slots 0-5."""
    base = np.array([[0, 0], [1, 0], [0, 2], [3, 1]], np.float32)
    x = np.concatenate([base + 100 * np.array([i % 4, i // 4], np.float32)
                        for i in range(8)])
    c8, a8 = gdi_parallel_init(T(x), 8, device="cpu")
    blob = np.arange(32) // 4
    assert all(len(set(a8.numpy()[blob == b])) == 1 for b in range(8))
    c6, _ = gdi_parallel_init(T(x), 6, device="cpu")
    assert torch.equal(c6, c8[:6])


# -- MiniBatch ------------------------------------------------------------


def _minibatch_rows(key, n, batch, iters):
    """The reference's batch rows: ``randint(split(key, iters)[t],
    (batch,), 0, n)``."""
    keys = jax.random.split(key, iters)
    return [np.array(jax.random.randint(keys[t], (batch,), 0, n))
            for t in range(iters)]


@pytest.mark.parametrize("n,d,k,batch,iters,eval_every",
                         [(2048, 16, 32, 100, None, 50),
                          (900, 8, 12, 64, 7, 3)])
def test_minibatch_with_reference_batches(n, d, k, batch, iters, eval_every):
    """Sculley's updates, vectorised across centers, against the
    reference's scan over the batch, with its batch rows: identical
    assignments, centers within rtol 1e-5 (module doc), equal charges,
    histories of one length with energies within rtol 1e-5."""
    x = blobs(4, n, d, 10)
    init = x[np.random.RandomState(4).choice(n, k, replace=False)]
    key = jax.random.PRNGKey(2)
    n_iters = iters or max(1, (2 * n + batch - 1) // batch)
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit_minibatch(jnp.asarray(x), jnp.asarray(init), key,
                           batch=batch, iters=iters, counter=cj,
                           eval_every=eval_every)
    rt = fit_minibatch(T(x), T(init), batch=batch, iters=iters, counter=ct,
                       eval_every=eval_every,
                       batches=_minibatch_rows(key, n, batch, n_iters),
                       device="cpu")
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.iterations == rj.iterations == n_iters
    assert len(rt.history) == len(rj.history)
    for (_, et), (_, ej) in zip(rt.history, rj.history):
        assert et == pytest.approx(ej, rel=1e-5)
    assert_same_charges(cj, ct)


def test_minibatch_step_is_the_sequential_update():
    """One batch with repeated centers against the per-sample loop in
    f32: the same centers and counts, bit for bit."""
    from repro_torch.core.minibatch import minibatch_step
    rng = np.random.RandomState(6)
    c = rng.randn(5, 4).astype(np.float32)
    xb = (c[rng.randint(0, 5, 40)] + 0.1 * rng.randn(40, 4)).astype(
        np.float32)
    v = np.array([0, 3, 1, 0, 7], np.float32)
    c2, v2 = minibatch_step(T(xb), T(c), T(v))
    a = np.argmin(((xb[:, None] - c[None]) ** 2).sum(-1), axis=1)
    cw, vw = torch.tensor(c), torch.tensor(v)
    for xi, ai in zip(xb, a):
        vw[ai] += 1.0
        eta = 1.0 / vw[ai]
        cw[ai] = (1.0 - eta) * cw[ai] + eta * torch.tensor(xi)
    assert torch.equal(v2, vw) and torch.equal(c2, cw)


def test_minibatch_step_differs_only_by_the_contraction():
    """One step from one state: the port's centers are the sequence
    ``(1 - eta) * c + eta * x`` with each operation rounded to f32, bit
    for bit; the reference's are that sequence or the same with the
    multiply-add fused (one rounding of ``(1 - eta) * c + round(eta *
    x)``), bit for bit (ROADMAP §3 entry 17)."""
    from repro.core.minibatch import minibatch_step as jax_step
    from repro_torch.core.minibatch import minibatch_step
    x = blobs(4, 2048, 16, 10)
    c = x[np.random.RandomState(4).choice(2048, 32, replace=False)]
    xb = x[np.random.RandomState(5).randint(0, 2048, 100)]
    v = np.zeros(32, np.float32)
    c_t, v_t = minibatch_step(T(xb), T(c), T(v))
    c_j, v_j = (np.asarray(u) for u in jax_step(jnp.asarray(xb),
                                                 jnp.asarray(c),
                                                 jnp.asarray(v)))
    a = np.argmin(((xb[:, None].astype(np.float64) - c[None]) ** 2).sum(-1),
                  axis=1)
    plain, fused, cnt = c.copy(), c.copy(), v.copy()
    one = np.float32(1.0)
    for xi, ai in zip(xb, a):
        cnt[ai] += one
        eta = one / cnt[ai]
        plain[ai] = (one - eta) * plain[ai] + eta * xi
        fused[ai] = ((one - eta).astype(np.float64) * fused[ai]
                     + (eta * xi).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(v_t.numpy(), cnt)
    np.testing.assert_array_equal(v_j, cnt)
    np.testing.assert_array_equal(c_t.numpy(), plain)
    assert (c_j == plain).all() or (c_j == fused).all()


def test_minibatch_zero_iters_evaluates_the_init():
    x = blobs(7, 300, 4, 3)
    init = x[:5]
    rj = jax_fit_minibatch(jnp.asarray(x), jnp.asarray(init),
                           jax.random.PRNGKey(0), iters=0)
    rt = fit_minibatch(T(x), T(init), iters=0, device="cpu")
    assert rt.iterations == rj.iterations == 0
    assert len(rt.history) == len(rj.history) == 1
    assert torch.equal(rt.centers, T(init))
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)


# -- AKM ------------------------------------------------------------------


def _akm_groups(key, k, g, max_iters):
    """The reference's group seeds: ``choice(split(key, max_iters)[i], k,
    (g,), replace=False)``."""
    keys = jax.random.split(key, max_iters)
    return [np.array(jax.random.choice(keys[i], k, shape=(g,),
                                       replace=False))
            for i in range(max_iters)]


@pytest.mark.parametrize("n,d,k,m,seed", [(2048, 16, 48, 8, 0),
                                          (1000, 8, 30, 30, 1),
                                          (1200, 12, 40, 3, 2)])
def test_akm_with_reference_groups(n, d, k, m, seed):
    """AKM with the reference's group seeds: identical assignments and
    iterations, centers within rtol 1e-5, equal charges (member
    evaluations included), histories of one length. m = 3 gives groups
    larger than the 4m cap, so members are dropped."""
    x = blobs(seed, n, d, 12)
    init = x[np.random.RandomState(seed).choice(n, k, replace=False)]
    key = jax.random.PRNGKey(seed)
    mm = min(m, k)
    g, max_iters = -(-k // mm), 30
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit_akm(jnp.asarray(x), jnp.asarray(init), key, m=m,
                     max_iters=max_iters, counter=cj)
    rt = fit_akm(T(x), T(init), m=m, max_iters=max_iters, counter=ct,
                 group_draws=_akm_groups(key, k, g, max_iters),
                 device="cpu")
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.iterations == rj.iterations
    assert len(rt.history) == len(rj.history)
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               rtol=1e-5, atol=1e-4)
    for (_, et), (_, ej) in zip(rt.history, rj.history):
        assert et == pytest.approx(ej, rel=1e-5)
    assert_same_charges(cj, ct)


def test_akm_member_table_drops_overflow_in_id_order():
    from repro_torch.core.akm import _member_table
    gid = T([2, 0, 2, 2, 1, 2, 0], dtype=torch.int32)
    tab = _member_table(gid, 3, 3)
    assert tab.tolist() == [[1, 6, -1], [4, -1, -1], [0, 2, 3]]


# -- the API --------------------------------------------------------------


def test_init_gdi_resolves_as_the_reference(monkeypatch):
    """fit(method="lloyd", init="gdi") seeds with the host loop
    ``gdi_init``, as the reference's fit does: with the reference's
    split members injected, the port's Lloyd fit starts from the
    reference's GDI centers and ends where the reference's ends."""
    calls, used = _draw_recorder(monkeypatch)
    x = blobs(8, 1200, 12, 10)
    k = 20
    rj = jax_fit(jnp.asarray(x), k, method="lloyd", init="gdi",
                 key=jax.random.PRNGKey(4), max_iters=50)
    rt = fit(x, k, method="lloyd", init="gdi", max_iters=50, device="cpu")
    assert len(used) == len(calls) == k - 1
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("method,backend,device_gdi", [
    ("k2means", None, True), ("k2means", "kernels", True),
    ("k2means", "xla", False), ("lloyd", None, False),
    ("elkan", None, False), ("minibatch", None, False),
    ("akm", None, False)])
def test_init_gdi_picks_device_gdi_only_on_the_kernels_k2means(
        monkeypatch, method, backend, device_gdi):
    """``init="gdi"`` runs ``gdi_device_init`` only for k²-means on the
    kernels backend, ``gdi_init`` otherwise; ``gdi_host`` and
    ``gdi_device`` pin one of them."""
    from repro_torch.core import api
    seen = []
    for name in ("gdi_init", "gdi_device_init"):
        real = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _r=real, _n=name, **kw: (
            seen.append(_n), _r(*a, **kw))[1])
    x = blobs(9, 400, 6, 5)
    kw = {} if backend is None else {"backend": backend}
    for init, want in (("gdi", "gdi_device_init" if device_gdi
                        else "gdi_init"),
                       ("gdi_host", "gdi_init"),
                       ("gdi_device", "gdi_device_init")):
        seen.clear()
        fit(x, 8, method=method, init=init, kn=3, max_iters=3, m=3,
            batch=40, device="cpu", **kw)
        assert seen == [want], (init, seen)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("init", INITS)
def test_fit_every_method_and_init(method, init):
    """Every method from every init through ``api.fit``: shapes, finite
    energies and history, charges on the counter, one result from one
    seed."""
    x = blobs(10, 600, 6, 8)
    kw = dict(method=method, init=init, kn=4, max_iters=12, m=4, batch=50,
              device="cpu")
    r = fit(x, 12, seed=3, profile=True, **kw)
    again = fit(x, 12, seed=3, **kw)
    assert r.centers.shape == (12, 6) and r.assignment.shape == (600,)
    assert 0 <= int(r.assignment.min()) and int(r.assignment.max()) < 12
    assert np.isfinite(r.energy) and r.ops > 0
    assert r.profile["total_ops"] == pytest.approx(r.ops)
    assert torch.equal(again.assignment, r.assignment)
    assert torch.equal(again.centers, r.centers)
    assert r.history and all(np.isfinite(e) for _, e in r.history)


def test_fit_minibatch_and_akm_keywords():
    """``batch``, ``minibatch_iters`` and ``m`` reach the methods: the
    charges are the reference's formulas."""
    x = blobs(11, 500, 5, 6)
    ct = OpCounter()
    fit(x, 10, method="minibatch", init="random", batch=20,
        minibatch_iters=7, counter=ct, device="cpu", eval_every=100)
    # 7 batches of 20 rows (k distances, 1 addition each), one evaluation
    assert ct.distances == 7 * 20 * 10 + 500 * 10 and ct.additions == 140
    ca = OpCounter()
    r = fit(x, 10, method="akm", init="random", m=5, max_iters=2, counter=ca,
            device="cpu")
    g = 2
    assert r.iterations == 2 and ca.additions == 2 * 500
    assert ca.distances > 2 * (3 * 10 * g + 500 * g + 500)


def test_host_draws_follow_the_generator_seed():
    """The host-drawn paths take a CPU generator with the caller's seed:
    a CPU generator passed in is used itself, and one seed gives one
    result."""
    g = torch.Generator().manual_seed(5)
    assert host_generator(g) is g
    x = blobs(12, 400, 4, 4)
    r1 = fit(x, 8, method="akm", init="gdi_parallel", m=3, max_iters=5,
             generator=torch.Generator().manual_seed(5), device="cpu")
    r2 = fit(x, 8, method="akm", init="gdi_parallel", m=3, max_iters=5,
             seed=5, device="cpu")
    assert torch.equal(r1.assignment, r2.assignment)


@pytest.mark.parametrize("method", ["minibatch", "akm"])
def test_new_methods_energy_near_reference(method):
    """With their own draws, MiniBatch's and AKM's seed-mean energies from
    k-means++ land within 2% of the reference's."""
    x = blobs(13, 1500, 8, 12)
    kw = dict(method=method, init="kmeanspp", max_iters=30, m=6, batch=100)
    ej = [jax_fit(jnp.asarray(x), 24, key=jax.random.PRNGKey(s),
                  **kw).energy for s in range(3)]
    et = [fit(x, 24, seed=s, device="cpu", **kw).energy for s in range(3)]
    assert abs(np.mean(et) / np.mean(ej) - 1.0) <= 0.02


def test_lloyd_from_gdi_parallel_matches_reference_from_its_init():
    """The round-parallel init feeds a Lloyd fit: from the reference's
    init (its draws injected), the port's Lloyd run equals the
    reference's."""
    n, k = 1024, 12
    x = blobs(14, n, 8, 9)
    key = jax.random.PRNGKey(1)
    c_j, _ = jax_gdi_parallel_init(jnp.asarray(x), k, key, bn=8, impl="xla")
    c_t, _ = gdi_parallel_init(T(x), k, bn=8, draws=jax_draws(key, n, 4),
                               device="cpu")
    rj = jax_fit_lloyd(jnp.asarray(x), c_j, max_iters=40)
    from repro_torch.core import fit_lloyd
    rt = fit_lloyd(c_t.new_tensor(x), c_t, max_iters=40, device="cpu")
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.iterations == rj.iterations
