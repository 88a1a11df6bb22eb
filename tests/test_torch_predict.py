"""The port's served model (``repro_torch.core.model``) against the JAX
reference's ``KMeansModel``, on the CPU.

The fixture is ``tests/test_model_predict.py``'s: 4096 + 2048 GMM rows
(d=16, 48 components), a fit at k=48, k_n=8, held-out queries from the
same mixture. The reference's model is carried across with
``convert.model_from_reference`` and both predict the same queries; the
reference runs its Pallas resolution kernels in interpret mode, as the
port runs its kernels' plain versions.

Tolerances: assignments, routed ids, survivor counts and the int8 charge
are equal. Squared distances are held to rtol 1e-6 of the norm
expansion's terms (``test_torch_quant.assert_sq_close``). The f32 charge
counts triangle-inequality comparisons of f32 distances, which the two
packages round differently (the port's products are rounded once from
f64, the reference's summed in f32): a query's charge may differ only
where one of its comparisons is within 1e-6 relative of its boundary
(a few f32 ulps), checked against an f64 evaluation of the same
comparisons. On this fixture 5 of the 2048 queries differ in the f32
charge, each within 1e-7 of a boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import fit as jax_fit
from repro.core.distance import chunked_argmin_sqdist
from repro.core.model import KMeansModel as JaxModel
from repro.core.model import _build_router as jax_build_router
from repro.core.model import _graph_with_dists as jax_graph
from repro.data import gmm_blobs
from repro_torch.convert import model_from_reference
from repro_torch.core import KMeansModel, KMeansResult, OpCounter, fit
from repro_torch.core.model import _build_router, _graph_with_dists

from test_resident_layout import check_layout
from test_torch_quant import assert_sq_close

KEY = jax.random.PRNGKey(0)
ARENA = ("xg", "pid", "ug", "lo_g", "wg", "b2c", "fill", "openb", "sums",
         "counts", "c", "prev_nb")


@pytest.fixture(scope="module")
def fitted():
    allx = gmm_blobs(KEY, 4096 + 2048, 16, true_k=48)
    x, q = np.array(allx[:4096]), np.array(allx[4096:])
    res, jm = jax_fit(jnp.asarray(x), 48, kn=8, max_iters=25, key=KEY,
                      return_model=True)
    jm = dataclasses.replace(jm, backend="pallas", interpret=True)
    return x, q, res, jm, model_from_reference(jm, device="cpu")


def _port_result(res):
    return KMeansResult(torch.tensor(np.asarray(res.centers)),
                        torch.tensor(np.asarray(res.assignment)),
                        float(res.energy), int(res.iterations),
                        float(res.ops), [])


def _near_boundary(jm, q, tol=1e-6):
    """Per query: whether one of the f32 route's and the Elkan count's
    comparisons lies within ``tol`` (relative) of its boundary, evaluated
    in f64 on the reference's router and graph (module doc)."""
    c = np.asarray(jm.centers, np.float64)
    gc = np.asarray(jm.router.gc, np.float64)
    members = np.asarray(jm.router.members)
    mdist = np.asarray(jm.router.mdist, np.float64)
    mowner = np.asarray(jm.router.mowner)
    modist = np.asarray(jm.router.modist, np.float64)
    nb_dist = np.asarray(jm.nb_dist, np.float64)
    p, cap = jm.route_probes, jm.route_cap
    q = np.asarray(q, np.float64)
    out = np.zeros(q.shape[0], bool)
    for i, qi in enumerate(q):
        dg = np.linalg.norm(qi - gc, axis=1)
        srt = np.sort(dg)
        margins = [(srt[p] - srt[p - 1]) / srt[p]] if len(srt) > p else []
        gi = np.argsort(dg, kind="stable")[:p]
        cand = members[gi].ravel()
        lb = np.maximum(np.abs(dg[gi][:, None] - mdist[gi]).ravel(),
                        dg[mowner[gi]].ravel() - modist[gi].ravel())
        dist = np.linalg.norm(qi - c[cand], axis=1)
        anchors = np.arange(p) * cap
        u_anchor = dist[anchors].min()
        rest = np.setdiff1d(np.arange(len(cand)), anchors)
        margins.append(np.min(np.abs(lb[rest] - u_anchor)) / u_anchor)
        passing = lb < u_anchor
        passing[anchors] = True
        d_pass = np.unique(dist[passing])
        if len(d_pass) > 1:
            margins.append((d_pass[1] - d_pass[0]) / d_pass[1])
        u = d_pass[0]
        routed = cand[passing][np.argmin(dist[passing])]
        margins.append(np.min(np.abs(nb_dist[routed] - 2 * u)) / (2 * u))
        out[i] = min(margins) <= tol
    return out


@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_predict_matches_reference(fitted, prec):
    _, q, _, jm, pm = fitted
    cj, ct = JaxCounter(), OpCounter()
    a_j, d_j = (np.asarray(v) for v in jm.predict(
        jnp.asarray(q), counter=cj, return_sqdist=True, precision=prec))
    a_t, d_t = pm.predict(torch.tensor(q), counter=ct, return_sqdist=True,
                          precision=prec)
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    assert_sq_close(d_t.numpy(), d_j, q, np.asarray(jm.centers), a_j)
    assert ct.int8_ops == cj.int8_ops
    # per-query charges of the one batch
    _, _, r_j, n_j = jm._predict_batch(jnp.asarray(q), precision=prec)
    _, _, r_t, n_t = pm._predict_batch(torch.tensor(q), precision=prec)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    n_j, n_t = np.asarray(n_j), n_t.numpy()
    assert ct.distances == n_t.sum() and cj.distances == n_j.sum()
    differ = n_j != n_t
    if prec == "int8":
        assert not differ.any()
        assert ct.bytes_scanned == cj.bytes_scanned
    else:
        assert ct.bytes_scanned == cj.bytes_scanned   # dense: no charge in it
        assert differ.mean() <= 0.01
        assert _near_boundary(jm, q[differ]).all(), np.flatnonzero(differ)


def test_int8_predict_equals_f32(fitted):
    """The §13 contract inside the port: identical assignments and
    distances, fewer f32 distances and scan bytes."""
    _, q, _, _, pm = fitted
    cf, ci = OpCounter(), OpCounter()
    a_f, d_f = pm.predict(q, counter=cf, return_sqdist=True)
    a_i, d_i = pm.predict(q, counter=ci, return_sqdist=True,
                          precision="int8")
    assert torch.equal(a_f, a_i) and torch.equal(d_f, d_i)
    assert ci.int8_ops > 0 and cf.int8_ops == 0
    assert ci.distances < cf.distances
    assert ci.bytes_scanned < cf.bytes_scanned
    assert ci.profile()["int8_ops"] == ci.int8_ops


def test_route_and_route_batch_match_reference(fitted):
    _, q, _, jm, pm = fitted
    np.testing.assert_array_equal(pm.route(q).numpy(),
                                  np.asarray(jm.route(jnp.asarray(q))))
    for prec in ("f32", "int8"):
        for probes in (None, 1):
            r_j, u_j, n_j = (np.asarray(v) for v in jm.route_batch(
                jnp.asarray(q), probes=probes, precision=prec))
            r_t, u_t, n_t = pm.route_batch(q, probes=probes, precision=prec)
            np.testing.assert_array_equal(r_t.numpy(), r_j)
            np.testing.assert_allclose(u_t.numpy(), u_j, rtol=1e-5,
                                       atol=1e-5)
            differ = n_t.numpy() != n_j
            assert differ.mean() <= 0.01, (prec, probes)
            if probes is None:
                assert _near_boundary(jm, q[differ]).all(), (prec, probes)


def test_router_and_graph_from_the_same_centers(fitted):
    """The port's own router and graph over the reference's centers. The
    router's member order may differ only between members whose scores
    tie within f32 noise (a two-member group's centroid is equidistant
    from both)."""
    _, _, _, jm, _ = fitted
    c = np.asarray(jm.centers)
    g, cap = jm.route_groups, jm.route_cap
    rt = _build_router(torch.tensor(c), g, cap, 8)
    rj = jax_build_router(jnp.asarray(c), g, cap, 8)
    np.testing.assert_allclose(rt.gc.numpy(), np.asarray(rj.gc), rtol=1e-6,
                               atol=1e-6)
    m_t, m_j = rt.members.numpy(), np.asarray(rj.members)
    assert all(set(a) == set(b) for a, b in zip(m_t, m_j))
    dgc = np.linalg.norm(np.asarray(rj.gc, np.float64)[:, None]
                         - c.astype(np.float64)[None], axis=2)
    owner = np.argmin(dgc, axis=0)
    score = np.where(owner[None, :] == np.arange(g)[:, None], 0.0, 1e9) + dgc
    s_t = np.take_along_axis(score, m_t, 1)
    assert (np.diff(s_t, axis=1) >= -1e-5 * s_t[:, 1:]).all()
    # per (group, member): owners equal; distances are square roots of
    # expanded squared distances, held as squares to rtol 1e-5 with atol
    # 1e-5 max|c|^2 (a one-member group's centroid is its member: the
    # expansion leaves f32 noise where the distance is 0)
    cmax = float(np.max(np.sum(c * c, 1)))
    for field, power in (("mdist", 2), ("mowner", 1), ("modist", 2)):
        vt = {(gg, m): v for gg in range(g)
              for m, v in zip(m_t[gg], getattr(rt, field).numpy()[gg])}
        vj = {(gg, m): v for gg in range(g)
              for m, v in zip(m_j[gg], np.asarray(getattr(rj, field))[gg])}
        keys = sorted(vt)
        got = np.array([vt[k] for k in keys], np.float64) ** power
        want = np.array([vj[k] for k in keys], np.float64) ** power
        if field == "mowner":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * cmax)
    nb_t, nbd_t = _graph_with_dists(torch.tensor(c), 8)
    nb_j, nbd_j = jax_graph(jnp.asarray(c), 8)
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    np.testing.assert_allclose(nbd_t.numpy() ** 2, np.asarray(nbd_j) ** 2,
                               rtol=1e-5, atol=1e-5 * cmax)


def test_from_result_arena_bit_equal(fitted):
    x, _, res, jm, _ = fitted
    pm = KMeansModel.from_result(_port_result(res), x, kn=8, device="cpu")
    jm0 = JaxModel.from_result(res, jnp.asarray(x), kn=8)
    assert (pm.bn, pm.capacity, pm.n_rows) == (jm0.bn, jm0.capacity,
                                                jm0.n_rows)
    for f in ARENA:
        got, want = getattr(pm.state, f).numpy(), np.asarray(
            getattr(jm0.state, f))
        assert got.shape == want.shape and (got == want).all(), f
    for f in ("x_pts", "a_pts", "w_pts"):
        assert (getattr(pm, f).numpy() == np.asarray(getattr(jm0, f))).all()
    np.testing.assert_array_equal(pm.assignment().numpy(),
                                  np.asarray(jm0.assignment()))


def test_fit_return_model_shapes(fitted):
    """As test_model_predict's: the port's fit(return_model=True)."""
    x = fitted[0]
    res, model = fit(x, 48, kn=8, max_iters=25, device="cpu",
                     return_model=True)
    k, d = res.centers.shape
    assert model.k == k and model.d == d
    assert model.neighbors.shape == (k, model.kn)
    assert model.capacity == 2 * x.shape[0]
    assert model.n_rows == x.shape[0]
    counts = np.bincount(res.assignment.numpy(), minlength=k)
    np.testing.assert_array_equal(model.counts.numpy(), counts)
    check_layout(model.state.pid, model.state.b2c, model.state.fill,
                 model.state.openb, model.a_pts, model.bn)
    assert float(model.state.wg.sum()) == x.shape[0]
    _, small = fit(x, 48, kn=8, max_iters=2, device="cpu",
                   return_model=True, model_capacity=5000)
    assert small.capacity == 5000


def test_predict_only_model(fitted):
    """from_result without x: no arena, the same predictions as the
    model with one (same centers, same router), recall@1 >= 0.99."""
    x, q, res, _, _ = fitted
    pr = _port_result(res)
    bare = KMeansModel.from_result(pr, kn=8, device="cpu")
    full = KMeansModel.from_result(pr, x, kn=8, device="cpu")
    assert not bare.has_arena and full.has_arena and bare.n_rows == 0
    a = bare.predict(q)
    assert torch.equal(a, full.predict(q))
    a_true = np.asarray(chunked_argmin_sqdist(jnp.asarray(q),
                                              jnp.asarray(pr.centers))[0])
    assert (a.numpy() == a_true).mean() >= 0.99
    np.testing.assert_array_equal(bare.counts.numpy(),
                                  full.counts.numpy())


@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_predict_batching_invariant(fitted, prec):
    _, q, _, _, pm = fitted
    c1, c2 = OpCounter(), OpCounter()
    a1, d1 = pm.predict(q, counter=c1, return_sqdist=True, precision=prec)
    a2, d2 = pm.predict(q, batch_size=700, counter=c2, return_sqdist=True,
                        precision=prec)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    assert c1.profile() | {"wall_s": 0} == c2.profile() | {"wall_s": 0}


def test_predict_low_precision_queries_upcast_once(fitted):
    _, q, _, _, pm = fitted
    for dt in (torch.bfloat16, torch.float16):
        q_low = torch.tensor(q).to(dt)
        assert torch.equal(pm.predict(q_low), pm.predict(q_low.float()))
    with pytest.raises(TypeError, match="floating"):
        pm.predict(torch.zeros((4, pm.d), dtype=torch.int32))


def test_predict_validate_modes(fitted):
    _, q, _, jm, pm = fitted
    bad = q[:64].copy()
    bad[[3, 17]] = np.nan
    with pytest.raises(ValueError, match=r"2 non-finite rows \(first at "
                                         r"\[3, 17\]\)"):
        pm.predict(bad)
    got = pm.predict(bad, validate="sanitize")
    zeroed = bad.copy()
    zeroed[[3, 17]] = 0.0
    assert torch.equal(got, pm.predict(zeroed))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jm.predict(jnp.asarray(bad),
                                           validate="sanitize")))
    assert pm.predict(q[:64], validate="none").shape == (64,)
    with pytest.raises(ValueError, match="validate"):
        pm.predict(q[:4], validate="strict")
    with pytest.raises(ValueError, match="precision"):
        pm.predict(q[:4], precision="fp8")
    assert pm.predict(q[:0]).shape == (0,)
