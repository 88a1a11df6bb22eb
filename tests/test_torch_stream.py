"""The port's streaming served model (``KMeansModel.partial_fit``, sliding
windows, decay, the drift guard and its repair, warm-start stream
bounds) against the JAX reference, on the CPU.

Both packages start from one model: the reference's, built by its own
``fit``/``from_result`` with the Pallas resolution in interpret mode,
carried across with ``convert.model_from_reference``; both then take the
same numpy batches. The scenarios are ``tests/test_model_predict.py``'s
partial-fit tests and ``tests/test_streaming.py``'s.

Tolerances, held after every batch:
- assignments, the arena (``ARENA``: slot arrays, sums, counts, centers,
  graph), the mirrors (``x_pts``, ``a_pts``, ``w_pts``, ``e_pts``) and the
  clocks and counters are equal, bit for bit, at decay 1 and below (the
  fold adds each cluster's rows onto its decayed sums in row order, as
  XLA's folded scatter-add does). Where a sliding window evicts at decay
  < 1, ``decay^age`` may differ from the reference's ``jnp.power`` in the
  last bit (ROADMAP §3 entry 11), and the subtraction of a decayed sum
  from one of its size keeps that difference at the operands' size;
  there each sum is held to 16 f32 ulps of its row's largest |sum|, each
  count to 16 ulps of the largest count, each center to 1e-5 of its
  row's largest |c| (``assert_stats_close``). Once a drift repair has
  re-seated centers (the split centers within rtol 1e-5: K3's f64 sums
  against the reference's f32 cumsum; a frozen center's sums re-anchor
  on them and then lose evicted rows of the field's size) every field is
  held to 1e-5 of its largest magnitude. Observed: without a repair
  every field equal (0 ulps), evictions at decay < 1 included; after the
  drift test's repairs sums within 2.1e-7 of the largest |sum|, centers
  within 6.7e-6 of the largest |c|, counts equal;
- the router after a refresh (``assert_router_close``): each group's
  member set and owners equal, the order up to members whose f64 scores
  tie within f32 noise (ROADMAP §3 entry 3); centroids to rtol 1e-5
  with atol 1e-5 of the largest center norm; member distances and
  ``nb_dist`` (square roots of differently rounded squares, the
  reference's zero distances f32 noise) as squares to rtol 1e-5 with
  atol 1e-5 of the largest squared center norm, as in
  ``test_torch_predict.py``;
- ``c_motion``, the sum of square roots of correctly rounded squared
  norms (the reference's are f32 sums), to rtol 1e-5, atol 1e-6;
- ``OpCounter`` lanes equal, except the f32 distance charge, held to
  ROADMAP §3 entry 3's rule. Each batch's charge is the sum of its live
  rows' route and resolution charges taken before the fold (plus the
  graph and router build at a refresh), in both packages. The port's
  rows, routed over the reference's router and graph distances, charge
  what the reference's charge except where a routing or Elkan
  comparison lies within 1e-6 relative of its boundary
  (``test_torch_predict._near_boundary``; a center that is its own
  group's centroid puts its bound exactly on the anchor distance) or
  the row sits on a center, where the reference's f32 distance is noise
  of the expansion (0.03125 for a distance 0 at |q|^2 = 12800, and it
  changes with the batch's size: ``_on_a_center``). Over
  its own router, whose tied members may come in another order, a row
  that probes such a group may name another anchor and charge another
  count: on ``test_streaming``'s integer blobs up to 84% of a batch's
  rows and 25% of its charge after a refresh, which this rule does not
  cover.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import fit as jax_fit
from repro.core.model import KMeansModel as JaxModel
from repro.data import gmm_blobs
from repro.ft.invariants import resident_violations as jax_violations
from repro.ft.invariants import streaming_violations as jax_stream_vio
from repro.kernels.ops import bounded_predict_assign_top2 as jax_top2
from repro_torch.convert import model_from_reference
from repro_torch.core import OpCounter, Router, gdi
from repro_torch.core.engine import decay_pow, decay_pow_f32, f32
from repro_torch.ft.invariants import (repair_dying_centers,
                                       resident_violations,
                                       streaming_violations)
from repro_torch.kernels.ops import bounded_predict_assign_top2

from test_resident_layout import check_layout
from test_torch_predict import ARENA, _near_boundary

KEY = jax.random.PRNGKey(0)
SKEY = jax.random.PRNGKey(7)
MIRRORS = ("x_pts", "a_pts", "w_pts", "e_pts")
CLOCKS = ("n_rows", "rows_streamed", "batches_seen", "evicted_rows",
          "repaired_centers", "degraded_folds")
LANES = ("inner_products", "additions", "sort_equivalents", "int8_ops",
         "bytes_gathered", "bytes_scattered", "bytes_sorted",
         "bytes_scanned", "sanitized_rows", "evicted_rows",
         "degraded_folds")


def _pallas(jm):
    return dataclasses.replace(jm, backend="pallas", interpret=True)


def _pair(jm):
    jm = _pallas(jm)
    return jm, model_from_reference(jm, device="cpu")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _scores(router, c):
    """f64 ranking scores of each group's members (the router's bands)."""
    gc = _np(router.gc).astype(np.float64)
    dgc = np.linalg.norm(gc[:, None] - _np(c).astype(np.float64)[None],
                         axis=2)
    owner = np.argmin(dgc, axis=0)
    g = gc.shape[0]
    own = owner[None, :] == np.arange(g)[:, None]
    return np.where(own, 0.0, 1e9) + dgc


def assert_router_close(pr, jr, c, fresh, context=""):
    """The port's router against the reference's; ``fresh``: both were
    just built from the centers ``c``, so where their member orders
    differ, the order is checked against ``c`` (as
    ``test_torch_predict.test_router_and_graph_from_the_same_centers``):
    each group's member set and each member's owner equal; where the
    orders differ the port's ranks by the f64 score up to f32 noise
    (members whose scores tie may come in another order); tolerances in
    the module doc."""
    c64 = _np(c).astype(np.float64)
    cmax = float(np.sqrt(np.max(np.sum(c64 * c64, 1)))) if c64.size else 0.
    np.testing.assert_allclose(_np(pr.gc), _np(jr.gc), rtol=1e-5,
                               atol=1e-5 * cmax, err_msg=context)
    m_t, m_j = _np(pr.members), _np(jr.members)
    assert all(set(a) == set(b) for a, b in zip(m_t, m_j)), context
    rows = (m_t != m_j).any(1)
    if rows.any() and fresh:
        s_t = np.take_along_axis(_scores(jr, c), m_t, 1)[rows]
        assert (np.diff(s_t, axis=1) >= -1e-5 * (s_t[:, 1:] + cmax)).all(), \
            context
    for f in ("mdist", "mowner", "modist"):
        vt = {(g, m): v for g in range(len(m_t))
              for m, v in zip(m_t[g], _np(getattr(pr, f))[g])}
        vj = {(g, m): v for g in range(len(m_j))
              for m, v in zip(m_j[g], _np(getattr(jr, f))[g])}
        keys = sorted(vt)
        got = np.array([vt[k] for k in keys], np.float64)
        want = np.array([vj[k] for k in keys], np.float64)
        if f == "mowner":
            assert (got == want).all(), context
        else:     # as squares: the reference's zero distances are noise
            np.testing.assert_allclose(got ** 2, want ** 2, rtol=1e-5,
                                       atol=1e-5 * cmax ** 2,
                                       err_msg=context)


def assert_stats_close(got, want, field, context="", split=False):
    """Decayed statistics after evictions at decay < 1 (module doc): each
    sum within 16 f32 ulps of its row's largest |sum|, each count within
    16 ulps of the largest count, each center within 1e-5 of its row's
    largest |c| (a center is a quotient of the two). ``split``: a drift
    repair has re-seated centers, whose split centers differ within
    rtol 1e-5 (``test_projective_split_with_reference_draws``), and frozen
    sums re-anchor on them: every field within 1e-5 of its largest
    magnitude."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    if field == "counts":
        scale = np.full_like(want, np.max(np.abs(want)))
        unit = 16 * 2.0 ** -24
    else:
        scale = np.max(np.abs(want), axis=1, keepdims=True) + 0 * want
        unit = 16 * 2.0 ** -24 if field == "sums" else 1e-5
    if split:
        scale = np.full_like(want, np.max(np.abs(want)))
        unit = 1e-5
    err = np.abs(got - want) / np.maximum(scale * unit, 1e-30)
    err = np.where(got == want, 0.0, err)
    assert (err <= 1.0).all(), (context, field, float(err.max()))


def assert_same_model(jm, pm, *, stats_close=False, context=""):
    """The port's model against the reference's (module doc)."""
    for f in ARENA:
        got, want = _np(getattr(pm.state, f)), _np(getattr(jm.state, f))
        assert got.shape == want.shape, (context, f)
        if stats_close and f in ("sums", "counts", "c"):
            assert_stats_close(got, want, f, context,
                               split=pm.repaired_centers > 0)
        else:
            assert (got == want).all(), (context, f)
    for f in MIRRORS:
        assert (_np(getattr(pm, f)) == _np(getattr(jm, f))).all(), \
            (context, f)
    for f in CLOCKS:
        assert getattr(pm, f) == getattr(jm, f), (context, f)
    assert_router_close(pm.router, jm.router, jm.state.c,
                        pm.batches_seen % pm.refresh_every == 0, context)
    c = _np(jm.state.c).astype(np.float64)
    cmax = float(np.sqrt(np.max(np.sum(c * c, 1)))) if c.size else 0.0
    np.testing.assert_allclose(_np(pm.nb_dist).astype(np.float64) ** 2,
                               _np(jm.nb_dist).astype(np.float64) ** 2,
                               rtol=1e-5, atol=1e-5 * cmax ** 2)
    np.testing.assert_allclose(_np(pm.c_motion), _np(jm.c_motion),
                               rtol=1e-5, atol=1e-6)


def _on_a_center(jm, q):
    """Per query: whether it sits on a center within the f32 expansion's
    noise (|q - c|^2 <= 1e-6 (|q|^2 + |c|^2)), where the reference's
    distances, and so its bound comparisons, are that noise."""
    c = _np(jm.state.c).astype(np.float64)
    q = np.asarray(q, np.float64)
    d2 = ((q[:, None] - c[None]) ** 2).sum(-1)
    terms = (q * q).sum(1)[:, None] + (c * c).sum(1)[None]
    return (d2 <= 1e-6 * terms).any(1)


def fold_both(jm, pm, xb, w=None, *, stats_close=False, context="", **kw):
    """One ``partial_fit`` of both models on ``xb``; asserts the batch's
    assignments, the models and the charges (module doc)."""
    xb = np.asarray(xb, np.float32)
    live = np.ones(len(xb), bool) if w is None else np.asarray(w) > 0
    finite = np.isfinite(xb).all(1)
    if kw.get("validate") == "sanitize":
        live &= finite
    xs = np.where(finite[:, None], xb, 0.0)
    _, _, _, n_j = jm._predict_batch(jnp.asarray(xs))
    _, _, _, n_t = pm._predict_batch(torch.tensor(xs))
    # the port's route over the reference's router and graph distances
    on_ref = dataclasses.replace(
        pm, router=Router(*(torch.tensor(np.asarray(v)) for v in jm.router)),
        nb_dist=torch.tensor(np.asarray(jm.nb_dist)))
    _, _, _, n_x = on_ref._predict_batch(torch.tensor(xs))
    n_j, n_t, n_x = np.asarray(n_j)[live], n_t.numpy()[live], n_x.numpy()[
        live]
    differ = n_j != n_x
    if differ.any():
        rows = xs[live][differ]
        assert (_near_boundary(jm, rows) | _on_a_center(jm, rows)).all(), \
            context
    cj, ct = JaxCounter(), OpCounter()
    wj = None if w is None else jnp.asarray(w, jnp.float32)
    a_j = np.asarray(jm.partial_fit(jnp.asarray(xb), wj, counter=cj, **kw))
    a_t = pm.partial_fit(xb, w, counter=ct, **kw).numpy()
    assert (a_t == a_j).all(), (context, np.flatnonzero(a_t != a_j))
    assert_same_model(jm, pm, stats_close=stats_close, context=context)
    for lane in LANES:
        assert getattr(ct, lane) == getattr(cj, lane), (context, lane)
    assert ct.repairs == cj.repairs, context
    assert cj.distances - ct.distances == n_j.sum() - n_t.sum(), context
    refresh = pm.k * pm.k + (pm.router_iters + 1) * pm.route_groups * pm.k \
        if pm.batches_seen % pm.refresh_every == 0 else 0
    if "stream" not in kw:
        assert ct.distances == n_t.sum() + refresh, context
    return a_t, ct


# -- test_model_predict.py's partial-fit scenarios -------------------------

@pytest.mark.parametrize("bn", [None, 16], ids=["bn_auto", "bn16"])
def test_partial_fit_sparse_repairs_resorts_and_full_arena(bn):
    """Capacity 2300 (test_model_predict's): the layout stays valid after
    every batch and the full arena refuses the next batch in both. At the
    default block size (128) every append is a sparse repair; at bn=16
    the free pool runs out every other batch, so re-sorts alternate with
    repairs."""
    allx = gmm_blobs(jax.random.PRNGKey(1), 1200 + 1000, 12, true_k=16)
    x, stream = allx[:1200], np.asarray(allx[1200:])
    res = jax_fit(x, 16, kn=6, max_iters=15, key=KEY)
    jm, pm = _pair(JaxModel.from_result(res, x, kn=6, capacity=2300, bn=bn))
    resorted = []
    for i in range(10):
        _, ct = fold_both(jm, pm, stream[i * 100:(i + 1) * 100],
                          context=f"b{i}")
        resorted.append(ct.bytes_sorted > 0)
        check_layout(pm.state.pid, pm.state.b2c, pm.state.fill,
                     pm.state.openb, pm.a_pts, pm.bn, context=f"batch {i}")
        assert pm.n_rows == 1200 + (i + 1) * 100
    assert float(pm.state.wg.sum()) == pm.n_rows
    assert resorted == ([False] * 10 if bn is None else [False, True] * 5)
    with pytest.raises(ValueError, match="arena full"):
        jm.partial_fit(jnp.asarray(stream[:200]))
    with pytest.raises(ValueError, match="arena full"):
        pm.partial_fit(stream[:200])


def test_partial_fit_running_means():
    x = np.asarray(gmm_blobs(jax.random.PRNGKey(2), 800, 8, true_k=8))
    _, jm = jax_fit(jnp.asarray(x[:600]), 8, kn=4, max_iters=10, key=KEY,
                    return_model=True)
    jm, pm = _pair(jm)
    a1, _ = fold_both(jm, pm, x[600:700])
    a2, _ = fold_both(jm, pm, x[700:])
    a_all = np.concatenate([pm.assignment()[:600].numpy(), a1, a2])
    counts = np.bincount(a_all, minlength=pm.k)
    np.testing.assert_array_equal(pm.counts.numpy(), counts)


def test_partial_fit_drifting_distribution_decay():
    """Decay 0.8, graph refresh every 2 batches, one abrupt shift."""
    k, d = 6, 8
    mus = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (k, d))) * 4.0

    def draw(seed, m, shift):
        key = jax.random.PRNGKey(seed)
        comp = np.asarray(jax.random.randint(key, (m,), 0, k))
        noise = 0.3 * np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                                   (m, d)))
        return (mus[comp] + shift + noise).astype(np.float32)

    _, jm = jax_fit(jnp.asarray(draw(10, 900, 0.0)), k, init="kmeanspp",
                    kn=4, max_iters=20, key=KEY, return_model=True,
                    model_capacity=6000)
    jm = dataclasses.replace(jm, decay=0.8, refresh_every=2)
    jm, pm = _pair(jm)
    target = mus + 3.0

    def err():
        c = pm.centers.numpy()
        return float(np.sqrt(((c[:, None] - target[None]) ** 2).sum(-1))
                     .min(0).mean())
    errs = [err()]
    for i in range(12):
        fold_both(jm, pm, draw(20 + i, 256, 3.0), context=f"b{i}")
        if (i + 1) % 4 == 0:
            errs.append(err())
    assert all(e2 < e1 for e1, e2 in zip(errs, errs[1:])), errs
    assert errs[-1] < 0.25 * errs[0], errs


def test_partial_fit_degrade_and_padding_rows():
    """``on_full="degrade"`` folds the stats and drops the rows; weight-0
    padding rows take no id, no room and no charge."""
    x = np.asarray(gmm_blobs(jax.random.PRNGKey(4), 700, 8, true_k=8))
    res = jax_fit(jnp.asarray(x[:400]), 8, kn=4, max_iters=10, key=KEY)
    jm, pm = _pair(JaxModel.from_result(res, jnp.asarray(x[:400]), kn=4,
                                        capacity=520))
    w = np.ones(100, np.float32)
    w[::3] = 0.0
    fold_both(jm, pm, x[400:500], w, context="padded")
    assert pm.n_rows == 400 + int((w > 0).sum())
    for i, lo in enumerate((500, 600)):
        fold_both(jm, pm, x[lo:lo + 100], on_full="degrade",
                  context=f"degrade {i}")
    assert pm.degraded_folds == jm.degraded_folds == 2
    with pytest.raises(ValueError, match="on_full"):
        pm.partial_fit(x[:4], on_full="drop")


def test_partial_fit_validate_modes():
    x = np.asarray(gmm_blobs(jax.random.PRNGKey(5), 600, 8, true_k=8))
    _, jm = jax_fit(jnp.asarray(x[:400]), 8, kn=4, max_iters=10, key=KEY,
                    return_model=True)
    jm, pm = _pair(jm)
    bad = x[400:464].copy()
    bad[[3, 17]] = np.nan
    with pytest.raises(ValueError, match=r"2 non-finite rows \(first at "
                                         r"\[3, 17\]\)"):
        pm.partial_fit(bad)
    with pytest.raises(ValueError, match="non-finite"):
        jm.partial_fit(jnp.asarray(bad))
    assert pm.batches_seen == 0
    fold_both(jm, pm, bad, validate="sanitize", context="sanitize")
    fold_both(jm, pm, x[464:500], validate="none", context="none")
    with pytest.raises(ValueError, match="validate"):
        pm.partial_fit(x[:4], validate="strict")
    with pytest.raises(ValueError, match="batch shape"):
        pm.partial_fit(x[:4, :3])


def test_partial_fit_predict_only_model():
    """No arena: the fold updates the stats only, as the reference's."""
    x = np.asarray(gmm_blobs(jax.random.PRNGKey(4), 600, 8, true_k=8))
    res = jax_fit(jnp.asarray(x), 8, kn=4, max_iters=10, key=KEY)
    jm, pm = _pair(JaxModel.from_result(res, kn=4))
    assert not pm.has_arena
    before = float(pm.counts.sum())
    fold_both(jm, pm, x[:50])
    assert float(pm.counts.sum()) == before + 50 and pm.n_rows == 0


# -- test_streaming.py's scenarios --------------------------------------------

def _windowed_model(n=256, d=8, k=8, cap=512, window=4, **kw):
    """test_streaming's: integer-valued blobs, so the folds are exact."""
    x = jnp.round(gmm_blobs(SKEY, n, d, true_k=k) * 4.0)
    res = jax_fit(x, k, kn=4, max_iters=10, key=SKEY, init="random")
    return _pair(JaxModel.from_result(res, x, kn=4, capacity=cap,
                                      window=window, **kw))


def _batches(seed, nb, bs, d, scale=4.0):
    ks = jax.random.split(jax.random.PRNGKey(seed), nb)
    return [np.asarray(jnp.round(jax.random.normal(kb, (bs, d)) * scale))
            for kb in ks]


def test_eviction_parity_bit_exact():
    """At decay 1 on integer data the port's statistics after the window
    slid equal a fold of the surviving rows (and the reference's)."""
    d, k = 8, 8
    base = np.random.default_rng(0).integers(-8, 8, size=(k, d)).astype(
        np.float32)
    x = jnp.asarray(np.repeat(base, 32, axis=0))
    res = jax_fit(x, k, kn=4, max_iters=10, key=SKEY, init="kmeanspp")
    jm, pm = _pair(JaxModel.from_result(res, x, kn=4, capacity=512,
                                        window=4))
    for i, xb in enumerate(_batches(1, 10, 32, d)):
        fold_both(jm, pm, xb, context=f"b{i}")
    assert pm.evicted_rows > 0 and pm.live_rows() == 4 * 32
    live = pm.w_pts.numpy() > 0
    a, xs = pm.a_pts.numpy(), pm.x_pts.numpy()
    sums_ref = np.zeros((k, d), np.float32)
    np.add.at(sums_ref, a[live], xs[live])
    assert (pm.counts.numpy() == np.bincount(a[live], minlength=k)).all()
    assert (pm.sums.numpy() == sums_ref).all()


@pytest.mark.parametrize("kw,seed", [
    (dict(count_floor=0.5), 2),
    (dict(half_life=4.0, count_floor=0.1), 6),
], ids=["floor", "half_life"])
def test_streaming_invariants_clean(kw, seed):
    """Windowed streaming at decay 1 and at a half-life (tolerances in
    the module doc): equal to the reference batch by batch, and the
    invariant counters clean and equal to the reference's."""
    jm, pm = _windowed_model(**kw)
    stats_close = pm.stream_decay < 1
    for i, xb in enumerate(_batches(seed, 12, 32, pm.d)):
        fold_both(jm, pm, xb, stats_close=stats_close, context=f"b{i}")
    v = resident_violations(pm.state, n=pm.capacity, owned=pm.w_pts > 0)
    v_j = jax_violations(jm.state, n=jm.capacity, owned=jm.w_pts > 0)
    assert v.tolist() == np.asarray(v_j).tolist() == [0, 0, 0, 0]
    sv = streaming_violations(pm.state, pm.e_pts, pm.w_pts,
                              pm.batches_seen - 1, pm.count_floor,
                              window=pm.window)
    sv_j = jax_stream_vio(jm.state, jm.e_pts, jm.w_pts,
                          jnp.int32(jm.batches_seen - 1),
                          jnp.float32(jm.count_floor), window=jm.window)
    assert sv.tolist() == np.asarray(sv_j).tolist() == [0, 0, 0]


def test_invariant_counters_see_faults():
    """The counters are not blind: a doubled slot, a stale live slot and
    a count under the floor each show on their lane."""
    jm, pm = _windowed_model(count_floor=0.5)
    for xb in _batches(2, 6, 32, pm.d):
        pm.partial_fit(xb)
    st = pm.state
    live = torch.nonzero((st.pid >= 0) & (st.wg > 0)).flatten()
    pid = st.pid.clone()
    pid[live[1]] = pid[live[0]]
    v = resident_violations(st._replace(pid=pid), n=pm.capacity)
    assert v[3] > 0 and v[:3].tolist() == [0, 0, 0]
    e = pm.e_pts.clone()
    e[st.pid[live[0]].long()] = 0
    sv = streaming_violations(st, e, pm.w_pts, pm.batches_seen - 1,
                              pm.count_floor, window=pm.window)
    assert sv[0] == 1
    sv = streaming_violations(st._replace(counts=st.counts * 0), pm.e_pts,
                              pm.w_pts, pm.batches_seen - 1, pm.count_floor,
                              window=pm.window)
    assert sv[2] == pm.k


def test_half_life_decay_and_floor():
    """half_life sets the decay 2^(-1/half_life); starved counts freeze at
    the floor; arena-full batches degrade. Equal to the reference."""
    jm, pm = _windowed_model(window=0, half_life=2.0, count_floor=0.25)
    assert pm.stream_decay == jm.stream_decay == pytest.approx(2.0 ** -0.5)
    far = np.full((16, pm.d), 40.0, np.float32)
    for i in range(30):
        fold_both(jm, pm, far, on_full="degrade", context=f"b{i}")
    counts = pm.counts.numpy()
    assert np.isfinite(pm.centers.numpy()).all()
    assert (counts >= pm.count_floor - 1e-6).all()
    assert counts.min() == pytest.approx(pm.count_floor)


def test_decay_pow_fixed_form():
    """decay^age by binary exponentiation in f64: exact powers of 2 and
    of 1, within 1 f32 ulp of jnp.power, and one f64 form for both
    callers (module doc of core.model)."""
    age = torch.arange(200)
    ones = torch.ones(200, dtype=torch.float64)
    assert torch.equal(decay_pow(1.0, age, 199), ones)
    assert torch.equal(decay_pow(0.5, age, 199),
                       torch.tensor([0.5 ** a for a in range(200)],
                                    dtype=torch.float64))
    differ = 0
    for hl in (2.0, 3.0, 4.0, 8.0, 0.7, 16.0, 5.5):
        dec = f32(2.0 ** (-1.0 / hl))
        got = decay_pow(dec, age, 199).float().numpy()
        want = np.asarray(jnp.power(jnp.float32(dec),
                                    jnp.arange(200, dtype=jnp.float32)))
        normal = want >= np.finfo(np.float32).tiny
        np.testing.assert_array_max_ulp(got[normal], want[normal], maxulp=1)
        assert (got[~normal] <= np.finfo(np.float32).tiny).all()
        differ += int((got != want)[normal].sum())
    assert differ < 100          # a few last-bit differences (entry 11)


def test_decay_pow_f32_flushes_subnormals_as_the_reference():
    """ROADMAP §3 entry 11's 1,400 pairs (half-lives {2, 3, 4, 8, 0.7, 16,
    5.5}, ages 0-199) against the reference's f32 ``jnp.power``: with the
    subnormal results flushed to zero, one pair is left apart, the
    last-bit case at half-life 16, age 172."""
    age = torch.arange(200)
    differ = []
    for hl in (2.0, 3.0, 4.0, 8.0, 0.7, 16.0, 5.5):
        dec = f32(2.0 ** (-1.0 / hl))
        got = decay_pow_f32(dec, age, 199).numpy()
        want = np.asarray(jnp.power(jnp.float32(dec),
                                    jnp.arange(200, dtype=jnp.float32)))
        assert got.dtype == np.float32
        assert not (got[got != 0] < np.finfo(np.float32).tiny).any()
        differ += [(hl, int(a)) for a in np.flatnonzero(got != want)]
    assert differ == [(16.0, 172)]
    got = float(decay_pow_f32(f32(2.0 ** (-1.0 / 16.0)), age, 199)[172])
    assert got == pytest.approx(0.000580667, rel=1e-6)


def _draw_recorder(monkeypatch):
    """Record the reference's projective_split draws (the two member ids
    its ``jax.random.choice`` calls give) and hand them to the port's
    ``gdi._split_draws`` in the same order, checking each call's mask."""
    import repro.core.gdi as jgdi
    real = jgdi.projective_split
    calls = []

    @jax.jit
    def ref_draws(mask, key):
        n = mask.shape[0]
        fmask = mask.astype(jnp.float32)
        p = fmask / jnp.maximum(jnp.sum(fmask), 1.0)
        k1, k2 = jax.random.split(key)
        i_a = jax.random.choice(k1, n, p=p)
        p2 = p.at[i_a].set(0.0)
        p2 = p2 / jnp.maximum(jnp.sum(p2), 1e-30)
        return i_a, jax.random.choice(k2, n, p=p2)

    def recording(x, mask, key, iters=2):
        i_a, i_b = ref_draws(mask, key)
        calls.append((np.asarray(mask), int(i_a), int(i_b)))
        return real(x, mask, key, iters)
    monkeypatch.setattr(jgdi, "projective_split", recording)
    used = []

    def replay(mask, generator):
        want, i_a, i_b = calls[len(used)]
        assert (mask.numpy() == want).all()
        used.append(1)
        return torch.tensor([i_a]), torch.tensor([i_b])
    monkeypatch.setattr(gdi, "_split_draws", replay)
    return calls, used


def test_drift_guard_repairs_with_reference_draws(monkeypatch):
    """test_streaming's sustained drift: the guard flags the same
    centers, each repair splits with the reference's draws, and the
    repaired clustering equals the reference's (equal repaired_centers,
    assignments, arena; half-life 8: tolerances in the module doc)."""
    calls, used = _draw_recorder(monkeypatch)
    jm, pm = _windowed_model(window=6, drift_guard=True, count_floor=0.25,
                             half_life=8.0, cap=1024)
    shift = np.linspace(0.0, 30.0, 40, dtype=np.float32)
    for i, xb in enumerate(_batches(3, 40, 32, pm.d)):
        fold_both(jm, pm, xb + shift[i], stats_close=True, on_full="degrade",
                  context=f"b{i}")
    assert pm.repaired_centers == jm.repaired_centers > 0
    assert len(used) == len(calls) == pm.repaired_centers
    v = resident_violations(pm.state, n=pm.capacity, owned=pm.w_pts > 0)
    assert v.tolist() == [0, 0, 0, 0]


def test_repair_dying_centers_direct(monkeypatch):
    """``repair_dying_centers`` on one state with chosen flags: the same
    centers re-seated, the same assignment and counts."""
    calls, used = _draw_recorder(monkeypatch)
    from repro.ft.invariants import repair_dying_centers as jax_repair
    jm, pm = _windowed_model(window=0, drift_guard=True, half_life=4.0)
    for i, xb in enumerate(_batches(12, 8, 32, pm.d)):
        fold_both(jm, pm, xb, context=f"b{i}")
    dying = np.zeros(pm.k, bool)
    dying[[1, 4]] = True
    cj, ct = JaxCounter(), OpCounter()
    n_j = jax_repair(jm, jnp.asarray(dying), counter=cj)
    n_t = repair_dying_centers(pm, torch.tensor(dying), counter=ct)
    assert n_t == n_j == 2 and ct.repairs == cj.repairs
    assert (pm.a_pts.numpy() == np.asarray(jm.a_pts)).all()
    np.testing.assert_array_max_ulp(pm.counts.numpy(),
                                    np.asarray(jm.counts), maxulp=4)
    np.testing.assert_allclose(pm.centers.numpy(), np.asarray(jm.centers),
                               rtol=1e-5, atol=1e-5)
    for f in ("pid", "b2c", "fill", "openb", "wg"):
        assert (getattr(pm.state, f).numpy()
                == np.asarray(getattr(jm.state, f))).all(), f


def test_projective_split_with_reference_draws(monkeypatch):
    """One Lemma-1 split of a masked subset: the same sides, centers
    within rtol 1e-5 (the port's running sums are K3's f64 order, the
    reference's an f32 cumsum) and energies within rtol 1e-4."""
    import repro.core.gdi as jgdi
    calls, used = _draw_recorder(monkeypatch)
    x = np.asarray(gmm_blobs(jax.random.PRNGKey(8), 700, 12, true_k=6))
    mask = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (700,))) < 0.6
    for seed in range(3):
        out_j = jgdi.projective_split(jnp.asarray(x), jnp.asarray(mask),
                                      jax.random.PRNGKey(seed))
        out_t = gdi.projective_split(torch.tensor(x), torch.tensor(mask))
        ma, mb = out_t[0].numpy(), out_t[1].numpy()
        assert (ma == np.asarray(out_j[0])).all()
        assert (mb == np.asarray(out_j[1])).all()
        assert not (ma & ~mask).any() and (ma | mb).sum() == mask.sum()
        for got, want, tol in zip(out_t[2:], out_j[2:], (1e-5, 1e-5, 1e-4,
                                                         1e-4)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=tol, atol=tol)
    assert len(used) == 3


def test_split_draws_stay_in_the_mask():
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 17, 40]] = True
    seen = set()
    for _ in range(200):
        i_a, i_b = gdi._split_draws(mask, g)
        assert int(i_a) != int(i_b)
        seen |= {int(i_a), int(i_b)}
    assert seen == {3, 17, 40}


def test_warm_start_stream_bounds():
    """A repeated batch on a named stream: the reference's assignments,
    1 counted distance a warm row; the cold call's charge equals the
    reference's cold charge under entry 3's rule."""
    jm, pm = _windowed_model()
    q = np.asarray(gmm_blobs(jax.random.PRNGKey(9), 64, pm.d, true_k=pm.k))
    out = {}
    for name, model, counter in (("j", jm, JaxCounter), ("t", pm,
                                                          OpCounter)):
        c_cold, c_warm = counter(), counter()
        a_cold = _np(model.predict(q, counter=c_cold, stream="s0"))
        a_warm = _np(model.predict(q, counter=c_warm, stream="s0"))
        out[name] = (a_cold, a_warm, c_cold.total, c_warm.total,
                     _np(model.predict(q)))
    (ac_j, aw_j, cc_j, cw_j, ar_j), (ac_t, aw_t, cc_t, cw_t, ar_t) = \
        out["j"], out["t"]
    assert (ac_t == ar_t).all() and (aw_t == ar_t).all()
    assert (ar_t == ar_j).all() and (aw_t == aw_j).all()
    assert cw_t == cw_j == q.shape[0] and cw_t < cc_t
    _, _, _, n_j = jm._predict_batch(jnp.asarray(q))
    _, _, _, n_t = pm._predict_batch(torch.tensor(q))
    assert cc_j - cc_t == int(np.asarray(n_j).sum() - n_t.numpy().sum())


def test_warm_bounds_survive_center_motion_and_fit_streams():
    """Folds move the centers; the stream bounds inflate by the motion
    clock, so warm predicts equal a cold predict. ``partial_fit(stream=)``
    matches the reference's."""
    jm, pm = _windowed_model()
    q = np.asarray(gmm_blobs(jax.random.PRNGKey(11), 64, pm.d, true_k=pm.k))
    jm.predict(jnp.asarray(q), stream="s1")
    pm.predict(q, stream="s1")
    for i, xb in enumerate(_batches(4, 3, 32, pm.d)):
        a_j = np.asarray(jm.partial_fit(jnp.asarray(xb), stream="f"))
        a_t = pm.partial_fit(xb, stream="f").numpy()
        assert (a_t == a_j).all()
        assert_same_model(jm, pm, context=f"b{i}")
    a_warm = pm.predict(q, stream="s1")
    assert torch.equal(a_warm, pm.predict(q))
    assert (a_warm.numpy() == np.asarray(jm.predict(jnp.asarray(q),
                                                    stream="s1"))).all()


def test_evicted_rows_counted_and_surfaced():
    jm, pm = _windowed_model()
    ct = OpCounter()
    for xb in _batches(9, 8, 32, pm.d):
        pm.partial_fit(xb, counter=ct)
    assert ct.evicted_rows == pm.evicted_rows > 0
    assert ct.profile()["evicted_rows"] == ct.evicted_rows
    assert ct.profile()["repairs"] == ct.repairs


def test_ring_clash_raises_or_degrades():
    """A window wider than the capacity holds: the recycled ring ids
    clash with live rows; "raise" refuses, "degrade" folds the stats."""
    jm, pm = _windowed_model(cap=300, window=8)
    batches = _batches(13, 3, 32, pm.d)
    for i, xb in enumerate(batches[:1]):
        fold_both(jm, pm, xb, context=f"b{i}")
    with pytest.raises(ValueError, match="ring full"):
        pm.partial_fit(batches[1])
    jm2, pm2 = _windowed_model(cap=300, window=8)
    for i, xb in enumerate(batches):
        fold_both(jm2, pm2, xb, on_full="degrade", context=f"d{i}")
    assert pm2.degraded_folds > 0


def test_bounded_predict_assign_top2_matches_reference():
    """K1 with its second output (plain version) against the reference's
    Pallas kernel in interpret mode: equal ids, distances to rtol 1e-6 of
    the expansion's terms."""
    from test_torch_quant import assert_sq_close
    x = np.asarray(gmm_blobs(jax.random.PRNGKey(12), 900, 16, true_k=12))
    res = jax_fit(jnp.asarray(x[:600]), 24, kn=6, max_iters=10, key=KEY)
    jm = _pallas(JaxModel.from_result(res, kn=6))
    q = x[600:]
    routed = jm.route(jnp.asarray(q))
    a_j, d1_j, d2_j = (np.asarray(v) for v in jax_top2(
        jnp.asarray(q), jm.centers, jm.neighbors, routed, bn=8,
        interpret=True))
    a_t, d1_t, d2_t = bounded_predict_assign_top2(
        torch.tensor(q), torch.tensor(np.asarray(jm.centers)),
        torch.tensor(np.asarray(jm.neighbors)),
        torch.tensor(np.asarray(routed)), bn=8)
    np.testing.assert_array_equal(a_t.numpy(), a_j)
    c = np.asarray(jm.centers)
    assert_sq_close(d1_t.numpy(), d1_j, q, c, a_j)
    nb = np.asarray(jm.neighbors)[np.asarray(routed)]
    second = np.argsort(((q[:, None] - c[nb]) ** 2).sum(-1), 1)[:, 1]
    assert_sq_close(d2_t.numpy(), d2_j, q, c, nb[np.arange(len(q)), second])
    assert (d2_t >= d1_t).all()


