"""The port's int8 scan stage (``repro_torch.kernels.quant``, K4's plain
version and the int8 predict ops) against the JAX reference, on the CPU.

Inputs are drawn once with numpy and handed to both packages; the
reference runs its Pallas kernels with ``interpret=True``. Tolerances:
int8 codes, scales, survivor columns, survivor counts, fallback flags and
assignments are equal. Float lanes that both packages compute by the same
elementwise formula from the same inputs are held to rtol 1e-6; sums the
two packages reduce in other orders (table norms, residual norms) to rtol
1e-6 as well. Squared distances from the norm expansion ``|q|^2 - 2 q.c +
|c|^2`` are held to rtol 1e-6 of the expanded terms ``|q|^2 + |c|^2``:
the port rounds the products once from f64, the reference sums in f32,
and the expansion cancels most of those terms' size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distance import chunked_candidate_argmin
from repro.kernels import quant as jq
from repro.kernels.candidate_assign import \
    candidate_assign_int8_tiled as jax_int8_tiled
from repro.kernels.candidate_assign import pad_candidates as jax_pad
from repro.kernels.ops import bounded_predict_assign_int8 as jax_bpa_int8
from repro.kernels.ops import group_by_cluster_device as jax_group
from repro.kernels.ops import quantized_scan_rerank as jax_scan_rerank
from repro_torch.kernels import quant
from repro_torch.kernels.candidate_assign import candidate_assign_int8_tiled
from repro_torch.kernels.ops import (bounded_predict_assign_int8,
                                     quantized_scan_rerank)
from repro_torch.kernels.ref import candidate_assign_int8_tiled_ref


def T(v, dtype=None):
    return torch.tensor(np.asarray(v), dtype=dtype)


def N(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def assert_sq_close(got, want, q, c, ids):
    """rtol 1e-6 of the expansion's terms |q|^2 + |c_id|^2 (module doc)."""
    q, c = np.asarray(q, np.float64), np.asarray(c, np.float64)
    ids = np.asarray(ids)
    terms = np.sum(q * q, -1).reshape(-1, *([1] * (ids.ndim - 1))) \
        + np.sum(c * c, -1)[np.maximum(ids, 0)]
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= 1e-6 * terms + 1e-6 * np.abs(want)).all(), \
        float(np.max(err / terms))


def _cq_np(cq):
    return jq.CenterQuant(*(np.asarray(v) for v in cq))


def _cq_port(cq):
    return quant.CenterQuant(*(T(v) for v in cq))


# -- quantization scheme -------------------------------------------------


@pytest.mark.parametrize("rows,d,seed", [(1, 1, 0), (17, 24, 2), (64, 5, 3),
                                         (40, 784, 4)])
def test_quantize_rows_bit_equal(rows, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 10.0 ** rng.uniform(-3, 2, (rows, 1))
         ).astype(np.float32)
    x[0] = 0.0                                   # the zero-row guard
    qj, sj = jq.quantize_rows(jnp.asarray(x))
    qt, st = quant.quantize_rows(T(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(N(qt), np.asarray(qj))
    np.testing.assert_array_equal(N(st), np.asarray(sj))
    np.testing.assert_array_equal(
        N(quant.dequantize_rows(qt, st)),
        np.asarray(jq.dequantize_rows(qj, sj)))
    np.testing.assert_array_equal(N(quant.quant_radius(st, d)),
                                  np.asarray(jq.quant_radius(sj, d)))


def test_quantize_tiles_bit_equal():
    x = np.random.RandomState(6).randn(12, 5).astype(np.float32)
    for got, want in zip(quant.quantize_tiles(T(x), 4),
                         jq.quantize_tiles(jnp.asarray(x), 4)):
        np.testing.assert_array_equal(N(got), np.asarray(want))


def test_center_quant_matches():
    c = (np.random.RandomState(7).randn(48, 16) * 3).astype(np.float32)
    got, want = quant.center_quant(T(c)), jq.center_quant(jnp.asarray(c))
    np.testing.assert_array_equal(N(got.q), np.asarray(want.q))
    np.testing.assert_array_equal(N(got.scale), np.asarray(want.scale))
    np.testing.assert_allclose(N(got.sq), np.asarray(want.sq), rtol=1e-6)
    np.testing.assert_allclose(N(got.err), np.asarray(want.err), rtol=1e-6)


def test_quantized_candidate_slabs_bit_equal():
    rng = np.random.RandomState(8)
    c = rng.randn(24, 16).astype(np.float32)
    cq = jq.center_quant(jnp.asarray(c))
    cidx = jax_pad(jnp.asarray(rng.randint(0, 24, (24, 6)).astype(np.int32)),
                   4)
    got = quant.quantized_candidate_slabs(_cq_port(_cq_np(cq)), T(cidx))
    want = jq.quantized_candidate_slabs(cq, cidx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(N(g), np.asarray(w))


def test_rerank_exact_and_first_min_top2():
    rng = np.random.RandomState(9)
    x = (rng.randn(50, 16) + 3).astype(np.float32)
    c = (rng.randn(24, 16) * 2 + 3).astype(np.float32)
    ids = rng.randint(-1, 24, (50, 8)).astype(np.int32)
    ids[:, 0] = np.maximum(ids[:, 0], 0)
    ids[3] = -1                                # a row with no candidate
    got = quant.rerank_exact(T(x), T(c), T(ids))
    want = np.asarray(jq.rerank_exact(jnp.asarray(x), jnp.asarray(c),
                                      jnp.asarray(ids)))
    valid = ids >= 0
    assert (N(got)[~valid] == 1e30).all() and (want[~valid] == 1e30).all()
    assert_sq_close(N(got)[valid], want[valid],
                    np.repeat(x, 8, 0).reshape(50, 8, 16)[valid], c,
                    ids[valid])
    # first_min_top2 on one tile, ties included: bit-equal
    sq = np.round(want, 1).astype(np.float32)
    for g, w in zip(quant.first_min_top2(T(sq), T(ids)),
                    jq.first_min_top2(jnp.asarray(sq), jnp.asarray(ids))):
        np.testing.assert_array_equal(N(g), np.asarray(w))
    a, d1, d2 = quant.full_candidate_top2_sq(T(x), T(c), T(ids), chunk=16)
    aw, d1w, _ = jq.full_candidate_top2_sq(jnp.asarray(x), jnp.asarray(c),
                                           jnp.asarray(ids), chunk=16)
    np.testing.assert_array_equal(N(a), np.asarray(aw))


# -- K4's plain version against the Pallas kernel ------------------------


def _scan_setup(n, d, k, kn, bn, bkn, seed, near_ties=False):
    """A grouped int8 scan input as the reference's int8 predict builds
    it: queries grouped by their nearest center's block, quantized, with
    the exact residual radii; some live blocks are skipped on top of the
    all-padding capacity blocks."""
    rng = np.random.RandomState(seed)
    if near_ties:          # every candidate survives the margin test
        base = rng.randn(d).astype(np.float32) * 2.0
        c = (base[None, :] + 1e-4 * rng.randn(k, d)).astype(np.float32)
        c[1] = c[0]                                  # an exact tie
        q = (base[None, :] + 0.3 * rng.randn(n, d)).astype(np.float32)
    else:
        c = (rng.randn(k, d) * 2.0).astype(np.float32)
        q = rng.randn(n, d).astype(np.float32)
    dc = np.linalg.norm(c[:, None] - c[None], axis=2)
    neighbors = np.argsort(dc, axis=1, kind="stable")[:, :kn].astype(
        np.int32)
    routed = np.argmin(np.linalg.norm(q[:, None] - c[None], axis=2),
                       1).astype(np.int32)
    perm, b2c = (np.asarray(v) for v in jax_group(jnp.asarray(routed), k,
                                                  bn))
    nb = perm.shape[0] // bn
    skip = (~(perm >= 0).reshape(nb, bn).any(1)).astype(np.int32)
    skip[rng.rand(nb) < 0.2] = 1
    qg = q[np.maximum(perm, 0)]
    xq, xsc = (np.asarray(v) for v in jq.quantize_rows(jnp.asarray(qg)))
    xerr = np.asarray(jnp.linalg.norm(
        jnp.asarray(qg) - jq.dequantize_rows(jnp.asarray(xq),
                                             jnp.asarray(xsc)), axis=1))
    cq = jq.center_quant(jnp.asarray(c))
    cidx = jax_pad(jnp.asarray(neighbors), bkn)
    slabs = [np.asarray(v) for v in jq.quantized_candidate_slabs(cq, cidx)]
    return dict(q=q, c=c, neighbors=neighbors, routed=routed, perm=perm,
                b2c=b2c, skip=skip, qg=qg, xq=xq, xsc=xsc, xerr=xerr, cq=cq,
                cidx=np.asarray(cidx), slabs=slabs)


K4_CASES = [
    # the reference's int8 parity shape (test_quant.py): r = 8 > kn
    dict(n=300, d=16, k=24, kn=6, bn=16, bkn=4, r=8, seed=4),
    # the same with r = 1: rows with two survivors overflow the width
    dict(n=300, d=16, k=24, kn=6, bn=16, bkn=4, r=1, seed=4, overflow=True),
    # near-ties: every candidate survives, nsv > r on every live row
    dict(n=96, d=8, k=12, kn=12, bn=8, bkn=4, r=4, seed=3, near_ties=True,
         overflow=True),
    # the predict layout of the smoke shape's d, bn = 8, kn not a multiple
    dict(n=128, d=785, k=40, kn=30, bn=8, bkn=8, r=16, seed=5),
]


@pytest.mark.parametrize("case", K4_CASES,
                         ids=lambda c: f"n{c['n']}d{c['d']}r{c['r']}")
def test_candidate_assign_int8_tiled_matches_pallas(case):
    cs = dict(case)
    r, overflow = cs.pop("r"), cs.pop("overflow", False)
    s = _scan_setup(**cs)
    bn, bkn = cs["bn"], cs["bkn"]
    args = [s["xq"], s["xsc"], s["xerr"], *s["slabs"], s["b2c"], s["skip"]]
    want = jax_int8_tiled(*(jnp.asarray(a) for a in args), bn=bn, bkn=bkn,
                          r=r, interpret=True)
    got = candidate_assign_int8_tiled(*(T(a) for a in args), bn=bn, bkn=bkn,
                                      r=r)
    np.testing.assert_array_equal(N(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(N(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(N(got[2]), np.asarray(want[2]), rtol=1e-6)
    live = np.repeat(s["skip"] == 0, bn)
    assert (~live).any(), "no skipped block"
    assert (N(got[0])[~live] == -1).all() and (N(got[1])[~live] == 0).all()
    assert (N(got[2])[~live] == 1e30).all()
    if overflow:
        assert (N(got[1]) > r).any(), "no row overflowed the re-rank width"
    # the slab form equals the row-list form over each row's own list
    cand = s["cidx"][np.repeat(s["b2c"], bn)]
    rows = np.flatnonzero(live)
    scan = quant.approx_scan(T(s["xq"][rows]), T(s["xsc"][rows]),
                             T(s["xerr"][rows]), _cq_port(_cq_np(s["cq"])),
                             T(cand[rows]), r=r)
    for g, w in zip(scan, got):
        np.testing.assert_array_equal(N(g), N(w)[rows])


def test_approx_scan_matches_reference():
    s = _scan_setup(n=300, d=16, k=24, kn=6, bn=16, bkn=4, seed=11)
    cand = s["cidx"][np.repeat(s["b2c"], 16)]
    want = jq.approx_scan(jnp.asarray(s["xq"]), jnp.asarray(s["xsc"]),
                          jnp.asarray(s["xerr"]), s["cq"],
                          jnp.asarray(cand), r=4, chunk=128)
    got = quant.approx_scan(T(s["xq"]), T(s["xsc"]), T(s["xerr"]),
                            _cq_port(_cq_np(s["cq"])), T(cand), r=4,
                            chunk=128)
    np.testing.assert_array_equal(N(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(N(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(N(got[2]), np.asarray(want[2]), rtol=1e-6)


def test_k4_plain_version_is_the_wrapper_on_cpu():
    s = _scan_setup(n=64, d=16, k=12, kn=6, bn=8, bkn=4, seed=12)
    args = [T(a) for a in (s["xq"], s["xsc"], s["xerr"], *s["slabs"],
                           s["b2c"], s["skip"])]
    got = candidate_assign_int8_tiled(*args, bn=8, bkn=4, r=4)
    want = candidate_assign_int8_tiled_ref(*args, 8, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="bn"):
        candidate_assign_int8_tiled(*args, bn=7, bkn=4, r=4)


# -- the int8 resolution ops ---------------------------------------------


@pytest.mark.parametrize("r", [8, 1])
def test_quantized_scan_rerank_matches_reference(r):
    s = _scan_setup(n=300, d=16, k=24, kn=6, bn=16, bkn=4, seed=4)
    n_rows = s["qg"].shape[0]
    prev_a = np.full(n_rows, 5, np.int32)
    prev_d = np.full(n_rows, 7.0, np.float32)
    args = [s["qg"], s["xq"], s["xsc"], s["c"]]
    rest = [s["cidx"], s["b2c"], s["skip"], prev_a, prev_d, prev_d]
    want = jax_scan_rerank(*(jnp.asarray(a) for a in args), s["cq"],
                           *(jnp.asarray(a) for a in rest), bn=16, bkn=4,
                           r=r, backend="pallas", interpret=True)
    got = quantized_scan_rerank(*(T(a) for a in args),
                                _cq_port(_cq_np(s["cq"])),
                                *(T(a) for a in rest), bn=16, bkn=4, r=r)
    for i in (0, 3, 4):                      # a, n_surv, fallback
        np.testing.assert_array_equal(N(got[i]), np.asarray(want[i]))
    if r == 1:
        assert N(got[4]).any(), "no row took the full-candidate fallback"
    a = N(got[0])
    assert_sq_close(N(got[1]), np.asarray(want[1]), s["qg"], s["c"], a)
    # d2: the exact second-best floored by the margin bound
    np.testing.assert_allclose(N(got[2]), np.asarray(want[2]), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("near_ties", [False, True])
def test_bounded_predict_assign_int8_matches_reference(near_ties):
    """The reference's int8 parity configuration (n=300, d=16, k=24,
    kn=6, bn=16, bkn=4, r=8), and its near-tie one that forces the f32
    fallback (d=8, k=12 centers within quantization noise, r=4)."""
    kw = dict(n=96, d=8, k=12, kn=12, bn=8, bkn=4, seed=3, near_ties=True) \
        if near_ties else dict(n=300, d=16, k=24, kn=6, bn=16, bkn=4,
                               seed=4)
    r = 4 if near_ties else 8
    s = _scan_setup(**kw)
    bn, bkn = kw["bn"], kw["bkn"]
    want = jax_bpa_int8(jnp.asarray(s["q"]), jnp.asarray(s["c"]), s["cq"],
                        jnp.asarray(s["neighbors"]),
                        jnp.asarray(s["routed"]), bn=bn, bkn=bkn, r=r,
                        backend="pallas", interpret=True)
    got = bounded_predict_assign_int8(
        T(s["q"]), T(s["c"]), _cq_port(_cq_np(s["cq"])), T(s["neighbors"]),
        T(s["routed"]), bn=bn, bkn=bkn, r=r)
    for i in (0, 2, 3):                      # a, n_surv, fallback
        np.testing.assert_array_equal(N(got[i]), np.asarray(want[i]))
    assert_sq_close(N(got[1]), np.asarray(want[1]), s["q"], s["c"],
                    N(got[0]))
    a_o, _ = chunked_candidate_argmin(jnp.asarray(s["q"]),
                                      jnp.asarray(s["c"]),
                                      jnp.asarray(s["neighbors"][s["routed"]]))
    np.testing.assert_array_equal(N(got[0]), np.asarray(a_o))
    if near_ties:
        assert N(got[3]).any(), "near-ties never overflowed the width"


# -- the int8 resident fit arena (ROADMAP §1 item 7b) -------------------

_FIT_N, _FIT_D, _FIT_K, _FIT_KN = 2048, 16, 32, 8
COUNTED = ("distances", "inner_products", "additions", "sort_equivalents",
           "int8_ops", "bytes_gathered", "bytes_scattered", "bytes_sorted",
           "bytes_scanned", "rows_moved", "resorts")


def _fit_blobs(seed=0):
    """test_quant.py's fitted_pair shape (n=2048, d=16, k=32 blobs), drawn
    with numpy, and one init: k rows and their nearest-center assignment
    (the reference's)."""
    from repro.core import assign_nearest as jax_assign_nearest
    rng = np.random.RandomState(seed)
    mus = rng.randn(_FIT_K, _FIT_D) * 4.0
    comp = rng.choice(_FIT_K, _FIT_N)
    x = (mus[comp] + rng.randn(_FIT_N, _FIT_D)).astype(np.float32)
    init = x[rng.choice(_FIT_N, _FIT_K, replace=False)]
    a0 = np.asarray(jax_assign_nearest(jnp.asarray(x), jnp.asarray(init)))
    return x, init, a0.astype(np.int32)


@pytest.fixture(scope="module")
def int8_fits():
    """The reference's int8 fit (``backend="xla"``, as test_quant.py's
    fitted_pair runs it) and the port's int8 and f32 fits from one init,
    12 iterations."""
    from repro.core import OpCounter as JaxCounter
    from repro.core import fit_k2means as jax_fit_k2means
    from repro_torch.core import OpCounter, fit_k2means
    x, init, a0 = _fit_blobs()
    kw = dict(kn=_FIT_KN, max_iters=12)
    cj = JaxCounter()
    rj = jax_fit_k2means(jnp.asarray(x), jnp.asarray(init), jnp.asarray(a0),
                         backend="xla", precision="int8", counter=cj, **kw)
    ci, cf = OpCounter(), OpCounter()
    ri = fit_k2means(T(x), T(init), T(a0), precision="int8", counter=ci,
                     device="cpu", **kw)
    rf = fit_k2means(T(x), T(init), T(a0), counter=cf, device="cpu", **kw)
    return dict(x=x, init=init, a0=a0, rj=rj, cj=cj, ri=ri, ci=ci, rf=rf,
                cf=cf)


def test_int8_fit_matches_reference(int8_fits):
    """The port's int8 fit against the reference's: assignments, centers
    and iterations bit-identical, every counted lane equal (the re-ranked
    survivors' f32 distances, the int8 ops, the int8 scan and moved-row
    bytes), and the energies, which the two packages sum over the rows in
    other orders, within rel 1e-6 at every iteration."""
    f = int8_fits
    rj, ri = f["rj"], f["ri"]
    np.testing.assert_array_equal(N(ri.assignment), np.asarray(rj.assignment))
    np.testing.assert_array_equal(N(ri.centers), np.asarray(rj.centers))
    assert ri.iterations == rj.iterations
    assert ri.energy == pytest.approx(rj.energy, rel=1e-6)
    assert len(ri.history) == len(rj.history)
    for (oi, ei), (oj, ej) in zip(ri.history, rj.history):
        assert oi == oj
        assert ei == pytest.approx(ej, rel=1e-6)
    pj, pi = f["cj"].profile(), f["ci"].profile()
    for key in COUNTED:
        assert pi[key] == pj[key], key
    assert f["ci"].total == f["cj"].total


def test_int8_fit_equals_the_f32_fit(int8_fits):
    """The quantized arena never changes the trajectory: the port's int8
    fit equals its f32 fit bit for bit, charges int8 ops and fewer f32
    distances, and a moved row costs d + 16 bytes against 4 (d + 3)."""
    f = int8_fits
    ri, rf, ci, cf = f["ri"], f["rf"], f["ci"], f["cf"]
    assert torch.equal(ri.assignment, rf.assignment)
    assert torch.equal(ri.centers, rf.centers)
    assert ri.energy == rf.energy and ri.iterations == rf.iterations
    assert ci.int8_ops > 0 and cf.int8_ops == 0
    assert ci.distances < cf.distances
    assert ci.bytes_scanned < cf.bytes_scanned
    d = _FIT_D
    assert ci.bytes_gathered * 4 * (d + 3) == cf.bytes_gathered * (d + 16)
    assert ci.bytes_scattered * 4 * (d + 3) == cf.bytes_scattered * (d + 16)
    assert ci.rows_moved == cf.rows_moved and ci.resorts == cf.resorts


def test_int8_resident_step_matches_reference_per_iteration():
    """The int8 arena step by step against the reference's (``backend=
    "xla"``, re-sort every 5, move buffer 128): after every iteration the
    int8 rows, the slot arrays and the centers are bit-equal, the scales
    within one f32 ulp (the reference's jitted ``max|row| / 127`` rounds
    apart from an IEEE division in about 2% of rows, as a fused
    reciprocal would; the codes are equal), and the statistics (the
    re-ranked count among them) agree."""
    from repro.core.engine import K2Step as JaxK2Step
    from repro_torch.core import K2Step
    x, init, a0 = _fit_blobs(1)
    kw = dict(k=_FIT_K, kn=_FIT_KN, residency="resident", regroup_every=5,
              move_cap=128, precision="int8")
    sj, st = JaxK2Step(backend="xla", **kw), K2Step(**kw)
    step_j, step_t = sj.build(_FIT_N, _FIT_D), st.build(_FIT_N, _FIT_D)
    xj, wj = jnp.asarray(x), jnp.ones((_FIT_N,), jnp.float32)
    xt, wt = T(x), torch.ones(_FIT_N)
    state_j = sj.init_resident(xj, wj, jnp.asarray(init), jnp.asarray(a0))
    state_t = st.init_resident(xt, wt, T(init), T(a0))
    assert state_t.xg.dtype == torch.int8
    resorts = 0
    for it in range(10):
        state_j, stats_j = step_j(xj, wj, state_j)
        state_t, stats_t = step_t(xt, wt, state_t)
        for name in ("xg", "pid", "b2c", "fill", "openb", "c"):
            np.testing.assert_array_equal(
                N(getattr(state_t, name)), np.asarray(getattr(state_j, name)),
                err_msg=f"iteration {it}: {name}")
        np.testing.assert_array_max_ulp(N(state_t.xsc),
                                        np.asarray(state_j.xsc), maxulp=1)
        for i in (0, 1, 3, 4, 5):     # n_need, changed, moved, resorted,
            assert int(stats_t[i]) == int(stats_j[i]), (it, i)  # reranked
        resorts += int(stats_t[4])
    assert resorts >= 2


def test_int8_fit_validation_matches_reference(int8_fits):
    """The reference's refusals: an unknown precision, int8 with guards
    or fault injection, int8 on the rebuild residency."""
    from repro.core import fit_k2means as jax_fit_k2means
    from repro.ft import FaultInjector as JaxInjector
    from repro_torch.core import fit_k2means
    from repro_torch.ft import FaultInjector
    f = int8_fits
    xj, cj, aj = (jnp.asarray(f[k]) for k in ("x", "init", "a0"))
    xt, ct, at = (T(f[k]) for k in ("x", "init", "a0"))
    kw = dict(kn=_FIT_KN, max_iters=2)
    cases = [(dict(precision="int4"), "precision"),
             (dict(precision="int8", guards=True), "guards"),
             (dict(precision="int8", residency="rebuild"), "resident")]
    for over, match in cases:
        with pytest.raises(ValueError, match=match) as ej:
            jax_fit_k2means(xj, cj, aj, backend="xla", **kw, **over)
        with pytest.raises(ValueError, match=match) as et:
            fit_k2means(xt, ct, at, device="cpu", **kw, **over)
        assert str(et.value) == str(ej.value)
    with JaxInjector(seed=0), pytest.raises(ValueError, match="guards"):
        jax_fit_k2means(xj, cj, aj, backend="xla", precision="int8", **kw)
    with FaultInjector(seed=0), pytest.raises(ValueError, match="guards"):
        fit_k2means(xt, ct, at, precision="int8", device="cpu", **kw)
