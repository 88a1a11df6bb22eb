"""The port's KV-cache clustering and K6 ``cluster_attend`` against the
JAX reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
reference runs its Pallas ``cluster_attend`` with ``interpret=True``, the
port its kernels' plain versions (CPU tensors). Everything here is f32,
where the point is the algorithm; the model's bf16 path is held in
tests/test_torch_lm.py. Tolerances, and why:
- K6 outputs and softmax states: rtol 1e-5, atol 1e-6. The TPU kernel
  carries an online softmax over blocks, the plain version takes one
  softmax over all p * cap slots, and the two sum in other orders.
- Cluster structures (members, masks, sizes, tables, counts): equal. The
  assignments are argmins of f32 distances that both packages compute in
  one order of operations, with ties to the lower index on both sides.
- Centroids: rtol 1e-5, atol 1e-6 of the keys' scale. The port sums
  segment members in f64 and rounds once, the reference multiplies by a
  one-hot matrix in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cluster_attend import cluster_attend as jax_cluster_attend
from repro.kernels.cluster_attend import \
    cluster_major_pack as jax_cluster_major_pack
from repro.kernels.cluster_attend import select_clusters as jax_select
from repro.kernels.ref import clustered_attend_ref as jax_clustered_ref
from repro.models.attention import _cm_partial as jax_cm_partial
from repro.models.attention import \
    cluster_major_decode_attention as jax_cm_decode
from repro.models.kv_cluster import build_cluster_major as jax_build_cm
from repro.models.kv_cluster import build_kv_clusters as jax_build
from repro.models.kv_cluster import \
    cluster_major_append as jax_cluster_major_append
from repro.models.kv_cluster import kv_partial_fit as jax_kv_partial_fit
from repro.models.kv_cluster import recluster_ring as jax_recluster_ring
from repro_torch.kernels import _build
from repro_torch.kernels.cluster_attend import (cluster_attend,
                                                cluster_attend_partial,
                                                cluster_major_pack,
                                                select_clusters)
from repro_torch.kernels.ref import clustered_attend_ref
from repro_torch.models.attention import cluster_major_decode_attention
from repro_torch.models.kv_cluster import (build_cluster_major,
                                           build_kv_clusters,
                                           cluster_major_append,
                                           kv_partial_fit, recluster_ring,
                                           strided_ids)

RTOL, ATOL = 1e-5, 1e-6


def T(a):
    return torch.tensor(np.asarray(a))


def _np(x):
    return np.asarray(x)


def _qkv(seed, B, Hkv, g, S, dh):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Hkv * g, dh).astype(np.float32)
    k = rng.randn(B, Hkv, S, dh).astype(np.float32)
    v = rng.randn(B, Hkv, S, dh).astype(np.float32)
    return q, k, v


def _packed(seed, B, Hkv, g, S, dh, kc, cap, p):
    """The reference's cluster-major pack and selection, as numpy."""
    q, k, v = _qkv(seed, B, Hkv, g, S, dh)
    cent, mem, mmask, _ = jax_build(jnp.asarray(k), kc, cap)
    kt, vt, valid = jax_cluster_major_pack(jnp.asarray(k), jnp.asarray(v),
                                           mem, mmask)
    sel = jax_select(jnp.asarray(q), cent, p)
    return (q.reshape(B * Hkv * g, dh), _np(kt), _np(vt), _np(valid),
            _np(sel), _np(cent), k, v, _np(mem), _np(mmask))


# the shapes of tests/test_kernels.py::test_cluster_attend_matches_jnp
SHAPES = [(2, 2, 2, 128, 32, 8, 64, 4), (1, 4, 1, 64, 16, 4, 32, 2),
          (2, 1, 4, 96, 64, 6, 32, 3)]


@pytest.mark.parametrize("B,Hkv,g,S,dh,kc,cap,p", SHAPES)
def test_cluster_attend_plain_matches_pallas(B, Hkv, g, S, dh, kc, cap, p):
    q, kt, vt, valid, sel = _packed(B * S + dh, B, Hkv, g, S, dh, kc, cap,
                                    p)[:5]
    want = _np(jax_cluster_attend(jnp.asarray(q), jnp.asarray(kt),
                                  jnp.asarray(vt), jnp.asarray(valid),
                                  jnp.asarray(sel), interpret=True))
    got = cluster_attend(T(q), T(kt), T(vt), T(valid), T(sel))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the sizes form: validity in the cluster-major pack is a prefix
    sizes = valid.sum(1).astype(np.int32)
    assert (valid == (np.arange(valid.shape[1]) < sizes[:, None])).all()
    m, l, acc = cluster_attend_partial(T(q), T(kt), T(vt), T(sel),
                                       sizes=T(sizes))
    np.testing.assert_allclose((acc / l[:, None]).numpy(), want, rtol=RTOL,
                               atol=ATOL)
    # the port's pack and selection give the reference's tables and ids
    _, _, _, _, _, cent, k, v, mem, mmask = _packed(
        B * S + dh, B, Hkv, g, S, dh, kc, cap, p)
    kt2, vt2, valid2 = cluster_major_pack(T(k), T(v), T(mem), T(mmask))
    assert torch.equal(kt2, T(kt)) and torch.equal(vt2, T(vt))
    assert torch.equal(valid2, T(valid))
    qr = T(q).reshape(B, Hkv * g, dh)
    assert torch.equal(select_clusters(qr, T(cent), p), T(sel))


def test_cluster_attend_all_empty_row():
    B, Hkv, g, S, dh, kc, cap, p = 2, 2, 2, 128, 32, 8, 64, 4
    q, kt, vt, valid, sel = _packed(5, B, Hkv, g, S, dh, kc, cap, p)[:5]
    # empty every block that row 0 selects
    valid = valid.copy()
    valid[sel[0]] = 0
    kt, vt = kt.copy(), vt.copy()
    kt[sel[0]] = 0.0
    vt[sel[0]] = 0.0
    want = _np(jax_cluster_attend(jnp.asarray(q), jnp.asarray(kt),
                                  jnp.asarray(vt), jnp.asarray(valid),
                                  jnp.asarray(sel), interpret=True))
    got = cluster_attend(T(q), T(kt), T(vt), T(valid), T(sel))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert (got[0] == 0).all() and (want[0] == 0).all()
    for form in ({"valid": T(valid)},
                 {"sizes": T(valid.sum(1).astype(np.int32))}):
        m, l, acc = cluster_attend_partial(T(q), T(kt), T(vt), T(sel),
                                           **form)
        assert m[0] == -torch.inf and l[0] == 0 and (acc[0] == 0).all()
        assert torch.isfinite(m[1:]).all() and (l[1:] > 0).all()


@pytest.mark.parametrize("B,Hkv,g,S,dh,kc,cap,p", SHAPES)
def test_cluster_attend_state_matches_cm_partial(B, Hkv, g, S, dh, kc, cap,
                                                 p):
    """(m, l, acc) against the reference's ``_cm_partial`` on the
    cluster-major tables, with the sizes form of validity."""
    rng = np.random.RandomState(S + p)
    q, k, v = _qkv(S + p, B, Hkv, g, S, dh)
    kt, vt, cent, sizes = jax_build_cm(jnp.asarray(k), jnp.asarray(v), kc,
                                       cap)
    sel = rng.randint(0, kc, (B, Hkv, g, p)).astype(np.int32)
    qr = q.reshape(B, Hkv, g, dh)
    m_w, l_w, acc_w = (_np(t) for t in jax_cm_partial(
        jnp.asarray(qr), kt, vt, sizes, jnp.asarray(sel), 0, dh))
    base = (np.arange(B)[:, None] * Hkv + np.arange(Hkv)[None, :]) * kc
    flat = (sel + base[:, :, None, None]).reshape(B * Hkv * g, p)
    m, l, acc = cluster_attend_partial(
        T(q.reshape(-1, dh)), T(_np(kt)).reshape(-1, cap, dh),
        T(_np(vt)).reshape(-1, cap, dh), T(flat.astype(np.int32)),
        sizes=T(_np(sizes)).reshape(-1))
    np.testing.assert_allclose(m.numpy(), m_w.reshape(-1), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(l.numpy(), l_w.reshape(-1), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(acc.numpy(), acc_w.reshape(-1, dh),
                               rtol=RTOL, atol=ATOL)


def test_clustered_attend_ref_matches_reference():
    h, S, dh, kc, cap, p = 4, 96, 16, 6, 32, 3
    rng = np.random.RandomState(3)
    q = rng.randn(h, dh).astype(np.float32)
    k = rng.randn(h, S, dh).astype(np.float32)
    v = rng.randn(h, S, dh).astype(np.float32)
    cent, mem, mmask, _ = jax_build(jnp.asarray(k)[None], kc, cap)
    args = (_np(cent[0]), _np(mem[0]), _np(mmask[0]))
    want = _np(jax_clustered_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), *map(jnp.asarray, args), p))
    got = clustered_attend_ref(T(q), T(k), T(v), *map(T, args), p)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# build_kv_clusters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,kc", [(1, 1), (1, 8), (5, 8), (7, 8), (8, 8),
                                  (48, 8), (100, 7), (127, 16), (1000, 33),
                                  (4097, 64), (65536, 2048), (65537, 1000),
                                  (131072, 2048)])
def test_strided_ids_match_jitted_linspace(S, kc):
    """The init's sample ids as the reference computes them inside its
    jitted ``build_kv_clusters``: the f32 linspace as XLA folds it,
    truncated (S < kc repeats ids)."""
    want = _np(jax.jit(lambda: jnp.linspace(0, S - 1, kc).astype(
        jnp.int32))())
    np.testing.assert_array_equal(strided_ids(S, kc).numpy(), want)


def _assert_clusters_equal(got, want, scale):
    cent, mem, mask, sizes = got
    c_w, m_w, k_w, s_w = (_np(t) for t in want)
    np.testing.assert_array_equal(mem.numpy(), m_w)
    np.testing.assert_array_equal(mask.numpy(), k_w)
    np.testing.assert_array_equal(sizes.numpy(), s_w)
    np.testing.assert_allclose(cent.numpy(), c_w, rtol=RTOL,
                               atol=ATOL * scale)


@pytest.mark.parametrize("B,H,S,d,kc,cap,seed", [
    (2, 2, 48, 16, 8, 16, 0),      # the qwen3-8b smoke config's cache
    (1, 2, 128, 32, 8, 32, 1),
    (2, 1, 96, 64, 6, 8, 2),       # cap 8 < the mean size: rows drop
    (1, 1, 5, 16, 8, 4, 3),        # S < kc: repeated seeds, empty clusters
    (1, 3, 300, 8, 16, 64, 4),     # kc > k_n: the restricted sweeps
])
def test_build_kv_clusters_matches_reference(B, H, S, d, kc, cap, seed):
    k = np.random.RandomState(seed).randn(B, H, S, d).astype(np.float32)
    got = build_kv_clusters(T(k), kc, cap)
    _assert_clusters_equal(got, jax_build(jnp.asarray(k), kc, cap),
                           np.abs(k).max())
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32


def test_build_kv_clusters_on_clustered_keys():
    """Keys drawn around 8 well-separated modes: the sweeps converge to
    them and both packages agree on every member."""
    rng = np.random.RandomState(7)
    mus = rng.randn(8, 16).astype(np.float32) * 6
    k = (mus[rng.randint(0, 8, (2, 2, 200))]
         + rng.randn(2, 2, 200, 16).astype(np.float32))
    got = build_kv_clusters(T(k), 8, 64)
    _assert_clusters_equal(got, jax_build(jnp.asarray(k), 8, 64),
                           np.abs(k).max())


def test_build_kv_clusters_chunked_equals_whole(monkeypatch):
    """The chunked distance and candidate passes give the unchunked
    result."""
    from repro_torch.models import kv_cluster
    k = np.random.RandomState(9).randn(2, 2, 96, 16).astype(np.float32)
    whole = build_kv_clusters(T(k), 8, 32)
    monkeypatch.setattr(kv_cluster, "CHUNK_ELEMS", 256)
    chunked = build_kv_clusters(T(k), 8, 32)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(500, 16), (500,)])
def test_segment_sum_f64_is_order_free(shape):
    """The centroid update's f64 segment sum adds each segment's rows in
    row order on every device and rounds once: it equals numpy's
    row-order f64 sum rounded to f32, and on these values (six decades)
    its f64 rounding lies so far below f32's that permuted rows give the
    same bits too."""
    from repro_torch.kernels.ops import segment_sum_f64
    rng = np.random.RandomState(4)
    v = (rng.randn(*shape) * 10.0 ** rng.randint(-3, 4, shape[:1] + (1,) *
                                                  (len(shape) - 1))).astype(
        np.float32)
    seg = rng.randint(0, 7, shape[0])
    perm = rng.permutation(shape[0])
    got = segment_sum_f64(T(v), T(seg), 7)
    again = segment_sum_f64(T(v[perm]), T(seg[perm]), 7)
    want = np.zeros((7,) + shape[1:])
    np.add.at(want, seg, v.astype(np.float64))
    assert got.dtype == torch.float32
    assert torch.equal(got, again)
    assert torch.equal(got, T(want.astype(np.float32)))


def test_build_cluster_major_matches_reference():
    B, H, S, d, kc, cap = 2, 2, 96, 16, 8, 16
    rng = np.random.RandomState(11)
    k = rng.randn(B, H, S, d).astype(np.float32)
    v = rng.randn(B, H, S, d).astype(np.float32)
    want = [_np(t) for t in jax_build_cm(jnp.asarray(k), jnp.asarray(v),
                                         kc, cap)]
    got = build_cluster_major(T(k), T(v), kc, cap)
    for name, g, w in zip(("kt", "vt"), got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=RTOL,
                               atol=ATOL * np.abs(k).max())
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    # into preallocated tables, as attach_clusters fills them
    out = (torch.full((B, H, kc, cap, d), 7.0),
           torch.full((B, H, kc, cap, d), 7.0))
    again = build_cluster_major(T(k), T(v), kc, cap, out=out)
    assert again[0] is out[0] and torch.equal(out[0], got[0])
    assert torch.equal(out[1], got[1])


# --------------------------------------------------------------------------
# ring folds and appends
# --------------------------------------------------------------------------

def _tables(seed, B, H, S, d, kc, cap, R):
    rng = np.random.RandomState(seed)
    k = rng.randn(B, H, S, d).astype(np.float32)
    v = rng.randn(B, H, S, d).astype(np.float32)
    kt, vt, cent, sizes = (_np(t) for t in jax_build_cm(
        jnp.asarray(k), jnp.asarray(v), kc, cap))
    ring_k = rng.randn(B, H, R, d).astype(np.float32)
    ring_v = rng.randn(B, H, R, d).astype(np.float32)
    return kt, vt, cent, sizes, ring_k, ring_v


def _port(*arrays):
    return [T(a.copy()) for a in arrays]


FOLDS = [(2, 2, 48, 16, 8, 16, 8, 5),    # the smoke cache, a part-filled ring
         (1, 2, 96, 16, 4, 24, 8, 11),   # a wrapped ring; full clusters drop
         (2, 1, 40, 8, 6, 8, 6, 0)]      # an empty ring


@pytest.mark.parametrize("B,H,S,d,kc,cap,R,fill", FOLDS)
def test_kv_partial_fit_matches_reference(B, H, S, d, kc, cap, R, fill):
    kt, vt, cent, sizes, rk, rv = _tables(fill + S, B, H, S, d, kc, cap, R)
    counts = sizes.astype(np.float32) + np.arange(kc, dtype=np.float32)
    want = [_np(t) for t in jax_kv_partial_fit(
        *map(jnp.asarray, (kt, vt, cent, sizes, counts, rk, rv)),
        jnp.int32(fill))]
    got = kv_partial_fit(*_port(kt, vt, cent, sizes, counts, rk, rv),
                         torch.tensor(fill, dtype=torch.int32))
    names = ("kt", "vt", "cent", "sizes", "counts", "ring_k", "ring_v",
             "fill")
    for name, g, w in zip(names, got, want):
        if name == "cent":
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if fill:
        assert (got[3].numpy() != sizes).any()


@pytest.mark.parametrize("B,H,S,d,kc,cap,R,fill", FOLDS)
def test_recluster_ring_matches_reference(B, H, S, d, kc, cap, R, fill):
    kt, vt, cent, sizes, rk, rv = _tables(fill + S + 1, B, H, S, d, kc, cap,
                                          R)
    want = [_np(t) for t in jax_recluster_ring(
        *map(jnp.asarray, (kt, vt, cent, sizes, rk, rv)), jnp.int32(fill))]
    # the caller may name the live rows (one host read for all layers)
    got = recluster_ring(*_port(kt, vt, cent, sizes, rk, rv),
                         torch.tensor(fill, dtype=torch.int32),
                         n_live=min(fill, R))
    names = ("kt", "vt", "cent", "sizes", "ring_k", "ring_v", "fill")
    for name, g, w in zip(names, got, want):
        if name == "cent":
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_cluster_major_append_matches_reference():
    B, H, S, d, kc, cap = 2, 2, 48, 16, 8, 8
    kt, vt, cent, sizes, rk, rv = _tables(21, B, H, S, d, kc, cap, 4)
    state = _port(kt, vt, cent, sizes)
    want = (jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(cent),
            jnp.asarray(sizes))
    for r in range(4):
        want = jax_cluster_major_append(*want, jnp.asarray(rk[:, :, r]),
                                        jnp.asarray(rv[:, :, r]))
        state = cluster_major_append(*state, T(rk[:, :, r].copy()),
                                     T(rv[:, :, r].copy()))
    for name, g, w in zip(("kt", "vt", "cent", "sizes"), state, want):
        if name == "cent":
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)


# --------------------------------------------------------------------------
# cluster-major decode attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fill,with_self", [(3, True), (0, True), (11, True),
                                            (5, False)])
def test_cluster_major_decode_attention_matches_reference(fill, with_self):
    B, Hkv, g, S, dh, kc, cap, p, R = 2, 2, 4, 96, 16, 8, 16, 2, 8
    kt, vt, cent, sizes, rk, rv = _tables(fill + 31, B, Hkv, S, dh, kc, cap,
                                          R)
    rng = np.random.RandomState(fill)
    q = rng.randn(B, Hkv * g, dh).astype(np.float32)
    kn = rng.randn(B, Hkv, dh).astype(np.float32)
    vn = rng.randn(B, Hkv, dh).astype(np.float32)
    self_j = (jnp.asarray(kn), jnp.asarray(vn)) if with_self else None
    want = _np(jax_cm_decode(
        jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jnp.asarray(cent),
        jnp.asarray(sizes), p, self_kv=self_j,
        ring=(jnp.asarray(rk), jnp.asarray(rv), jnp.int32(fill))))
    _build.reset_launches()
    got = cluster_major_decode_attention(
        T(q), T(kt), T(vt), T(cent), T(sizes), p,
        self_kv=(T(kn), T(vn)) if with_self else None,
        ring=(T(rk), T(rv), torch.tensor(fill, dtype=torch.int32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # CPU tensors take the plain version: no launch is counted
    assert _build.launches()["cluster_attend"] == 0
