"""The port's three kernels (K1 candidate_assign_tiled, K2 center_sqdist,
K3 segmented_scan) against the JAX reference's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; the reference
runs its Pallas kernels with ``interpret=True``. Inputs are drawn once
with numpy from a seed and handed to both. Tolerances: assignments
identical; squared distances rtol=1e-5 with atol=1e-5*max|c|^2 (the
norm expansion cancels in f32); scan sums rtol=1e-5 with atol=1e-5 times
the segment's sum of absolute values (the summation order differs);
counts exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.candidate_assign import \
    candidate_assign_tiled as jax_candidate_assign_tiled
from repro.kernels.candidate_assign import \
    candidate_tables as jax_candidate_tables
from repro.kernels.candidate_assign import pad_candidates as jax_pad
from repro.kernels.center_knn import center_knn as jax_center_knn
from repro.kernels.center_knn import center_sqdist as jax_center_sqdist
from repro.kernels.ops import group_by_cluster_device as jax_group
from repro.kernels.segmented_scan import \
    segmented_scan as jax_segmented_scan
from repro_torch.core.engine import center_knn_graph
from repro_torch.kernels.candidate_assign import (candidate_assign_tiled,
                                                  candidate_tables,
                                                  pad_candidates)
from repro_torch.kernels.center_knn import center_sqdist
from repro_torch.kernels.ops import group_by_cluster_device
from repro_torch.kernels.segmented_scan import segmented_scan


def _assign_inputs(n, k, d, kn, bn, bkn, seed):
    rng = np.random.RandomState(seed)
    nb = n // bn
    t = max(2, nb // 2)
    x = rng.randn(n, d).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    cand = rng.randint(0, k, (t, kn)).astype(np.int32)
    rowsel = rng.randint(0, t, nb).astype(np.int32)
    skip = (rng.rand(nb) < 0.3).astype(np.int32)
    prev_a = rng.randint(0, k, n).astype(np.int32)
    prev_d1 = np.full(n, 7.0, np.float32)
    prev_d2 = np.full(n, 9.0, np.float32)
    return x, c, cand, rowsel, skip, prev_a, prev_d1, prev_d2


def _torch_assign(x, c, cand, rowsel, skip, prev_a, prev_d1, prev_d2, bn,
                  bkn, device="cpu"):
    t = lambda v: torch.tensor(v, device=device)   # noqa: E731
    cidx = pad_candidates(t(cand), bkn).contiguous()
    ctab, csqtab = candidate_tables(t(c), cidx)
    return candidate_assign_tiled(t(x), ctab, csqtab, cidx, t(rowsel),
                                  t(skip), t(prev_a), t(prev_d1),
                                  t(prev_d2), bn=bn, bkn=bkn)


@pytest.mark.parametrize("n,k,d,kn,bn,bkn", [
    (256, 64, 48, 8, 64, 8),
    (512, 128, 16, 16, 128, 8),
    (128, 32, 200, 4, 32, 8),     # kn < bkn: a single padded tile
    (256, 64, 32, 12, 64, 8),     # kn not a bkn multiple: -1 padding
    (256, 64, 32, 16, 64, 16),    # one full-width tile
    (96, 40, 784, 30, 32, 8),     # the smoke run's kn and d
])
def test_candidate_assign_tiled_matches_pallas(n, k, d, kn, bn, bkn):
    inp = _assign_inputs(n, k, d, kn, bn, bkn, seed=n * k + kn)
    x, c, cand, rowsel, skip, prev_a, prev_d1, prev_d2 = inp
    cidx = jax_pad(jnp.asarray(cand), bkn)
    ctab, csqtab = jax_candidate_tables(jnp.asarray(c), cidx)
    want = jax_candidate_assign_tiled(
        jnp.asarray(x), ctab, csqtab, cidx, jnp.asarray(rowsel),
        jnp.asarray(skip), jnp.asarray(prev_a), jnp.asarray(prev_d1),
        jnp.asarray(prev_d2), bn=bn, bkn=bkn, interpret=True)
    got = _torch_assign(*inp, bn, bkn)
    atol = 1e-5 * float(np.max(np.sum(c * c, 1)))
    assert (got[0].numpy() == np.asarray(want[0])).all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=atol)
    # the table the kernel reads is the reference's table
    _, csq_t = candidate_tables(torch.tensor(c),
                                pad_candidates(torch.tensor(cand), bkn))
    np.testing.assert_allclose(csq_t.numpy(), np.asarray(csqtab), rtol=1e-6)


@pytest.mark.parametrize("k,d", [(128, 32), (256, 64), (128, 300),
                                 (100, 784)])
def test_center_sqdist_matches_pallas(k, d):
    c = np.random.RandomState(k + d).randn(k, d).astype(np.float32)
    want = np.asarray(jax_center_sqdist(jnp.asarray(c), interpret=True))
    got = center_sqdist(torch.tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.sum(c * c, 1))))


@pytest.mark.parametrize("dup", [False, True])
def test_center_knn_graph_matches_top_k(dup):
    """Neighbor lists equal the reference's lax.top_k ones, ties included:
    duplicated centers tie exactly and both pick the lower index."""
    rng = np.random.RandomState(5)
    c = rng.randn(128, 16).astype(np.float32)
    if dup:
        c[64:] = c[:64]
    want = np.asarray(jax_center_knn(jnp.asarray(c), 8, interpret=True))
    got = center_knn_graph(torch.tensor(c), 8).numpy()
    assert (got == want).all()
    if not dup:
        assert (got[:, 0] == np.arange(128)).all()


def _segments_abs(v, b2s, bn):
    """Per-row sum of |v| over the row's segment (atol scale)."""
    row_seg = np.repeat(b2s, bn)
    out = np.zeros_like(v)
    for s in np.unique(row_seg):
        rows = row_seg == s
        out[rows] = np.abs(v[rows]).sum(0)
    return out


@pytest.mark.parametrize("n,d,k,bn", [
    (100, 5, 7, 8),
    (256, 32, 4, 16),      # multi-block segments
    (64, 3, 64, 8),        # k == n: many empty/singleton leaves
    (512, 128, 16, 32),
])
def test_segmented_scan_matches_pallas(n, d, k, bn):
    rng = np.random.RandomState(n + d)
    x = rng.randn(n, d).astype(np.float32)
    a = rng.randint(0, k, n).astype(np.int32)
    perm, b2s = (np.asarray(v) for v in jax_group(jnp.asarray(a), k, bn))
    xg = x[np.maximum(perm, 0)]
    w = (perm >= 0).astype(np.float32)
    want = jax_segmented_scan(jnp.asarray(xg), jnp.asarray(w),
                              jnp.asarray(b2s), bn=bn, interpret=True)
    got = segmented_scan(torch.tensor(xg), torch.tensor(w),
                         torch.tensor(b2s), bn=bn)
    xw = xg * w[:, None]
    for g, wv, v in ((got[0], want[0], xw),
                     (got[1], want[1], np.sum(xw * xg, 1))):
        err = np.abs(g.numpy() - np.asarray(wv))
        bound = 1e-5 * np.abs(np.asarray(wv)) + 1e-5 * _segments_abs(v, b2s,
                                                                     bn)
        assert (err <= bound).all(), float((err - bound).max())
    assert (got[2].numpy() == np.asarray(want[2])).all()
    # the port's own grouping gives the layout the scan ran on
    p2, b2 = group_by_cluster_device(torch.tensor(a), k, bn)
    assert (p2.numpy() == perm).all() and (b2.numpy() == b2s).all()
