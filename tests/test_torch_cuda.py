"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use); without a card they
skip. They import no JAX, so they run on a machine that has only the
port's dependencies: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Tolerances are those of the CPU parity
tests (tests/test_torch_kernels.py); an assignment may differ only on a
near-tie, where the plain second-best is within 1e-5 relative of the
best.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.candidate_assign import (candidate_assign_tiled,
                                                  candidate_tables,
                                                  pad_candidates)
from repro_torch.kernels.center_knn import center_sqdist
from repro_torch.kernels.ops import group_by_cluster_device
from repro_torch.kernels.segmented_scan import segmented_scan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


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


def _segments_abs(v, b2s, bn):
    """Per-row sum of |v| over the row's segment (atol scale)."""
    row_seg = np.repeat(b2s, bn)
    out = np.zeros_like(v)
    for s in np.unique(row_seg):
        rows = row_seg == s
        out[rows] = np.abs(v[rows]).sum(0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,kn,bn,bkn", [(256, 64, 48, 8, 64, 8),
                                             (320, 100, 784, 30, 32, 8),
                                             (512, 128, 16, 16, 128, 8)])
def test_cuda_candidate_assign_tiled(cuda, n, k, d, kn, bn, bkn):
    inp = _assign_inputs(n, k, d, kn, bn, bkn, seed=n + k)
    before = _build.launches()["candidate_assign_tiled"]
    got = _torch_assign(*inp, bn, bkn, device=cuda)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_tiled"] == before + 1
    want = _torch_assign(*inp, bn, bkn)
    atol = 1e-5 * float(np.max(np.sum(inp[1] ** 2, 1)))
    d1w, d2w = want[1].numpy(), want[2].numpy()
    tie = (d2w - d1w) <= 1e-5 * d1w
    assert ((got[0].cpu().numpy() == want[0].numpy()) | tie).all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", [(100, 784), (1000, 64), (64, 3)])
def test_cuda_center_sqdist(cuda, k, d):
    c = np.random.RandomState(k).randn(k, d).astype(np.float32)
    got = center_sqdist(torch.tensor(c, device=cuda)).cpu().numpy()
    want = center_sqdist(torch.tensor(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.sum(c * c, 1))))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,bn", [(100, 5, 7, 8), (2000, 784, 20, 32)])
def test_cuda_segmented_scan(cuda, n, d, k, bn):
    rng = np.random.RandomState(n)
    x = rng.randn(n, d).astype(np.float32)
    a = torch.tensor(rng.randint(0, k, n).astype(np.int32))
    perm, b2s = group_by_cluster_device(a, k, bn)
    xg = torch.tensor(x)[perm.clamp(min=0).long()]
    w = (perm >= 0).float()
    got = segmented_scan(xg.to(cuda), w.to(cuda), b2s.to(cuda), bn=bn)
    want = ref.segmented_scan_ref(xg.double(), w.double(), b2s, bn)
    b2n, xw = b2s.numpy(), (xg * w[:, None]).numpy()
    for g, wv, v in ((got[0], want[0], xw),
                     (got[1], want[1], np.sum(xw * xg.numpy(), 1))):
        err = np.abs(g.cpu().double().numpy() - wv.numpy())
        bound = 1e-5 * np.abs(wv.numpy()) + 1e-5 * _segments_abs(v, b2n, bn)
        assert (err <= bound).all()
    assert (got[2].cpu().double() == want[2]).all()
