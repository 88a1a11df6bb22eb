"""Each CUDA kernel against its plain PyTorch version, on the card, and
the served model's predict on the card against the same model on the CPU.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use); without a card they
skip. They import no JAX, so they run on a machine that has only the
port's dependencies: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Tolerances are those of the CPU parity
tests (tests/test_torch_kernels.py). K1, K5 and K7 round their f64 sums
once to f32 and K4 rounds after every operation, each like its plain
version, so their assignments and distances and K4's survivors, counts
and lower bounds are held bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (KMeansModel, OpCounter, fit_elkan,
                              fit_k2means, fit_lloyd)
from repro_torch.kernels import _build, quant, ref
from repro_torch.kernels.candidate_assign import (candidate_assign_int8_tiled,
                                                  candidate_assign_rowwise,
                                                  candidate_assign_tiled,
                                                  candidate_tables,
                                                  pad_candidates)
from repro_torch.kernels.center_knn import center_sqdist
from repro_torch.kernels.distance_argmin import distance_argmin
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
                                             (512, 128, 16, 16, 128, 8),
                                             (256, 100, 784, 30, 8, 8),
                                             (512, 400, 100, 200, 128, 8)])
def test_cuda_candidate_assign_tiled(cuda, n, k, d, kn, bn, bkn):
    inp = _assign_inputs(n, k, d, kn, bn, bkn, seed=n + k)
    before = _build.launches()["candidate_assign_tiled"]
    got = _torch_assign(*inp, bn, bkn, device=cuda)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_tiled"] == before + 1
    want = _torch_assign(*inp, bn, bkn)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


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


def _int8_inputs(n, k, d, kn, bn, bkn, seed):
    """A K4 input (CPU tensors): random candidate lists, blocks skipped at
    random, and block 0 near kn nearly equal centers that all survive
    the margin test, so its rows overflow a re-rank width below kn."""
    rng = np.random.RandomState(seed)
    nb = n // bn
    t = max(2, nb // 2)
    c = (rng.randn(k, d) * 2).astype(np.float32)
    c[:kn] = c[0] + 1e-3 * rng.randn(kn, d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    x[:bn] = c[0] + 0.3 * rng.randn(bn, d).astype(np.float32)
    cand = rng.randint(0, k, (t, kn)).astype(np.int32)
    cand[0] = np.arange(kn)
    rowsel = rng.randint(0, t, nb).astype(np.int32)
    skip = (rng.rand(nb) < 0.3).astype(np.int32)
    rowsel[0], skip[0], skip[-1] = 0, 0, 1
    xt = torch.tensor(x)
    xq, xsc = quant.quantize_rows(xt)
    xerr = torch.linalg.norm(xt - quant.dequantize_rows(xq, xsc), dim=1)
    slabs = quant.quantized_candidate_slabs(
        quant.center_quant(torch.tensor(c)),
        pad_candidates(torch.tensor(cand), bkn).contiguous())
    return (xq, xsc, xerr, *slabs, torch.tensor(rowsel), torch.tensor(skip))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 784, 785])
@pytest.mark.parametrize("bkn", [4, 8])
@pytest.mark.parametrize("bn", [8, 16, 128])
def test_cuda_candidate_assign_int8_tiled(cuda, bn, bkn, d):
    r = 8
    args = [a.to(cuda) for a in _int8_inputs(bn * 6, 40, d, 12, bn, bkn,
                                             seed=bn + bkn + d)]
    before = _build.launches()["candidate_assign_int8_tiled"]
    got = candidate_assign_int8_tiled(*args, bn=bn, bkn=bkn, r=r)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_int8_tiled"] == before + 1
    want = ref.candidate_assign_int8_tiled_ref(*args, bn, r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    nsv = got[1].cpu()
    assert (nsv[:bn] > r).all(), "block 0 did not overflow the width"
    assert (nsv[-bn:] == 0).all() and (got[0][-bn:] == -1).all()


@pytest.mark.cuda
def test_cuda_candidate_assign_int8_tiled_wide_slab(cuda):
    """kn_pad = 384 at bn = 128: past the 333 columns that K4's
    shared-memory tile held before it walked kn_pad in chunks."""
    bn, r = 128, 8
    args = [a.to(cuda) for a in _int8_inputs(bn * 4, 400, 784, 384, bn, 8,
                                             seed=384)]
    assert args[4].shape[1] == 384
    got = candidate_assign_int8_tiled(*args, bn=bn, bkn=8, r=r)
    torch.cuda.synchronize()
    want = ref.candidate_assign_int8_tiled_ref(*args, bn, r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][:bn] > r).all(), "block 0 did not overflow the width"


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(1000, 333, 17), (4097, 1000, 784),
                                   (130, 65, 3072), (64, 1, 5),
                                   (700, 129, 784)])
def test_cuda_distance_argmin(cuda, n, k, d):
    rng = np.random.RandomState(n + k + d)
    x = torch.tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    c = torch.tensor(rng.randn(k, d).astype(np.float32), device=cuda)
    c[k // 2:k // 2 + 1] = c[:1]                # a duplicated center
    before = _build.launches()["distance_argmin"]
    got = distance_argmin(x, c)
    torch.cuda.synchronize()
    assert _build.launches()["distance_argmin"] == before + 1
    want = ref.distance_argmin_ref(x, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,kn,bn", [(256, 64, 48, 8, 64),
                                         (320, 100, 784, 30, 32),
                                         (96, 40, 3072, 5, 8)])
def test_cuda_candidate_assign_rowwise(cuda, n, k, d, kn, bn):
    rng = np.random.RandomState(n * kn)
    nb = n // bn
    t = lambda v: torch.tensor(v, device=cuda)   # noqa: E731
    args = (t(rng.randn(n, d).astype(np.float32)),
            t(rng.randn(k, d).astype(np.float32)),
            t(rng.randint(0, k, (nb, kn)).astype(np.int32)),
            t((np.arange(nb) % 3 == 1).astype(np.int32)),
            t(rng.randint(0, k, n).astype(np.int32)),
            t(np.full(n, 7.0, np.float32)))
    before = _build.launches()["candidate_assign_rowwise"]
    got = candidate_assign_rowwise(*args, bn=bn)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_rowwise"] == before + 1
    want = ref.candidate_assign_ref(*args, bn)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_lloyd_and_elkan_match_cpu(cuda):
    """A small Lloyd fit through K5 on the card against the plain CPU
    path from one init: the same trajectory; Elkan's first assignment on
    the card equals Lloyd's first."""
    rng = np.random.RandomState(3)
    mus = rng.randn(12, 20) * 6
    x = (mus[rng.randint(0, 12, 4000)] + rng.randn(4000, 20)).astype(
        np.float32)
    init = x[rng.permutation(4000)[:30]]
    first = {}
    out = {dev: fit_lloyd(x, init, max_iters=40, device=dev,
                          callback=lambda it, c, a, e, dev=dev:
                          first.setdefault(dev, a.cpu()))
           for dev in ("cpu", cuda)}
    assert out["cpu"].iterations == out[cuda].iterations
    assert torch.equal(out["cpu"].assignment, out[cuda].assignment.cpu())
    assert out[cuda].energy == pytest.approx(out["cpu"].energy, rel=1e-5)
    elkan0 = fit_elkan(x, init, max_iters=0, device=cuda)
    assert torch.equal(elkan0.assignment.cpu(), first[cuda])


@pytest.mark.cuda
def test_cuda_predict_matches_cpu(cuda):
    """A small served model on the card against the same model on the
    CPU: assignments, distances and charges in both precisions."""
    rng = np.random.RandomState(7)
    mus = rng.randn(16, 16) * 8
    x = (mus[rng.randint(0, 16, 3000)] + rng.randn(3000, 16)).astype(
        np.float32)
    q = (mus[rng.randint(0, 16, 1000)] + rng.randn(1000, 16)).astype(
        np.float32)
    init = x[rng.permutation(3000)[:24]]
    a0 = torch.cdist(torch.tensor(x), torch.tensor(init)).argmin(1)
    res = fit_k2means(x, init, a0.to(torch.int32), kn=8, max_iters=30,
                      device="cpu")
    models = {dev: KMeansModel.from_result(res, x, kn=8, device=dev)
              for dev in ("cpu", cuda)}
    for prec in ("f32", "int8"):
        out = {}
        for dev, model in models.items():
            counter = OpCounter()
            a, dist = model.predict(q, counter=counter, return_sqdist=True,
                                    batch_size=256, precision=prec)
            out[dev] = (a.cpu(), dist.cpu(), counter.distances,
                        counter.bytes_scanned)
        assert torch.equal(out["cpu"][0], out[cuda][0])
        assert torch.equal(out["cpu"][1], out[cuda][1])
        assert out["cpu"][2:] == out[cuda][2:]
