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
and lower bounds are held bit-equal. K6 carries an online softmax over
tiles of 64 rows where its plain version takes one softmax over all
slots, and sums its dot products in another order: its m, and its l
rescaled to the plain version's max, are held to rtol 1e-5; its acc,
rescaled the same way, to 1e-5 times the row's sum of w |v| plus 1e-6,
since acc sums terms of both signs and its error scales with their
magnitudes, not with the sum; empty rows exactly.
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
from repro_torch.kernels.cluster_attend import cluster_attend_partial
from repro_torch.kernels.distance_argmin import distance_argmin
from repro_torch.kernels.ops import (group_by_cluster_device,
                                     segment_sum_ordered)
from repro_torch.kernels.segmented_scan import segmented_scan
from repro_torch.models.attention import cluster_major_decode_attention


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
@pytest.mark.parametrize("n,d,k,bn", [
    (100, 5, 7, 8), (2000, 784, 20, 32),
    (64000, 784, 1, 32),          # one segment over 2,000 blocks: long chains
    (3000, 3, 2000, 8),           # many singleton and short segments
    (3000, 3072, 5, 128),         # d over three 1024-column slices
    (1500, 1030, 9, 24)])         # 4-byte copies over two slices; bn = 3 * 8
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
@pytest.mark.parametrize("n,k,d,dups", [
    (1000, 333, 17, (166,)), (4097, 1000, 784, (500,)),
    (130, 65, 3072, (32,)), (64, 1, 5, ()), (700, 129, 784, (64,)),
    (8193, 1000, 784, (1, 700)),  # in center 0's warp tile and another tile
    (517, 260, 33, (130,))])      # d no multiple of the MMA depth or chunk
def test_cuda_distance_argmin(cuda, n, k, d, dups):
    """Bit-equal to the plain version; center 0 is copied to the indices
    ``dups`` and one row of x equals it, so that row ties at distance 0
    and must go to index 0."""
    rng = np.random.RandomState(n + k + d)
    x = torch.tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    c = torch.tensor(rng.randn(k, d).astype(np.float32), device=cuda)
    for i in dups:
        c[i] = c[0]
    x[n // 3] = c[0]
    before = _build.launches()["distance_argmin"]
    got = distance_argmin(x, c)
    torch.cuda.synchronize()
    assert _build.launches()["distance_argmin"] == before + 1
    want = ref.distance_argmin_ref(x, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][n // 3]) == 0 and float(got[1][n // 3]) == 0.0


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
@pytest.mark.parametrize("n,d,k", [(100000, 0, 3), (100000, 1, 3),
                                   (100000, 20, 30), (20000, 784, 1000)])
def test_cuda_segment_sum_ordered_matches_cpu(cuda, n, d, k):
    """Lloyd's center sums on the card are the CPU's bit for bit: each
    segment's rows are added in row order (many rows per segment, values
    over six decades, so any other order rounds differently). d=0: rows
    of one value, a 1-D input."""
    rng = np.random.RandomState(11)
    v = rng.randn(n, max(d, 1)) * 10.0 ** rng.randint(-3, 4, (n, 1))
    v = torch.tensor(v.astype(np.float32))
    v = v[:, 0] if d == 0 else v
    seg = torch.tensor(rng.randint(0, k, n))
    want = segment_sum_ordered(v, seg, k)
    got = segment_sum_ordered(v.to(cuda), seg.to(cuda), k)
    assert torch.equal(got.cpu(), want)


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


def _attend_inputs(bh, rows, cap, dh, p, dtype, seed, device):
    """Random tables with ragged sizes (some 0, some full), random
    selections, and row 0 selecting only empty blocks."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(0, cap + 1, rows).astype(np.int32)
    sizes[:3] = 0
    sizes[3:6] = cap
    sel = rng.randint(0, rows, (bh, p)).astype(np.int32)
    sel[0] = rng.randint(0, 3, p)
    valid = (np.arange(cap)[None, :] < sizes[:, None]).astype(np.int32)
    t = lambda a, dt=None: torch.tensor(a, device=device, dtype=dt)  # noqa
    return (t(rng.randn(bh, dh).astype(np.float32)),
            t(rng.randn(rows, cap, dh).astype(np.float32), dtype),
            t(rng.randn(rows, cap, dh).astype(np.float32), dtype),
            t(sel), t(sizes), t(valid))


def _assert_state_close(got, want, acc_abs):
    """K6's state against its plain version's: m within rtol 1e-5, l and
    acc after rescaling to the plain max within rtol 1e-5, acc with atol
    1e-5 times the row's sum of w |v| (``acc_abs``: acc over |v|, the
    scale of its cancellation); empty rows exactly (-inf, 0, 0)."""
    m, l, acc = got
    m_p, l_p, acc_p = want
    empty = torch.isinf(m_p)
    assert torch.equal(torch.isinf(m), empty)
    assert (l[empty] == 0).all() and (acc[empty] == 0).all()
    live = ~empty
    torch.testing.assert_close(m[live], m_p[live], rtol=1e-5, atol=1e-6)
    rescale = torch.exp(m[live] - m_p[live])
    torch.testing.assert_close(l[live] * rescale, l_p[live], rtol=1e-5,
                               atol=0.0)
    err = (acc[live] * rescale[:, None] - acc_p[live]).abs()
    assert (err <= 1e-5 * acc_abs[live] + 1e-6).all(), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 20, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("form", ["sizes", "valid"])
def test_cuda_cluster_attend(cuda, dh, dtype, form):
    q, kt, vt, sel, sizes, valid = _attend_inputs(37, 96, 100, dh, 5, dtype,
                                                  dh, cuda)
    if form == "valid":                  # a mask that is not a prefix
        holes = torch.rand(valid.shape, device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
        valid = valid * (holes > 0.3).to(torch.int32)
    kw = {form: sizes if form == "sizes" else valid}
    _build.reset_launches()
    got = cluster_attend_partial(q, kt, vt, sel, **kw)
    torch.cuda.synchronize()
    assert _build.launches()["cluster_attend"] == 1
    want = ref.cluster_attend_ref(q, kt, vt, sel, **kw)
    _assert_state_close(got, want,
                        ref.cluster_attend_ref(q, kt, vt.abs(), sel, **kw)[2])
    assert torch.isinf(got[0][0]) and got[1][0] == 0


@pytest.mark.cuda
def test_cuda_cluster_attend_decode_shape(cuda):
    """The decode shape's cap and p with real-sized rows (dh 128, bf16),
    both validity forms giving the same state."""
    q, kt, vt, sel, sizes, valid = _attend_inputs(64, 512, 512, 128, 16,
                                                  torch.bfloat16, 3, cuda)
    a = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    b = cluster_attend_partial(q, kt, vt, sel, valid=valid)
    _assert_state_close(a, ref.cluster_attend_ref(q, kt, vt, sel,
                                                  sizes=sizes),
                        ref.cluster_attend_ref(q, kt, vt.abs(), sel,
                                               sizes=sizes)[2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_cluster_major_decode_attention_matches_cpu(cuda):
    """The k²-attention decode step on the card (one K6 launch) against
    the same step on the CPU (plain version), with ring and self token."""
    rng = np.random.RandomState(5)
    B, Hkv, g, kc, cap, dh, R, p = 2, 4, 4, 32, 64, 128, 16, 4
    sizes = rng.randint(0, cap + 1, (B, Hkv, kc)).astype(np.int32)
    arrays = [rng.randn(B, Hkv * g, dh), rng.randn(B, Hkv, kc, cap, dh),
              rng.randn(B, Hkv, kc, cap, dh), rng.randn(B, Hkv, kc, dh),
              sizes, rng.randn(B, Hkv, R, dh), rng.randn(B, Hkv, R, dh),
              np.int32(5), rng.randn(B, Hkv, dh), rng.randn(B, Hkv, dh)]
    out = {}
    for dev in ("cpu", cuda):
        t = [torch.tensor(a, device=dev) for a in arrays]
        # bf16 tables, ring and self rows; f32 queries and centroids, so
        # that no bf16 near-tie can select other clusters on the card
        t = [x.to(torch.bfloat16) if i in (1, 2, 5, 6, 8, 9)
             else x.float() if x.is_floating_point() else x
             for i, x in enumerate(t)]
        _build.reset_launches()
        out[dev] = cluster_major_decode_attention(
            t[0], t[1], t[2], t[3], t[4], p, self_kv=(t[8], t[9]),
            ring=(t[5], t[6], t[7]))
        torch.cuda.synchronize()
        assert _build.launches()["cluster_attend"] == (dev == cuda)
    torch.testing.assert_close(out[cuda].cpu(), out["cpu"], rtol=1e-5,
                               atol=1e-5)
