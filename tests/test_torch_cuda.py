"""Each CUDA kernel against its plain PyTorch version, on the card, and
the served model's predict on the card against the same model on the CPU.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use); without a card they
skip. They import no JAX, so they run on a machine that has only the
port's dependencies: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. Tolerances are those of the CPU parity
tests (tests/test_torch_kernels.py). K1, K5 and K7 correctly round their
f64 sums to f32 (a value no order of summation changes) and K4 rounds
after every operation, each like its plain version, so their assignments
and distances and K4's survivors, counts and lower bounds are held
bit-equal, also on rows built to sit at f32 rounding midpoints
(``data.rounding_fixture``). The rounding kernels of the torch paths and
the ordered segment sums are held bit-equal to their plain versions, K3
to its plain version on the CPU (where torch's cumsum adds in K3's
order) and to itself across launches, the whole fit to itself across
runs, and GDI plus k²-means to the CPU's. K6 carries an online softmax over
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

from repro_torch.core import (K2Step, KMeansModel, OpCounter,
                              center_knn_graph, fit, fit_elkan, fit_k2means,
                              fit_lloyd)
from repro_torch.core.gdi import gdi_device_init
from repro_torch.data import rounding_fixture
from repro_torch.kernels import _build, exact_round, quant, ref
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
from repro_torch.kernels.segment_sum import segment_sum_blocks
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d,kn,bn,bkn", [(256, 64, 48, 8, 64, 8),
                                             (320, 100, 784, 30, 32, 8),
                                             (512, 128, 16, 16, 128, 8),
                                             (256, 100, 784, 30, 8, 8),
                                             (512, 400, 100, 200, 128, 8),
                                             (2048, 500, 784, 30, 32, 8),
                                             (192, 64, 785, 12, 8, 4),
                                             (96, 40, 13, 40, 24, 8),
                                             (1024, 300, 256, 64, 16, 8),
                                             (384, 200, 3, 100, 64, 4)])
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
    want = ref.segmented_scan_ref(xg, w, b2s, bn)   # K3's order on the CPU
    for g, wv in zip(got, want):
        assert torch.equal(g.cpu(), wv)


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


def _rounding_cases(device):
    """Inputs on which f64 sums in different orders round apart: the
    rounding fixture, and rows over wide exponent ranges."""
    x, c, _ = rounding_fixture(300, 40, 96, seed=5, device=device)
    rng = np.random.RandomState(6)
    wide = lambda *s: (rng.randn(*s) * 2.0 ** rng.randint(  # noqa: E731
        -30, 30, s)).astype(np.float32)
    return [(x, c), (torch.tensor(wide(200, 64), device=device),
                     torch.tensor(wide(50, 64), device=device))]


@pytest.mark.cuda
def test_cuda_exact_round_matches_plain(cuda):
    """The torch paths' rounding kernels give the plain versions' values
    bit for bit, 2-d and batched, with no host read."""
    for x, c in _rounding_cases(cuda):
        before = _build.launches()
        assert torch.equal(exact_round.exact_sqnorm(x), ref.exact_sqnorm(x))
        assert torch.equal(exact_round.exact_cross(x, c.T),
                           ref.exact_cross(x, c.T))
        xb = x[:40].reshape(4, 10, -1)
        cb = c[torch.arange(32, device=cuda) % c.shape[0]].reshape(4, 8, -1)
        assert torch.equal(exact_round.exact_cross(xb, cb.transpose(1, 2)),
                           ref.exact_cross(xb, cb.transpose(1, 2)))
        after = _build.launches()
        assert after["exact_sqnorm"] == before["exact_sqnorm"] + 1
        assert after["exact_cross"] == before["exact_cross"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 96, 784])
def test_cuda_kernels_on_the_rounding_fixture(cuda, d):
    """K1, K5 and K7 are bit-equal to their plain versions on rows whose
    own-center products sit just above f32 rounding midpoints, and give
    each row's own pair its correctly rounded distance."""
    k = 64
    x, c, a = rounding_fixture(k * 40, k, d, seed=d, device=cuda)
    got = distance_argmin(x, c)
    want = ref.distance_argmin_ref(x, c)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    st = K2Step(k=k, kn=8, bkn=8).init_resident(
        x, torch.ones(x.shape[0], device=cuda), c, a)
    nb = st.b2c.shape[0]
    bn = st.pid.shape[0] // nb
    graph = center_knn_graph(c, 8)
    cidx = pad_candidates(graph, 8).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    rows = st.pid.shape[0]
    zi = torch.zeros(rows, dtype=torch.int32, device=cuda)
    zf = torch.zeros(rows, device=cuda)
    noskip = torch.zeros(nb, dtype=torch.int32, device=cuda)
    args = (st.xg, ctab, csqtab, cidx, rowsel, noskip, zi, zf, zf)
    for g, w in zip(candidate_assign_tiled(*args, bn=bn, bkn=8),
                    ref.candidate_assign_tiled_ref(*args, bn)):
        assert torch.equal(g, w)
    args7 = (st.xg, c, graph[rowsel.long()].contiguous(), noskip, zi, zf)
    for g, w in zip(candidate_assign_rowwise(*args7, bn=bn),
                    ref.candidate_assign_ref(*args7, bn)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,bn,weighted", [
    (5000, 784, 1, 32, False), (20000, 64, 300, 8, True),
    (3000, 3, 2000, 16, True), (4000, 129, 37, 128, False),
    (1875, 784, 2000, 1, True)])      # the engine's moved rows: bn = 1
def test_cuda_segment_sum_blocks_matches_cpu(cuda, n, d, k, bn, weighted):
    """The ordered block sums on the card are the CPU's row-order
    scatter-add bit for bit (values over six decades, so another order
    rounds differently), with and without weights and a row map."""
    rng = np.random.RandomState(n + d)
    v = rng.randn(n, d) * 10.0 ** rng.randint(-3, 4, (n, 1))
    x = torch.tensor(v.astype(np.float32))
    a = torch.tensor(rng.randint(0, k, n).astype(np.int32))
    perm, b2s = group_by_cluster_device(a, k, bn)
    w = (torch.tensor(rng.rand(perm.shape[0]).astype(np.float32))
         * (perm >= 0)) if weighted else None
    want = segment_sum_blocks(x, b2s, k, bn, w=w, perm=perm)
    on = lambda t: None if t is None else t.to(cuda)  # noqa: E731
    got = segment_sum_blocks(x.to(cuda), b2s.to(cuda), k, bn, w=on(w),
                             perm=perm.to(cuda))
    for g, wv in zip(got, want):
        assert torch.equal(g.cpu(), wv)
    if not weighted:
        assert torch.equal(want[0], ref.segment_sum_blocks_ref(
            x, b2s, k, bn, perm=perm)[0])
        assert torch.equal(want[0], torch.zeros(k, d).index_add_(
            0, a.long(), x))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,bn", [(64000, 64, 1, 32),
                                      (64000, 784, 700, 32),
                                      (30000, 1030, 3, 24)])
def test_cuda_segmented_scan_is_reproducible(cuda, n, d, k, bn):
    """K3's look-back folds forward from the prefix it meets, so two
    launches on one input are bit-equal however far each walk went."""
    rng = np.random.RandomState(d)
    x = torch.tensor(rng.randn(n, d).astype(np.float32), device=cuda)
    a = torch.tensor(rng.randint(0, k, n).astype(np.int32), device=cuda)
    perm, b2s = group_by_cluster_device(a, k, bn)
    xg = x[perm.clamp(min=0).long()].contiguous()
    w = (perm >= 0).float()
    first = segmented_scan(xg, w, b2s, bn=bn)
    for _ in range(4):
        for g, f in zip(segmented_scan(xg, w, b2s, bn=bn), first):
            assert torch.equal(g, f)


def _tied_blobs(n, d, k, seed, spread=12.0):
    """Integer-valued blobs with every fifth row repeated: exact ties
    between rows and between their distances."""
    rng = np.random.RandomState(seed)
    mus = np.round(rng.randn(k, d) * spread)
    x = np.round(mus[rng.randint(0, k, n)] + rng.randn(n, d) * 1.5)
    x[::5] = x[1::5][:len(x[::5])]
    return x.astype(np.float32)


@pytest.mark.cuda
def test_cuda_gdi_fit_is_reproducible(cuda):
    """Two k²-means fits from GDI on the card, from one generator seed,
    are bit-identical: assignments, centers, energy, iterations."""
    x = torch.tensor(_tied_blobs(20000, 64, 40, 1), device=cuda)
    runs = [fit(x, 200, method="k2means", init="gdi", kn=16, max_iters=30,
                device=cuda, generator=torch.Generator(device=cuda)
                .manual_seed(3)) for _ in range(2)]
    assert torch.equal(runs[0].assignment, runs[1].assignment)
    assert torch.equal(runs[0].centers, runs[1].centers)
    assert runs[0].energy == runs[1].energy
    assert runs[0].iterations == runs[1].iterations


@pytest.mark.cuda
def test_cuda_gdi_fit_matches_cpu(cuda):
    """GDI (the same uniform draws on both devices) then k²-means, on the
    card and on the CPU, at a small shape with tied rows and k = 4x the
    number of blobs, so that GDI splits blobs where rows score within
    rounding of each other: identical GDI and k²-means assignments and
    iterations, energy within rel 1e-5. GDI's projections and split
    scores are correctly rounded and K3 sums in one fixed order, so the
    two devices split alike."""
    x = _tied_blobs(3000, 16, 12, 2)
    rng = np.random.RandomState(9)
    draws = [(rng.rand(3000).astype(np.float32),
              rng.rand(3000).astype(np.float32)) for _ in range(200)]
    out = {}
    for dev in ("cpu", cuda):
        c0, a0 = gdi_device_init(x, 48, draws=draws, device=dev)
        out[dev] = (a0.cpu(), fit_k2means(x, c0, a0, kn=8, max_iters=30,
                                          device=dev))
    assert torch.equal(out["cpu"][0], out[cuda][0])
    r_cpu, r_gpu = out["cpu"][1], out[cuda][1]
    assert r_cpu.iterations == r_gpu.iterations
    assert torch.equal(r_cpu.assignment, r_gpu.assignment.cpu())
    assert r_gpu.energy == pytest.approx(r_cpu.energy, rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(5000, 40, 784), (777, 3, 17),
                                   (3000, 12, 1030)])
def test_cuda_exact_rowdot_matches_plain(cuda, n, m, d):
    """GDI's projections through the kernel: bit-equal to the plain
    version, also on rows built to sit at f32 rounding midpoints."""
    x, c, a = rounding_fixture(n, m, d, seed=d, device="cpu")
    want = ref.exact_rowdot(x, c, a)
    got = exact_round.exact_rowdot(x.to(cuda), c.to(cuda), a.to(cuda))
    assert torch.equal(got.cpu(), want)
