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
runs, and GDI plus k²-means to the CPU's. K6 carries an online softmax
per warp over its tiles, merged across warps and across the CUDA blocks
that split a row's blocks in a fixed order, where its plain version
takes one softmax over all slots, and sums its dot products in another
order (so it is held bit-identical to itself and across its two
validity forms, and within tolerances of its plain version): its m, and its l
rescaled to the plain version's max, are held to rtol 1e-5; its acc,
rescaled the same way, to 1e-5 times the row's sum of w |v| plus 1e-6,
since acc sums terms of both signs and its error scales with their
magnitudes, not with the sum; empty rows exactly.
"""
import pathlib
import sys

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
from repro_torch.kernels.ssm_scan import ssd_scan, wkv6_scan
from repro_torch.models.attention import cluster_major_decode_attention

ROOT = pathlib.Path(__file__).resolve().parents[1]


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


def _k2_centers(case, k, d):
    if case == "midpoint":     # rows and their centers: products at midpoints
        x, c, _ = rounding_fixture(k - k // 5, k // 5, d, seed=k,
                                   device="cpu")
        return torch.cat([x, c])
    if case == "mixture":      # many close pairs: lists decided by rounding
        rng = np.random.RandomState(k)
        mus = rng.randn(128, d) * 4.0
        return torch.tensor((mus[rng.randint(0, 128, k)]
                             + rng.randn(k, d)).astype(np.float32))
    return torch.tensor(np.random.RandomState(k).randn(k, d)
                        .astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("case,k,d", [("normal", 100, 784),
                                      ("normal", 1000, 64),
                                      ("normal", 64, 3),
                                      ("normal", 997, 784),   # no tile fits
                                      ("normal", 1, 5),
                                      ("normal", 130, 13),    # d % 4 != 0
                                      ("midpoint", 200, 784),
                                      ("midpoint", 95, 40),
                                      ("mixture", 1000, 784)])
def test_cuda_center_sqdist(cuda, case, k, d):
    """K2 on the card is its plain version on the CPU bit for bit, and so
    is the k_n-NN graph built on it."""
    c = _k2_centers(case, k, d)
    before = _build.launches()["center_sqdist"]
    got = center_sqdist(c.to(cuda))
    torch.cuda.synchronize()
    assert _build.launches()["center_sqdist"] == before + 1
    want = center_sqdist(c)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(ref.center_sqdist_ref(c.to(cuda)), got)
    kn = min(30, k)
    assert torch.equal(center_knn_graph(c.to(cuda), kn).cpu(),
                       center_knn_graph(c, kn))


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
@pytest.mark.parametrize("d", [784, 785, 788])
@pytest.mark.parametrize("kn", [30, 60, 384])
@pytest.mark.parametrize("bn", [8, 128])
def test_cuda_candidate_assign_int8_tiled_layouts(cuda, bn, kn, d):
    """K4 bit-equal to its plain version at kn_pad 32, 64 and 384 (one
    pass over the slab, or a pass for the min and one for the survivors)
    with 16-byte (d = 784) and byte (785, 788) copies, over 7 point
    blocks: not a multiple of the units a CUDA block takes."""
    r = 16
    args = [a.to(cuda) for a in _int8_inputs(bn * 7, 400, d, kn, bn, 8,
                                             seed=bn + kn + d)]
    assert args[4].shape[1] == -(-kn // 8) * 8
    _build.reset_launches()
    got = candidate_assign_int8_tiled(*args, bn=bn, bkn=8, r=r)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_int8_tiled"] == 1
    want = ref.candidate_assign_int8_tiled_ref(*args, bn, r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][:bn] > r).all(), "block 0 did not overflow the width"
    assert (got[1][-bn:] == 0).all() and (got[0][-bn:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [8, 128])
def test_cuda_candidate_assign_int8_tiled_all_skipped(cuda, bn):
    """Every block skipped: (-1, 0, PAD_SQDIST) for every row, as the plain
    version gives."""
    args = [a.to(cuda) for a in _int8_inputs(bn * 5, 40, 784, 12, bn, 8,
                                             seed=bn)]
    args[-1] = torch.ones_like(args[-1])
    got = candidate_assign_int8_tiled(*args, bn=bn, bkn=8, r=8)
    torch.cuda.synchronize()
    want = ref.candidate_assign_int8_tiled_ref(*args, bn, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[0] == -1).all() and (got[1] == 0).all()
    assert (got[2] == ref.PAD_SQDIST).all()


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


def _rowwise_inputs(case, bn, kn, d):
    """K7's arguments (numpy) for one contract case: random lists
    ("random"); ids named twice ("dups"); two ids with equal rows, the
    larger id first, nearest every row ("equal_rows"); such a pair at
    positions 31 and 32, either side of a chunk's end ("chunk_tie");
    ``data.rounding_fixture`` rows, each block's list led by its rows' own
    centers, whose products sit at f32 rounding midpoints ("fixture");
    such rows of one center, copied to two ids named in turn, so that every
    pair goes to the exact recompute, more than the kernel's flag list
    holds for a chunk, and the first entry must win ("flush"); every other
    row with |x|^2 on an f32 rounding midpoint, which sends all its pairs
    there ("midpoint"). Every third block is skipped. Returns (x, c, cand,
    skip, prev_a, prev_d, (position, id) that must win, or None)."""
    rng = np.random.RandomState(bn * 1000 + kn * 10 + d)
    nb = 37 if bn == 1 else 4
    n, k = nb * bn, 200
    if case == "fixture":
        x, c, a = (v.numpy() for v in rounding_fixture(n, 64, d, seed=d,
                                                       device="cpu"))
        k = 64
        cand = rng.randint(0, k, (nb, kn)).astype(np.int32)
        own = a.reshape(nb, bn)[:, :kn]
        cand[:, :own.shape[1]] = own
    elif case == "flush":
        x, c, _ = (v.numpy() for v in rounding_fixture(n, 1, d, seed=d,
                                                       device="cpu"))
        c, k = np.concatenate([c, c]), 2
        cand = np.tile(1 - np.arange(kn) % 2, (nb, 1)).astype(np.int32)
    else:
        x = rng.randn(n, d).astype(np.float32)
        c = rng.randn(k, d).astype(np.float32)
        cand = rng.randint(0, k, (nb, kn)).astype(np.int32)
    wins = (0, 1) if case == "flush" else None
    if case == "midpoint":              # |x|^2 = s^2 (1 + 2^-24)
        for i in range(0, n, 2):
            j, s = rng.randint(0, d - 1), 2.0 ** rng.randint(-3, 4)
            x[i] = 0.0
            x[i, j], x[i, j + 1] = s, s * 2.0 ** -12
    if case == "dups":
        cand = rng.randint(0, max(2, kn // 3), (nb, kn)).astype(np.int32)
    elif case in ("equal_rows", "chunk_tie"):
        p1, p2 = (31, 32) if case == "chunk_tie" else (kn // 3, 2 * kn // 3)
        j1, j2 = 150, 7                 # the larger id comes first
        c[j2] = c[j1]
        cand[(cand == j1) | (cand == j2)] = 3     # named nowhere else
        cand[:, p1], cand[:, p2] = j1, j2
        x = (c[j1] + 0.01 * rng.randn(n, d)).astype(np.float32)
        wins = (p1, j1)
    skip = (np.arange(nb) % 3 == 1).astype(np.int32)
    prev_a = rng.randint(0, k, n).astype(np.int32)
    prev_d = np.full(n, 7.0, np.float32)
    return x, c, cand, skip, prev_a, prev_d, wins


def _offset(t):
    """``t`` copied into a view that starts one float past a 16-byte
    boundary: contiguous, but only the 4-byte copies may read it."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    v = buf[1:1 + t.numel()].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 == 4
    return v


_ROWWISE_CASES = (
    [("random", bn, kn, d) for bn in (1, 8, 32, 128, 256)
     for kn in (1, 30, 33, 100) for d in (3, 48, 784, 785, 3072)]
    + [("dups", 32, 30, 784), ("dups", 256, 33, 48), ("dups", 1, 100, 785),
       ("equal_rows", 8, 33, 785), ("equal_rows", 128, 100, 48),
       ("equal_rows", 256, 30, 3),
       ("chunk_tie", 32, 33, 784), ("chunk_tie", 256, 100, 3),
       ("chunk_tie", 1, 64, 785), ("chunk_tie", 8, 33, 48),
       ("offset_x", 32, 30, 784), ("offset_x", 8, 33, 48),
       ("offset_x", 256, 100, 3072), ("offset_c", 32, 30, 784),
       ("fixture", 8, 30, 784), ("fixture", 32, 33, 784),
       ("fixture", 256, 30, 96), ("fixture", 1, 30, 785),
       ("random", 16, 30, 784), ("random", 64, 33, 785),
       ("random", 32, 300, 784), ("dups", 8, 300, 48),
       ("equal_rows", 64, 300, 785), ("chunk_tie", 16, 33, 784),
       ("flush", 32, 40, 784), ("flush", 64, 100, 96),
       ("flush", 16, 300, 48), ("flush", 256, 33, 785),
       ("midpoint", 32, 33, 784), ("midpoint", 64, 30, 48),
       ("midpoint", 8, 300, 785), ("midpoint", 256, 100, 3072)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,bn,kn,d", _ROWWISE_CASES)
def test_cuda_candidate_assign_rowwise(cuda, case, bn, kn, d):
    """K7 bit-equal to its plain version over its contract (any bn, kn
    and d, ids named twice, equal rows, ties either side of a chunk's
    end, unaligned rows, rows at f32 rounding midpoints, more undecided
    pairs than one chunk's flag list holds, lists read from global memory
    above 256 entries), the first of two equal entries winning, and two
    launches bit-identical."""
    *inp, wins = _rowwise_inputs(case, bn, kn, d)
    args = [torch.tensor(v, device=cuda) for v in inp]
    if case == "offset_x":
        args[0] = _offset(args[0])
    elif case == "offset_c":
        args[1] = _offset(args[1])
    before = _build.launches()["candidate_assign_rowwise"]
    got = candidate_assign_rowwise(*args, bn=bn)
    again = candidate_assign_rowwise(*args, bn=bn)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_rowwise"] == before + 2
    want = ref.candidate_assign_ref(*args, bn)
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(h, g)
    if wins is not None:
        live = np.repeat(inp[3] == 0, bn)
        assert (got[0].cpu().numpy()[live] == wins[1]).all()


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
@pytest.mark.parametrize("dh", [16, 20, 64, 112, 128])
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh", [16, 64])
@pytest.mark.parametrize("p", [1, 16, 17, 40])
def test_cuda_cluster_attend_splits(cuda, p, bh, dtype):
    """Each row's p blocks split over several CUDA blocks (p = 17 and 40
    do not divide into the split), with ids outside [0, rows) skipped and
    rows whose blocks are all empty: one launch and one count per call,
    two launches bit-identical, the sizes and valid forms equal, and the
    state within the plain version's tolerances (an out-of-range id
    stands there for an empty block)."""
    rows = 300
    q, kt, vt, sel, sizes, valid = _attend_inputs(bh, rows, 96, 128, p,
                                                  dtype, p + bh, cuda)
    sel[1, 0] = -1
    sel[2, -1] = rows
    sel[3] = rows + 7                      # every id out of range
    _build.reset_launches()
    a = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    b = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    c = cluster_attend_partial(q, kt, vt, sel, valid=valid)
    torch.cuda.synchronize()
    assert _build.launches()["cluster_attend"] == 3
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    sel_p = torch.where((sel >= 0) & (sel < rows), sel, 0)   # block 0 empty
    _assert_state_close(a, ref.cluster_attend_ref(q, kt, vt, sel_p,
                                                  sizes=sizes),
                        ref.cluster_attend_ref(q, kt, vt.abs(), sel_p,
                                               sizes=sizes)[2])
    for i in (0, 3):
        assert torch.isinf(a[0][i]) and a[1][i] == 0 and (a[2][i] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_cluster_attend_wholly_remote_selection(cuda, dtype):
    """The sharded decode's selections (``attention.
    cluster_major_decode_attention(mesh=)``): a rank's local table rows,
    -1 for a cluster another rank holds, and heads whose whole selection
    is remote. The kernel against its plain version, which skips the
    same ids: those heads exactly (-inf, 0, 0), the others within the
    plain version's tolerances."""
    bh, rows, p = 64, 2 * 8 * 64, 16           # B=2, Hkv=8, kc/4 = 64
    q, kt, vt, sel, sizes, _ = _attend_inputs(bh, rows, 128, 128, p, dtype,
                                              11, cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    remote = torch.rand(sel.shape, device=cuda, generator=gen) < 0.75
    sel = torch.where(remote, -1, sel)
    sel[5:9] = -1                              # wholly remote heads
    _build.reset_launches()
    got = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    torch.cuda.synchronize()
    assert _build.launches()["cluster_attend"] == 1
    want = ref.cluster_attend_ref(q, kt, vt, sel, sizes=sizes)
    _assert_state_close(got, want, ref.cluster_attend_ref(
        q, kt, vt.abs(), sel, sizes=sizes)[2])
    for i in range(5, 9):
        assert torch.isinf(got[0][i]) and got[1][i] == 0
        assert (got[2][i] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("p", [3, 16, 40])
def test_cuda_cluster_attend_rows_independent_of_batch(cuda, p, dtype):
    """A row's state does not depend on the rows batched with it: the
    same rows at bh = 64, 16, 2 and 1 (and in reverse order) give the same
    bits, since the split of a row's blocks follows p alone."""
    q, kt, vt, sel, sizes, _ = _attend_inputs(64, 300, 96, 128, p, dtype,
                                              p + 1, cuda)
    whole = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    for rows in (torch.arange(16), torch.arange(5, 7), torch.arange(9, 10),
                 torch.arange(63, -1, -1)):
        rows = rows.to(cuda)
        part = cluster_attend_partial(q[rows].contiguous(), kt, vt,
                                      sel[rows].contiguous(), sizes=sizes)
        for x, y in zip(part, whole):
            assert torch.equal(x, y[rows])


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


def _cross_cases(device):
    """(a, b) pairs for ``exact_cross``, each with products at f32 rounding
    midpoints or over wide exponent ranges: the rounding cases; d = 784
    with m and k off the kernel's tiles (k > 64 and k <= 64, the router's
    width); an odd d; a's rows strided (4-byte copies); batched."""
    cases = []
    for x, c in _rounding_cases(device):
        cases.append((x, c.T))
        xb = x[:40].reshape(4, 10, -1)
        cb = c[torch.arange(32, device=device) % c.shape[0]].reshape(4, 8, -1)
        cases.append((xb, cb.transpose(1, 2)))
    x, c, _ = rounding_fixture(333, 1000, 784, seed=8, device=device)
    cases += [(x, c.T), (x, c[:63].T)]
    x, c, _ = rounding_fixture(130, 129, 97, seed=9, device=device)
    cases += [(x, c.T), (x.T.contiguous().T, c.T),
              (x[:120].reshape(3, 40, 97), c[:90].reshape(3, 30, 97)
               .transpose(1, 2))]
    return cases


@pytest.mark.cuda
def test_cuda_exact_round_matches_plain(cuda):
    """The torch paths' rounding kernels give the plain versions' values
    bit for bit, 2-d and batched, at any strides and off the tile sizes,
    with the squared norms given or not, and with no host read."""
    for x, c in _rounding_cases(cuda):
        before = _build.launches()
        assert torch.equal(exact_round.exact_sqnorm(x), ref.exact_sqnorm(x))
        assert _build.launches()["exact_sqnorm"] == before["exact_sqnorm"] + 1
    for a, b in _cross_cases(cuda):
        before = _build.launches()["exact_cross"]
        want = ref.exact_cross(a, b)
        assert torch.equal(exact_round.exact_cross(a, b), want)
        if a.dim() == 2:
            asq = exact_round.exact_sqnorm(a)
            bsq = exact_round.exact_sqnorm(b.T)
            assert torch.equal(exact_round.exact_cross(a, b, asq=asq), want)
            assert torch.equal(exact_round.exact_cross(a, b, asq=asq,
                                                       bsq=bsq), want)
        assert _build.launches()["exact_cross"] == before + (
            3 if a.dim() == 2 else 1)


@pytest.mark.cuda
def test_cuda_exact_cross_runs_no_library_product(cuda):
    """``exact_cross`` of f32 operands on the card is its own kernel: no
    torch matmul and no copy of an operand (in f64 or otherwise)."""
    from torch.profiler import ProfilerActivity, profile
    x, c, _ = rounding_fixture(512, 100, 784, seed=3, device=cuda)
    exact_round.exact_cross(x, c.T)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exact_round.exact_cross(x, c.T)
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::matmul", "aten::mm", "aten::bmm",
                      "aten::_to_copy", "aten::copy_"}, ops


def _split_inputs(case, device):
    """GDI's sweep inputs (K3's prefix sums ``csum``, the leaf totals at
    each leaf's last row, ``row_seg``) at d = 784, d = 23 (scalar loads)
    and on rows 4 bytes off 16-byte alignment; half the leaves empty and
    a third of the rows at weight 0 in ``sparse``; ``midpoint``: rows
    whose sum of squares sits at or beside an f32 midpoint, as ``csum =
    -row`` with a zero ``tot``."""
    if case == "midpoint":
        rows = np.zeros((4, 784), np.float32)
        g = 2.0 ** -12
        for i, terms in enumerate([(1.0, g), (1.0, g, g, g),
                                   (1.0, g, 2.0 ** -40),
                                   (1.0, g, g, g * (1.0 - 2.0 ** -23))]):
            rows[i, :len(terms)] = terms
        return (-torch.tensor(rows, device=device),
                torch.zeros(1, 784, device=device),
                torch.zeros(4, dtype=torch.int64, device=device))
    d = {"d784": 784, "d23": 23, "unaligned": 788, "sparse": 784}[case]
    rng = np.random.RandomState(d)
    n, k, bn = 6000, 120, 8
    x = torch.tensor((rng.randn(n, d) * 10.0 ** rng.randint(-3, 4, (n, 1)))
                     .astype(np.float32))
    a = torch.tensor(rng.randint(0, k // 2 if case == "sparse" else k, n)
                     .astype(np.int32))
    perm, b2s = group_by_cluster_device(a, k, bn)
    w = (perm >= 0).float()
    if case == "sparse":
        w = w * torch.tensor(rng.rand(w.shape[0]) > 0.33).float()
    csum = ref.segmented_scan_ref(x[perm.clamp(min=0).long()], w, b2s,
                                  bn)[0]
    row_seg = torch.repeat_interleave(b2s.long(), bn)
    last = torch.full((k,), -1, dtype=torch.int64).scatter_reduce_(
        0, row_seg, torch.arange(row_seg.shape[0]), "amax")
    tot = torch.where((last >= 0)[:, None], csum[last.clamp(min=0)], 0.0)
    if case == "unaligned":
        buf = torch.empty(csum.numel() + 1, device=device)
        buf[1:] = csum.reshape(-1).to(device)
        return buf[1:].view(csum.shape), tot.to(device), row_seg.to(device)
    return csum.to(device), tot.to(device), row_seg.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d784", "d23", "unaligned", "sparse",
                                  "midpoint"])
def test_cuda_exact_split_sqnorms_matches_plain(cuda, case):
    """GDI's split-score norms in one pass: bit-equal to the plain
    two-call composition, on every row (padding rows, empty leaves, rows
    at f32 midpoints), one launch a call."""
    csum, tot, row_seg = _split_inputs(case, cuda)
    before = _build.launches()["exact_split_sqnorms"]
    got = exact_round.exact_split_sqnorms(csum, tot, row_seg)
    assert _build.launches()["exact_split_sqnorms"] == before + 1
    want = ref.exact_split_sqnorms(csum, tot, row_seg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
@pytest.mark.parametrize("shuffled", [False, True])
def test_cuda_segment_sum_blocks_skewed(cuda, shuffled):
    """One segment of 20,000 slots beside 999 short ones (1 to 20 rows),
    with the layout's blocks in cluster order or shuffled over the whole
    arena (as repairs leave it): the card's sums are the plain version's
    bit for bit."""
    rng = np.random.RandomState(20000 + shuffled)
    k, d, bn = 1000, 784, 32
    a = np.concatenate([np.zeros(20000, np.int32),
                        np.repeat(np.arange(1, k, dtype=np.int32),
                                  rng.randint(1, 21, k - 1))])
    a = torch.tensor(rng.permutation(a))
    n = a.shape[0]
    x = torch.tensor((rng.randn(n, d) * 10.0 ** rng.randint(-3, 4, (n, 1)))
                     .astype(np.float32))
    perm, b2s = group_by_cluster_device(a, k, bn)
    if shuffled:
        order = torch.tensor(rng.permutation(b2s.shape[0]))
        b2s = b2s[order].contiguous()
        perm = perm.reshape(-1, bn)[order].reshape(-1).contiguous()
    w = torch.tensor(rng.rand(perm.shape[0]).astype(np.float32)) * (perm >= 0)
    want = segment_sum_blocks(x, b2s, k, bn, w=w, perm=perm)
    before = _build.launches()["segment_sum_blocks"]
    got = segment_sum_blocks(x.to(cuda), b2s.to(cuda), k, bn, w=w.to(cuda),
                             perm=perm.to(cuda))
    assert _build.launches()["segment_sum_blocks"] == before + 1
    for g, wv in zip(got, want):
        assert torch.equal(g.cpu(), wv)


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


def _stream_model(dev, **kw):
    """A small served model over integer-valued blobs (the streaming
    tests' shape: n=256, d=8, k=8), built from one CPU fit on ``dev``."""
    rng = np.random.RandomState(5)
    mus = rng.randn(8, 8) * 8
    x = np.round(mus[rng.randint(0, 8, 256)]
                 + rng.randn(256, 8) * 2).astype(np.float32)
    init = x[:8]
    a0 = torch.cdist(torch.tensor(x), torch.tensor(init)).argmin(1)
    res = fit_k2means(x, init, a0.to(torch.int32), kn=4, max_iters=10,
                      device="cpu")
    return KMeansModel.from_result(res, x, kn=4, device=dev, **kw)


def _stream_batches(nb, shift=30.0):
    rng = np.random.RandomState(6)
    ramp = np.linspace(0.0, shift, nb).astype(np.float32)
    return [np.round(rng.randn(32, 8) * 4).astype(np.float32) + ramp[i]
            for i in range(nb)]


@pytest.mark.cuda
def test_cuda_top2_matches_plain(cuda):
    """K1 with its second output (the stream bounds' resolution) on the
    card: ids and both distances bit-equal to the plain version."""
    from repro_torch.kernels.ops import bounded_predict_assign_top2
    model = _stream_model("cpu")
    q = torch.tensor(np.random.RandomState(3).randn(700, 8) * 8,
                     dtype=torch.float32)
    routed = model.route(q)
    want = bounded_predict_assign_top2(q, model.centers, model.neighbors,
                                       routed, bn=8)
    got = bounded_predict_assign_top2(q.to(cuda), model.centers.to(cuda),
                                      model.neighbors.to(cuda),
                                      routed.to(cuda), bn=8)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [1.0, 2.0 ** -0.125])
def test_cuda_eviction_delta_matches_cpu(cuda, decay):
    """``engine.resident_evict`` on the card (``segment_sum_blocks`` with
    the decayed weights, 0 on the slots it keeps) gives the CPU's sums,
    counts and centers bit for bit."""
    from repro_torch.core.engine import resident_evict
    from repro_torch.core.model import _slot_epochs
    model = _stream_model("cpu", capacity=1024, window=3)
    for xb in _stream_batches(6, shift=0.0):
        model.partial_fit(xb)
    st = model.state
    eg = _slot_epochs(st.pid, model.e_pts)
    out = {}
    for dev in ("cpu", cuda):
        s = type(st)(*(v.to(dev) if isinstance(v, torch.Tensor) else v
                       for v in st))
        s2, evict, n_ev = resident_evict(s, eg.to(dev), 5, 6, decay, 0.25)
        out[dev] = (s2.sums.cpu(), s2.counts.cpu(), s2.c.cpu(),
                    evict.cpu(), int(n_ev))
    assert out["cpu"][4] > 0
    for g, w in zip(out[cuda][:4], out["cpu"][:4]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_restores_a_cpu_checkpoint(cuda, tmp_path):
    """A checkpoint written on the CPU restores onto the card (the
    default device): every leaf equal, and both then fold the same
    batches bit for bit."""
    from repro_torch.checkpoint.checkpoint import _flatten
    cpu = _stream_model("cpu", capacity=1024, window=6, half_life=8.0,
                        count_floor=0.25)
    batches = _stream_batches(10, shift=0.0)
    for xb in batches[:5]:
        cpu.partial_fit(xb)
    cpu.save(str(tmp_path), step=5)
    gpu = KMeansModel.restore(str(tmp_path))
    assert gpu.centers.device.type == "cuda"
    for a, b in zip(_flatten(gpu._tree())[0], _flatten(cpu._tree())[0]):
        assert torch.equal(a.cpu(), b)
    for xb in batches[5:]:
        assert torch.equal(gpu.partial_fit(xb).cpu(), cpu.partial_fit(xb))
    for a, b in zip(_flatten(gpu._tree())[0], _flatten(cpu._tree())[0]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_small_stream_matches_cpu(cuda):
    """A windowed stream with the drift guard on and drifting batches,
    so that centers are re-seated (K3 inside the splits): the card and
    the CPU give the same assignments, repairs, evictions, and counts,
    sums and centers bit for bit."""
    out = {}
    for dev in ("cpu", cuda):
        model = _stream_model(dev, capacity=1024, window=6, half_life=8.0,
                              count_floor=0.25, drift_guard=True)
        _build.reset_launches()
        a = [model.partial_fit(xb, on_full="degrade").cpu()
             for xb in _stream_batches(40)]
        out[dev] = (a, model, _build.launches())
    (a_c, m_c, _), (a_g, m_g, launched) = out["cpu"], out[cuda]
    assert m_c.repaired_centers > 0 and launched["segmented_scan"] > 0
    assert all(torch.equal(x, y) for x, y in zip(a_c, a_g))
    assert (m_g.repaired_centers, m_g.evicted_rows) == \
        (m_c.repaired_centers, m_c.evicted_rows)
    for f in ("counts", "sums", "c", "pid", "wg", "b2c"):
        assert torch.equal(getattr(m_g.state, f).cpu(),
                           getattr(m_c.state, f)), f


def _mixture(n, d, k, seed):
    rng = np.random.RandomState(seed)
    mus = rng.randn(k, d) * 4.0
    return (mus[rng.randint(0, k, n)] + rng.randn(n, d)).astype(np.float32)


@pytest.mark.cuda
def test_cuda_k4_at_the_int8_fit_arena(cuda):
    """K4 over an int8 fit arena at the fit's shape (n = 60,000 rows of a
    128-component mixture, d = 784, k = 1000, kn = 30: bn = 32, 92,000
    slots), no block skipped: survivors, counts and lower bounds
    bit-equal to the plain version, and the engine's re-rank over them
    to the f32 arena's K1."""
    n, d, k, kn, bkn = 60000, 784, 1000, 30, 8
    x = torch.tensor(_mixture(n, d, 128, 0), device=cuda)
    c = x[torch.randperm(n, generator=torch.Generator().manual_seed(1))[:k]
          .to(cuda)].contiguous()
    a = distance_argmin(x, c)[0]
    sb = K2Step(k=k, kn=kn, bkn=bkn, precision="int8")
    st = sb.init_resident(x, torch.ones(n, device=cuda), c, a)
    s_rows, nb = st.pid.shape[0], st.b2c.shape[0]
    bn = s_rows // nb
    assert (bn, s_rows) == (32, 92000) and st.xg.dtype == torch.int8
    xf = torch.where((st.pid >= 0)[:, None], x[st.pid.clamp(min=0).long()],
                     0.0).contiguous()
    cidx = pad_candidates(center_knn_graph(c, kn), bkn).contiguous()
    rowsel = st.b2c.clamp(min=0).to(torch.int32).contiguous()
    noskip = torch.zeros(nb, dtype=torch.int32, device=cuda)
    args = (st.xg, st.xsc, quant.residual_norm(xf, st.xg, st.xsc),
            *quant.quantized_candidate_slabs(quant.center_quant(c), cidx),
            rowsel, noskip)
    before = _build.launches()["candidate_assign_int8_tiled"]
    got = candidate_assign_int8_tiled(*args, bn=bn, bkn=bkn, r=8)
    torch.cuda.synchronize()
    assert _build.launches()["candidate_assign_int8_tiled"] == before + 1
    want = ref.candidate_assign_int8_tiled_ref(*args, bn, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    from repro_torch.kernels.ops import quantized_scan_rerank
    zi = torch.zeros(s_rows, dtype=torch.int32, device=cuda)
    zf = torch.zeros(s_rows, device=cuda)
    a8, d8, _, _, _ = quantized_scan_rerank(
        xf, st.xg, st.xsc, c, quant.center_quant(c), cidx, rowsel, noskip,
        zi, zf, zf, bn=bn, bkn=bkn, r=8)
    ctab, csqtab = candidate_tables(c, cidx)
    a1, d1, _ = candidate_assign_tiled(xf, ctab, csqtab, cidx, rowsel,
                                       noskip, zi, zf, zf, bn=bn, bkn=bkn)
    live = st.wg > 0
    assert torch.equal(a8[live], a1[live]) and torch.equal(d8[live],
                                                           d1[live])


@pytest.mark.cuda
def test_cuda_int8_fit_matches_cpu(cuda):
    """The int8 fit on the card and on the CPU from one init: identical
    assignments, centers, iterations and counted lanes, energies (sums
    over the rows in each device's order) within rel 1e-5; and the
    card's int8 fit equals its f32 fit."""
    x = _mixture(4096, 64, 40, 3)
    init = x[np.random.RandomState(4).choice(4096, 64, replace=False)]
    a0 = torch.cdist(torch.tensor(x), torch.tensor(init)).argmin(1).to(
        torch.int32)
    out = {}
    for dev, prec in (("cpu", "int8"), (cuda, "int8"), (cuda, "f32")):
        ctr = OpCounter()
        _build.reset_launches()
        r = fit_k2means(x, init, a0, kn=10, max_iters=25, precision=prec,
                        counter=ctr, device=dev)
        out[(str(dev), prec)] = (r, ctr, _build.launches())
    (rc, cc, _), (rg, cg, launched), (rf, _, _) = (
        out[("cpu", "int8")], out[(str(cuda), "int8")],
        out[(str(cuda), "f32")])
    assert launched["candidate_assign_int8_tiled"] == rg.iterations
    assert launched["candidate_assign_tiled"] == 0
    assert rc.iterations == rg.iterations == rf.iterations
    for r in (rg, rf):
        assert torch.equal(r.assignment.cpu(), rc.assignment)
        assert torch.equal(r.centers.cpu(), rc.centers)
    assert rg.energy == pytest.approx(rc.energy, rel=1e-5)
    assert cg.profile() | {"wall_s": 0} == cc.profile() | {"wall_s": 0}


@pytest.mark.cuda
def test_cuda_k1_on_non_finite_rows_and_centers(cuda):
    """K1 with NaN rows and a NaN center in the candidate lists (what a
    fault brings in before the guard heals it): a NaN distance never
    wins, on the card as in the plain version, bit for bit."""
    inp = list(_assign_inputs(512, 100, 96, 16, 32, 8, seed=7))
    inp[0][[3, 40, 41]] = np.nan
    inp[4][:] = 0                                   # no block skipped
    bad = {int(inp[2][inp[3][0], 0]), int(inp[2][inp[3][2], 5])}
    inp[1][sorted(bad)] = np.nan
    got = _torch_assign(*inp, 32, 8, device=cuda)
    want = _torch_assign(*inp, 32, 8)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    finite = np.ones(512, bool)
    finite[[3, 40, 41]] = False          # no finite distance: column 0
    assert torch.isinf(want[1][~torch.tensor(finite)]).all()
    assert not np.isin(want[0].numpy()[finite], sorted(bad)).any()


@pytest.mark.cuda
def test_cuda_guarded_chaos_fit_matches_cpu(cuda):
    """A guarded resident fit under NaN rows, a poisoned center and
    poisoned slots on ROADMAP §3 entry 9's integer blobs (n = 3000,
    d = 16, k = 48): the card and the CPU fire the same faults, heal by
    the same rungs (K3 inside the split) and end with the same
    assignment."""
    from repro_torch.ft import FaultInjector
    x = _tied_blobs(3000, 16, 12, 2)
    init = x[np.random.RandomState(3).choice(3000, 48, replace=False)]
    a0 = torch.cdist(torch.tensor(x), torch.tensor(init)).argmin(1).to(
        torch.int32)
    sched = dict(nan_rows={2: 8}, poison_centers={4: 2}, poison_slots={6: 5})
    out = {}
    for dev in ("cpu", cuda):
        ctr = OpCounter()
        with FaultInjector(seed=5, **sched) as inj:
            r = fit_k2means(x, init, a0, kn=8, max_iters=20, guards=True,
                            counter=ctr, key=1, device=dev)
        out[str(dev)] = (r, ctr, inj.events)
    (rc, cc, ec), (rg, cg, eg) = out["cpu"], out[str(cuda)]
    assert ec == eg and cc.repairs == cg.repairs
    assert cg.repairs["regroup"] >= 1 and cg.repairs["split"] >= 1
    assert cc.sanitized_rows == cg.sanitized_rows == 8
    assert torch.equal(rg.assignment.cpu(), rc.assignment)
    assert np.isfinite(rg.energy)


@pytest.mark.cuda
def test_cuda_executor_matches_cpu(cuda):
    """One chaos trace through the serving executor over one model on
    the card and on the CPU: identical responses and transcripts."""
    from repro_torch.ft import FaultInjector, poisson_trace
    from repro_torch.serve import (ServeConfig, ServeExecutor,
                                   requests_from_trace)
    allx = _mixture(3072, 16, 32, 8)
    res = fit_k2means(allx[:2048], allx[:32], torch.cdist(
        torch.tensor(allx[:2048]), torch.tensor(allx[:32])).argmin(1).to(
        torch.int32), kn=8, max_iters=10, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        model = KMeansModel.from_result(res, kn=8, device=dev)
        ex = ServeExecutor(model, ServeConfig(queue_bound=64,
                                              ladder=(32, 64, 128),
                                              deadline=1e-3), OpCounter())
        ex.warmup()
        rate = 1.5 * ex.sustainable_qps() / 32
        trace = poisson_trace(5, rate=rate, horizon=300 / rate, rows=32,
                              deadline=1e-3, pf_every=9, pf_rows=32,
                              bursts=((90 / rate, 180 / rate, 3.0),))
        reqs = requests_from_trace(trace, allx[2048:], default_deadline=1e-3)
        with FaultInjector(seed=7, poison_queries={3: 4},
                           slow_consumer={5: 0.004},
                           fail_calls={"serve_predict": (2,)}):
            out[str(dev)] = (ex.run_trace(reqs), ex)
    (rc, exc), (rg, exg) = out["cpu"], out[str(cuda)]
    assert exg.ladder.transcript == exc.ladder.transcript
    for a, b in zip(rc, rg):
        assert (a.rid, a.status, a.rung, a.t_done) == (b.rid, b.status,
                                                       b.rung, b.t_done)
        assert (a.result is None) == (b.result is None)
        if a.result is not None:
            assert np.array_equal(a.result, b.result)
    assert exg.counter.profile() | {"wall_s": 0} == \
        exc.counter.profile() | {"wall_s": 0}


@pytest.mark.cuda
def test_cuda_candidate_helpers_match_plain(cuda):
    """The xla backend's candidate helpers through ``exact_rowdot`` on
    the card, on rows built to sit at f32 rounding midpoints: bit-equal
    to the CPU's values, assignments and top-2."""
    from repro_torch.core import (chunked_candidate_argmin,
                                  chunked_candidate_top2,
                                  gather_candidate_sqdist)
    x, c, _ = rounding_fixture(3000, 64, 784, seed=5, device="cpu")
    cand = torch.tensor(np.random.RandomState(6).randint(-1, 64, (3000, 30)),
                        dtype=torch.int32)
    live = torch.clamp(cand, min=0)
    for fn, args in ((gather_candidate_sqdist, (cand,)),
                     (chunked_candidate_argmin, (live,)),
                     (chunked_candidate_top2, (live,))):
        want = fn(x, c, *args, chunk=512)
        got = fn(x.to(cuda), c.to(cuda), *(a.to(cuda) for a in args),
                 chunk=512)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.cpu(), w), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"residency": "rebuild"},
                                {"residency": "resident"},
                                {"residency": "resident",
                                 "precision": "int8"}],
                         ids=["rebuild", "resident", "int8"])
def test_cuda_xla_fit_matches_cpu_and_kernels(cuda, kw):
    """The xla fit on the card equals the CPU's bit for bit (assignments,
    centers, iterations, counted lanes; energies, sums over the rows in
    each device's order, within rel 1e-5) and the card's kernels fit from
    the same init in assignments, centers and iterations. Off int8 it
    launches no K1."""
    x = _mixture(4096, 64, 40, 3)
    init = x[np.random.RandomState(4).choice(4096, 64, replace=False)]
    a0 = torch.cdist(torch.tensor(x), torch.tensor(init)).argmin(1).to(
        torch.int32)
    out = {}
    for dev, backend in (("cpu", "xla"), (cuda, "xla"), (cuda, "kernels")):
        ctr = OpCounter()
        _build.reset_launches()
        r = fit_k2means(x, init, a0, kn=10, max_iters=25, backend=backend,
                        counter=ctr, device=dev, **kw)
        out[(str(dev), backend)] = (r, ctr, _build.launches())
    (rc, cc, _), (rg, cg, launched), (rk, _, _) = (
        out[("cpu", "xla")], out[(str(cuda), "xla")],
        out[(str(cuda), "kernels")])
    assert launched["center_sqdist"] == rg.iterations
    if "precision" not in kw:
        assert launched["candidate_assign_tiled"] == 0
        assert launched["exact_rowdot"] >= rg.iterations
    assert rc.iterations == rg.iterations == rk.iterations
    for r in (rg, rk):
        assert torch.equal(r.assignment.cpu(), rc.assignment)
        assert torch.equal(r.centers.cpu(), rc.centers)
    assert rg.energy == pytest.approx(rc.energy, rel=1e-5)
    assert cg.profile() | {"wall_s": 0} == cc.profile() | {"wall_s": 0}


@pytest.mark.cuda
def test_cuda_host_gdi_then_xla_fit_matches_cpu(cuda):
    """fit(backend="xla", init="gdi"): the host GDI loop (K3 in every
    split) then the xla fit, on the card and on the CPU from one seed,
    at the tied-blob shape of ROADMAP §3 entry 9: identical results bit
    for bit."""
    x = _tied_blobs(3000, 16, 12, 2)
    out = {}
    for dev in ("cpu", cuda):
        _build.reset_launches()
        out[str(dev)] = (fit(x, 48, backend="xla", init="gdi", kn=8,
                             max_iters=30, seed=3, device=dev),
                         _build.launches())
    (rc, _), (rg, launched) = out["cpu"], out[str(cuda)]
    assert launched["segmented_scan"] == 2 * 47
    assert launched["candidate_assign_tiled"] == 0
    assert rc.iterations == rg.iterations
    assert torch.equal(rg.assignment.cpu(), rc.assignment)
    assert torch.equal(rg.centers.cpu(), rc.centers)


@pytest.mark.cuda
@pytest.mark.parametrize("init,k", [("gdi_host", 48), ("gdi_parallel", 48),
                                    ("gdi_parallel", 32)])
def test_cuda_host_drawn_inits_match_cpu(cuda, init, k):
    """gdi_init and gdi_parallel_init on the card from one CPU generator
    seed: the CPU's leaves and centers, bit for bit."""
    from repro_torch.core import gdi_init, gdi_parallel_init
    fn = gdi_init if init == "gdi_host" else gdi_parallel_init
    x = _tied_blobs(3000, 16, 12, 2)
    out = [fn(x, k, generator=torch.Generator().manual_seed(7), device=dev)
           for dev in ("cpu", cuda)]
    assert torch.equal(out[1][1].cpu(), out[0][1])
    assert torch.equal(out[1][0].cpu(), out[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["minibatch", "akm"])
def test_cuda_minibatch_and_akm_match_cpu(cuda, method):
    """MiniBatch and AKM on the card from one CPU generator seed: the
    CPU's assignments, centers, iterations and counted lanes, bit for
    bit; K5 runs every batch or iteration."""
    from repro_torch.core import fit_akm, fit_minibatch
    x = _mixture(3000, 16, 24, 5)
    init = x[np.random.RandomState(6).choice(3000, 48, replace=False)]
    out = {}
    for dev in ("cpu", cuda):
        ctr = OpCounter()
        _build.reset_launches()
        gen = torch.Generator().manual_seed(8)
        if method == "minibatch":
            r = fit_minibatch(x, init, generator=gen, counter=ctr,
                              device=dev)
        else:
            r = fit_akm(x, init, generator=gen, m=30, max_iters=20,
                        counter=ctr, device=dev)
        out[str(dev)] = (r, ctr, _build.launches())
    (rc, cc, _), (rg, cg, launched) = out["cpu"], out[str(cuda)]
    assert launched["distance_argmin"] >= rg.iterations
    assert rc.iterations == rg.iterations
    assert torch.equal(rg.assignment.cpu(), rc.assignment)
    assert torch.equal(rg.centers.cpu(), rc.centers)
    assert [e for _, e in rg.history] == pytest.approx(
        [e for _, e in rc.history], rel=1e-5)
    assert cg.profile() | {"wall_s": 0} == cc.profile() | {"wall_s": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("prec", ["f32", "int8"])
def test_cuda_xla_model_predict_matches_cpu(cuda, prec):
    """An xla model's predict on the card: the CPU's assignments and
    distances bit for bit, and the card's kernels model's."""
    allx = _mixture(3072, 16, 32, 8)
    res = fit_k2means(allx[:2048], allx[:32], torch.cdist(
        torch.tensor(allx[:2048]), torch.tensor(allx[:32])).argmin(1).to(
        torch.int32), kn=8, max_iters=10, device="cpu")
    q = allx[2048:]
    got = {}
    for dev, backend in (("cpu", "xla"), (cuda, "xla"), (cuda, "kernels")):
        m = KMeansModel.from_result(res, allx[:2048], kn=8, backend=backend,
                                    device=dev)
        a, d = m.predict(q, return_sqdist=True, precision=prec)
        got[(str(dev), backend)] = (a.cpu(), d.cpu())
    want = got[("cpu", "xla")]
    for key in ((str(cuda), "xla"), (str(cuda), "kernels")):
        assert torch.equal(got[key][0], want[0]) and \
            torch.equal(got[key][1], want[1]), key


@pytest.mark.cuda
def test_cuda_cross_shard_sum_equals_cpu(cuda):
    """The mesh's ordered sum over four gloo ranks on the card (its
    payload staged through the host, its additions on the card) gives the
    CPU's bits, a -0.0 partial included."""
    import torch_mesh_cases as cases
    from repro_torch.launch.mesh import run_local
    rng = np.random.default_rng(0)
    vals = (rng.standard_normal((4, 4096)) * 10.0 ** rng.integers(
        -6, 8, (4, 4096))).astype(np.float32)
    vals[:, :2] = -0.0
    cpu = run_local(cases.sum_world, 4, vals, device="cpu", timeout=300)
    card = run_local(cases.sum_world, 4, vals, device="cuda", timeout=300)
    for got in cpu + card:
        np.testing.assert_array_equal(got, cpu[0])
    assert (cpu[0][:2] == np.float32(-0.0).view(np.uint32)).all()


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card_equal_two_on_cpu(cuda):
    """The sharded kernels fit on two gloo ranks sharing the card equals
    the same fit on two CPU ranks bit for bit (ROADMAP §3 entry 9's
    integer blobs, n=3000, d=16, k=48)."""
    import torch_mesh_cases as cases
    from repro_torch.launch.mesh import run_local
    rng = np.random.default_rng(2)
    mus = np.round(rng.standard_normal((12, 16)) * 12)
    x = np.round(mus[rng.integers(0, 12, 3000)]
                 + rng.standard_normal((3000, 16)) * 1.5).astype(np.float32)
    data = {"x": x, "init": x[rng.permutation(3000)[:48]].copy()}
    cpu = run_local(cases.small_fit_world, 2, data, device="cpu",
                    timeout=300)
    card = run_local(cases.small_fit_world, 2, data, device="cuda",
                     timeout=300)
    for got in cpu[1:] + card:
        np.testing.assert_array_equal(got["a"], cpu[0]["a"])
        np.testing.assert_array_equal(got["c"], cpu[0]["c"])
        assert got["iterations"] == cpu[0]["iterations"]


def _moe_layer(dtype, device, top_k=2):
    """An MoE layer (16 experts, a shared expert) and 2 x 96 tokens drawn
    on the CPU from seeds, in ``dtype`` on ``device``."""
    from repro_torch.models.moe import moe_init
    p = moe_init(torch.Generator().manual_seed(0), 64, 48, 16, 1,
                 dtype=torch.float32)
    x = torch.randn((2, 96, 64), generator=torch.Generator().manual_seed(1))

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        return t.to(device=device, dtype=dtype)
    q = cast(p)
    q["router"] = {"w": p["router"]["w"].to(device)}      # f32 always
    return q, x.to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [2, 6])
def test_cuda_moe_layer_matches_cpu(cuda, top_k):
    """The MoE layer on the card: in f32 the CPU's expert ids, kept
    tokens and gates exactly and its outputs within rtol 1e-5 (products
    summed in other orders); in bf16 two runs bit-identical (the combine
    adds in ascending expert id, no atomics)."""
    from repro_torch.models.moe import moe_apply, route
    outs = {}
    for dev in ("cpu", cuda):
        p, x = _moe_layer(torch.float32, dev, top_k)
        y, aux = moe_apply(p, x, top_k=top_k, capacity_factor=1.0)
        r = route(p["router"]["w"], x.reshape(-1, 64), top_k=top_k,
                  capacity_factor=1.0)
        outs[str(dev)] = (y.cpu(), float(aux),
                          {k: r[k].cpu() for k in ("eidx", "slot_tok",
                                                   "pair_slot", "kept")})
    (y0, a0, r0), (y1, a1, r1) = outs["cpu"], outs[str(cuda)]
    for k in r0:
        assert torch.equal(r0[k], r1[k]), k
    assert not bool(r0["kept"].all())            # capacity dropped pairs
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    assert abs(a1 - a0) <= 1e-6
    p, x = _moe_layer(torch.bfloat16, cuda, top_k)
    ya, _ = moe_apply(p, x, top_k=top_k, capacity_factor=1.0)
    yb, _ = moe_apply(p, x, top_k=top_k, capacity_factor=1.0)
    assert torch.equal(ya, yb)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [2, 6])
def test_cuda_moe_stepped_matches_cpu(cuda, top_k):
    """The serve prefill's MoE pass (``moe_apply_stepped``) on the card:
    in f32 the CPU's outputs within rtol 1e-5 and its aux within 1e-6; in
    bf16 two runs bit-identical."""
    from repro_torch.models.moe import moe_apply_stepped
    outs = []
    for dev in ("cpu", cuda):
        p, x = _moe_layer(torch.float32, dev, top_k)
        y, aux = moe_apply_stepped(p, x, top_k=top_k)
        outs.append((y.cpu(), float(aux)))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=1e-5, atol=1e-5)
    assert abs(outs[1][1] - outs[0][1]) <= 1e-6
    p, x = _moe_layer(torch.bfloat16, cuda, top_k)
    ya, _ = moe_apply_stepped(p, x, top_k=top_k)
    yb, _ = moe_apply_stepped(p, x, top_k=top_k)
    assert torch.equal(ya, yb)


@pytest.mark.cuda
def test_cuda_gdi_router_matches_cpu(cuda):
    """``gdi_router_init`` from one CPU generator: the card's router is the
    CPU's bit for bit (K3's fixed order, correctly rounded norms)."""
    from repro_torch.models.moe import gdi_router_init
    x = torch.randn((3000, 32), generator=torch.Generator().manual_seed(2))
    got = [gdi_router_init(x.to(dev), 16, device=dev,
                           generator=torch.Generator().manual_seed(3)).cpu()
           for dev in ("cpu", cuda)]
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(torch.linalg.norm(got[1].double(), dim=0),
                               torch.ones(16, dtype=torch.float64),
                               rtol=1e-6, atol=0.0)


def _f32(tree, device):
    """A params or cache tree with its floating tensors in f32 on
    ``device``."""
    if isinstance(tree, dict):
        return {k: _f32(v, device) for k, v in tree.items()}
    return (tree.float() if tree.is_floating_point() else tree).to(device)


def _smoke_serve(arch, device, steps, member_lists=False, clustered=False,
                 launches=None):
    """``arch``'s smoke config in f32 on ``device`` from params drawn on
    the CPU: the serve prefill of a 2 x 48-token prompt, optionally the
    member lists of the flat-cache k²-attention variant or (``clustered``)
    the cluster-major tables over the prompt's keys, then ``steps``
    decode steps teacher-forced with tokens drawn on the CPU. Returns (the
    logits after the prompt and after each step, the cache), on the CPU.
    The decode steps launch the kernels ``launches`` counts (none by
    default). An audio config encodes 24 frames and a VLM's prompt takes
    patch rows, both drawn on the CPU."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_cache, init_params, serve_step
    cfg = get_smoke_config(arch)
    params = _f32(init_params(cfg, torch.Generator().manual_seed(3),
                              device="cpu"), device)
    prompt = torch.randint(0, cfg.vocab, (2, 48),
                           generator=torch.Generator().manual_seed(4))
    toks = torch.randint(0, cfg.vocab, (steps, 2, 1),
                         generator=torch.Generator().manual_seed(5))
    cache = _f32(init_cache(cfg, 2, 48 + steps + 1, clustered=False,
                            enc_len=24, device="cpu"), device)
    extra = torch.randn((2, 24 if cfg.family == "audio" else cfg.n_patches,
                         cfg.d_model),
                        generator=torch.Generator().manual_seed(6)).to(device)
    kw = ({"frames": extra} if cfg.family == "audio" else
          {"patches": extra} if cfg.n_patches else {})
    logits, cache = serve.prefill_into_cache(cfg, params, cache,
                                             prompt.to(device), **kw)
    if member_lists:
        cache = serve.attach_member_lists(cfg, cache, length=48)
    if clustered:
        cache = serve.attach_clusters(cfg, cache, length=48)
    out = [logits.cpu()]
    _build.reset_launches()
    for i in range(steps):
        logits, cache = serve_step(cfg, params, cache, toks[i].to(device),
                                   48 + i)
        out.append(logits.cpu())
    got = {k: v for k, v in _build.launches().items() if v}
    want = {} if launches is None or device == "cpu" else launches
    assert got == want, (got, want)
    return out, _f32(cache, "cpu")


def _logits_close(got, want):
    """Logits within 1e-4 of their largest magnitude (f32, sums in other
    orders)."""
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_deepseek_smoke_serve_matches_cpu(cuda):
    """DeepSeek's smoke config (the GQA prefix, MLA over the latent cache,
    the MoE with a shared expert) in f32 on the card against the CPU: the
    serve prefill and 8 decode steps, logits within 1e-4 of their largest
    magnitude, the latent cache within 1e-4 of its; no kernel launched."""
    got, cache = _smoke_serve("deepseek-v2-lite-16b", cuda, 8)
    want, want_c = _smoke_serve("deepseek-v2-lite-16b", "cpu", 8)
    _logits_close(got, want)
    lat, want_lat = cache["stack"]["lat"], want_c["stack"]["lat"]
    assert float((lat - want_lat).abs().max()) <= \
        1e-4 * float(want_lat.abs().max())


@pytest.mark.cuda
def test_cuda_flat_clustered_serve_step_matches_cpu(cuda):
    """The flat-cache k²-attention variant (qwen3-8b's smoke config in f32:
    member lists from k²-means over the prompt's keys, 8 decode steps
    that gather the top-p clusters' rows and file each token with
    ``cluster_append``) on the card against the CPU: logits within 1e-4
    of their largest magnitude, member lists and sizes equal."""
    got, cache = _smoke_serve("qwen3-8b", cuda, 8, member_lists=True)
    want, want_c = _smoke_serve("qwen3-8b", "cpu", 8, member_lists=True)
    _logits_close(got, want)
    for f in ("mem", "mmask", "sizes"):
        assert torch.equal(cache["stack"][f], want_c["stack"][f]), f


@pytest.mark.cuda
def test_cuda_mla_decode_is_bit_identical_run_to_run(cuda):
    """``mla_decode`` at DeepSeek-V2-Lite's widths (d 2048, 16 heads,
    kv_lora 512, nope 128, rope 64, v 128) in bf16 over a 4,096-slot
    latent cache, twice from the same cache: bit-identical outputs and
    caches."""
    from repro_torch.models.attention import MLADims, mla_decode, mla_init
    dims = MLADims(512, 128, 64, 128)
    p = mla_init(torch.Generator(device=cuda).manual_seed(0), 2048, 16, dims)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 1, 2048), generator=gen, device=cuda).bfloat16()
    lat = torch.randn((2, 4096, 576), generator=gen, device=cuda).bfloat16()
    runs = []
    for _ in range(2):
        cache = lat.clone()
        out, _ = mla_decode(p, x, cache, 4000, n_heads=16, dims=dims)
        runs.append((out, cache))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert bool(torch.isfinite(runs[0][0].float()).all())


@pytest.mark.cuda
def test_cuda_cluster_attend_zamba_shape(cuda):
    """K6 at Zamba2's head width (dh 112: a bf16 row of 224 bytes) with
    phase 2o's cap 256 and p 16, both validity forms giving the same
    state, within the plain version's tolerances."""
    q, kt, vt, sel, sizes, valid = _attend_inputs(64, 1024, 256, 112, 16,
                                                  torch.bfloat16, 5, cuda)
    a = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    b = cluster_attend_partial(q, kt, vt, sel, valid=valid)
    _assert_state_close(a, ref.cluster_attend_ref(q, kt, vt, sel,
                                                  sizes=sizes),
                        ref.cluster_attend_ref(q, kt, vt.abs(), sel,
                                               sizes=sizes)[2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [16, 32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_cluster_attend_whisper_shape(cuda, cap, dtype):
    """K6 at Whisper's head width (dh 64: a bf16 row of 128 bytes, so a
    16-row tile a warp stage) with small caps (16 and 32, phase 2p's) and
    p 4, over 512 query rows (64 utterances x 8 heads, a GQA group of 1):
    both validity forms give the same state, within the plain version's
    tolerances, and a second launch gives the same bits."""
    q, kt, vt, sel, sizes, valid = _attend_inputs(512, 4096, cap, 64, 4,
                                                  dtype, 7, cuda)
    a = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    b = cluster_attend_partial(q, kt, vt, sel, valid=valid)
    c = cluster_attend_partial(q, kt, vt, sel, sizes=sizes)
    _assert_state_close(a, ref.cluster_attend_ref(q, kt, vt, sel,
                                                  sizes=sizes),
                        ref.cluster_attend_ref(q, kt, vt.abs(), sel,
                                               sizes=sizes)[2])
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
def test_cuda_cluster_attend_gqa_group_of_8(cuda):
    """K6 at InternVL2's attention (dh 128, 64 q-heads over 8 kv-heads, a
    group of 8 query rows reading one kv-head's blocks) with cap 512 and
    p 16, the selection made by ``select_clusters`` as the decode path
    makes it (kc 64 here, where phase 2q has 2048): the plain version's
    tolerances, and both validity forms equal."""
    from repro_torch.kernels.cluster_attend import select_clusters
    B, H, Hkv, dh, kc, cap, p = 2, 64, 8, 128, 64, 512, 16
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((B, H, dh), generator=gen, device=cuda)
    cent = torch.randn((B, Hkv, kc, dh), generator=gen, device=cuda)
    kt = torch.randn((B * Hkv * kc, cap, dh), generator=gen,
                     device=cuda).bfloat16()
    vt = torch.randn((B * Hkv * kc, cap, dh), generator=gen,
                     device=cuda).bfloat16()
    sizes = torch.randint(0, cap + 1, (B * Hkv * kc,), generator=gen,
                          device=cuda, dtype=torch.int32)
    valid = (torch.arange(cap, device=cuda)[None, :]
             < sizes[:, None]).to(torch.int32)
    sel = select_clusters(q, cent, p)
    kv_head = (sel.long() // kc).reshape(B, H, p)
    assert torch.equal(kv_head, (torch.arange(B, device=cuda)[:, None, None]
                                 * Hkv + torch.arange(H, device=cuda)[
                                     None, :, None] // 8).expand(B, H, p))
    qf = q.reshape(B * H, dh)
    a = cluster_attend_partial(qf, kt, vt, sel, sizes=sizes)
    b = cluster_attend_partial(qf, kt, vt, sel, valid=valid)
    _assert_state_close(a, ref.cluster_attend_ref(qf, kt, vt, sel,
                                                  sizes=sizes),
                        ref.cluster_attend_ref(qf, kt, vt.abs(), sel,
                                               sizes=sizes)[2])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-base", "internvl2-76b"])
@pytest.mark.parametrize("clustered", [False, True])
def test_cuda_audio_vlm_smoke_serve_matches_cpu(cuda, arch, clustered):
    """Whisper's (24 encoded frames) and InternVL2's (8 patch rows) smoke
    configs in f32 on the card against the CPU: the serve prefill and 4
    decode steps, flat or k²-attention over the cluster-major cache (K6
    once a layer a step), logits within 1e-4 of their largest magnitude,
    every cache field within 1e-4 of its."""
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    got, cache = _smoke_serve(arch, cuda, 4, clustered=clustered,
                              launches={"cluster_attend": 4 * cfg.n_layers}
                              if clustered else None)
    want, want_c = _smoke_serve(arch, "cpu", 4, clustered=clustered)
    _logits_close(got, want)
    for f, t in want_c["stack"].items():
        if t.is_floating_point():
            assert float((cache["stack"][f] - t).abs().max()) <= \
                1e-4 * float(t.abs().max()), f
        else:
            assert torch.equal(cache["stack"][f], t), f


def _scan_close(got, want, scale):
    """A scan's outputs within 1e-5 of ``scale`` (each output's sum of
    absolute terms) plus 1e-6: the kernel sums in another order than
    the plain version's product."""
    err = (got - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 16), (1, 1, 64), (2, 40, 64)],
                         ids=["smoke", "head", "rwkv6-3b"])
@pytest.mark.parametrize("S", [1, 300])
def test_cuda_wkv6_scan(cuda, shape, S):
    """``wkv6_scan`` against its plain version on the card (the smoke
    width, one full-width head, all 40 heads of RWKV6-3B), at S = 1 (a
    decode step) and 300, from a random state: the final state bit-equal
    (the same products and sums, each rounded), the outputs within 1e-5
    of their sum of absolute terms; one launch and one count a call."""
    B, H, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(S + dh)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa
    r, k, v = rnd(B, S, H, dh), rnd(B, S, H, dh), rnd(B, S, H, dh)
    w = torch.exp(-torch.exp(rnd(B, S, H, dh) * 0.5 - 3.0))
    u = rnd(H, dh) * 0.1
    s0 = rnd(B, H, dh, dh)
    st, st_p = s0.clone(), s0.clone()
    _build.reset_launches()
    got = wkv6_scan(r, k, v, w, u, st)
    torch.cuda.synchronize()
    assert _build.launches()["wkv6_scan"] == 1
    want = ref.wkv6_scan_ref(r, k, v, w, u, st_p)
    assert torch.equal(st, st_p)
    st_a = s0.abs()
    scale = ref.wkv6_scan_ref(r.abs(), k.abs(), v.abs(), w, u.abs(), st_a)
    _scan_close(got, want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 32, 8), (1, 1, 224, 64),
                                   (2, 32, 224, 64)],
                         ids=["smoke", "head", "zamba2-7b"])
@pytest.mark.parametrize("S", [1, 300])
def test_cuda_ssd_scan(cuda, shape, S):
    """``ssd_scan`` against its plain version on the card (the smoke
    width, one full-width head, all 32 heads of Zamba2-7B: P 224, N 64),
    at S = 1 and 300, from a random state: the final state bit-equal, the
    outputs within 1e-5 of their sum of absolute terms."""
    B, H, P, N = shape
    gen = torch.Generator(device=cuda).manual_seed(S + P)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa
    x, Bm, Cm = rnd(B, S, H, P), rnd(B, S, N), rnd(B, S, N)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    decay = torch.exp(-torch.exp(rnd(H) * 0.5) * dt)
    D = rnd(H)
    s0 = rnd(B, H, P, N)
    st, st_p = s0.clone(), s0.clone()
    _build.reset_launches()
    got = ssd_scan(x, Bm, Cm, decay, dt, D, st)
    torch.cuda.synchronize()
    assert _build.launches()["ssd_scan"] == 1
    want = ref.ssd_scan_ref(x, Bm, Cm, decay, dt, D, st_p)
    assert torch.equal(st, st_p)
    scale = ref.ssd_scan_ref(x.abs(), Bm.abs(), Cm.abs(), decay, dt, D.abs(),
                             s0.abs())
    _scan_close(got, want, scale)


@pytest.mark.cuda
def test_cuda_scans_raise_on_what_they_do_not_take(cuda):
    """A CUDA tensor the kernel does not take raises (no CPU fallback)."""
    z = torch.zeros((1, 2, 1, 200), device=cuda)
    with pytest.raises(ValueError, match="dh must be <= 64"):
        wkv6_scan(z, z, z, z, torch.zeros((1, 200), device=cuda),
                  torch.zeros((1, 1, 200, 200), device=cuda))
    with pytest.raises(ValueError, match="P must be <= 256 and N <= 64"):
        ssd_scan(torch.zeros((1, 2, 1, 8), device=cuda),
                 torch.zeros((1, 2, 80), device=cuda),
                 torch.zeros((1, 2, 80), device=cuda),
                 torch.zeros((1, 2, 1), device=cuda),
                 torch.zeros((1, 2, 1), device=cuda),
                 torch.zeros((1,), device=cuda),
                 torch.zeros((1, 1, 8, 80), device=cuda))
    x = torch.zeros((1, 2, 1, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan(x, torch.zeros((1, 2, 4), device=cuda),
                 torch.zeros((1, 2, 4), device=cuda),
                 torch.zeros((1, 2, 1), device=cuda),
                 torch.zeros((1, 2, 1), device=cuda),
                 torch.zeros((1,), device=cuda),
                 torch.zeros((1, 1, 8, 4), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_cuda_ssm_smoke_serve_matches_cpu(cuda, arch):
    """The SSM smoke configs in f32 on the card against the CPU: the serve
    prefill (one scan launch a layer) and 8 decode steps (one a layer a
    step; Zamba2's shared block over its flat cache), logits within 1e-4
    of their largest magnitude, every cache field within 1e-4 of its."""
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    name = "wkv6_scan" if cfg.ssm == "rwkv6" else "ssd_scan"
    got, cache = _smoke_serve(arch, cuda, 8,
                              launches={name: 8 * cfg.n_layers})
    want, want_c = _smoke_serve(arch, "cpu", 8)
    _logits_close(got, want)
    for part in want_c:
        for f, t in want_c[part].items():
            assert float((cache[part][f] - t).abs().max()) <= \
                1e-4 * float(t.abs().max()), (part, f)


@pytest.mark.cuda
def test_cuda_zamba_clustered_serve_matches_cpu(cuda):
    """Zamba2's smoke config in f32 with its shared block's cache
    clustered (``attach_clusters``) on the card against the CPU: 4
    k²-attention steps (K6 once an application a step, the scan once a
    layer a step), logits within 1e-4 of their largest magnitude, the
    tables equal and the rings within 1e-4."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import n_shared_apps
    cfg = get_smoke_config("zamba2-7b")
    napps = n_shared_apps(cfg)
    got, cache = _smoke_serve("zamba2-7b", cuda, 4, clustered=True,
                              launches={"ssd_scan": 4 * cfg.n_layers,
                                        "cluster_attend": 4 * napps})
    want, want_c = _smoke_serve("zamba2-7b", "cpu", 4, clustered=True)
    _logits_close(got, want)
    for f in ("sizes", "ring_fill"):
        assert torch.equal(cache["shared"][f], want_c["shared"][f]), f
    for f in ("ring_k", "ring_v", "kt", "cent"):
        t = want_c["shared"][f]
        assert float((cache["shared"][f] - t).abs().max()) <= \
            1e-4 * float(t.abs().max()), f


def _scan_grads_check(names, got, want, scale):
    """Each gradient within 1e-5 of its sum of absolute terms plus 1e-6
    (autograd through the plain version on |inputs| and |cotangents|)."""
    for n, g, w, s in zip(names, got, want, scale):
        err = (g - w).abs()
        assert bool((err <= 1e-5 * s.abs() + 1e-6).all()), (n, float(
            err.max()))


def _grads(fn, inputs, cots):
    ts = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*ts)
    loss = sum(torch.sum(o * c) for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, ts)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 16), (2, 40, 64)],
                         ids=["smoke", "rwkv6-3b"])
@pytest.mark.parametrize("S", [1, 130, 300])
def test_cuda_wkv6_scan_backward(cuda, shape, S):
    """``wkv6_scan_bwd`` (through ``ssm_scan.wkv6_scan_states``'s autograd
    Function) against autograd through the plain version on the card,
    from a random state with random cotangents of the outputs and the
    final state, at S = 1, 130 (a chunk boundary inside) and 300: the
    gradients of r, k, v, w, u and the initial state within 1e-5 of
    their sum of absolute terms; one forward and one backward launch; a
    second backward bit-identical."""
    from repro_torch.kernels import ssm_scan
    B, H, dh = shape
    gen = torch.Generator(device=cuda).manual_seed(7 * S + dh)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa
    w = torch.exp(-torch.exp(rnd(B, S, H, dh) * 0.5 - 3.0))
    inputs = [rnd(B, S, H, dh), rnd(B, S, H, dh), rnd(B, S, H, dh), w,
              rnd(H, dh) * 0.1, rnd(B, H, dh, dh)]
    cots = [rnd(B, S, H, dh), rnd(B, H, dh, dh)]
    _build.reset_launches()
    got = _grads(ssm_scan.wkv6_scan_states, inputs, cots)
    torch.cuda.synchronize()
    assert _build.launches()["wkv6_scan"] == 1
    assert _build.launches()["wkv6_scan_bwd"] == 1
    again = _grads(ssm_scan.wkv6_scan_states, inputs, cots)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads(ref.wkv6_scan_states_ref, inputs, cots)
    scale = _grads(ref.wkv6_scan_states_ref,
                   [t if i == 3 else t.abs() for i, t in enumerate(inputs)],
                   [c.abs() for c in cots])
    _scan_grads_check(("r", "k", "v", "w", "u", "state0"), got, want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 32, 8), (2, 32, 224, 64)],
                         ids=["smoke", "zamba2-7b"])
@pytest.mark.parametrize("S", [1, 130, 300])
def test_cuda_ssd_scan_backward(cuda, shape, S):
    """``ssd_scan_bwd`` against autograd through the plain version on the
    card, as the WKV6 test: the gradients of x, B, C, decay, dt, D and
    the initial state within 1e-5 of their sum of absolute terms."""
    from repro_torch.kernels import ssm_scan
    B, H, P, N = shape
    gen = torch.Generator(device=cuda).manual_seed(5 * S + P)
    rnd = lambda *sh: torch.randn(sh, generator=gen, device=cuda)  # noqa
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    decay = torch.exp(-torch.exp(rnd(H) * 0.5) * dt)
    inputs = [rnd(B, S, H, P), rnd(B, S, N), rnd(B, S, N), decay, dt,
              rnd(H), rnd(B, H, P, N)]
    cots = [rnd(B, S, H, P), rnd(B, H, P, N)]
    _build.reset_launches()
    got = _grads(ssm_scan.ssd_scan_states, inputs, cots)
    torch.cuda.synchronize()
    assert _build.launches()["ssd_scan"] == 1
    assert _build.launches()["ssd_scan_bwd"] == 1
    again = _grads(ssm_scan.ssd_scan_states, inputs, cots)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads(ref.ssd_scan_states_ref, inputs, cots)
    scale = _grads(ref.ssd_scan_states_ref,
                   [t if i in (3, 4) else t.abs()
                    for i, t in enumerate(inputs)], [c.abs() for c in cots])
    _scan_grads_check(("x", "Bm", "Cm", "decay", "dt", "D", "state0"), got,
                      want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-lite-16b",
                                  "granite-8b", "qwen3-8b", "qwen3-14b",
                                  "minitron-4b", "rwkv6-3b", "internvl2-76b",
                                  "zamba2-7b", "whisper-base"])
def test_cuda_train_smoke_matches_cpu(cuda, arch):
    """``forward_train``'s loss and every gradient leaf of each arch's
    smoke config in f32 on the card against the CPU: the loss rel 1e-5,
    each leaf within 1e-4 of its largest magnitude; the SSM configs
    through the scan kernels and their backward kernels and no other
    config through any kernel (``chip_smoke.train_smoke_agrees``, which
    phase 2s runs too)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    ok, detail = chip_smoke.train_smoke_agrees(torch, arch, cuda)
    assert ok, detail

@pytest.mark.cuda
def test_cuda_analyzer_kernel_pass_and_host_reads(cuda):
    """The analyzer's kernel pass on the card: every kernel launched once
    a case through its wrapper, its plan read from the launcher's own
    ``k2_plan_*`` with no blocking finding and its shared memory within
    the card's opt-in limit; and the audit of the resident step on the
    card with its one host read."""
    from repro_torch.analysis import host_sync_audit, kernel_contracts
    from repro_torch.analysis.registry import audit_entries
    _build.reset_launches()
    fs, stats = kernel_contracts.run(device=cuda, repo_root=str(ROOT))
    assert [f for f in fs if f.severity == "error"] == []
    assert all(_build.launches().values()), _build.launches()
    optin = stats["limits"]["smem_optin"]
    assert len(stats["plans"]) == stats["cases"]
    assert all(0 <= p["smem"] <= optin for p in stats["plans"])
    entry = [e for e in audit_entries()
             if e.name == "step/kernels-resident-f32"][0]
    fs, counts = host_sync_audit.audit_entry(entry, cuda, str(ROOT))
    assert fs == [] and counts["host_reads"] == 1
