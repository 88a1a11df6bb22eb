"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``): the functions each CUDA kernel computes, run by
the kernel wrappers on CPU tensors and held against the kernels on the
card."""
from __future__ import annotations

import math

import torch

from .segment_sum import segment_sum_ordered

# Padded candidate columns carry this squared "distance" so they never win
# an argmin; finite (not inf) so no inf-inf NaNs can appear downstream.
PAD_SQDIST = 1e30


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """Square roots of f32 values correctly rounded to f32, the same bits
    on every device: the f64 root rounded once. torch's f32 ``sqrt`` on
    the CPU is not correctly rounded (one value in about 170 differs from
    the card's, which is). The exact root of an f32 value lies at least 4
    f64 ulps from every f32 rounding midpoint, so an f64 root within a few
    f64 ulps, the CPU's too, rounds to the correctly rounded f32 one."""
    return torch.sqrt(v.to(torch.float64)).to(torch.float32)


def center_sqdist_ref(c: torch.Tensor) -> torch.Tensor:
    """(k, d) -> (k, k) squared center distances ``max((|c_i|^2 - 2 c_i.c_j)
    + |c_j|^2, 0)`` in f32 from the correctly rounded norms and products
    (:func:`exact_sqnorm`, :func:`exact_cross`): values no order of
    summation changes, so K2 gives them bit for bit and a permutation of
    d leaves them as they are. The products are symmetric and x_ii is
    |c_i|^2; each of (i, j) and (j, i) is composed from its own side, as
    written, so the matrix need not be symmetric in its last bit."""
    sq = exact_sqnorm(c)
    x = exact_cross(c, c.T, asq=sq, bsq=sq)
    return torch.clamp((sq[:, None] - 2.0 * x) + sq[None, :], min=0.0)


# The screen's relative error of an f64 sum of exact products, in any
# order: gamma_d = d u / (1 - d u), u = 2^-53 (Higham, Accuracy and
# Stability of Numerical Algorithms, 2nd ed., §3.1), times a safety factor
# 1 + 2^-20 for the rounding of the bound's own arithmetic and for bounds
# built from f64 norms (themselves f64 sums, relative error <= 2^-22 for
# d < 2^31); the CUDA kernels' k2_gamma (csrc/common.cuh) is the same.
def screen_gamma(d: int) -> float:
    u = d * 2.0 ** -53
    return u / (1.0 - u) * (1.0 + 2.0 ** -20)


def rn_f32_of_int(v: int, exp: int) -> float:
    """The f32 nearest ``v * 2**exp`` (v a Python int), ties to even, with
    f32's subnormal quantum 2^-149 and overflow to infinity; a zero is
    +0.0. Returned as a Python float that is exactly that f32."""
    if v == 0:
        return 0.0
    mag = abs(v)
    top = mag.bit_length() - 1 + exp              # exponent of the lead bit
    lsb = max(top - 23, -149)                     # exponent of the quantum
    shift = lsb - exp
    if shift > 0:
        q, r = mag >> shift, mag & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        if r > half or (r == half and q & 1):
            q += 1
    else:
        q = mag << -shift
    if q == 0:
        return 0.0
    if q.bit_length() - 1 + lsb >= 128:          # 2^128 or more: overflow
        return math.copysign(math.inf, v)
    return math.copysign(math.ldexp(q, lsb), v)


def exact_dots_f32(a: torch.Tensor, b: torch.Tensor, *,
                   rows: int = 4096) -> torch.Tensor:
    """(m, d) x (m, d) f32 -> (m,) f32: row i is RN_f32 of the exact sum of
    ``a[i, j] * b[i, j]``. Every f32 is an integer below 2^24 times
    2^(e - 150), so each product is an integer below 2^48 at bit
    ``e_a + e_b - 2`` of ``value * 2^298``; the products are added exactly
    into 19 limbs of 32 bits in int64 on the tensors' device (at most three
    limbs a product), and each row's limbs become one Python integer,
    rounded once (:func:`rn_f32_of_int`). Works in chunks of ``rows``."""
    out = []
    for lo in range(0, a.shape[0], rows):
        ua = a[lo:lo + rows].contiguous().view(torch.int32).long() \
            & 0xffffffff
        ub = b[lo:lo + rows].contiguous().view(torch.int32).long() \
            & 0xffffffff
        ea, eb = (ua >> 23) & 0xff, (ub >> 23) & 0xff
        m = (((ua & 0x7fffff) | ((ea > 0).long() << 23))
             * ((ub & 0x7fffff) | ((eb > 0).long() << 23)))
        p = torch.clamp(ea, min=1) + torch.clamp(eb, min=1) - 2
        off = p & 31
        low, high = (m & 0xffffffff) << off, (m >> 32) << off
        sign = 1 - 2 * (((ua ^ ub) >> 31) & 1)
        vals = torch.stack([low & 0xffffffff,
                            (low >> 32) + (high & 0xffffffff), high >> 32],
                           dim=-1) * sign[..., None]
        limb = (p >> 5)[..., None] + torch.arange(3, device=a.device)
        acc = torch.zeros((ua.shape[0], 19), dtype=torch.int64,
                          device=a.device).scatter_add_(
            1, limb.reshape(ua.shape[0], -1), vals.reshape(ua.shape[0], -1))
        for row in acc.cpu().numpy():
            out.append(rn_f32_of_int(sum(int(v) << (32 * i)
                                         for i, v in enumerate(row)), -298))
    return torch.tensor(out, dtype=torch.float32, device=a.device)


def _round_screened(s: torch.Tensor, err: torch.Tensor, pairs):
    """f64 sums ``s`` with ``|s - exact| <= err`` -> f32 RN(exact), a zero
    as +0: where ``s - err`` and ``s + err`` round to one f32 that is the
    answer (f64 -> f32 rounding is monotone); elsewhere the element is
    recomputed exactly, ``pairs(idx)`` giving the (m, d) rows whose
    products it sums. ``2^-52 |s|`` more of slack makes up for rounding
    ``s -/+ err`` to nearest instead of outward. Reads the flagged
    elements to the host (a plain version's privilege)."""
    err = err + torch.abs(s) * 2.0 ** -52
    lo, hi = (s - err).float(), (s + err).float()
    out = hi + 0.0
    idx = ((lo != hi) & torch.isfinite(s)).nonzero()
    if idx.shape[0]:
        out[tuple(idx.T)] = exact_dots_f32(*pairs(idx))
    return out


def exact_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares, each RN_f32 of the exact sum of the exact
    products, ties to even, a zero as +0: a value of no order, so every
    evaluation of a row's norm agrees with every kernel's. The f64 sum is
    screened against its error bound ``gamma_d * s``; rows it cannot
    decide are recomputed exactly (:func:`exact_dots_f32`). Integer rows
    (int8) sum exactly in f64 already."""
    xd = x.double()
    s = torch.sum(xd * xd, dim=-1)
    if not x.is_floating_point():
        return s.float()
    d = x.shape[-1]

    def pairs(idx):
        rows = x[tuple(idx.T)].float()
        return rows, rows
    return _round_screened(s, s * screen_gamma(d), pairs)


def exact_split_sqnorms(csum: torch.Tensor, tot: torch.Tensor,
                        row_seg: torch.Tensor):
    """GDI's split-score norms over K3's prefix sums: (|csum[r]|^2,
    |tot[row_seg[r]] - csum[r]|^2) for each row r, both correctly rounded
    (:func:`exact_sqnorm`), the suffix an f32 subtraction."""
    return (exact_sqnorm(csum),
            exact_sqnorm(tot[row_seg.long()] - csum))


def sqnorm_bound(sq: torch.Tensor) -> torch.Tensor:
    """An f64 bound >= |x| from the correctly rounded f32 ``|x|^2``: at
    most 2^-24 below the exact value relatively while normal and 2^-150
    in f32's subnormal range (``k2_sqnorm_up`` of ``csrc/common.cuh``)."""
    return torch.sqrt(sq.double() * (1.0 + 2.0 ** -22) + 2.0 ** -149)


def exact_cross(a: torch.Tensor, b: torch.Tensor, *, asq=None,
                bsq=None) -> torch.Tensor:
    """``a @ b`` (batched or not), each element RN_f32 of the exact sum of
    the exact f32 products, ties to even, a zero as +0: the same value
    whatever the order of the sum (see :func:`exact_sqnorm`). The f64
    product is screened against ``gamma_d |a_i| |b_j|`` (Cauchy-Schwarz
    bounds the sum of |products|); elements it cannot decide are
    recomputed exactly. Integer inputs (int8) multiply exactly in f64
    already. ``asq`` (..., m) / ``bsq`` (..., k): the correctly rounded
    squared norms of a's rows / b's columns when the caller has them
    (bounded by :func:`sqnorm_bound`); else the f64 norms."""
    ad, bd = a.double(), b.double()
    s = ad @ bd
    if not (a.is_floating_point() and b.is_floating_point()):
        return s.float()
    d = a.shape[-1]
    na = (torch.linalg.vector_norm(ad, dim=-1) if asq is None
          else sqnorm_bound(asq))[..., :, None]
    nb = (torch.linalg.vector_norm(bd, dim=-2) if bsq is None
          else sqnorm_bound(bsq))[..., None, :]
    batch = s.shape[:-2]
    ab = a.expand(batch + a.shape[-2:])
    bb = b.expand(batch + b.shape[-2:]).transpose(-1, -2)

    def pairs(idx):
        t = tuple(idx[:, :-2].T)
        return ab[t + (idx[:, -2],)], bb[t + (idx[:, -1],)]
    return _round_screened(s, na * nb * screen_gamma(d), pairs)


def exact_rowdot(x: torch.Tensor, y: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d), (n,) -> (n,): ``x[i] . y[idx[i]]``, each RN_f32 of
    the exact sum of the exact f32 products (see :func:`exact_cross`),
    screened against ``gamma_d |x_i| |y_idx[i]|``."""
    yg = y[idx.long()]
    xd, yd = x.double(), yg.double()
    s = torch.sum(xd * yd, dim=-1)
    bnd = torch.sqrt(torch.sum(xd * xd, dim=-1) * torch.sum(yd * yd, dim=-1))

    def pairs(i):
        return x[i[:, 0]].float(), yg[i[:, 0]].float()
    return _round_screened(s, bnd * screen_gamma(x.shape[-1]), pairs)


def _rounders(sqnorm, cross):
    return sqnorm or exact_sqnorm, cross or exact_cross


def exact_sqdist(x: torch.Tensor, c: torch.Tensor, *,
                 chunk_elems: int = 1 << 24, sqnorm=None,
                 cross=None) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) f32 squared distances ``max((|x|^2 -
    2 x.c) + |c|^2, 0)`` from the correctly rounded norms and products,
    the value every kernel of the port gives a (point, center) pair. Runs
    in row chunks that keep the f64 product under ``chunk_elems``
    values. ``sqnorm``/``cross`` (default :func:`exact_sqnorm`,
    :func:`exact_cross`) compute the rounded values: the torch paths pass
    ``exact_round``'s, which stay on the device."""
    exact_sqnorm, exact_cross = _rounders(sqnorm, cross)
    csq = exact_sqnorm(c)
    ct = c.T
    rows = max(1, chunk_elems // max(c.shape[0], 1))
    out = []
    for xb in torch.split(x, rows):
        xsq = exact_sqnorm(xb)
        cross = exact_cross(xb, ct, asq=xsq, bsq=csq)
        out.append(torch.clamp(xsq[:, None] - 2.0 * cross + csq, min=0.0))
    return torch.cat(out)


def distance_argmin_ref(x: torch.Tensor, c: torch.Tensor, *,
                        chunk_elems: int = 1 << 24):
    """(n, d), (k, d) -> (assignment (n,) int32, min sqdist (n,) f32): the
    nearest of all k centers by :func:`exact_sqdist`, ties to the first
    center. Works in row chunks, so no (n, k) matrix is held."""
    rows = max(1, chunk_elems // max(c.shape[0], 1))
    a, m = [], []
    for xb in torch.split(x, rows):
        sq = exact_sqdist(xb, c, chunk_elems=chunk_elems)
        a.append(torch.argmin(sq, dim=1).to(torch.int32))
        m.append(torch.amin(sq, dim=1))
    return torch.cat(a), torch.cat(m)


def candidate_assign_ref(x, c, cand, skip, prev_a, prev_d, bn: int, *,
                         chunk_elems: int = 1 << 24):
    """Per-block restricted assignment: block b of ``x`` (bn rows) against
    the centers ``cand[b]`` (nb, kn), with the distances of
    :func:`exact_sqdist`. Returns (argbest id int32, best sqdist), ties to
    the first in list order, ``prev_*`` on rows of skipped blocks. Runs in
    chunks of blocks that keep the gathered f64 centers under
    ``chunk_elems`` values."""
    n, d = x.shape
    nb, kn = cand.shape
    csq = exact_sqnorm(c)
    cl = cand.long()
    xb = x.reshape(nb, bn, d)
    cb = max(1, chunk_elems // max(kn * d, 1))
    a, m = [], []
    for b0 in range(0, nb, cb):
        ids = cl[b0:b0 + cb]
        cross = exact_cross(xb[b0:b0 + cb], c[ids].transpose(1, 2))
        sq = torch.clamp(exact_sqnorm(xb[b0:b0 + cb])[..., None]
                         - 2.0 * cross + csq[ids][:, None, :], min=0.0)
        loc = torch.argmin(sq, dim=-1)                    # first in the list
        a.append(torch.gather(ids, 1, loc).reshape(-1))
        m.append(torch.amin(sq, dim=-1).reshape(-1))
    skip_pt = torch.repeat_interleave(skip != 0, bn)
    return (torch.where(skip_pt, prev_a, torch.cat(a).to(torch.int32)),
            torch.where(skip_pt, prev_d, torch.cat(m)))


def slab_sqdist(x, ctab, csqtab, rowsel, bn: int, *,
                chunk_elems: int = 1 << 24, sqnorm=None, cross=None):
    """Squared distances of every grouped row to each column of its
    block's slab ``ctab[rowsel[b]]``, (n, kn_pad): ``max((|x|^2 - 2 x.c)
    + |c|^2, 0)`` in f32 from the exactly rounded ``|x|^2`` and ``x.c``,
    the values K1 selects from (so K1, this function and
    ``quant.rerank_exact`` give one pair one value). Padding columns
    carry ``csqtab`` = PAD_SQDIST. Runs in chunks of blocks so that the
    gathered f64 slabs stay under ``chunk_elems`` values; ``sqnorm`` and
    ``cross`` as in :func:`exact_sqdist`."""
    exact_sqnorm, exact_cross = _rounders(sqnorm, cross)
    n, d = x.shape
    nb = n // bn
    knp = ctab.shape[1]
    rs = rowsel.long()
    xb = x.reshape(nb, bn, d)
    cb = max(1, chunk_elems // (knp * d))
    out = []
    for b0 in range(0, nb, cb):
        xc, rc = xb[b0:b0 + cb], rs[b0:b0 + cb]
        cross = exact_cross(xc, ctab[rc].transpose(1, 2))  # (cb, bn, kn_pad)
        out.append(torch.clamp(exact_sqnorm(xc)[..., None] - 2.0 * cross
                               + csqtab[rc][:, None, :], min=0.0))
    return torch.cat(out).reshape(n, knp)


def candidate_assign_tiled_ref(x, ctab, csqtab, cidx, rowsel, skip, prev_a,
                               prev_d1, prev_d2, bn: int):
    """Grouped k_n-restricted assignment over a candidate table: block b
    of ``x`` (bn rows) competes among ``cidx[rowsel[b]]`` with the
    distances of :func:`slab_sqdist`. Returns (argbest id int32, best
    sqdist, second-best sqdist), with ``prev_*`` on rows of skipped
    blocks. Ties take the first column. A NaN distance (a non-finite row
    or center, which only fault injection brings in) never wins, as in
    the kernel: it counts as +inf."""
    nb = x.shape[0] // bn
    rs = rowsel.long()
    sq = slab_sqdist(x, ctab, csqtab, rowsel, bn).reshape(nb, bn, -1)
    sq = torch.where(torch.isnan(sq), float("inf"), sq)
    loc = torch.argmin(sq, dim=-1)                   # first-min
    a = torch.gather(cidx[rs], 1, loc).reshape(-1).to(torch.int32)
    if sq.shape[-1] >= 2:
        top2 = torch.topk(sq, 2, dim=-1, largest=False, sorted=True).values
        d1, d2 = top2[..., 0].reshape(-1), top2[..., 1].reshape(-1)
    else:
        d1 = sq[..., 0].reshape(-1)
        d2 = torch.full_like(d1, float("inf"))
    skip_pt = torch.repeat_interleave(skip != 0, bn)
    return (torch.where(skip_pt, prev_a, a).to(torch.int32),
            torch.where(skip_pt, prev_d1, d1),
            torch.where(skip_pt, prev_d2, d2))


# K3's tile (csrc/segmented_scan.cu, ``plan``): TR rows, the largest power
# of two that divides bn, is at most 128 and keeps TR f32 rows of
# min(d, 1024) columns (rounded up to 4, plus 2) within 100 KB.
def scan_tile_rows(bn: int, d: int) -> int:
    row = 4 * (((min(d, 1024) + 3) & ~3) + 2)
    tr = 1
    while tr * 2 <= 128 and bn % (tr * 2) == 0 and row * tr * 2 <= 100 * 1024:
        tr *= 2
    return tr


def segmented_scan_ref(x, w, block2seg, bn: int):
    """Segmented inclusive scans of (w x, w |x|^2, w) over block-aligned
    segments (``block2seg`` non-decreasing), in K3's own arithmetic, so
    that the kernel gives this function's bits. Every lane is summed in
    f64 in one fixed order: a running sum down each tile of
    :func:`scan_tile_rows` rows; the tiles' totals folded left from the
    segment's first tile; a row's value is its tile's exclusive prefix
    plus its running sum, rounded once to f32. The |x|^2 lane sums w times
    the correctly rounded |x|^2 (:func:`exact_sqnorm`), so it too has no
    order of its own. torch's cumsum adds in sequence on the CPU; on the
    card it adds in another order, within rounding of these values."""
    r, d = x.shape
    tr = scan_tile_rows(bn, d)
    nt = r // tr
    lanes = torch.cat([x * w[:, None], (w * exact_sqnorm(x))[:, None],
                       w[:, None]], dim=1).double()
    run = torch.cumsum(lanes.reshape(nt, tr, d + 2), dim=1)
    agg = run[:, -1]
    row0 = torch.arange(nt, device=x.device) * tr
    blk = row0 // bn
    starts = (row0 % bn == 0) & ((blk == 0) | (
        block2seg[blk] != block2seg[torch.clamp(blk - 1, min=0)]))
    incl = torch.empty_like(agg)
    edges = starts.nonzero().flatten().tolist() + [nt]
    for lo, hi in zip(edges[:-1], edges[1:]):
        incl[lo:hi] = torch.cumsum(agg[lo:hi], dim=0)
    excl = torch.zeros_like(agg)
    excl[1:] = torch.where(starts[1:, None], 0.0, incl[:-1])
    out = (excl[:, None, :] + run).reshape(r, d + 2).to(x.dtype)
    return out[:, :d], out[:, d], out[:, d + 1]


def int8_approx_sqdist(xhsq, xsc, tsc, cross, tsq):
    """Approximate squared distance between dequantized rows,
    ``max(xhsq - (2 (xsc tsc)) cross + tsq, 0)``, in the reference's
    order of operations (operands broadcast; all f32)."""
    return torch.clamp(xhsq - 2.0 * (xsc * tsc) * cross + tsq, min=0.0)


def survivor_columns(mask: torch.Tensor, lb: torch.Tensor, r: int):
    """(..., P) margin-test mask and lower bounds -> (surv (..., r) int32:
    the first r survivor columns in ascending order, -1 beyond the count;
    nsv (...,) int32 survivor count, may exceed r; lbm (...,) the least
    lower bound among non-survivors, PAD_SQDIST when every column
    survives)."""
    nsv = torch.sum(mask, dim=-1, dtype=torch.int32)
    pos = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    iota = torch.arange(mask.shape[-1], device=mask.device)
    cols = [torch.where(s < nsv, torch.sum(torch.where(mask & (pos == s),
                                                       iota, 0), dim=-1),
                        -1) for s in range(r)]
    surv = torch.stack(cols, dim=-1).to(torch.int32)
    lbm = torch.amin(torch.where(mask, PAD_SQDIST, lb), dim=-1)
    return surv, nsv, lbm


def candidate_assign_int8_tiled_ref(xq, xsc, xerr, qtab, qsc, qerrtab,
                                    csqtab, rowsel, skip, bn: int, r: int):
    """Int8 margin-test scan over quantized candidate slabs: block b of
    ``xq`` (bn rows) against slab ``qtab[rowsel[b] * (1 - skip[b])]``.
    Per row: the int8 products (exact, in f64), the approximate distance
    s_hat, and the survivors of ``s_hat - rc <= min(s_hat + rc) + 2 rx``
    (rc = qerrtab, rx = xerr; the min starts at PAD_SQDIST as the TPU
    kernel's running minimum does). Returns (surv (n, r) int32 ascending
    survivor columns, -1 padded; nsv (n,) int32; lbm (n,) f32 least
    non-survivor lower bound); a skipped block yields (-1, 0,
    PAD_SQDIST). Runs in chunks of blocks to bound the f64 temporaries."""
    n, d = xq.shape
    nb = n // bn
    tsel = (rowsel * (1 - skip)).long()
    cb = max(1, min(256, 8192 // bn))
    outs = []
    for b0 in range(0, nb, cb):
        ts = tsel[b0:b0 + cb]
        m = ts.shape[0]
        rows = slice(b0 * bn, (b0 + m) * bn)
        xb = xq[rows].reshape(m, bn, d)
        cross = exact_cross(xb, qtab[ts].transpose(1, 2))
        s = xsc[rows].reshape(m, bn, 1)
        xhsq = s * s * exact_sqnorm(xb)[..., None]
        shat = sqrt_rn(int8_approx_sqdist(
            xhsq, s, qsc[ts][:, None, :], cross, csqtab[ts][:, None, :]))
        rc = qerrtab[ts][:, None, :]
        lb = shat - rc
        ub_min = torch.clamp(torch.amin(shat + rc, dim=-1), max=PAD_SQDIST)
        cut = ub_min + 2.0 * xerr[rows].reshape(m, bn)
        live = (skip[b0:b0 + m] == 0)[:, None]
        surv, nsv, lbm = survivor_columns((lb <= cut[..., None])
                                          & live[..., None], lb, r)
        outs.append((surv.reshape(-1, r), nsv.reshape(-1),
                     torch.where(live, lbm, PAD_SQDIST).reshape(-1)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def cluster_attend_ref(q, k_table, v_table, sel, *, valid=None, sizes=None):
    """K6's contract as a one-shot softmax (the reference's
    ``attention._cm_partial``): each row of ``q`` (BH, dh) attends over
    the p blocks ``k_table[sel[i]]`` / ``v_table[sel[i]]`` (rows, cap,
    dh) in f32 at scale dh^-0.5, masked by ``valid`` (rows, cap) > 0 or,
    when ``sizes`` (rows,) is given instead, by slot < size. Returns the
    softmax state (m (BH,), l (BH,), acc (BH, dh)), all f32; a row whose
    blocks are all empty gives (-inf, 0, 0)."""
    bh, dh = q.shape
    cap = k_table.shape[1]
    s = sel.long()
    if sizes is not None:
        ok = (torch.arange(cap, device=q.device)
              < sizes.long()[s][..., None])               # (BH, p, cap)
    else:
        ok = valid[s] > 0
    logits = torch.einsum("nd,npcd->npc", q.float(),
                          k_table[s].float()) * dh ** -0.5
    logits = torch.where(ok, logits, -torch.inf).reshape(bh, -1)
    m = torch.amax(logits, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.where(torch.isfinite(logits),
                    torch.exp(logits - m_safe[:, None]), 0.0)
    acc = torch.einsum("nm,nmd->nd", w,
                       v_table[s].float().reshape(bh, -1, dh))
    return m, torch.sum(w, dim=-1), acc


def clustered_attend_ref(q, k_cache, v_cache, centroids, members,
                         member_mask, top_p: int):
    """Oracle for clustered-KV sparse decode attention (see
    ``cluster_attend``). q: (h, dh); k_cache/v_cache: (h, S, dh);
    centroids: (h, kc, dh); members: (h, kc, cap) int32 indices into S;
    member_mask: same shape, bool. Attends to the union of the top_p
    closest clusters' members (ties to the lower cluster id)."""
    from ..core.distance import bottom_k
    h, s, dh = k_cache.shape
    d2 = (torch.sum(q * q, -1)[:, None]
          - 2.0 * torch.einsum("hd,hkd->hk", q, centroids)
          + torch.sum(centroids * centroids, -1))
    top = bottom_k(d2, top_p).long()                          # (h, p)
    sel = torch.gather(members, 1, top[:, :, None].expand(
        -1, -1, members.shape[2])).reshape(h, -1).long()
    sel_mask = torch.gather(member_mask, 1, top[:, :, None].expand(
        -1, -1, members.shape[2])).reshape(h, -1)
    kk = torch.gather(k_cache, 1, sel[:, :, None].expand(-1, -1, dh))
    vv = torch.gather(v_cache, 1, sel[:, :, None].expand(-1, -1, dh))
    logits = torch.einsum("hd,hmd->hm", q, kk) / torch.sqrt(
        torch.tensor(float(dh), dtype=q.dtype))
    logits = torch.where(sel_mask, logits, -torch.inf)
    w = torch.softmax(logits, dim=-1)
    w = torch.where(sel_mask, w, 0.0)
    return torch.einsum("hm,hmd->hd", w, vv)


def segment_sum_blocks_ref(x, b2s, k: int, bn: int, *, w=None, perm=None):
    """Per-segment sums over a block-grouped layout of ``b2s.shape[0] *
    bn`` slots: block b belongs to segment ``b2s[b]`` (-1: none), slot s
    reads row ``perm[s]`` of ``x`` (-1: empty; slot s itself without
    ``perm``) with weight ``w[s]`` (1 without ``w``). Returns (sums (k, d)
    of RN(x * w), sums (k,) of w), each a scatter-add in slot order
    (``segment_sum.segment_sum_ordered``): the chain ``csrc/segment_sum.cu``
    takes, and, where the layout lists a segment's rows in row order, the
    CPU's row-order ``segment_sum``."""
    dev = x.device
    nslot = b2s.shape[0] * bn
    seg = torch.repeat_interleave(b2s.long(), bn)
    row = perm.long() if perm is not None else torch.arange(nslot,
                                                            device=dev)
    seg = torch.where((seg >= 0) & (row >= 0), seg, k)
    rs = torch.clamp(row, min=0)
    wt = w if w is not None else torch.ones(nslot, dtype=x.dtype,
                                            device=dev)
    vals = x[rs] * wt[:, None] if w is not None else x[rs]
    return (segment_sum_ordered(vals, seg, k + 1)[:k],
            segment_sum_ordered(wt, seg, k + 1)[:k])


def wkv6_scan_ref(r, k, v, w, u, state):
    """``ssm_scan.wkv6_scan``'s contract step by step, as the reference's
    ``ssm.rwkv6_apply`` scan body: kv = k_t v_tᵀ, out_t = r_t · (S + u ⊙
    kv), S <- w_t ⊙ S + kv. r, k, v, w: (B, S, H, dh) f32; u: (H, dh);
    state (B, H, dh, dh) f32, overwritten with the final state (outside
    the autograd graph). Returns out (B, S, H, dh)."""
    out, final = wkv6_scan_states_ref(r, k, v, w, u, state.clone())
    with torch.no_grad():
        state.copy_(final)
    return out


def wkv6_scan_states_ref(r, k, v, w, u, state0):
    """:func:`wkv6_scan_ref` out of place: (out, final state). Each step
    makes a new state (the same product, then sum, as an update in place
    rounds), so autograd through this function gives the gradients of
    every input and of ``state0``: the oracle of ``wkv6_scan_bwd``."""
    outs = []
    uu = u[None, :, :, None]
    s = state0
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv))
        s = s * w[:, t, :, :, None] + kv
    return (torch.stack(outs, 1) if outs else torch.empty_like(v)), s


def ssd_scan_ref(x, Bm, Cm, decay, dt, D, state):
    """``ssm_scan.ssd_scan``'s contract step by step, as the reference's
    ``ssm.mamba2_apply`` scan body and its D skip: upd = (dt_t x_t) B_tᵀ,
    S <- decay_t S + upd, y_t = S C_t, then y + D x. x: (B, S, H, P);
    Bm, Cm: (B, S, N); decay, dt: (B, S, H); D: (H,); state (B, H, P, N),
    overwritten with the final state (outside the autograd graph); all
    f32. Returns y (B, S, H, P)."""
    y, final = ssd_scan_states_ref(x, Bm, Cm, decay, dt, D, state.clone())
    with torch.no_grad():
        state.copy_(final)
    return y


def ssd_scan_states_ref(x, Bm, Cm, decay, dt, D, state0):
    """:func:`ssd_scan_ref` out of place: (y, final state), the oracle of
    ``ssd_scan_bwd`` as :func:`wkv6_scan_states_ref` is of
    ``wkv6_scan_bwd``."""
    ys = []
    s = state0
    for t in range(x.shape[1]):
        upd = (dt[:, t, :, None, None] * x[:, t, :, :, None]
               * Bm[:, t, None, None, :])
        s = s * decay[:, t, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cm[:, t]))
    y = torch.stack(ys, 1) if ys else torch.empty_like(x)
    return y + D[None, None, :, None] * x, s
