"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``): the functions each CUDA kernel computes, run by
the kernel wrappers on CPU tensors and held against the kernels on the
card."""
from __future__ import annotations

import torch

# Padded candidate columns carry this squared "distance" so they never win
# an argmin; finite (not inf) so no inf-inf NaNs can appear downstream.
PAD_SQDIST = 1e30


def center_sqdist_ref(c: torch.Tensor) -> torch.Tensor:
    """(k, d) -> (k, k) squared center distances, clamped at 0."""
    sq = torch.sum(c * c, dim=-1)
    return torch.clamp(sq[:, None] - 2.0 * (c @ c.T) + sq[None, :], min=0.0)


def exact_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares accumulated in f64 and rounded once to f32:
    the correctly rounded value (up to a rare double rounding), whatever
    the order, so every evaluation of a row's norm agrees. Exact for
    int8 rows (every partial sum is an integer below 2^53)."""
    xd = x.double()
    return torch.sum(xd * xd, dim=-1).float()


def exact_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched or not) accumulated in f64 and rounded once to
    f32: each f32 x f32 product is exact in f64, so the result does not
    depend on the order of the sum (see :func:`exact_sqnorm`)."""
    return (a.double() @ b.double()).float()


def exact_sqdist(x: torch.Tensor, c: torch.Tensor, *,
                 chunk_elems: int = 1 << 24) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) f32 squared distances ``max((|x|^2 -
    2 x.c) + |c|^2, 0)`` from the exactly rounded norms and products,
    the value every kernel of the port gives a (point, center) pair. Runs
    in row chunks that keep the f64 product under ``chunk_elems``
    values."""
    csq = exact_sqnorm(c)
    ct = c.T
    rows = max(1, chunk_elems // max(c.shape[0], 1))
    return torch.cat([torch.clamp(exact_sqnorm(xb)[:, None]
                                  - 2.0 * exact_cross(xb, ct) + csq, min=0.0)
                      for xb in torch.split(x, rows)])


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
                chunk_elems: int = 1 << 24):
    """Squared distances of every grouped row to each column of its
    block's slab ``ctab[rowsel[b]]``, (n, kn_pad): ``max((|x|^2 - 2 x.c)
    + |c|^2, 0)`` in f32 from the exactly rounded ``|x|^2`` and ``x.c``,
    the values K1 selects from (so K1, this function and
    ``quant.rerank_exact`` give one pair one value). Padding columns
    carry ``csqtab`` = PAD_SQDIST. Runs in chunks of blocks so that the
    gathered f64 slabs stay under ``chunk_elems`` values."""
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
    blocks. Ties take the first column."""
    nb = x.shape[0] // bn
    rs = rowsel.long()
    sq = slab_sqdist(x, ctab, csqtab, rowsel, bn).reshape(nb, bn, -1)
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


def segmented_scan_ref(x, w, block2seg, bn: int):
    """Segmented inclusive scans of (w x, w |x|^2, w) over block-aligned
    segments (``block2seg`` non-decreasing): a global inclusive cumsum
    minus the cumsum just before each segment's first row, the
    formulation of the reference's device-resident sweep
    (``gdi._segmented_sweep``, impl="xla"). The cumsums run in float64 so
    that the subtraction keeps f32 accuracy relative to the segment's own
    sums, not to the global prefix; results are cast back to x's type."""
    r = x.shape[0]
    nb = r // bn
    xw = x * w[:, None]
    gx = torch.cumsum(xw.double(), dim=0)
    gq = torch.cumsum(torch.sum(xw * x, dim=-1).double(), dim=0)
    gc = torch.cumsum(w.double(), dim=0)
    blk = torch.arange(nb, device=x.device)
    new = torch.ones(nb, dtype=torch.bool, device=x.device)
    new[1:] = block2seg[1:] != block2seg[:-1]
    start = torch.cummax(torch.where(new, blk, 0), dim=0).values
    prev_row = torch.clamp(start * bn - 1, min=0)
    has = start > 0
    row_blk = torch.repeat_interleave(blk, bn)
    off_x = torch.where(has[:, None], gx[prev_row], 0.0)[row_blk]
    off_q = torch.where(has, gq[prev_row], 0.0)[row_blk]
    off_c = torch.where(has, gc[prev_row], 0.0)[row_blk]
    return ((gx - off_x).to(x.dtype), (gq - off_q).to(x.dtype),
            (gc - off_c).to(x.dtype))


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
        shat = torch.sqrt(int8_approx_sqdist(
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
