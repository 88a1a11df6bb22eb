"""Plain PyTorch versions of the port's kernels (port of
``repro.kernels.ref``): the functions each CUDA kernel computes, run by
the kernel wrappers on CPU tensors and held against the kernels on the
card."""
from __future__ import annotations

import torch



def center_sqdist_ref(c: torch.Tensor) -> torch.Tensor:
    """(k, d) -> (k, k) squared center distances, clamped at 0."""
    sq = torch.sum(c * c, dim=-1)
    return torch.clamp(sq[:, None] - 2.0 * (c @ c.T) + sq[None, :], min=0.0)


def candidate_assign_tiled_ref(x, ctab, csqtab, cidx, rowsel, skip, prev_a,
                               prev_d1, prev_d2, bn: int):
    """Grouped k_n-restricted assignment over a candidate table: block b
    of ``x`` (bn rows) competes among ``cidx[rowsel[b]]``. Returns
    (argbest id int32, best sqdist, second-best sqdist), with ``prev_*``
    on rows of skipped blocks. Ties take the first column."""
    n, d = x.shape
    nb = n // bn
    rs = rowsel.long()
    xb = x.reshape(nb, bn, d)
    ct = ctab[rs]                                    # (nb, kn_pad, d)
    cross = torch.bmm(xb, ct.transpose(1, 2))        # (nb, bn, kn_pad)
    sq = torch.clamp(torch.sum(xb * xb, dim=-1)[..., None] - 2.0 * cross
                     + csqtab[rs][:, None, :], min=0.0)
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
