"""Symmetric int8 quantization for the scan stages (port of
``repro.kernels.quant``, DESIGN.md §13).

Scheme (symmetric, per row): ``scale = max|row| / 127``, ``q =
round(row / scale)`` clipped to [-127, 127] (``torch.round`` rounds half
to even, as ``jnp.round`` does). Margin bound: with ``s_j`` the distance
between the dequantized query and candidate j and the exact residual
norms ``rx = ||x - dequant(x)||``, ``rc_j`` as radii, every true minimum
survives ``s_j - rc_j <= min_l (s_l + rc_l) + 2 rx``, so an exact f32
re-rank of the survivors returns the f32 argmin.

Idioms that differ from the reference: every product and norm is
accumulated in f64 and rounded once to f32. For int8 rows that is exact
(every partial sum is an integer below 2^53) and its cast rounds as the
reference's int32 -> f32 does (PyTorch has no integer matmul on CUDA);
for f32 rows it is the correctly rounded value, which K1 computes too,
so the f32 path and the int8 re-rank agree on every pair. Products
against gathered candidate rows are taken as one (m, rows) product whose
columns are gathered, so no (m, P, d) gather is ever formed. K4
(``candidate_assign.candidate_assign_int8_tiled``) computes the same
survivor sets over the slab layout.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .exact_round import exact_cross, exact_sqnorm, sqrt_rn
from .ref import PAD_SQDIST, int8_approx_sqdist, survivor_columns

QMAX = 127.0
_EPS = 1e-12        # zero-row guard: a zero scale would 0/0 the dequant


class CenterQuant(NamedTuple):
    """Quantized row table: int8 rows, per-row scales, exact squared
    norms of the dequantized rows, and the exact residual norms
    ``err = ||row - dequant(row)||`` (the margins' radii)."""
    q: torch.Tensor        # (rows, d) int8
    scale: torch.Tensor    # (rows,) f32
    sq: torch.Tensor       # (rows,) f32  ||dequant(q)||^2
    err: torch.Tensor      # (rows,) f32  ||row - dequant(q)||


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization: (..., d) -> (q int8, scale)."""
    amax = torch.amax(torch.abs(x), dim=-1)
    scale = torch.clamp(amax / QMAX, min=_EPS).to(torch.float32)
    q = torch.clamp(torch.round(x / scale[..., None]), -QMAX, QMAX)
    return q.to(torch.int8), scale


def quantize_tiles(x: torch.Tensor, tile: int):
    """One shared scale per ``tile`` consecutive rows (rows must divide),
    returned broadcast back to one scale per row."""
    rows, d = x.shape
    if rows % tile:
        raise ValueError(f"quantize_tiles: rows={rows} must divide by "
                         f"tile={tile}")
    amax = torch.amax(torch.abs(x).reshape(rows // tile, tile * d), dim=-1)
    scale = torch.clamp(amax / QMAX, min=_EPS).to(torch.float32)
    srow = torch.repeat_interleave(scale, tile)
    q = torch.clamp(torch.round(x / srow[:, None]), -QMAX, QMAX)
    return q.to(torch.int8), srow


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def quant_radius(scale: torch.Tensor, d: int) -> torch.Tensor:
    """Worst-case l2 distortion of a quantized row (scale/2 per dim)."""
    return scale * (math.sqrt(d) / 2.0)


def residual_norm(x: torch.Tensor, q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Exact residual norms ``||x - dequant(q)||`` per row (the margins'
    radii), the sum of squares rounded once from f64."""
    return sqrt_rn(exact_sqnorm(x - dequantize_rows(q, scale)))


def center_quant(c: torch.Tensor) -> CenterQuant:
    """Quantize the (k, d) center table per row."""
    q, scale = quantize_rows(c)
    cd = dequantize_rows(q, scale)      # one round trip, as the reference
    return CenterQuant(q, scale, exact_sqnorm(cd),
                       sqrt_rn(exact_sqnorm(c - cd)))


def quantized_candidate_slabs(cq: CenterQuant, cidx: torch.Tensor):
    """Quantized per-cluster candidate slabs for K4, the int8 analogue of
    ``candidate_assign.candidate_tables``: cidx (T, kn_pad) int32 (-1 =
    padding) -> (qtab (T, kn_pad, d) int8, qsc, qerrtab (T, kn_pad) f32
    with 0 at padding, csqtab (T, kn_pad) f32 with PAD_SQDIST at
    padding)."""
    valid = cidx >= 0
    safe = torch.clamp(cidx, min=0).long()
    qsc = torch.where(valid, cq.scale[safe], 0.0)
    qerrtab = torch.where(valid, cq.err[safe], 0.0)
    csqtab = torch.where(valid, cq.sq[safe], PAD_SQDIST)
    return (cq.q[safe].contiguous(), qsc.contiguous(), qerrtab.contiguous(),
            csqtab.to(torch.float32).contiguous())


def int8_shat(xq: torch.Tensor, xsc: torch.Tensor, cq: CenterQuant,
              cand: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate distances s_hat between int8 rows (xq, xsc) and the
    rows of ``cq``: all of them, (m, rows), or the (m, P) columns
    ``cand`` (-1 = padding: scale 0, squared norm PAD_SQDIST)."""
    cross = exact_cross(xq, cq.q.T)
    xhsq = (xsc * xsc * exact_sqnorm(xq))[:, None]
    if cand is None:
        return sqrt_rn(int8_approx_sqdist(
            xhsq, xsc[:, None], cq.scale[None, :], cross, cq.sq[None, :]))
    valid = cand >= 0
    safe = torch.clamp(cand, min=0).long()
    cross = torch.gather(cross, 1, safe)
    return sqrt_rn(int8_approx_sqdist(
        xhsq, xsc[:, None], torch.where(valid, cq.scale[safe], 0.0), cross,
        torch.where(valid, cq.sq[safe], PAD_SQDIST)))


def margin_test(xq, xsc, xerr, cq: CenterQuant, cand: torch.Tensor):
    """The margin test over per-row candidate lists ``cand`` (m, P): (lb
    = s_hat - rc (m, P), mask (m, P) of the candidates that may be the
    true argmin; padding never survives)."""
    valid = cand >= 0
    shat = int8_shat(xq, xsc, cq, cand)
    rc = torch.where(valid, cq.err[torch.clamp(cand, min=0).long()], 0.0)
    lb = shat - rc
    cut = torch.amin(shat + rc, dim=1) + 2.0 * xerr
    return lb, (lb <= cut[:, None]) & valid


def approx_scan(xq: torch.Tensor, xsc: torch.Tensor, xerr: torch.Tensor,
                cq: CenterQuant, cand: torch.Tensor, *, r: int = 8,
                chunk: int = 2048):
    """Chunked int8 scan over per-row candidate lists, the row-list form
    of K4: xq (m, d) int8, xsc/xerr (m,), cand (m, P) int32 (-1 =
    invalid). Returns (surv (m, r), n_surv (m,), lb_min (m,)) as
    ``ref.survivor_columns``."""
    outs = []
    for lo in range(0, xq.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        lb, mask = margin_test(xq[sl], xsc[sl], xerr[sl], cq, cand[sl])
        outs.append(survivor_columns(mask, lb, r))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def sqdist_exact(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs squared distances (m, d) x (k, d) -> (m, k) with the
    oracle's formula ``max((|x|^2 - 2 x.c) + |c|^2, 0)``, its norms and
    products correctly rounded (``exact_round.exact_sqnorm``,
    ``exact_round.exact_cross``), as K1 computes them: a (row, center)
    pair gets one value wherever, and on whichever device, it is
    evaluated. The rounded norms also bound the products' screen."""
    xsq, csq = exact_sqnorm(x), exact_sqnorm(c)
    cross = exact_cross(x, c.T, asq=xsq, bsq=csq)
    return torch.clamp(xsq[:, None] - 2.0 * cross + csq[None, :], min=0.0)


def rerank_exact(xf: torch.Tensor, c: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """Exact f32 squared distances of rows ``xf`` to the centers ``ids``
    (m, r) (-1 -> PAD_SQDIST): columns of :func:`sqdist_exact`, so no (m,
    r, d) gather is formed."""
    sq = torch.gather(sqdist_exact(xf, c), 1,
                      torch.clamp(ids, min=0).long())
    return torch.where(ids >= 0, sq, PAD_SQDIST)


def first_min_top2(sq: torch.Tensor, ids: torch.Tensor):
    """First-min argmin and second-best over a (m, r) exact-distance
    tile: (a (m,) int32 winning id, d1 (m,), d2 (m,) with PAD_SQDIST when
    no second candidate exists)."""
    loc = torch.argmin(sq, dim=1, keepdim=True)       # first minimum
    d1 = torch.gather(sq, 1, loc)[:, 0]
    a = torch.gather(ids, 1, loc)[:, 0]
    hit = torch.arange(sq.shape[1], device=sq.device)[None, :] == loc
    d2 = torch.amin(torch.where(hit, PAD_SQDIST, sq), dim=1)
    return a.to(torch.int32), d1, d2


def full_candidate_top2_sq(xf: torch.Tensor, c: torch.Tensor,
                           cand: torch.Tensor, *, chunk: int = 2048):
    """Exact f32 top-2 over full per-row candidate lists, the fallback
    for rows whose survivor set overflows the re-rank width. Returns (a,
    d1_sq, d2_sq)."""
    outs = [first_min_top2(rerank_exact(xf[lo:lo + chunk], c,
                                        cand[lo:lo + chunk]),
                           cand[lo:lo + chunk])
            for lo in range(0, xf.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


__all__ = ["CenterQuant", "QMAX", "approx_scan", "center_quant",
           "dequantize_rows", "first_min_top2", "full_candidate_top2_sq",
           "int8_shat", "margin_test", "quant_radius", "quantize_rows",
           "quantize_tiles", "quantized_candidate_slabs", "rerank_exact",
           "residual_norm", "sqdist_exact"]
