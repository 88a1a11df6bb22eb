"""Correctly rounded ``|x|^2`` and ``x.c`` for the torch code around the
kernels: RN_f32 of the exact sum of the exact f32 products, the one
value K1, K5 and K7 give a (point, center) pair (``csrc/common.cuh``).

CUDA tensors go through ``csrc/exact_round.cu``, which screens the f64
sum against its error bound and recomputes the few undecided elements
exactly on the device, with no read to the host; CPU tensors through the
plain versions in ``ref`` of the same names. Not a port of a TPU kernel:
the reference forms these sums in f32 in its glue.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref
from .ref import exact_cross as exact_cross_ref
from .ref import exact_sqnorm as exact_sqnorm_ref
from .ref import sqrt_rn  # noqa: F401  (correctly rounded roots)

_ARGS_SQ = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
_ARGS_ROWDOT = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]
_ARGS_SPLIT = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]
_ARGS_CROSS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])


def plan_exact_sqnorm(rows: int, d: int) -> dict:
    """The launch plan of :func:`exact_sqnorm` over rows of d floats
    (``_build.plan``)."""
    return _build.plan("exact_round", "exact_sqnorm",
                       [ctypes.c_longlong, ctypes.c_int], rows, d)


def plan_exact_rowdot(rows: int, d: int) -> dict:
    """The launch plan of :func:`exact_rowdot` over rows of d floats."""
    return _build.plan("exact_round", "exact_rowdot",
                       [ctypes.c_longlong, ctypes.c_int], rows, d)


def plan_exact_split_sqnorms(rows: int, d: int, *,
                             aligned: bool = True) -> dict:
    """The launch plan of :func:`exact_split_sqnorms` (``aligned``: csum and
    tot 16-byte aligned)."""
    return _build.plan("exact_round", "exact_split_sqnorms",
                       [ctypes.c_longlong, ctypes.c_int, ctypes.c_int], rows,
                       d, int(aligned))


def plan_exact_cross(nbat: int, m: int, k: int, d: int, strides=None, *,
                     aligned: bool = True) -> dict:
    """The launch plan of :func:`exact_cross`'s product kernel over nbat (m,
    d) x (d, k) products; ``strides``: (sat, sam, sad, sbt, sbd, sbk) as
    the kernel takes them (None: both operands contiguous); ``aligned``:
    a and b 16-byte aligned."""
    if strides is None:
        strides = (m * d, d, 1, d * k, k, 1)
    return _build.plan("exact_round", "exact_cross",
                       [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                       + [ctypes.c_int], nbat, m, k, d, *strides,
                       int(aligned))


def exact_sqnorm(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (...): each row's sum of squares, correctly rounded to
    f32 (a zero as +0). Integer rows sum exactly in f64 and round once."""
    if x.device.type == "cpu" or not x.is_floating_point():
        return exact_sqnorm_ref(x)
    d = x.shape[-1]
    rows = x.reshape(-1, d).to(torch.float32).contiguous()
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=x.device)
    fn = _build.function("exact_round", "k2_exact_sqnorm", _ARGS_SQ)
    _build.check(fn(_build.ptr(rows), _build.ptr(out), rows.shape[0], d,
                    _build.stream_ptr(x.device)), "exact_sqnorm")
    _build.count("exact_sqnorm")
    return out.reshape(x.shape[:-1])


def exact_split_sqnorms(csum: torch.Tensor, tot: torch.Tensor,
                        row_seg: torch.Tensor):
    """GDI's split-score norms in one pass over K3's prefix sums: csum
    (R, d) f32, tot (k, d) f32 leaf totals, row_seg (R,) leaf of each row
    in [0, k) -> (|csum[r]|^2, |tot[row_seg[r]] - csum[r]|^2), each (R,)
    and correctly rounded to f32, with no (R, d) suffix formed."""
    if csum.device.type == "cpu":
        return ref.exact_split_sqnorms(csum, tot, row_seg)
    r, d = csum.shape
    _build.require("exact_split_sqnorms", "csum", csum, torch.float32, (r, d))
    _build.require("exact_split_sqnorms", "tot", tot, torch.float32,
                   (tot.shape[0], d))
    row_seg = row_seg.to(torch.int64).contiguous()
    out_p = torch.empty(r, dtype=torch.float32, device=csum.device)
    out_s = torch.empty(r, dtype=torch.float32, device=csum.device)
    fn = _build.function("exact_round", "k2_exact_split_sqnorms",
                         _ARGS_SPLIT)
    p = _build.ptr
    _build.check(fn(p(csum), p(tot), p(row_seg), p(out_p), p(out_s), r, d,
                    _build.stream_ptr(csum.device)), "exact_split_sqnorms")
    _build.count("exact_split_sqnorms")
    return out_p, out_s


def exact_rowdot(x: torch.Tensor, y: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) f32 and (n,) row ids -> (n,): ``x[i] . y[idx[i]]``,
    each correctly rounded to f32 (a zero as +0), with no gather of y's
    rows."""
    if x.device.type == "cpu":
        return ref.exact_rowdot(x, y, idx)
    n, d = x.shape
    _build.require("exact_rowdot", "x", x, torch.float32, (n, d))
    _build.require("exact_rowdot", "y", y, torch.float32, (y.shape[0], d))
    idx = idx.to(torch.int64).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _build.function("exact_round", "k2_exact_rowdot", _ARGS_ROWDOT)
    p = _build.ptr
    _build.check(fn(p(x), p(y), p(idx), p(out), n, d,
                    _build.stream_ptr(x.device)), "exact_rowdot")
    _build.count("exact_rowdot")
    return out


def exact_cross(a: torch.Tensor, b: torch.Tensor, *, asq=None,
                bsq=None) -> torch.Tensor:
    """``a @ b`` for a (..., m, d) and b (..., d, k) f32 (the same batch
    shape, or 2-d; any element strides), each element correctly rounded to
    f32 (a zero as +0). On the card one kernel forms the f64 products on
    the tensor cores and rounds them in its epilogue; no f64 copy of an
    operand is made. Integer inputs multiply exactly in f64 and round
    once. ``asq`` (..., m) / ``bsq`` (..., k): the correctly rounded f32
    squared norms of a's rows / b's columns (``exact_sqnorm``'s values)
    when the caller has them, for the screen's bound; else the kernel
    takes bounds from a and b."""
    if a.device.type == "cpu" or not (a.is_floating_point()
                                      and b.is_floating_point()):
        return exact_cross_ref(a, b, asq=asq, bsq=bsq)
    if a.dim() != b.dim() or a.dim() not in (2, 3) \
            or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"exact_cross: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be (m, d), (d, k) or "
                         f"(t, m, d), (t, d, k)")
    a3 = (a if a.dim() == 3 else a[None]).to(torch.float32)
    b3 = (b if b.dim() == 3 else b[None]).to(torch.float32)
    t, m, d = a3.shape
    k = b3.shape[-1]
    asq, bsq = (None if v is None else v.to(torch.float32).reshape(
        t, rows).contiguous() for v, rows in ((asq, m), (bsq, k)))
    scratch = None if asq is not None and bsq is not None else torch.empty(
        t * (m + k), dtype=torch.float32, device=a.device)
    out = torch.empty((t, m, k), dtype=torch.float32, device=a.device)
    fn = _build.function("exact_round", "k2_exact_cross", _ARGS_CROSS)
    p = _build.ptr
    _build.check(fn(p(a3), p(b3), None if asq is None else p(asq),
                    None if bsq is None else p(bsq), p(out),
                    None if scratch is None else p(scratch), t, m, k, d,
                    *a3.stride(), *b3.stride(), _build.stream_ptr(a.device)),
                 "exact_cross")
    _build.count("exact_cross")
    return out if a.dim() == 3 else out[0]


def exact_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``ref.exact_sqdist`` with this module's rounding: (n, k) squared
    distances, on the device for CUDA tensors."""
    return ref.exact_sqdist(x, c, sqnorm=exact_sqnorm, cross=exact_cross)


def candidate_sqdist(x: torch.Tensor, c: torch.Tensor, cand: torch.Tensor,
                     *, chunk: int = 2048, xsq=None, csq=None) -> torch.Tensor:
    """Squared distances of each row of ``x`` (m, d) to its own candidate
    centers ``cand`` (m, P) int (-1 = padding) among ``c`` (k, d) -> (m,
    P): the columns of :func:`exact_sqdist` (the value every kernel gives
    a pair), PAD_SQDIST at padding. One :func:`exact_rowdot` over the
    flattened pairs of each ``chunk`` rows, each row repeated once per
    candidate: neither the dense (m, k) product nor a gather of c's rows
    is formed. ``xsq``/``csq``: the rows' and centers' ``exact_sqnorm``
    when the caller has them."""
    m, p = cand.shape
    xsq = exact_sqnorm(x) if xsq is None else xsq
    csq = exact_sqnorm(c) if csq is None else csq
    c = c.contiguous()
    safe = torch.clamp(cand, min=0).long()
    cross = torch.cat([
        exact_rowdot(x[lo:lo + chunk].repeat_interleave(p, dim=0), c,
                     safe[lo:lo + chunk].reshape(-1))
        for lo in range(0, max(m, 1), chunk)]).reshape(m, p)
    sq = torch.clamp(xsq[:, None] - 2.0 * cross + csq[safe], min=0.0)
    return torch.where(cand >= 0, sq, ref.PAD_SQDIST)


def slab_sqdist(x, ctab, csqtab, rowsel, bn: int):
    """``ref.slab_sqdist`` (K1's distances over its candidate slabs) with
    this module's rounding, on the device for CUDA tensors."""
    return ref.slab_sqdist(x, ctab, csqtab, rowsel, bn, sqnorm=exact_sqnorm,
                           cross=exact_cross)
