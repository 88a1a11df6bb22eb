"""Correctly rounded ``|x|^2`` and ``x.c`` for the torch code around the
kernels: RN_f32 of the exact sum of the exact f32 products, the one
value K1, K5 and K7 give a (point, center) pair (``csrc/common.cuh``).

CUDA tensors go through ``csrc/exact_round.cu``, which screens the f64
sum against its error bound and recomputes the few undecided elements
exactly on the device, with no read to the host; CPU tensors through the
plain versions ``ref.exact_sqnorm`` and ``ref.exact_cross``. Not a port
of a TPU kernel: the reference forms these sums in f32 in its glue.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref
from .ref import exact_cross as exact_cross_ref
from .ref import exact_sqnorm as exact_sqnorm_ref

_ARGS_SQ = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p]
_ARGS_ROWDOT = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]
_ARGS_CROSS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
               + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])


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


def exact_cross(a: torch.Tensor, b: torch.Tensor, *, na=None,
                nb=None) -> torch.Tensor:
    """``a @ b`` for a (..., m, d) and b (..., d, k) f32 (the same batch
    shape, or 2-d), each element correctly rounded to f32 (a zero as +0).
    The f64 product is a DGEMM (``torch.matmul``); the kernel rounds it.
    Integer inputs multiply exactly in f64 and round once. ``na`` /
    ``nb``: the f64 norms of a's rows / b's columns when the caller has
    them (the screen's bound)."""
    if a.device.type == "cpu" or not (a.is_floating_point()
                                      and b.is_floating_point()):
        return exact_cross_ref(a, b, na=na, nb=nb)
    if a.dim() != b.dim() or a.dim() not in (2, 3) \
            or a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"exact_cross: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be (m, d), (d, k) or "
                         f"(t, m, d), (t, d, k)")
    a3 = (a if a.dim() == 3 else a[None]).to(torch.float32)
    b3 = (b if b.dim() == 3 else b[None]).to(torch.float32)
    ad, bd = a3.double(), b3.double()
    s = (ad @ bd).contiguous()
    na = (torch.linalg.vector_norm(ad, dim=-1) if na is None
          else na.reshape(a3.shape[:2])).contiguous()
    nb = (torch.linalg.vector_norm(bd, dim=-2) if nb is None
          else nb.reshape(b3.shape[0], b3.shape[2])).contiguous()
    t, m, d = a3.shape
    k = b3.shape[-1]
    out = torch.empty((t, m, k), dtype=torch.float32, device=a.device)
    fn = _build.function("exact_round", "k2_exact_cross", _ARGS_CROSS)
    p = _build.ptr
    _build.check(fn(p(s), p(a3), p(b3), p(na), p(nb), p(out), t, m, k, d,
                    *a3.stride(), *b3.stride(), _build.stream_ptr(a.device)),
                 "exact_cross")
    _build.count("exact_cross")
    return out if a.dim() == 3 else out[0]


def exact_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``ref.exact_sqdist`` with this module's rounding: (n, k) squared
    distances, on the device for CUDA tensors."""
    return ref.exact_sqdist(x, c, sqnorm=exact_sqnorm, cross=exact_cross)


def slab_sqdist(x, ctab, csqtab, rowsel, bn: int):
    """``ref.slab_sqdist`` (K1's distances over its candidate slabs) with
    this module's rounding, on the device for CUDA tensors."""
    return ref.slab_sqdist(x, ctab, csqtab, rowsel, bn, sqnorm=exact_sqnorm,
                           cross=exact_cross)
