"""K5: the nearest of all k centers for every point, fused with its
squared distance — Lloyd's assignment step and ``assign_nearest``.

Port of ``repro.kernels.distance_argmin``. CUDA tensors go through the
hand-written kernel ``csrc/distance_argmin.cu``; CPU tensors through the
plain version ``ref.distance_argmin_ref``. The kernel tiles both n and
k and handles ragged n, k and any d itself, so no padded copies are made
(the reference pads x and c to its block sizes); it picks its own tiles,
so the reference's ``choose_blocks`` (a TPU VMEM budget) has no
counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .exact_round import exact_sqnorm
from .ref import distance_argmin_ref

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def plan_distance_argmin(n: int, k: int, d: int, *,
                         aligned: bool = True) -> dict:
    """The launch plan of :func:`distance_argmin` over n points and k
    centers of d floats (``_build.plan``); ``aligned``: x and c 16-byte
    aligned."""
    return _build.plan("distance_argmin", "distance_argmin",
                       [ctypes.c_int] * 4, n, k, d, int(aligned))


def distance_argmin(x: torch.Tensor, c: torch.Tensor):
    """Nearest center per point: x (n, d) f32, c (k, d) f32, k >= 1 ->
    (assignment int32 (n,), min sqdist f32 (n,)), ties to the first
    center; the (n, k) distance matrix is never formed."""
    if x.dim() != 2 or c.dim() != 2 or c.shape[1] != x.shape[1] \
            or c.shape[0] < 1:
        raise ValueError(f"distance_argmin: x {tuple(x.shape)} and c "
                         f"{tuple(c.shape)} must be (n, d) and (k >= 1, d)")
    if x.device.type == "cpu":
        return distance_argmin_ref(x, c)
    n, d = x.shape
    k = c.shape[0]
    _build.require("distance_argmin", "x", x, torch.float32, (n, d))
    _build.require("distance_argmin", "c", c, torch.float32, (k, d))
    # |c|^2 outside the kernel, as the reference's wrapper takes it
    csq = exact_sqnorm(c)
    a = torch.empty((n,), dtype=torch.int32, device=x.device)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _build.function("distance_argmin", "k2_distance_argmin", _ARGS)
    p = _build.ptr
    _build.check(fn(p(x), p(c), p(csq), p(a), p(dmin), n, k, d,
                    _build.stream_ptr(x.device)), "distance_argmin")
    _build.count("distance_argmin")
    return a, dmin
