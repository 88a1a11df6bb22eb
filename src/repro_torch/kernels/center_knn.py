"""K2: the k x k center distance matrix behind the center k_n-NN graph.

Port of ``repro.kernels.center_knn``. CUDA tensors go through the
hand-written kernel ``csrc/center_knn.cu``; CPU tensors through the
plain version ``ref.center_sqdist_ref``. Both give every distance as
``max((|c_i|^2 - 2 c_i.c_j) + |c_j|^2, 0)`` in f32 from the correctly
rounded norms and products (``csrc/common.cuh``), so the card's matrix
is the CPU's bit for bit and no permutation of d changes it. The kernel
forms the f64 products on the tensor cores, only for the tiles on and
above the diagonal, and writes each product both ways. The top-k_n
selection stays outside the kernel (``core.engine.center_knn_graph``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import center_sqdist_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def plan_center_sqdist(k: int, d: int, *, aligned: bool = True) -> dict:
    """The launch plan of :func:`center_sqdist`'s tile kernel over k
    centers of d floats (``_build.plan``); ``aligned``: c 16-byte
    aligned."""
    return _build.plan("center_knn", "center_sqdist", [ctypes.c_int] * 3, k,
                       d, int(aligned))


def center_sqdist(c: torch.Tensor) -> torch.Tensor:
    """(k, d) f32 -> (k, k) squared distances, clamped at 0. A call runs
    the rows' rounded squared norms, then the tiles, and counts once."""
    if c.device.type == "cpu":
        return center_sqdist_ref(c)
    if c.dtype != torch.float32 or c.dim() != 2 or not c.is_contiguous():
        raise ValueError("center_sqdist: c must be a contiguous (k, d) "
                         f"float32 tensor, got {c.dtype} {tuple(c.shape)}")
    k, d = c.shape
    out = torch.empty((k, k), dtype=torch.float32, device=c.device)
    csq = torch.empty((k,), dtype=torch.float32, device=c.device)
    fn = _build.function("center_knn", "k2_center_sqdist", _ARGS)
    _build.check(fn(_build.ptr(c), _build.ptr(csq), _build.ptr(out), k, d,
                    _build.stream_ptr(c.device)), "center_sqdist")
    _build.count("center_sqdist")
    return out
