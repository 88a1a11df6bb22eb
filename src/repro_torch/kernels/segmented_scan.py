"""K3: segmented inclusive scan over a leaf-grouped layout — the Lemma-1
sweep of the divisive init.

Port of ``repro.kernels.segmented_scan``. CUDA tensors go through the
hand-written one-pass kernel ``csrc/segmented_scan.cu`` (decoupled
look-back); CPU tensors through the plain version
``ref.segmented_scan_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import segmented_scan_ref

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SCRATCH_ARGS = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_size_t)]


def plan_segmented_scan(nb: int, bn: int, d: int, *,
                        aligned: bool = True) -> dict:
    """The launch plan of :func:`segmented_scan` over nb blocks of bn rows
    of d floats (``_build.plan``); ``aligned``: x and csum 16-byte
    aligned."""
    return _build.plan("segmented_scan", "segmented_scan",
                       [ctypes.c_int] * 4, nb, bn, d, int(aligned))


def segmented_scan(x: torch.Tensor, w: torch.Tensor, block2seg: torch.Tensor,
                   *, bn: int):
    """Segmented inclusive scan of (x, ||x||^2, 1) weighted by ``w``.

    x: (R, d) f32 rows in leaf-grouped order (R = nb * bn); w: (R,) f32
    (1 real row, 0 padding); block2seg: (nb,) int32 leaf id per block,
    non-decreasing. Returns (csum (R, d), qsum (R,), cnt (R,)), each
    inclusive within its segment.
    """
    r, d = x.shape
    if r % bn or block2seg.shape != (r // bn,) or w.shape != (r,):
        raise ValueError(f"segmented_scan: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and block2seg "
                         f"{tuple(block2seg.shape)} disagree at bn={bn}")
    if x.device.type == "cpu":
        return segmented_scan_ref(x, w, block2seg, bn)
    for name, t, dt in (("x", x, torch.float32), ("w", w, torch.float32),
                        ("block2seg", block2seg, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device.type != "cuda":
            raise ValueError(f"segmented_scan: {name} must be a contiguous "
                             f"CUDA {dt} tensor, got {t.dtype} on {t.device}")
    nb = r // bn
    dev = x.device
    # the kernel's tile counter, flags and carries, sized by its own plan
    nbytes = ctypes.c_size_t()
    _build.check(_build.function("segmented_scan", "k2_segmented_scan_scratch",
                                 _SCRATCH_ARGS)(nb, bn, d,
                                                ctypes.byref(nbytes)),
                 "segmented_scan")
    scratch = torch.empty((nbytes.value,), dtype=torch.uint8, device=dev)
    csum = torch.empty((r, d), dtype=torch.float32, device=dev)
    qsum = torch.empty((r,), dtype=torch.float32, device=dev)
    cnt = torch.empty((r,), dtype=torch.float32, device=dev)
    fn = _build.function("segmented_scan", "k2_segmented_scan", _ARGS)
    p = _build.ptr
    _build.check(fn(p(x), p(w), p(block2seg), p(scratch), p(csum), p(qsum),
                    p(cnt), nb, bn, d, _build.stream_ptr(dev)),
                 "segmented_scan")
    _build.count("segmented_scan")
    return csum, qsum, cnt
