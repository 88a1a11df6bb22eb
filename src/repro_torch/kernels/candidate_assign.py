"""K1: k_n-restricted assignment over the cluster-grouped layout — the
k²-means hotspot.

Port of ``repro.kernels.candidate_assign`` (the tiled fast path). CUDA
tensors go through the hand-written kernel ``csrc/candidate_assign.cu``;
CPU tensors through the plain version ``ref.candidate_assign_tiled_ref``.

Contract: points are grouped so that every block of bn rows shares one
candidate list, ``cidx[rowsel[b]]``; blocks need not be cluster
contiguous or hole free, which is what lets the resident layout repair
blocks in place. A block with ``skip[b] != 0`` emits ``prev_*``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import candidate_assign_tiled_ref

# Padded candidate columns carry this squared "distance" so they never win
# an argmin; finite (not inf) so no inf-inf NaNs can appear downstream.
PAD_SQDIST = 1e30

_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pad_candidates(cand: torch.Tensor, bkn: int) -> torch.Tensor:
    """Pad candidate lists (rows, kn) -> (rows, kn_pad) with -1 sentinels
    so kn divides into bkn tiles. -1 columns are masked to PAD_SQDIST."""
    pad = (-cand.shape[-1]) % bkn
    if pad == 0:
        return cand
    return torch.nn.functional.pad(cand, (0, pad), value=-1)


def candidate_tables(c: torch.Tensor, cidx: torch.Tensor):
    """Candidate-center table for :func:`candidate_assign_tiled`:
    c (k, d), cidx (T, kn_pad) int32 (-1 = padding) -> (ctab (T, kn_pad,
    d), csqtab (T, kn_pad)) with PAD_SQDIST on padded columns."""
    ctab = c[torch.clamp(cidx, min=0).long()]
    csqtab = torch.where(cidx >= 0, torch.sum(ctab * ctab, dim=-1),
                         torch.full_like(ctab[..., 0], PAD_SQDIST))
    return ctab.contiguous(), csqtab.to(torch.float32).contiguous()


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device.type != "cuda":
        raise ValueError(f"candidate_assign_tiled: {name} must be a "
                         f"contiguous CUDA {dtype} tensor of shape "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def candidate_assign_tiled(x, ctab, csqtab, cidx, rowsel, skip, prev_a,
                           prev_d1, prev_d2, *, bn: int, bkn: int = 8):
    """Tiled k_n-restricted assignment over a candidate-center table.

    x: (n, d) f32 grouped points, n % bn == 0; ctab: (T, kn_pad, d) f32;
    csqtab: (T, kn_pad) f32; cidx: (T, kn_pad) int32; rowsel, skip: (nb,)
    int32; prev_a int32, prev_d1/prev_d2 f32: (n,). Returns (assignment
    int32 (n,), best sqdist f32 (n,), second-best sqdist f32 (n,)).
    """
    n, d = x.shape
    t, knp = cidx.shape
    if n % bn or knp % bkn:
        raise ValueError(f"candidate_assign_tiled: n={n} must divide by "
                         f"bn={bn} and kn_pad={knp} by bkn={bkn}")
    nb = n // bn
    if x.device.type == "cpu":
        return candidate_assign_tiled_ref(x, ctab, csqtab, cidx, rowsel,
                                          skip, prev_a, prev_d1, prev_d2, bn)
    f32, i32 = torch.float32, torch.int32
    for name, ten, dt, shape in (
            ("x", x, f32, (n, d)), ("ctab", ctab, f32, (t, knp, d)),
            ("csqtab", csqtab, f32, (t, knp)), ("cidx", cidx, i32, (t, knp)),
            ("rowsel", rowsel, i32, (nb,)), ("skip", skip, i32, (nb,)),
            ("prev_a", prev_a, i32, (n,)), ("prev_d1", prev_d1, f32, (n,)),
            ("prev_d2", prev_d2, f32, (n,))):
        _check(name, ten, dt, shape)
    a = torch.empty((n,), dtype=i32, device=x.device)
    d1 = torch.empty((n,), dtype=f32, device=x.device)
    d2 = torch.empty((n,), dtype=f32, device=x.device)
    fn = _build.function("candidate_assign", "k2_candidate_assign_tiled",
                         _ARGS)
    p = _build.ptr
    _build.check(fn(p(x), p(ctab), p(csqtab), p(cidx), p(rowsel), p(skip),
                    p(prev_a), p(prev_d1), p(prev_d2), p(a), p(d1), p(d2),
                    nb, bn, knp, d, _build.stream_ptr(x.device)),
                 "candidate_assign_tiled")
    _build.count("candidate_assign_tiled")
    return a, d1, d2
