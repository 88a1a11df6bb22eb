"""K1, K4 and K7: k_n-restricted assignment over the cluster-grouped
layout — the k²-means hotspot — in f32 (K1), as the int8 margin-test
scan (K4), and as the legacy one-candidate-at-a-time baseline (K7).

Port of ``repro.kernels.candidate_assign``. CUDA tensors go through the
hand-written kernels ``csrc/candidate_assign.cu``,
``csrc/candidate_assign_int8.cu`` and ``csrc/candidate_assign_rowwise.cu``;
CPU tensors through the plain versions ``ref.candidate_assign_tiled_ref``,
``ref.candidate_assign_int8_tiled_ref`` and ``ref.candidate_assign_ref``.

Contract: points are grouped so that every block of bn rows shares one
candidate list, ``cidx[rowsel[b]]`` (K1, K4) or ``cand[b]`` (K7); blocks
need not be cluster contiguous or hole free, which is what lets the
resident layout repair blocks in place. A block with ``skip[b] != 0``
emits ``prev_*`` (K1, K7) or no survivors (K4). K1 and K4 take any
kn_pad and K7 any kn: each walks it in 32-column chunks. K7 also takes
any bn, splitting a block of more than 32 rows among CUDA blocks.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .exact_round import exact_sqnorm
from .ref import (PAD_SQDIST, candidate_assign_int8_tiled_ref,
                  candidate_assign_ref, candidate_assign_tiled_ref)

_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGS_INT8 = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGS_ROWWISE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def plan_candidate_assign_tiled(nb: int, bn: int, knp: int, d: int, *,
                                aligned: bool = True) -> dict:
    """The launch plan of :func:`candidate_assign_tiled` over nb blocks of
    bn rows and knp candidates of d floats, the one its launcher takes
    (``_build.plan``); ``aligned``: x and ctab 16-byte aligned."""
    return _build.plan("candidate_assign", "candidate_assign_tiled",
                       [ctypes.c_int] * 5, nb, bn, knp, d, int(aligned))


def plan_candidate_assign_int8_tiled(nb: int, bn: int, knp: int, d: int,
                                     r: int, *, aligned: bool = True) -> dict:
    """The launch plan of :func:`candidate_assign_int8_tiled` (``aligned``:
    xq and qtab 16-byte aligned)."""
    return _build.plan("candidate_assign_int8", "candidate_assign_int8_tiled",
                       [ctypes.c_int] * 6, nb, bn, knp, d, r, int(aligned))


def plan_candidate_assign_rowwise(nb: int, bn: int, kn: int, d: int, *,
                                  aligned: bool = True) -> dict:
    """The launch plan of :func:`candidate_assign_rowwise` (``aligned``: x
    and c 16-byte aligned)."""
    return _build.plan("candidate_assign_rowwise", "candidate_assign_rowwise",
                       [ctypes.c_int] * 5, nb, bn, kn, d, int(aligned))


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
    d), csqtab (T, kn_pad)) with the correctly rounded ``|c|^2``
    (``exact_round.exact_sqnorm``) and PAD_SQDIST on padded columns."""
    safe = torch.clamp(cidx, min=0).long()
    csqtab = torch.where(cidx >= 0, exact_sqnorm(c)[safe], PAD_SQDIST)
    return c[safe].contiguous(), csqtab.to(torch.float32).contiguous()


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
    if n % bn or knp % bkn or not 1 <= bn <= 128:
        raise ValueError(f"candidate_assign_tiled: n={n} must divide by "
                         f"bn={bn} in [1, 128] and kn_pad={knp} by "
                         f"bkn={bkn}")
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
        _build.require("candidate_assign_tiled", name, ten, dt, shape)
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


def candidate_assign_int8_tiled(xq, xsc, xerr, qtab, qsc, qerrtab, csqtab,
                                rowsel, skip, *, bn: int, bkn: int = 8,
                                r: int = 8):
    """Int8 tiled scan: per-row survivor sets instead of exact argmins.

    xq: (n, d) int8 grouped points, n % bn == 0; xsc, xerr: (n,) f32 their
    scales and exact residual norms; qtab: (T, kn_pad, d) int8 and qsc,
    qerrtab, csqtab: (T, kn_pad) f32 from
    ``quant.quantized_candidate_slabs``; rowsel, skip: (nb,) int32.
    Returns (surv (n, r) int32 ascending survivor columns, -1 beyond the
    count; nsv (n,) int32 survivor count, may exceed r; lbm (n,) f32 the
    least non-survivor lower bound). Skipped blocks yield (-1, 0,
    PAD_SQDIST).
    """
    n, d = xq.shape
    t, knp = qsc.shape
    if n % bn or knp % bkn:
        raise ValueError(f"candidate_assign_int8_tiled: n={n} must divide "
                         f"by bn={bn} and kn_pad={knp} by bkn={bkn}")
    nb = n // bn
    if xq.device.type == "cpu":
        return candidate_assign_int8_tiled_ref(xq, xsc, xerr, qtab, qsc,
                                               qerrtab, csqtab, rowsel, skip,
                                               bn, r)
    f32, i32 = torch.float32, torch.int32
    for name, ten, dt, shape in (
            ("xq", xq, torch.int8, (n, d)), ("xsc", xsc, f32, (n,)),
            ("xerr", xerr, f32, (n,)), ("qtab", qtab, torch.int8, (t, knp, d)),
            ("qsc", qsc, f32, (t, knp)), ("qerrtab", qerrtab, f32, (t, knp)),
            ("csqtab", csqtab, f32, (t, knp)), ("rowsel", rowsel, i32, (nb,)),
            ("skip", skip, i32, (nb,))):
        _build.require("candidate_assign_int8_tiled", name, ten, dt,
                       shape)
    surv = torch.empty((n, r), dtype=i32, device=xq.device)
    nsv = torch.empty((n,), dtype=i32, device=xq.device)
    lbm = torch.empty((n,), dtype=f32, device=xq.device)
    fn = _build.function("candidate_assign_int8",
                         "k2_candidate_assign_int8_tiled", _ARGS_INT8)
    p = _build.ptr
    _build.check(fn(p(xq), p(xsc), p(xerr), p(qtab), p(qsc), p(qerrtab),
                    p(csqtab), p(rowsel), p(skip), p(surv), p(nsv), p(lbm),
                    nb, bn, knp, d, r, _build.stream_ptr(xq.device)),
                 "candidate_assign_int8_tiled")
    _build.count("candidate_assign_int8_tiled")
    return surv, nsv, lbm


def tiled_grid_steps(n: int, kn: int, bn: int, bkn: int) -> int:
    """Grid steps the reference's tiled kernel issues (vs
    :func:`rowwise_grid_steps`): one per point block and bkn-wide tile."""
    return (n // bn) * (-(-kn // bkn))


def rowwise_grid_steps(n: int, kn: int, bn: int) -> int:
    """Grid steps the reference's rowwise kernel issues: one per point
    block and candidate."""
    return (n // bn) * kn


def candidate_assign_rowwise(x, c, cand, skip, prev_a, prev_d, *, bn: int):
    """Legacy per-row k_n-restricted assignment: block b of ``x`` (bn
    rows) competes among the centers ``cand[b]``, taken one at a time in
    list order (ties to the first). Same contract as
    :func:`candidate_assign_tiled` minus the second-best distance, with
    per-block lists instead of a candidate table.

    x: (n, d) f32, n % bn == 0; c: (k, d) f32; cand: (n // bn, kn) int32
    ids in [0, k); skip: (n // bn,) int32; prev_a int32, prev_d f32: (n,).
    Returns (assignment int32 (n,), best sqdist f32 (n,)).
    """
    n, d = x.shape
    nb, kn = cand.shape
    if bn < 1 or n % bn or nb != n // bn or kn < 1:
        raise ValueError(f"candidate_assign_rowwise: n={n} must divide by "
                         f"bn={bn} into cand's {nb} non-empty lists")
    if x.device.type == "cpu":
        return candidate_assign_ref(x, c, cand, skip, prev_a, prev_d, bn)
    f32, i32 = torch.float32, torch.int32
    k = c.shape[0]
    for name, ten, dt, shape in (
            ("x", x, f32, (n, d)), ("c", c, f32, (k, d)),
            ("cand", cand, i32, (nb, kn)), ("skip", skip, i32, (nb,)),
            ("prev_a", prev_a, i32, (n,)), ("prev_d", prev_d, f32, (n,))):
        _build.require("candidate_assign_rowwise", name, ten, dt, shape)
    # |c|^2 outside the kernel, as the reference's wrapper takes it
    csq = exact_sqnorm(c)
    a = torch.empty((n,), dtype=i32, device=x.device)
    dist = torch.empty((n,), dtype=f32, device=x.device)
    fn = _build.function("candidate_assign_rowwise",
                         "k2_candidate_assign_rowwise", _ARGS_ROWWISE)
    p = _build.ptr
    _build.check(fn(p(x), p(c), p(csq), p(cand), p(skip), p(prev_a),
                    p(prev_d), p(a), p(dist), nb, bn, kn, d,
                    _build.stream_ptr(x.device)),
                 "candidate_assign_rowwise")
    _build.count("candidate_assign_rowwise")
    return a, dist
