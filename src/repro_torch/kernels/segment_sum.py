"""Segment sums, and which one each caller takes.

``jax.ops.segment_sum`` adds each segment's rows in row order on the
CPU. On the card an ``index_add_`` adds them with atomics in no fixed
order, so a sum that is not exact changes from run to run. The port
therefore keeps four sums, each where its cost and its order fit:

- :func:`segment_sum` (``index_add_``): only where every partial sum is
  exact, so that no order changes it: the counts of Lloyd, the router
  and the KV clustering.
- :func:`segment_sum_ordered`: each segment's rows in row order on every
  device, the CPU's bits on the card (``index_put_(accumulate=True)``,
  one warp a segment): Lloyd's center sums and the engine's rebuild
  iteration, off the k²-means hot path.
- :func:`segment_sum_f64`: the ordered sum in f64, rounded once: the
  router's group centroids and the KV clustering's centroids.
- :func:`segment_sum_blocks` (``csrc/segment_sum.cu``): the k²-means
  engine's center sums over its resident arena (init, full recomputes)
  and its moved rows' deltas. Each (segment, column) chain walks the
  segment's blocks in order and adds its rows as the CPU's row-order
  scatter-add does, so the card gives the CPU's bits in every run, where
  the ordered sum everywhere doubled the fit's time per iteration. The
  kernel finds each segment's blocks itself (no sort of the layout) and
  streams their rows through shared memory. CPU tensors go through the
  plain version ``ref.segment_sum_blocks_ref``. Not a port of a TPU
  kernel: the reference takes these sums with ``jax.ops.segment_sum``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from . import ref

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def plan_segment_sum_blocks(k: int, nb: int, bn: int, d: int, *,
                            aligned: bool = True) -> dict:
    """The launch plan of :func:`segment_sum_blocks`' summing kernel over k
    segments and nb blocks of bn slots of d floats (``_build.plan``);
    ``aligned``: x 16-byte aligned."""
    return _build.plan("segment_sum", "segment_sum_blocks",
                       [ctypes.c_int] * 5, k, nb, bn, d, int(aligned))


def segment_sum(v: torch.Tensor, seg: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.ops.segment_sum(v, seg, num_segments=k)`` for seg in [0, k).
    On the card its atomics add in no fixed order, so the result may
    change from run to run unless every partial sum is exact (integer
    counts): use :func:`segment_sum_ordered`, :func:`segment_sum_f64` or
    :func:`segment_sum_blocks` where it must not."""
    out = torch.zeros((k,) + v.shape[1:], dtype=v.dtype, device=v.device)
    return out.index_add_(0, seg.long(), v)


def segment_sum_f64(v: torch.Tensor, seg: torch.Tensor,
                    k: int) -> torch.Tensor:
    """:func:`segment_sum` summed in f64, each segment's rows added in row
    order (:func:`segment_sum_ordered`), and rounded once to ``v``'s type:
    the card gives the CPU's bits, in every run. (An f64 sum taken in no
    fixed order is the same only while it is exact.)"""
    return segment_sum_ordered(v.double(), seg, k).to(v.dtype)


def segment_sum_ordered(v: torch.Tensor, seg: torch.Tensor, k: int,
                        init: torch.Tensor | None = None) -> torch.Tensor:
    """``jax.ops.segment_sum`` with each segment's rows added in row order
    on every device, so the card gives the CPU's bits, and the CPU's bits
    are XLA's: ``index_add_`` on the CPU, which adds the rows in order; on
    the card ``index_put_(accumulate=True)``, which sorts the ids with a
    stable radix sort and adds each segment's rows in that order, one warp
    per segment (fast for many small segments, slow for a few large ones).
    Its kernel for one-value rows reduces across the warp, out of order,
    so such rows go in beside a column of zeros.

    ``init`` (k, ...): values each segment's chain starts from, as XLA
    folds ``init + segment_sum(...)`` into one scatter-add onto ``init``.
    They go in as each segment's first rows (onto zeros), since the
    card's kernel for narrow rows adds a segment's rows together before
    it adds them to what the output holds."""
    seg = seg.long()
    if init is not None:
        v = torch.cat([init.to(v.dtype), v])
        seg = torch.cat([torch.arange(k, device=seg.device), seg])
    if v.device.type == "cpu":
        out = torch.zeros((k,) + v.shape[1:], dtype=v.dtype, device=v.device)
        return out.index_add_(0, seg, v)
    rows = v.reshape(v.shape[0], -1)
    width = rows.shape[1]
    if width == 1:
        rows = torch.cat([rows, torch.zeros_like(rows)], dim=1)
    out = torch.zeros((k, rows.shape[1]), dtype=v.dtype, device=v.device)
    out.index_put_((seg,), rows, accumulate=True)
    return out[:, :width].reshape((k,) + v.shape[1:])


def segment_sum_blocks(x, b2s, k: int, bn: int, *, w=None, perm=None):
    """Sums per segment over ``b2s.shape[0] * bn`` slots of a layout whose
    block b belongs to segment ``b2s[b]`` (-1: none): slot s reads row
    ``perm[s]`` of x (-1: empty; row s without ``perm``), weighted by
    ``w[s]`` (1 without ``w``). Returns (sums (k, d), weight sums (k,)),
    each added in block order, then slot order.

    x: (rows, d) f32; b2s: (nb,) int32; w: (nb * bn,) f32; perm: (nb * bn,)
    int32.
    """
    if x.device.type == "cpu":
        return ref.segment_sum_blocks_ref(x, b2s, k, bn, w=w, perm=perm)
    rows, d = x.shape
    nb = b2s.shape[0]
    f32, i32 = torch.float32, torch.int32
    _build.require("segment_sum_blocks", "x", x, f32, (rows, d))
    _build.require("segment_sum_blocks", "b2s", b2s, i32, (nb,))
    for name, t, dt, shape in (("w", w, f32, (nb * bn,)),
                               ("perm", perm, i32, (nb * bn,))):
        if t is not None:
            _build.require("segment_sum_blocks", name, t, dt, shape)
    dev = x.device
    sums = torch.empty((k, d), dtype=f32, device=dev)
    cnt = torch.empty((k,), dtype=f32, device=dev)
    scratch = torch.empty((1 + 3 * k,), dtype=i32, device=dev)
    p = _build.ptr
    opt = lambda t: None if t is None else p(t)  # noqa: E731
    fn = _build.function("segment_sum", "k2_segment_sum_blocks", _ARGS)
    _build.check(fn(p(x), opt(w), opt(perm), p(b2s), p(scratch), p(sums),
                    p(cnt), k, nb, bn, d, _build.stream_ptr(dev)),
                 "segment_sum_blocks")
    _build.count("segment_sum_blocks")
    return sums, cnt
