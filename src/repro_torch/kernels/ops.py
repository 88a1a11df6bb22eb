"""Operations around the kernels (port of ``repro.kernels.ops``): the
fused nearest-center assignment (K5),
block-size selection, the cluster-grouped layout, the resident arena's
re-sort, sparse repair and sliding-window eviction plans, the rebuild
iteration's bound-gated assignment, and the query-time resolution in
f32 (K1, also with the second-best distance) and int8 (K4, or on the
ungrouped ``xla`` backend ``quant.approx_scan``, + exact f32 re-rank).

Idioms that differ from the reference, kept exact:
- sorts are stable everywhere the reference's are (``jnp.argsort`` is
  stable by default, ``torch.argsort`` is not);
- ``jnp.nonzero(size=, fill_value=)`` becomes :func:`compact`, a
  cumsum-and-scatter with a fixed output size (``torch.nonzero`` syncs
  with the host and has a dynamic shape);
- ``.at[idx].set(v, mode="drop")`` becomes :func:`scatter_drop`, a
  scatter into one extra trailing slot that is sliced off, so sentinel
  writes never alias a real slot;
- the int8 re-rank's ``lax.cond`` on overflowing rows becomes a
  selection on the device: the exact distances of every row's whole
  slab row are formed once (``exact_round.slab_sqdist``), the survivors
  are re-ranked from them and the overflowing rows take their exact
  top-2 over the whole row, with no host read
  (:func:`quantized_scan_rerank`).
"""
from __future__ import annotations

import torch

from . import quant
from .candidate_assign import (candidate_assign_int8_tiled,
                               candidate_assign_tiled, candidate_tables,
                               pad_candidates)
from .distance_argmin import distance_argmin
from .exact_round import candidate_sqdist, slab_sqdist, sqrt_rn
from .ref import PAD_SQDIST
from .segment_sum import (segment_sum, segment_sum_f64,  # noqa: F401
                          segment_sum_ordered)

# the reference sizes point blocks against a ~12 MiB f32 working set; the
# port keeps its formula so both packages build bit-equal layouts
_VMEM_BUDGET = 12 * 2 ** 20 // 4


def choose_group_bn(n: int, k: int, d: int | None = None,
                    bn_max: int = 128, bkn: int = 8,
                    itemsize: int = 4) -> int:
    """Point-block size of the cluster-grouped layout: the largest power
    of two <= the expected cluster size n/k, clamped to [8, bn_max] and,
    when ``d`` is given, to the reference's working-set budget."""
    per = max(8, n // max(k, 1))
    cap = bn_max
    if d is not None:
        budget = _VMEM_BUDGET * 4                   # bytes
        while cap > 8 and \
                (cap * d + bkn * d) * itemsize + 4 * cap * 4 > budget:
            cap //= 2
    bn = 8
    while bn * 2 <= min(per, cap):
        bn *= 2
    return bn


def assign_nearest_kernel(x: torch.Tensor, c: torch.Tensor):
    """Drop-in fused assignment, the port of the reference's
    ``assign_nearest_pallas``: (n, d), (k, d) -> (assignment int32 (n,),
    min sqdist f32 (n,)) through K5 (:func:`distance_argmin`), which
    launches its kernel on CUDA tensors and takes its plain version on
    CPU tensors. No padding: the kernel handles ragged n and k."""
    return distance_argmin(x.contiguous(), c.contiguous())


def grouped_capacity(n: int, k: int, bn: int) -> int:
    """Static block capacity of the grouped layout: every cluster adds at
    most one partial block on top of the ceil(n/bn) data blocks."""
    return -(-n // bn) + k


def compact(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Indices of the first ``size`` True entries of ``mask`` in order,
    padded with ``fill``: ``jnp.nonzero(mask, size=, fill_value=)`` at a
    fixed shape with no host sync. int64."""
    s = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    keep = mask & (pos < size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out[torch.where(keep, pos, size)] = torch.arange(s, device=mask.device)
    return out[:size]


def bincount(idx: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.bincount(idx, length=size)`` for idx in [0, size), int64.
    (``torch.bincount`` sizes its output from ``idx.max()``, which syncs
    with the host on CUDA.)"""
    out = torch.zeros((size,), dtype=torch.int64, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx))


def scatter_drop(target: torch.Tensor, idx: torch.Tensor,
                 values) -> torch.Tensor:
    """``target.at[idx].set(values, mode="drop")`` for indices in
    [0, len(target)]: index ``len(target)`` lands in a trailing slot that
    is sliced off. Returns a new tensor."""
    out = torch.cat([target, target[:1]])
    out[idx] = values
    return out[:-1]


def _cluster_pack(a: torch.Tensor, k: int, bn: int, nb_total: int):
    """Shared packing math of the grouped layout: stable argsort by
    cluster, every cluster padded to a bn multiple, inside an
    ``nb_total``-block arena. Returns (perm (nb_total*bn,) int32 with -1
    padding, b2c (nb_total,) int32 clamped to k-1 past the packed extent,
    sizes, sizes_pad, starts_pad)."""
    n = a.shape[0]
    dev = a.device
    al = a.long()
    order = torch.argsort(al, stable=True)
    sizes = bincount(al, k)
    sizes_pad = ((sizes + bn - 1) // bn) * bn               # empty -> 0
    starts_data = torch.cumsum(sizes, 0) - sizes
    starts_pad = torch.cumsum(sizes_pad, 0) - sizes_pad
    ci = al[order]
    rank = torch.arange(n, device=dev) - starts_data[ci]
    dest = starts_pad[ci] + rank
    perm = torch.full((nb_total * bn,), -1, dtype=torch.int32, device=dev)
    perm[dest] = order.to(torch.int32)
    bounds = torch.cumsum(sizes_pad, 0)
    block_starts = torch.arange(nb_total, device=dev) * bn
    b2c = torch.searchsorted(bounds, block_starts, right=True)
    b2c = torch.clamp(b2c, max=k - 1).to(torch.int32)
    return perm, b2c, sizes, sizes_pad, starts_pad


def group_by_cluster_device(a: torch.Tensor, k: int, bn: int):
    """Sort point ids by cluster and pad every cluster to a bn multiple,
    at the static capacity ``grouped_capacity(n, k, bn)``. Returns (perm
    (cap*bn,) int32 with -1 padding, block2cluster (cap,) int32)."""
    nbcap = grouped_capacity(a.shape[0], k, bn)
    perm, b2c, _, _, _ = _cluster_pack(a, k, bn, nbcap)
    return perm, b2c


def scatter_from_grouped(perm: torch.Tensor, values: torch.Tensor,
                         prev: torch.Tensor) -> torch.Tensor:
    """Scatter grouped-layout ``values`` (one per perm row) back to point
    order on top of ``prev``; padding rows (perm == -1) are dropped. A
    point that several rows name (a corrupted arena) takes the last of
    them, as a row-order scatter does, on every device (a scatter of
    duplicate indices on the card writes in no fixed order)."""
    n = prev.shape[0]
    idx = torch.where(perm >= 0, perm.long(), n)
    rows = torch.arange(perm.shape[0], device=perm.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64,
                      device=perm.device).scatter_reduce_(0, idx, rows,
                                                          "amax")[:n]
    vals = values.to(prev.dtype)[torch.clamp(last, min=0)]
    return torch.where(last >= 0, vals, prev)


def resident_capacity(n: int, k: int, bn: int,
                      spare: int | None = None) -> int:
    """Static block capacity of the resident layout: the re-sort worst
    case plus ``spare`` headroom blocks."""
    return grouped_capacity(n, k, bn) + (spare or 0)


def resident_regroup(a: torch.Tensor, k: int, bn: int, nb_total: int):
    """Full layout (re)build with the resident free-slot metadata.
    Returns (perm (nb_total*bn,) int32 (-1 = free slot), b2c (nb_total,)
    int32 (-1 = free block), fill (k,) int32 append watermark in (0, bn]
    (0 when empty), openb (k,) int32 open block (-1 when empty))."""
    perm, b2c, sizes, sizes_pad, starts_pad = _cluster_pack(a, k, bn,
                                                            nb_total)
    used = torch.sum(sizes_pad) // bn
    blk = torch.arange(nb_total, device=a.device)
    b2c = torch.where(blk < used, b2c, -1).to(torch.int32)
    empty = sizes == 0
    openb = torch.where(empty, -1,
                        (starts_pad + sizes_pad) // bn - 1).to(torch.int32)
    fill = torch.where(empty, 0, sizes - (sizes_pad - bn)).to(torch.int32)
    return perm, b2c, fill, openb


def plan_layout_repair(b2c: torch.Tensor, fill: torch.Tensor,
                       openb: torch.Tensor, active: torch.Tensor,
                       dst: torch.Tensor, *, bn: int):
    """Append-only slot allocation for a batch of moved rows.

    ``active`` (M,) flags the live lanes of the move buffer and ``dst``
    (M,) their destination clusters. Each move is appended at its
    cluster's watermark: into the open block's free tail, then into fresh
    blocks popped from the free pool (``b2c == -1``), lowest id first.
    Returns ``(dst_slot, b2c', fill', openb', total_new, n_free)``;
    inactive lanes get the sentinel ``nb*bn``, and the layout arrays are
    only valid when ``total_new <= n_free``.
    """
    k = fill.shape[0]
    nbt = b2c.shape[0]
    sentinel = nbt * bn
    m = dst.shape[0]
    dev = dst.device
    dstl = dst.long()
    fill, openb = fill.long(), openb.long()
    seg = torch.where(active, dstl, k)
    inc = bincount(seg, k + 1)[:k]
    # rank of each move within its destination cluster, stable in lane
    # order so repairs are deterministic
    order = torch.argsort(seg, stable=True)
    sd = seg[order]
    starts = torch.searchsorted(sd, sd, right=False)
    rank = torch.empty((m,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(m, device=dev) - starts
    rem = torch.where(openb >= 0, bn - fill, 0)             # open tail
    nf = (torch.clamp(inc - rem, min=0) + bn - 1) // bn     # fresh blocks
    total_new = torch.sum(nf)
    free_mask = b2c < 0
    n_free = torch.sum(free_mask)
    free_list = compact(free_mask, nbt, nbt)
    base = torch.cumsum(nf, 0) - nf
    c_m = torch.where(active, dstl, 0)
    rem_m = rem[c_m]
    in_open = rank < rem_m
    r2 = torch.clamp(rank - rem_m, min=0)
    blk_fresh = free_list[torch.clamp(base[c_m] + r2 // bn, max=nbt - 1)]
    blk = torch.where(in_open, openb[c_m], blk_fresh)
    off = torch.where(in_open, fill[c_m] + rank, r2 % bn)
    dst_slot = torch.where(active, blk * bn + off, sentinel)
    alloc_blk = torch.where(active & ~in_open, blk_fresh, nbt)
    b2c2 = scatter_drop(b2c, alloc_blk, c_m.to(torch.int32))
    grew = inc > rem
    last_fresh = free_list[torch.clamp(base + torch.clamp(nf - 1, min=0),
                                       max=nbt - 1)]
    openb2 = torch.where(grew, last_fresh, openb).to(torch.int32)
    fill2 = torch.where(grew, inc - rem - (nf - 1) * bn,
                        torch.where(inc > 0, fill + inc, fill)
                        ).to(torch.int32)
    return dst_slot, b2c2, fill2, openb2, total_new, n_free


def plan_layout_evict(pid: torch.Tensor, wg: torch.Tensor, eg: torch.Tensor,
                      cutoff: int):
    """Sliding-window eviction plan over the resident arena: retire every
    live slot (``pid >= 0`` and ``wg > 0``) whose stream epoch ``eg`` (S,)
    predates ``cutoff``. A retired slot becomes a hole below its
    cluster's watermark (``pid = -1``, ``wg = 0``), as a departing row of
    a sparse repair does; ``b2c``/``fill``/``openb`` are untouched and the
    next full re-sort reclaims the holes. Returns ``(evict (S,) bool,
    pid2, wg2, n_evicted)``, the count a device scalar."""
    evict = (pid >= 0) & (wg > 0) & (eg < cutoff)
    pid2 = torch.where(evict, -1, pid).to(torch.int32)
    wg2 = torch.where(evict, 0.0, wg).to(wg.dtype)
    return evict, pid2, wg2, torch.sum(evict)


def k2_assign_grouped(x, c, neighbors, perm, block2cluster, skip, prev_a,
                      prev_d1, prev_d2, *, bn: int, bkn: int = 8):
    """Full k²-means assignment through the tiled kernel over a grouped
    layout from :func:`group_by_cluster_device`: the candidate table has
    one row per cluster and ``block2cluster`` routes each point block to
    its cluster's row. prev_d1/prev_d2 are squared distances. Returns
    updated (a, sqdist1, sqdist2) in point order; skipped blocks keep
    their prev values exactly."""
    cidx = pad_candidates(neighbors.to(torch.int32), bkn).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    sp = torch.clamp(perm, min=0).long()
    a_g, d1_g, d2_g = candidate_assign_tiled(
        x[sp].contiguous(), ctab, csqtab, cidx, block2cluster, skip,
        prev_a[sp].contiguous(), prev_d1[sp].contiguous(),
        prev_d2[sp].contiguous(), bn=bn, bkn=bkn)
    return (scatter_from_grouped(perm, a_g, prev_a),
            scatter_from_grouped(perm, d1_g, prev_d1),
            scatter_from_grouped(perm, d2_g, prev_d2))


def k2_bounded_assign(x, c, neighbors, a, u, lo, need, *, bn: int,
                      bkn: int = 8):
    """Bound-gated grouped assignment of the rebuild iteration: build the
    grouped layout, skip every block in which no point needs a
    recompute, run the tiled kernel, and refresh the true-distance bounds
    on recomputed rows only. Returns (a_new, u_new, lo_new)."""
    n = x.shape[0]
    k = c.shape[0]
    perm, b2c = group_by_cluster_device(a, k, bn)
    nb = perm.shape[0] // bn
    needp = need[torch.clamp(perm, min=0).long()] & (perm >= 0)
    skip = (~torch.any(needp.reshape(nb, bn), dim=1)).to(torch.int32)
    a_new, d1_sq, d2_sq = k2_assign_grouped(
        x, c, neighbors, perm, b2c, skip, a, u * u, lo * lo, bn=bn, bkn=bkn)
    fresh = scatter_from_grouped(perm, torch.repeat_interleave(skip == 0, bn),
                                 torch.zeros((n,), dtype=torch.bool,
                                             device=x.device))
    return (a_new, torch.where(fresh, sqrt_rn(d1_sq), u),
            torch.where(fresh, sqrt_rn(d2_sq), lo))


def _route_grouping(routed: torch.Tensor, k: int, bn: int):
    """Queries grouped by route center: (perm, b2c, skip) with every
    all-padding capacity block skipped."""
    perm, b2c = group_by_cluster_device(routed, k, bn)
    nb = perm.shape[0] // bn
    skip = (~torch.any((perm >= 0).reshape(nb, bn), dim=1)).to(torch.int32)
    return perm, b2c, skip


def bounded_predict_assign(q, c, neighbors, routed, *, bn: int = 128,
                           bkn: int = 8):
    """Resolve routed queries against their route center's
    k_n-neighborhood through K1: q (m, d), c (k, d), neighbors (k, kn),
    routed (m,) int32. Queries are grouped by route center so every point
    block shares one candidate list. Returns (assignment (m,) int32, best
    squared distance (m,)) in query order."""
    m = q.shape[0]
    perm, b2c, skip = _route_grouping(routed, c.shape[0], bn)
    zeros = torch.zeros((m,), dtype=torch.float32, device=q.device)
    a, d1, _ = k2_assign_grouped(q, c, neighbors, perm, b2c, skip,
                                 routed.to(torch.int32), zeros, zeros,
                                 bn=bn, bkn=bkn)
    return a, d1


def bounded_predict_assign_top2(q, c, neighbors, routed, *, bn: int = 128,
                                bkn: int = 8):
    """:func:`bounded_predict_assign` that also returns the second-best
    squared distance within the routed k_n-neighborhood (K1's second
    output), the Hamerly lower bound of the per-stream warm starts.
    Returns (assignment (m,) int32, best sqdist (m,), second-best sqdist
    (m,)) in query order."""
    m = q.shape[0]
    perm, b2c, skip = _route_grouping(routed, c.shape[0], bn)
    zeros = torch.zeros((m,), dtype=torch.float32, device=q.device)
    return k2_assign_grouped(q, c, neighbors, perm, b2c, skip,
                             routed.to(torch.int32), zeros, zeros,
                             bn=bn, bkn=bkn)


def quantized_scan_rerank(xf, xq, xsc, c, cq, cidx, rowsel, skip, prev_a,
                          prev_d1, prev_d2, *, bn: int = 128, bkn: int = 8,
                          r: int = 8, backend: str = "kernels"):
    """Int8 scan + exact f32 re-rank, the quantized replacement for
    :func:`candidate_assign_tiled` over a grouped layout.

    xf: (n, d) f32 grouped rows, xq/xsc their int8 quantization; c (k, d)
    centers and cq their ``quant.CenterQuant``; cidx (T, kn_pad);
    rowsel/skip/prev_* as in the f32 kernel. The int8 stage is K4 on
    ``backend="kernels"`` and ``quant.approx_scan`` over each row's list
    on ``"xla"``. Survivors are re-ranked with the oracle's formula over
    each row's kn_pad candidates, not k (``exact_round.slab_sqdist``
    against the block's slab on kernels, ``exact_round.candidate_sqdist``
    per pair on xla: one value a pair either way); rows whose survivor
    count exceeds ``r`` take the exact top-2 over the whole list row
    instead, selected on the device (no host read). Returns (a, d1_sq,
    d2_sq, n_surv, fallback): d2_sq is the exact second-best among
    survivors, floored by the non-survivor margin bound."""
    xerr = quant.residual_norm(xf, xq, xsc)
    cand_all = cidx[torch.repeat_interleave(rowsel.long(), bn)]
    if backend == "xla":
        surv, nsv, lbm = quant.approx_scan(xq, xsc, xerr, cq, cand_all, r=r)
        sq_all = candidate_sqdist(xf, c, cand_all)
    else:
        qtab, qsc, qerrtab, csqtab = quant.quantized_candidate_slabs(cq,
                                                                     cidx)
        surv, nsv, lbm = candidate_assign_int8_tiled(
            xq, xsc, xerr, qtab, qsc, qerrtab, csqtab, rowsel, skip, bn=bn,
            bkn=bkn, r=r)
        sq_all = slab_sqdist(xf, *candidate_tables(c, cidx), rowsel, bn)
    fresh = torch.repeat_interleave(skip == 0, bn)
    nsv = torch.where(fresh, nsv, 0)
    cols = torch.clamp(surv, min=0).long()
    ids = torch.where(surv >= 0, torch.gather(cand_all, 1, cols), -1)
    sq = torch.where(surv >= 0, torch.gather(sq_all, 1, cols), PAD_SQDIST)
    a, d1, d2 = quant.first_min_top2(sq, ids)
    lo_rest = torch.square(torch.clamp(torch.clamp(lbm, max=1e15) - xerr,
                                       min=0.0))
    d2 = torch.minimum(d2, lo_rest)
    fb = fresh & (nsv > r)
    a_fb, d1_fb, d2_fb = quant.first_min_top2(sq_all, cand_all)
    a, d1, d2 = (torch.where(fb, a_fb, a), torch.where(fb, d1_fb, d1),
                 torch.where(fb, d2_fb, d2))
    return (torch.where(fresh, a, prev_a).to(torch.int32),
            torch.where(fresh, d1, prev_d1), torch.where(fresh, d2, prev_d2),
            nsv, fb)


def bounded_predict_assign_int8(q, c, cq, neighbors, routed, *,
                                bn: int = 128, bkn: int = 8, r: int = 8,
                                backend: str = "kernels"):
    """Quantized analogue of :func:`bounded_predict_assign`: routed
    queries resolve through the int8 scan (K4 on ``backend="kernels"``,
    ``quant.approx_scan`` on ``"xla"``) + exact f32 re-rank. cq: the
    ``quant.CenterQuant`` of ``c``. Returns (assignment (m,), best sqdist
    (m,), n_surv (m,), fallback (m,) bool) in query order."""
    m = q.shape[0]
    cidx = pad_candidates(neighbors.to(torch.int32), bkn).contiguous()
    perm, b2c, skip = _route_grouping(routed, c.shape[0], bn)
    sp = torch.clamp(perm, min=0).long()
    qg = q[sp].contiguous()
    qq, qs = quant.quantize_rows(qg)
    routed32 = routed.to(torch.int32)
    zeros_g = torch.zeros((perm.shape[0],), dtype=torch.float32,
                          device=q.device)
    a_g, d1_g, _, nsv_g, fb_g = quantized_scan_rerank(
        qg, qq, qs, c, cq, cidx, b2c, skip, routed32[sp], zeros_g, zeros_g,
        bn=bn, bkn=bkn, r=r, backend=backend)
    zeros = zeros_g[:m]
    return (scatter_from_grouped(perm, a_g, routed32),
            scatter_from_grouped(perm, d1_g, zeros),
            scatter_from_grouped(perm, nsv_g, torch.zeros_like(routed32)),
            scatter_from_grouped(perm, fb_g, zeros > 0))
