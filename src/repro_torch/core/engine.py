"""Engine layer: ONE k²-means iteration (port of ``repro.core.engine``).

The paper's bounded iteration (center k_n-NN graph -> k_n-restricted
assignment with Hamerly bounds -> mean update -> bound adjustment).
``K2Step(...).build(n, d)`` returns ``step(x, w, state)
-> (state', stats)`` on one of two backends:

``"kernels"`` (the default, the reference's ``"pallas"``) — the
bound-gated assignment runs K1 over the cluster-grouped layout, whole
point blocks recomputed where any row needs it;

``"xla"`` — the ungrouped path: every row's candidate list is scored
through ``distance.chunked_candidate_top2`` (one exactly rounded
product per (row, candidate) pair, chunked) and the rows meeting the
exact recompute condition take the result. It recomputes every row, so
residency buys it layout traffic only. Both rank the same correctly
rounded distances, so they assign alike; the center graph is K2 on both
(``center_knn_graph``).

and one of two residencies:

``"rebuild"`` — :func:`k2_iteration`: the grouped layout is rebuilt from
scratch every iteration.

``"resident"`` — :func:`k2_resident_iteration` (the default): the layout
lives in :class:`ResidentState` and is repaired each iteration by moving
only the rows whose assignment changed, with an incremental delta
center update and a full re-sort every ``regroup_every`` iterations, on
move-buffer overflow, or when the free-block pool would run out. With
``precision="int8"`` (DESIGN.md §13) the arena holds int8 rows and
per-slot scales: the scan is K4 plus an exact f32 re-rank of its
survivors against the f32 masters, so the trajectory is the f32
engine's bit for bit.

:func:`resident_evict` is the streaming model's sliding-window eviction
on the same arena (``core.model.KMeansModel.partial_fit``).

Placement: one device (``mesh=None``) or a :class:`launch.mesh.Mesh`,
one process per shard. On a mesh each rank runs the same iteration on its
own rows (its arena built over them, its ``pid`` local row ids; repairs
and re-sorts never move rows between shards), centers and the k_n-NN
graph are replicated, and the center sums, the resident deltas, the
overflow flag and the step statistics are summed across the shards in
shard order (``psum``, :meth:`launch.mesh.Mesh.sum`), so every rank
holds the same centers. With one shard the sum is the partial itself and
the iteration is the single-device one bit for bit.

Differences from the reference, none of which changes what is computed:
- the reference's two ``lax.cond``s become one host read per resident
  iteration of ``(overflow, pool exhausted, rows changed)``; the time
  trigger is known on the host, so ``it`` and ``first`` are host values
  in the port's states. That read is the only sync inside the step;
  every other statistic stays on the device until the fit loop's
  monitor flush;
- the sparse repair scatters only the host-known prefix of live move
  lanes, in place into the arena (the step consumes its input state);
- the k_n-NN graph takes the first kn columns of a stable ascending
  sort, which breaks ties toward the lower index like ``lax.top_k``;
- the bounds' square roots are correctly rounded
  (``exact_round.sqrt_rn``), as XLA's and the card's roots are and
  torch's f32 root on the CPU is not;
- the center sums add each cluster's rows in a fixed order on every
  device, so the card's fit is the same in every run: the full sums walk
  each cluster's arena blocks in slot order (``segment_sum_blocks``, the
  CPU's row-order scatter-add bit for bit), and so do the moved rows'
  deltas (each row a block of one slot); the rebuild iteration uses
  ``ops.segment_sum_ordered``.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import numpy as np
import torch

from ..kernels import quant
from ..kernels.candidate_assign import (candidate_assign_tiled,
                                        candidate_tables, pad_candidates)
from ..kernels.center_knn import center_sqdist
from ..kernels.exact_round import sqrt_rn
from ..kernels.ops import (choose_group_bn, compact, k2_bounded_assign,
                           plan_layout_evict, plan_layout_repair,
                           quantized_scan_rerank, resident_capacity,
                           resident_regroup, scatter_from_grouped,
                           segment_sum_ordered)
from ..kernels.segment_sum import segment_sum_blocks
from ..launch.mesh import dp_axes
from .distance import bottom_k, chunked_candidate_top2, sqnorm


class K2State(typing.NamedTuple):
    """Bound-carried loop state of the rebuild iteration."""
    c: torch.Tensor        # (k, d) centers
    a: torch.Tensor        # (n,) int32 assignment
    u: torch.Tensor        # (n,) upper bound on the assigned-center distance
    lo: torch.Tensor       # (n,) lower bound on the second-closest candidate
    prev_nb: torch.Tensor  # (k, kn) previous neighbor lists (-1 = invalid)
    first: bool            # force a full recompute (iteration 1)


class ResidentState(typing.NamedTuple):
    """Loop state of the resident-layout iteration: the cluster-grouped
    arena (``xg`` rows, ``pid`` slot -> point id with -1 = free, ``b2c``
    block -> cluster with -1 = free block, ``fill``/``openb`` append
    watermarks) plus the running center sums."""
    c: torch.Tensor        # (k, d) centers
    prev_nb: torch.Tensor  # (k, kn) previous neighbor lists (-1 = invalid)
    sums: torch.Tensor     # (k, d) weighted member sums
    counts: torch.Tensor   # (k,) weighted member counts
    it: int                # completed iterations (re-sort schedule)
    first: bool            # force a full recompute (iteration 1)
    xg: torch.Tensor       # (S, d) grouped point rows (S = nb_total * bn)
    pid: torch.Tensor      # (S,) int32 point id per slot, -1 = free / hole
    ug: torch.Tensor       # (S,) upper bound per slot
    lo_g: torch.Tensor     # (S,) second-closest lower bound per slot
    wg: torch.Tensor       # (S,) weight per slot (0 = free slot)
    b2c: torch.Tensor      # (nb_total,) int32 block -> cluster, -1 = free
    fill: torch.Tensor     # (k,) int32 open-block watermark in [0, bn]
    openb: torch.Tensor    # (k,) int32 open block per cluster, -1 = none
    # the int8 arena (precision="int8"): ``xg`` holds int8 rows and
    # ``xsc`` their per-slot scales; None on the f32 arena
    xsc: torch.Tensor | None = None


class StepStats(typing.NamedTuple):
    """Device scalars, host-read by the fit loop every ``monitor_every``
    iterations (``core.opcount.charge_iteration``)."""
    n_need: torch.Tensor    # points meeting the exact recompute condition
    changed: torch.Tensor   # assignment changes across the iteration
    energy: torch.Tensor    # clustering energy after the update step
    moved: torch.Tensor     # rows moved through the layout
    resorted: torch.Tensor  # 1 if the layout was fully re-sorted
    # the int8 engine's f32 distances (survivors re-ranked, the whole
    # list on fallback rows); 0 on the f32 paths
    reranked: typing.Any = 0


def init_state(centers: torch.Tensor, assignment: torch.Tensor,
               kn: int) -> K2State:
    """Stale-zero bounds (``first`` forces a full recompute on iteration
    1) and an all-invalid neighbor graph."""
    n, k = assignment.shape[0], centers.shape[0]
    z = torch.zeros((n,), dtype=centers.dtype, device=centers.device)
    return K2State(centers, assignment.to(torch.int32), z, z.clone(),
                   torch.full((k, kn), -1, dtype=torch.int32,
                              device=centers.device), True)


def center_knn_graph(c: torch.Tensor, kn: int) -> torch.Tensor:
    """Self-inclusive k_n-NN graph over centers, (k, kn) int32: the
    center distance kernel, then the kn smallest of each row
    (:func:`distance.bottom_k`, ties to the lower index)."""
    return bottom_k(center_sqdist(c), kn)


def k2_iteration(x: torch.Tensor, w: torch.Tensor, state: K2State, *,
                 kn: int, bn: int, bkn: int = 8, backend: str = "kernels",
                 chunk: int = 2048, psum=None) -> tuple[K2State, StepStats]:
    """The rebuild-residency iteration: on ``backend="kernels"`` the
    grouped layout is rebuilt from the current assignment every call; on
    ``"xla"`` the candidates are scored ungrouped, ``chunk`` rows at a
    time, and no layout is built (``moved`` and ``resorted`` are 0).
    ``psum``: the cross-shard sum of a mesh placement (None: one
    device); ``x``, ``w`` and the state's rows are then this shard's."""
    c, a, u, lo, prev_nb, first = state
    k = c.shape[0]
    wpos = w > 0
    neighbors = center_knn_graph(c, kn)
    list_changed = torch.any(neighbors != prev_nb, dim=1)
    need = ((u >= lo) | list_changed[a.long()] | first) & wpos
    if backend == "xla":
        a_cmp, d1, d2 = chunked_candidate_top2(x, c, neighbors[a.long()],
                                               chunk=chunk)
        a_new = torch.where(need, a_cmp, a)
        u_new = torch.where(need, d1, u)
        lo_new = torch.where(need, d2, lo)
    else:
        a_new, u_new, lo_new = k2_bounded_assign(x, c, neighbors, a, u, lo,
                                                 need, bn=bn, bkn=bkn)
    al = a_new.long()
    sums = segment_sum_ordered(x * w[:, None], al, k)
    counts = segment_sum_ordered(w, al, k)
    if psum is not None:
        sums, counts = psum(sums, counts)
    c_next = torch.where(counts[:, None] > 0,
                         sums / torch.clamp(counts, min=1.0)[:, None], c)
    delta = sqrt_rn(torch.clamp(sqnorm(c_next - c), min=0.0))
    delta_nb = torch.max(delta[neighbors.long()], dim=1).values
    u_adj = u_new + delta[al]
    lo_adj = lo_new - delta_nb[al]
    n_need = torch.sum(need)
    changed = torch.sum((a_new != a) & wpos)
    energy = torch.sum(w * sqnorm(x - c_next[al]))
    dev = x.device
    grouped = backend == "kernels"      # the layout is rebuilt in full
    stats = StepStats(n_need, changed, energy,
                      torch.tensor(x.shape[0] if grouped else 0, device=dev),
                      torch.tensor(int(grouped), device=dev))
    if psum is not None:
        stats = StepStats(*psum(*stats[:5]))
    return K2State(c_next, a_new, u_adj, lo_adj, neighbors, False), stats


def init_resident_state(x: torch.Tensor, w: torch.Tensor,
                        centers: torch.Tensor, assignment: torch.Tensor, *,
                        kn: int, bn: int, nb_total: int,
                        precision: str = "f32", psum=None) -> ResidentState:
    """Build the resident layout once from an initial assignment (one
    grouping pass + one full segment-sum); stale-zero bounds with
    ``first`` forcing a full recompute on iteration 1. Under
    ``precision="int8"`` the arena rows are quantized per row and carry
    their scales in ``xsc``; ``x`` stays the f32 master copy. ``psum``:
    the cross-shard sum of a mesh placement (the arena is this shard's,
    the sums global)."""
    k = centers.shape[0]
    a = assignment.to(torch.int32)
    perm, b2c, fill, openb = resident_regroup(a, k, bn, nb_total)
    valid = perm >= 0
    sp = torch.clamp(perm, min=0).long()
    xg = torch.where(valid[:, None], x[sp], 0.0).contiguous()
    wg = torch.where(valid, w[sp], 0.0)
    zeros = torch.zeros((perm.shape[0],), dtype=centers.dtype,
                        device=centers.device)
    # each cluster's rows in row order: the arena lists them so
    sums, counts = segment_sum_blocks(xg, b2c, k, bn, w=wg)
    if psum is not None:
        sums, counts = psum(sums, counts)
    xsc = None
    if precision == "int8":
        xg, xsc = quant.quantize_rows(xg)
    return ResidentState(
        centers, torch.full((k, kn), -1, dtype=torch.int32,
                            device=centers.device),
        sums, counts, 0, True, xg, perm, zeros, zeros.clone(), wg, b2c, fill,
        openb, xsc)


def resident_assignment(state: ResidentState, n: int) -> torch.Tensor:
    """Point-order assignment from the resident layout (one scatter
    through ``pid``)."""
    bn = state.pid.shape[0] // state.b2c.shape[0]
    a_slot = torch.repeat_interleave(torch.clamp(state.b2c, min=0), bn)
    return scatter_from_grouped(state.pid, a_slot.to(torch.int32),
                                torch.zeros((n,), dtype=torch.int32,
                                            device=state.pid.device))


def f32(v: float) -> float:
    """``v`` rounded to the nearest f32, as a Python float: the value the
    reference's ``jnp.float32(v)`` holds (host arithmetic: no tensor is
    made or read)."""
    return float(np.float32(v))


def decay_pow(decay: float, age: torch.Tensor, max_age: int) -> torch.Tensor:
    """``decay ** age`` in f64 for integer ages in [0, ``max_age``]: binary
    exponentiation of the f64 value ``decay`` (the squarings and the
    products in one fixed order, each an IEEE multiplication), so every
    device gives these bits. The callers round once where the reference
    works in f32: the eviction raises the f32 decay and rounds the power
    to f32 (the reference's ``jnp.power`` in f32), the drift repair
    raises the f64 decay and keeps f64 (the reference's ``np.power``).
    Either may differ from the reference's power in the last bit."""
    a = torch.clamp(age.to(torch.int64), min=0)
    p = torch.tensor(decay, dtype=torch.float64, device=age.device)
    out = torch.ones(age.shape, dtype=torch.float64, device=age.device)
    for bit in range(max(int(max_age), 0).bit_length()):
        out = torch.where((a >> bit) & 1 == 1, out * p, out)
        p = p * p
    return out


def _masters(x: torch.Tensor, pid: torch.Tensor) -> torch.Tensor:
    """The f32 master rows in slot order (zero on free slots)."""
    sp = torch.clamp(pid, 0, x.shape[0] - 1).long()
    return torch.where((pid >= 0)[:, None], x[sp], 0.0).contiguous()


def decay_pow_f32(decay: float, age: torch.Tensor,
                  max_age: int) -> torch.Tensor:
    """The eviction's ``decay ** age`` in f32: :func:`decay_pow` of the f32
    ``decay``, rounded once to f32, with subnormal results flushed to
    zero as the reference's f32 ``jnp.power`` flushes them (XLA runs with
    denormals off). It then differs from the reference's power only in
    the last bit of a normal result, where binary exponentiation and
    libm's ``pow`` round apart (ROADMAP §3 entry 11)."""
    pw = decay_pow(f32(decay), age, max_age).to(torch.float32)
    return torch.where(pw < torch.finfo(torch.float32).tiny, 0.0, pw)


def resident_evict(state: ResidentState, eg: torch.Tensor, cutoff: int,
                   epoch_now: int, decay: float, floor: float,
                   masters: torch.Tensor | None = None):
    """Sliding-window eviction on the resident arena.

    Retires every live slot whose stream epoch ``eg`` (S,) predates
    ``cutoff`` (:func:`kernels.ops.plan_layout_evict`: the slots become
    holes, reclaimed at the next full re-sort) and subtracts the evicted
    rows from the center sums and counts as an incremental delta, so the
    surviving statistics match a fold of the window (bit for bit at
    ``decay == 1`` on exactly representable data). A row folded at epoch
    ``e`` has decayed to weight ``w * decay^(epoch_now - e)``
    (:func:`decay_pow_f32`), which is
    what is subtracted. ``floor`` is the fold's count floor: a center
    whose mass dips under it is frozen at the floor with its sums
    re-anchored (``sums = c * floor``).

    The delta sums walk each cluster's blocks in slot order
    (``segment_sum_blocks`` with the decayed weights, 0 on every slot not
    evicted, blocks without an evicted slot left out): the reference's
    row-order ``segment_sum`` over slots, the CPU's bits on the card. A
    weight-0 slot adds ``0 * x``, a signed zero, which changes no partial
    sum (they start at +0, and only two -0 terms make a -0), so leaving
    such slots in or out gives the same bits. The rows are read from
    ``masters`` (the f32 point-order rows, gathered through ``pid``) when
    given, else from the arena: ``xg`` itself on the f32 arena (it holds
    the mirror's rows bit for bit), its dequantized rows on an int8 one.
    Returns ``(state', evict (S,) bool, n_evicted device scalar)``.
    """
    k = state.c.shape[0]
    nbt = state.b2c.shape[0]
    bn = state.pid.shape[0] // nbt
    evict, pid2, wg2, n_ev = plan_layout_evict(state.pid, state.wg, eg,
                                               cutoff)
    age = torch.clamp(epoch_now - eg.to(torch.int64), min=0)
    pw = decay_pow_f32(decay, age, epoch_now)
    w_eff = torch.where(evict, state.wg * pw, 0.0).contiguous()
    # blocks without an evicted slot add only zeros: leave them out of
    # the chains (cluster 0's parked pool alone spans most of the arena)
    b2s = torch.where(torch.any(evict.reshape(nbt, bn), dim=1), state.b2c,
                      -1).to(torch.int32).contiguous()
    if masters is not None:
        rows = _masters(masters, state.pid)
    elif state.xsc is not None:
        rows = quant.dequantize_rows(state.xg, state.xsc).contiguous()
    else:
        rows = state.xg
    d_sums, d_counts = segment_sum_blocks(rows, b2s, k, bn, w=w_eff)
    floor_t = torch.tensor(f32(floor), device=state.c.device)
    sums2 = state.sums - d_sums
    counts2 = torch.clamp(state.counts - d_counts, min=0.0)
    frozen = counts2 < floor_t
    counts2 = torch.where(frozen, torch.maximum(floor_t, counts2), counts2)
    sums2 = torch.where(frozen[:, None], state.c * counts2[:, None], sums2)
    c2 = torch.where(counts2[:, None] > 0,
                     sums2 / torch.clamp(counts2, min=1e-12)[:, None],
                     state.c)
    return (state._replace(c=c2, sums=sums2, counts=counts2, pid=pid2,
                           wg=wg2), evict, n_ev)


def k2_resident_iteration(x: torch.Tensor, w: torch.Tensor,
                          state: ResidentState, *, kn: int, bkn: int = 8,
                          regroup_every: int = 16, move_cap: int = 1024,
                          precision: str = "f32", rerank_r: int = 8,
                          backend: str = "kernels", chunk: int = 2048,
                          psum=None) -> tuple[ResidentState, StepStats]:
    """One iteration over the resident grouped layout.

    The bounded assignment reads the arena ``xg`` directly, the bound
    refresh and statistics stay in slot space, the center update is an
    incremental delta over the changed rows, and the layout is repaired
    by moving only those rows (at most ``move_cap``). A full re-sort and
    exact recompute run every ``regroup_every`` iterations, on
    move-buffer overflow, or when the free-block pool would run out.
    ``x``/``w`` are the point-order arrays, read only by re-sorts. ``bn``
    is a property of the arena and is read from its shapes.

    ``precision="int8"`` scans the quantized arena (``xg`` int8, ``xsc``
    its scales): K4 emits each row's margin survivors, which are
    re-ranked exactly against the f32 masters ``x[pid]``
    (``ops.quantized_scan_rerank``; rows with more than ``rerank_r``
    survivors take their whole list). The center deltas, the full
    recompute and the energy read the masters, never dequantized rows,
    and a re-sort re-quantizes from them, so the assignments and centers
    are the f32 engine's. ``d2`` is floored by the non-survivors' margin
    bound, a valid (possibly looser) Hamerly bound.

    ``backend="xla"`` scores every arena slot (free slots and holes
    included, about n + k*bn rows) through
    ``distance.chunked_candidate_top2``, ``chunk`` rows at a time, with no
    block skip; under int8 it passes the backend to the quantized scan
    (``quant.approx_scan`` in place of K4).

    ``psum``: the cross-shard sum of a mesh placement (None: one
    device). The arena, ``x`` and ``w`` are then this shard's; the
    overflow flag is summed before the host read, so the full center
    recompute happens on every shard at once, while each shard re-sorts
    its own arena on its own triggers (time, its overflow, its free
    pool), as the reference's mesh iteration does.
    """
    k = state.c.shape[0]
    n = x.shape[0]
    s_total = state.pid.shape[0]
    nbt = state.b2c.shape[0]
    bn = s_total // nbt
    c = state.c
    dev = c.device
    wpos = state.wg > 0
    int8 = precision == "int8"

    # --- 1. k_n-NN graph over centers ----------------------------------
    neighbors = center_knn_graph(c, kn)
    list_changed = torch.any(neighbors != state.prev_nb, dim=1)

    # --- 2. bounded assignment straight over the resident layout --------
    a_slot = torch.repeat_interleave(torch.clamp(state.b2c, min=0), bn)
    need = ((state.ug >= state.lo_g) | list_changed[a_slot.long()]
            | state.first) & wpos
    reranked = torch.zeros((), dtype=torch.int64, device=dev)
    if backend == "xla" and not int8:
        a_cmp, d1, d2 = chunked_candidate_top2(
            state.xg, c, neighbors[a_slot.long()], chunk=chunk)
        a_new = torch.where(need, a_cmp.long(), a_slot)
        u_new = torch.where(need, d1, state.ug)
        lo_new = torch.where(need, d2, state.lo_g)
    else:
        skip = (~torch.any(need.reshape(nbt, bn), dim=1)).to(torch.int32)
        cidx = pad_candidates(neighbors, bkn).contiguous()
        rowsel = torch.clamp(state.b2c, min=0).to(torch.int32).contiguous()
        if int8:
            xf = _masters(x, state.pid)
            a_g, d1_sq, d2_sq, nsv, fb = quantized_scan_rerank(
                xf, state.xg, state.xsc, c, quant.center_quant(c), cidx,
                rowsel, skip, a_slot.to(torch.int32), state.ug * state.ug,
                state.lo_g * state.lo_g, bn=bn, bkn=bkn, r=rerank_r,
                backend=backend)
            # f32 distances of the exact stage: min(n_surv, r) a re-ranked
            # row, the whole candidate list on a fallback row
            reranked = torch.sum(torch.where(fb, cidx.shape[1],
                                             torch.clamp(nsv, max=rerank_r)))
        else:
            ctab, csqtab = candidate_tables(c, cidx)
            a_g, d1_sq, d2_sq = candidate_assign_tiled(
                state.xg, ctab, csqtab, cidx, rowsel, skip,
                a_slot.to(torch.int32), state.ug * state.ug,
                state.lo_g * state.lo_g, bn=bn, bkn=bkn)
        fresh = torch.repeat_interleave(skip == 0, bn)
        u_new = torch.where(fresh, sqrt_rn(d1_sq), state.ug)
        lo_new = torch.where(fresh, sqrt_rn(d2_sq), state.lo_g)
        # free slots are frozen: they must never enter the move buffer
        a_new = torch.where(wpos, a_g.long(), a_slot)

    # --- 3. compact the changed rows into the move buffer ----------------
    mask_mv = wpos & (a_new != a_slot)
    n_changed = torch.sum(mask_mv)
    mv = compact(mask_mv, move_cap, s_total)
    active = mv < s_total
    mvs = torch.clamp(mv, max=s_total - 1)
    src_c = a_slot[mvs]
    dst_c = a_new[mvs]

    # --- 4. incremental center-update deltas over the moved rows ---------
    w_mv = torch.where(active, state.wg[mvs], 0.0)
    # each moved row a block of one slot, once into its destination (segment
    # c) and once out of its source (segment k + c): every cluster's moved
    # rows in lane order, as the CPU's row-order scatter-add takes them;
    # idle lanes belong to no segment
    cap = mvs.shape[0]
    seg2 = torch.cat([torch.where(active, dst_c, -1),
                      torch.where(active, src_c + k, -1)]).to(torch.int32)
    lanes = torch.arange(cap, dtype=torch.int32, device=dev).repeat(2)
    # (the int8 arena reads the masters: centers carry no quantization
    # error)
    sums_mv, counts_mv = segment_sum_blocks(
        (xf if int8 else state.xg)[mvs].contiguous(), seg2, 2 * k, 1,
        w=torch.cat([w_mv, w_mv]), perm=lanes)
    delta_sums = sums_mv[:k] - sums_mv[k:]
    delta_counts = counts_mv[:k] - counts_mv[k:]

    # --- 5. re-sort triggers: the step's one host read -------------------
    dst_slot, b2c_rep, fill_rep, openb_rep, total_new, n_free = \
        plan_layout_repair(state.b2c, state.fill, state.openb, active,
                           dst_c, bn=bn)
    overflow = (n_changed > move_cap).to(torch.int64)
    any_overflow = psum(overflow) if psum is not None else overflow
    overflow, any_overflow, exhausted, n_mv = torch.stack(
        [overflow, any_overflow, total_new > n_free, n_changed]
    ).to(torch.int64).tolist()
    time_trigger = (state.it + 1) % regroup_every == 0
    resort = bool(time_trigger or overflow or exhausted)
    full_update = bool(time_trigger or any_overflow or state.first)

    # --- 6. layout repair (sparse, in place) or full re-sort -------------
    if resort:
        zero = torch.zeros((n,), dtype=torch.float32, device=dev)
        a_pt = scatter_from_grouped(state.pid, a_new.to(torch.int32),
                                    torch.zeros((n,), dtype=torch.int32,
                                                device=dev))
        u_pt = scatter_from_grouped(state.pid, u_new, zero)
        lo_pt = scatter_from_grouped(state.pid, lo_new, zero)
        pid2, b2c2, fill2, openb2 = resident_regroup(a_pt, k, bn, nbt)
        valid2 = pid2 >= 0
        sp = torch.clamp(pid2, min=0).long()
        xg2 = torch.where(valid2[:, None], x[sp], 0.0).contiguous()
        wg2 = torch.where(valid2, w[sp], 0.0)
        ug2 = torch.where(valid2, u_pt[sp], 0.0)
        lo2 = torch.where(valid2, lo_pt[sp], 0.0)
        xf2, xsc2 = xg2, None
        if int8:     # re-quantized from the f32 masters
            xg2, xsc2 = quant.quantize_rows(xf2)
    else:
        src, dst = mv[:n_mv], dst_slot[:n_mv]
        pid2, xg2, wg2 = state.pid, state.xg, state.wg
        moved_pid, moved_w = pid2[src], wg2[src]
        pid2[src] = -1
        pid2[dst] = moved_pid
        xg2[dst] = xg2[src]
        wg2[src] = 0.0
        wg2[dst] = moved_w
        ug2, lo2 = u_new, lo_new
        ug2[dst] = u_new[src]
        lo2[dst] = lo_new[src]
        b2c2, fill2, openb2 = b2c_rep, fill_rep, openb_rep
        xsc2 = state.xsc
        if int8:     # the moved rows' scales travel with them
            xsc2[dst] = xsc2[src]
        xf2 = _masters(x, pid2) if int8 else xg2
    a_slot2 = torch.repeat_interleave(torch.clamp(b2c2, min=0), bn).long()

    # --- 7. center update: incremental delta, or exact recompute ---------
    if full_update:
        # per cluster, a chain over its blocks in slot order: the CPU's
        # row-order scatter-add, bit for bit, on the card
        sums2, counts2 = segment_sum_blocks(xf2, b2c2, k, bn, w=wg2)
    else:
        sums2, counts2 = delta_sums, delta_counts
    if psum is not None:
        sums2, counts2 = psum(sums2, counts2)
    if not full_update:
        sums2 = state.sums + sums2
        counts2 = state.counts + counts2
    c_next = torch.where(counts2[:, None] > 0,
                         sums2 / torch.clamp(counts2, min=1.0)[:, None], c)

    # --- 8. Hamerly bound adjustment (slot space) ------------------------
    delta = sqrt_rn(torch.clamp(sqnorm(c_next - c), min=0.0))
    delta_nb = torch.max(delta[neighbors.long()], dim=1).values
    u_adj = ug2 + delta[a_slot2]
    lo_adj = lo2 - delta_nb[a_slot2]

    # --- 9. device-resident step statistics ------------------------------
    energy = torch.sum(wg2 * sqnorm(xf2 - c_next[a_slot2]))
    moved = torch.sum(state.pid >= 0) if resort else n_changed
    stats = StepStats(torch.sum(need), n_changed, energy, moved,
                      torch.tensor(int(resort), device=dev), reranked)
    if psum is not None:
        stats = StepStats(*psum(*stats))
    return ResidentState(c_next, neighbors, sums2, counts2, state.it + 1,
                         False, xg2, pid2, u_adj, lo_adj, wg2, b2c2, fill2,
                         openb2, xsc2), stats


@dataclasses.dataclass(frozen=True)
class K2Step:
    """Constructs the k²-means step.

    ``K2Step(k=.., kn=..).build(n, d)`` returns ``step(x, w, state) ->
    (state', stats)`` over :class:`K2State` (``residency="rebuild"``) or
    :class:`ResidentState` (``"resident"``, the default);
    :meth:`init_resident` builds the initial resident state and
    :meth:`final_assignment` scatters it back to point order.

    ``mesh``: a :class:`launch.mesh.Mesh` (None: one device), whose
    ``data_axes`` (default: all of its data axes) carry the row shards.
    ``n`` is then the padded global row count, divisible by the shard
    count, and the step takes this rank's rows; the point-block size and
    the move cap follow the local row count, as the reference's mesh
    step takes them, and :meth:`final_assignment` gathers every shard's
    rows.
    """
    k: int
    kn: int
    backend: str = "kernels"      # "kernels" | "xla" (ungrouped)
    chunk: int = 2048             # xla backend: assignment chunk rows
    bn: int | None = None         # point-block size (None: choose_group_bn)
    bkn: int = 8                  # candidate-tile width (kn padding)
    residency: str = "resident"   # "rebuild" | "resident"
    regroup_every: int = 16       # resident: full re-sort period
    move_cap: int | None = None   # resident: move-buffer rows (None: auto)
    precision: str = "f32"        # "f32" | "int8" quantized arena (§13)
    mesh: typing.Any = None       # launch.mesh.Mesh | None (one device)
    data_axes: tuple | None = None

    def _validate(self):
        if self.backend not in ("kernels", "xla"):
            raise ValueError(f"unknown backend {self.backend!r}; "
                             "expected 'kernels' or 'xla'")
        if self.residency not in ("rebuild", "resident"):
            raise ValueError(f"unknown residency {self.residency!r}; "
                             "expected 'rebuild' or 'resident'")
        if self.residency == "resident" and self.regroup_every < 1:
            raise ValueError("regroup_every must be >= 1, got "
                             f"{self.regroup_every}")
        if self.precision not in ("f32", "int8"):
            raise ValueError(f"unknown precision {self.precision!r}; "
                             "expected 'f32' or 'int8'")
        if self.precision == "int8" and self.residency != "resident":
            raise ValueError("precision='int8' requires the resident "
                             "arena (residency='resident'): the rebuild "
                             "engines would re-quantize the whole layout "
                             "every iteration")

    def axes(self) -> tuple:
        if self.mesh is None:
            return ()
        return tuple(self.data_axes) if self.data_axes \
            else dp_axes(self.mesh)

    def shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.axes()) \
            if self.mesh is not None else 1

    def psum(self):
        """The cross-shard sum over the step's axes (None: one device)."""
        if self.mesh is None:
            return None
        mesh, axes = self.mesh, self.axes()
        return lambda *ts: mesh.sum(*ts, axes=axes)

    def _n_local(self, n: int) -> int:
        nsh = self.shards()
        if n % nsh:
            raise ValueError(f"n={n} must divide over {nsh} shards; pad "
                             "rows (w=0) before building the step")
        return n // nsh

    def _bn(self, n: int, d: int | None = None) -> int:
        return self.bn or choose_group_bn(self._n_local(n), self.k, d,
                                          bkn=self.bkn)

    def _move_cap(self, n: int) -> int:
        return self.move_cap or max(64, self._n_local(n) // 32)

    def build(self, n: int, d: int | None = None):
        self._validate()
        kn = min(self.kn, self.k)
        psum = self.psum()
        if self.residency == "resident":
            move_cap, regroup_every = self._move_cap(n), self.regroup_every

            def step(x, w, state):
                return k2_resident_iteration(
                    x, w, state, kn=kn, bkn=self.bkn,
                    regroup_every=regroup_every, move_cap=move_cap,
                    precision=self.precision, backend=self.backend,
                    chunk=self.chunk, psum=psum)
            return step
        bn = self._bn(n, d)

        def step(x, w, state):
            return k2_iteration(x, w, state, kn=kn, bn=bn, bkn=self.bkn,
                                backend=self.backend, chunk=self.chunk,
                                psum=psum)
        return step

    def init_resident(self, x: torch.Tensor, w: torch.Tensor,
                      centers: torch.Tensor,
                      assignment: torch.Tensor) -> ResidentState:
        """One-time resident-layout build from an initial assignment
        (this shard's rows on a mesh)."""
        self._validate()
        n_loc, d = x.shape
        n = n_loc * self.shards()
        bn = self._bn(n, d)
        return init_resident_state(
            x, w, centers, assignment, kn=min(self.kn, self.k), bn=bn,
            nb_total=resident_capacity(n_loc, self.k, bn),
            precision=self.precision, psum=self.psum())

    def final_assignment(self, state: ResidentState, n: int) -> torch.Tensor:
        """Point-order assignment of a resident state, (n,) int32 (on a
        mesh: every shard's rows, gathered in shard order, on every
        rank)."""
        a = resident_assignment(state, self._n_local(n))
        return a if self.mesh is None else self.mesh.gather_rows(a)
