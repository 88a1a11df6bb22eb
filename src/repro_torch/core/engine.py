"""Engine layer: ONE k²-means iteration (port of ``repro.core.engine``).

The paper's bounded iteration (center k_n-NN graph -> k_n-restricted
assignment with Hamerly bounds -> mean update -> bound adjustment),
single-device, on the cluster-grouped layout through the port's kernels.
``K2Step(...).build(n, d)`` returns ``step(x, w, state) -> (state',
stats)`` for one of two residencies:

``"rebuild"`` — :func:`k2_iteration`: the grouped layout is rebuilt from
scratch every iteration.

``"resident"`` — :func:`k2_resident_iteration` (the default): the layout
lives in :class:`ResidentState` and is repaired each iteration by moving
only the rows whose assignment changed, with an incremental delta
center update and a full re-sort every ``regroup_every`` iterations, on
move-buffer overflow, or when the free-block pool would run out.

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
- the center sums add each cluster's rows in a fixed order on every
  device, so the card's fit is the same in every run: the full sums walk
  each cluster's arena blocks in slot order (``segment_sum_blocks``, the
  CPU's row-order scatter-add bit for bit), and so do the moved rows'
  deltas (each row a block of one slot); the rebuild iteration uses
  ``ops.segment_sum_ordered``.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from ..kernels.candidate_assign import (candidate_assign_tiled,
                                        candidate_tables, pad_candidates)
from ..kernels.center_knn import center_sqdist
from ..kernels.ops import (choose_group_bn, compact, k2_bounded_assign,
                           plan_layout_repair, resident_capacity,
                           resident_regroup, scatter_from_grouped,
                           segment_sum_ordered)
from ..kernels.segment_sum import segment_sum_blocks
from .distance import bottom_k, sqnorm


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


class StepStats(typing.NamedTuple):
    """Device scalars, host-read by the fit loop every ``monitor_every``
    iterations (``core.opcount.charge_iteration``)."""
    n_need: torch.Tensor    # points meeting the exact recompute condition
    changed: torch.Tensor   # assignment changes across the iteration
    energy: torch.Tensor    # clustering energy after the update step
    moved: torch.Tensor     # rows moved through the layout
    resorted: torch.Tensor  # 1 if the layout was fully re-sorted


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
                 kn: int, bn: int, bkn: int = 8
                 ) -> tuple[K2State, StepStats]:
    """The rebuild-residency iteration: the grouped layout is rebuilt
    from the current assignment every call."""
    c, a, u, lo, prev_nb, first = state
    k = c.shape[0]
    wpos = w > 0
    neighbors = center_knn_graph(c, kn)
    list_changed = torch.any(neighbors != prev_nb, dim=1)
    need = ((u >= lo) | list_changed[a.long()] | first) & wpos
    a_new, u_new, lo_new = k2_bounded_assign(x, c, neighbors, a, u, lo,
                                             need, bn=bn, bkn=bkn)
    al = a_new.long()
    sums = segment_sum_ordered(x * w[:, None], al, k)
    counts = segment_sum_ordered(w, al, k)
    c_next = torch.where(counts[:, None] > 0,
                         sums / torch.clamp(counts, min=1.0)[:, None], c)
    delta = torch.sqrt(torch.clamp(sqnorm(c_next - c), min=0.0))
    delta_nb = torch.max(delta[neighbors.long()], dim=1).values
    u_adj = u_new + delta[al]
    lo_adj = lo_new - delta_nb[al]
    n_need = torch.sum(need)
    changed = torch.sum((a_new != a) & wpos)
    energy = torch.sum(w * sqnorm(x - c_next[al]))
    dev = x.device
    stats = StepStats(n_need, changed, energy,
                      torch.tensor(x.shape[0], device=dev),
                      torch.tensor(1, device=dev))
    return K2State(c_next, a_new, u_adj, lo_adj, neighbors, False), stats


def init_resident_state(x: torch.Tensor, w: torch.Tensor,
                        centers: torch.Tensor, assignment: torch.Tensor, *,
                        kn: int, bn: int, nb_total: int) -> ResidentState:
    """Build the resident layout once from an initial assignment (one
    grouping pass + one full segment-sum); stale-zero bounds with
    ``first`` forcing a full recompute on iteration 1."""
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
    return ResidentState(
        centers, torch.full((k, kn), -1, dtype=torch.int32,
                            device=centers.device),
        sums, counts, 0, True, xg, perm, zeros, zeros.clone(), wg, b2c, fill,
        openb)


def resident_assignment(state: ResidentState, n: int) -> torch.Tensor:
    """Point-order assignment from the resident layout (one scatter
    through ``pid``)."""
    bn = state.pid.shape[0] // state.b2c.shape[0]
    a_slot = torch.repeat_interleave(torch.clamp(state.b2c, min=0), bn)
    return scatter_from_grouped(state.pid, a_slot.to(torch.int32),
                                torch.zeros((n,), dtype=torch.int32,
                                            device=state.pid.device))


def k2_resident_iteration(x: torch.Tensor, w: torch.Tensor,
                          state: ResidentState, *, kn: int, bkn: int = 8,
                          regroup_every: int = 16, move_cap: int = 1024
                          ) -> tuple[ResidentState, StepStats]:
    """One iteration over the resident grouped layout.

    The bounded assignment reads the arena ``xg`` directly, the bound
    refresh and statistics stay in slot space, the center update is an
    incremental delta over the changed rows, and the layout is repaired
    by moving only those rows (at most ``move_cap``). A full re-sort and
    exact recompute run every ``regroup_every`` iterations, on
    move-buffer overflow, or when the free-block pool would run out.
    ``x``/``w`` are the point-order arrays, read only by re-sorts. ``bn``
    is a property of the arena and is read from its shapes.
    """
    k = state.c.shape[0]
    n = x.shape[0]
    s_total = state.pid.shape[0]
    nbt = state.b2c.shape[0]
    bn = s_total // nbt
    c = state.c
    dev = c.device
    wpos = state.wg > 0

    # --- 1. k_n-NN graph over centers ----------------------------------
    neighbors = center_knn_graph(c, kn)
    list_changed = torch.any(neighbors != state.prev_nb, dim=1)

    # --- 2. bounded assignment straight over the resident layout --------
    a_slot = torch.repeat_interleave(torch.clamp(state.b2c, min=0), bn)
    need = ((state.ug >= state.lo_g) | list_changed[a_slot.long()]
            | state.first) & wpos
    skip = (~torch.any(need.reshape(nbt, bn), dim=1)).to(torch.int32)
    cidx = pad_candidates(neighbors, bkn).contiguous()
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = torch.clamp(state.b2c, min=0).to(torch.int32).contiguous()
    a_g, d1_sq, d2_sq = candidate_assign_tiled(
        state.xg, ctab, csqtab, cidx, rowsel, skip, a_slot.to(torch.int32),
        state.ug * state.ug, state.lo_g * state.lo_g, bn=bn, bkn=bkn)
    fresh = torch.repeat_interleave(skip == 0, bn)
    u_new = torch.where(fresh, torch.sqrt(d1_sq), state.ug)
    lo_new = torch.where(fresh, torch.sqrt(d2_sq), state.lo_g)
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
    sums_mv, counts_mv = segment_sum_blocks(
        state.xg[mvs].contiguous(), seg2, 2 * k, 1,
        w=torch.cat([w_mv, w_mv]), perm=lanes)
    delta_sums = sums_mv[:k] - sums_mv[k:]
    delta_counts = counts_mv[:k] - counts_mv[k:]

    # --- 5. re-sort triggers: the step's one host read -------------------
    dst_slot, b2c_rep, fill_rep, openb_rep, total_new, n_free = \
        plan_layout_repair(state.b2c, state.fill, state.openb, active,
                           dst_c, bn=bn)
    overflow, exhausted, n_mv = torch.stack(
        [n_changed > move_cap, total_new > n_free, n_changed]
    ).to(torch.int64).tolist()
    time_trigger = (state.it + 1) % regroup_every == 0
    resort = bool(time_trigger or overflow or exhausted)
    full_update = bool(time_trigger or overflow or state.first)

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
    a_slot2 = torch.repeat_interleave(torch.clamp(b2c2, min=0), bn).long()

    # --- 7. center update: incremental delta, or exact recompute ---------
    if full_update:
        # per cluster, a chain over its blocks in slot order: the CPU's
        # row-order scatter-add, bit for bit, on the card
        sums2, counts2 = segment_sum_blocks(xg2, b2c2, k, bn, w=wg2)
    else:
        sums2 = state.sums + delta_sums
        counts2 = state.counts + delta_counts
    c_next = torch.where(counts2[:, None] > 0,
                         sums2 / torch.clamp(counts2, min=1.0)[:, None], c)

    # --- 8. Hamerly bound adjustment (slot space) ------------------------
    delta = torch.sqrt(torch.clamp(sqnorm(c_next - c), min=0.0))
    delta_nb = torch.max(delta[neighbors.long()], dim=1).values
    u_adj = ug2 + delta[a_slot2]
    lo_adj = lo2 - delta_nb[a_slot2]

    # --- 9. device-resident step statistics ------------------------------
    energy = torch.sum(wg2 * sqnorm(xg2 - c_next[a_slot2]))
    moved = torch.sum(state.pid >= 0) if resort else n_changed
    stats = StepStats(torch.sum(need), n_changed, energy, moved,
                      torch.tensor(int(resort), device=dev))
    return ResidentState(c_next, neighbors, sums2, counts2, state.it + 1,
                         False, xg2, pid2, u_adj, lo_adj, wg2, b2c2, fill2,
                         openb2), stats


@dataclasses.dataclass(frozen=True)
class K2Step:
    """Constructs the single-device k²-means step.

    ``K2Step(k=.., kn=..).build(n, d)`` returns ``step(x, w, state) ->
    (state', stats)`` over :class:`K2State` (``residency="rebuild"``) or
    :class:`ResidentState` (``"resident"``, the default);
    :meth:`init_resident` builds the initial resident state and
    :meth:`final_assignment` scatters it back to point order.
    """
    k: int
    kn: int
    bn: int | None = None         # point-block size (None: choose_group_bn)
    bkn: int = 8                  # candidate-tile width (kn padding)
    residency: str = "resident"   # "rebuild" | "resident"
    regroup_every: int = 16       # resident: full re-sort period
    move_cap: int | None = None   # resident: move-buffer rows (None: auto)

    def _validate(self):
        if self.residency not in ("rebuild", "resident"):
            raise ValueError(f"unknown residency {self.residency!r}; "
                             "expected 'rebuild' or 'resident'")
        if self.residency == "resident" and self.regroup_every < 1:
            raise ValueError("regroup_every must be >= 1, got "
                             f"{self.regroup_every}")

    def _bn(self, n: int, d: int | None = None) -> int:
        return self.bn or choose_group_bn(n, self.k, d, bkn=self.bkn)

    def _move_cap(self, n: int) -> int:
        return self.move_cap or max(64, n // 32)

    def build(self, n: int, d: int | None = None):
        self._validate()
        kn = min(self.kn, self.k)
        if self.residency == "resident":
            move_cap, regroup_every = self._move_cap(n), self.regroup_every

            def step(x, w, state):
                return k2_resident_iteration(
                    x, w, state, kn=kn, bkn=self.bkn,
                    regroup_every=regroup_every, move_cap=move_cap)
            return step
        bn = self._bn(n, d)

        def step(x, w, state):
            return k2_iteration(x, w, state, kn=kn, bn=bn, bkn=self.bkn)
        return step

    def init_resident(self, x: torch.Tensor, w: torch.Tensor,
                      centers: torch.Tensor,
                      assignment: torch.Tensor) -> ResidentState:
        """One-time resident-layout build from an initial assignment."""
        self._validate()
        n, d = x.shape
        bn = self._bn(n, d)
        return init_resident_state(
            x, w, centers, assignment, kn=min(self.kn, self.k), bn=bn,
            nb_total=resident_capacity(n, self.k, bn))

    def final_assignment(self, state: ResidentState, n: int) -> torch.Tensor:
        """Point-order assignment of a resident state, (n,) int32."""
        return resident_assignment(state, n)
