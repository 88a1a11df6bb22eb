"""Query-time subsystem: the served model, its bounded ``predict`` and its
streaming ``partial_fit`` (port of ``repro.core.model``, DESIGN.md §10,
§13 and §14).

After ``fit`` the clustering becomes a served structure, read by
``predict`` and written by ``partial_fit``:
:class:`KMeansModel` holds the centers, the center k_n-NN graph, the
per-cluster statistics and, when built from the training points, the
resident grouped arena (:class:`core.engine.ResidentState`).

``predict`` is two-level. *Routing* is a cluster-closure coarse quantizer
over the centers: a tiny k-means groups the k centers into
``route_groups`` groups, each group lists its centers closure-filled to
``route_cap`` with the nearest outside ones, and a query scans its
``route_probes`` nearest groups' lists. *Resolution* takes the routed
center's k_n-neighborhood from the graph through K1
(``kernels.ops.bounded_predict_assign``) on ``backend="kernels"``, or
ungrouped through ``distance.chunked_candidate_argmin`` on ``"xla"``;
at ``precision="int8"`` through the int8 scan (K4, or
``quant.approx_scan`` on xla) and an exact f32 re-rank of its survivors
(``kernels.ops.bounded_predict_assign_int8``). Every path gives a
(query, center) pair one correctly rounded distance, so all four return
the same assignments. Triangle-inequality bounds make the *counted* distance
charge smaller than the dense scan; they change the charge, never the
assignment.

``partial_fit`` is the streaming side (Sculley's per-center running
means, ``centers = sums / counts``, with exponential forgetting): each
batch is assigned by the bounded route, folded into the statistics as an
incremental delta, and appended into the resident arena by the sparse
repair (``kernels.ops.plan_layout_repair``; a full re-sort when the free
pool runs out). The center graph (K2) and the router are rebuilt every
``refresh_every`` batches. Every batch is one stream epoch: with
``window = W`` rows older than the W newest epochs are evicted from the
arena (``engine.resident_evict``) and their decayed weight subtracted,
ring ids recycle mirror rows modulo the capacity; ``half_life`` sets the
decay per epoch, ``count_floor`` freezes starved counts, and
``drift_guard`` flags dying centers and re-seats them at refresh cadence
(``ft.invariants.repair_dying_centers``). ``predict(stream=)`` and
``partial_fit(stream=)`` carry warm-start Hamerly bounds per named
stream. ``save``/``restore`` write the reference's checkpoint format
(``checkpoint``), so each package restores the other's.

Idioms that differ from the reference:
- every ``lax.top_k`` selection is a stable sort (``distance.bottom_k``);
- every norm, product and sum on the path accumulates in f64 and is
  rounded once to f32, as K1 does: the f32 and int8 paths give a (query,
  center) pair one distance, and the card and the CPU give one result;
  candidate products are one (m, k) product whose columns are gathered
  (``quant.rerank_exact``), never an (m, P, d) gather. The norms that
  feed the stream bounds (the query motion ``dq`` and the center motion
  ``c_motion``) are the square roots of correctly rounded squared norms
  (``exact_sqnorm``); every square root is correctly rounded
  (``exact_round.sqrt_rn``), as XLA's and the card's are and torch's f32
  root on the CPU is not;
- the Sculley sums of a fold, the drift guard's per-center energy and
  the eviction's delta add each cluster's rows in row (slot) order on
  every device (``segment_sum_ordered``, ``segment_sum_blocks``), the
  CPU's bits on the card, never with ``index_add_``'s atomics;
- ``decay^age`` is ``engine.decay_pow``: the f32 decay raised by binary
  exponentiation in f64 and rounded once to f32, subnormal results
  flushed to zero as XLA flushes them (the drift repair keeps
  the f64 decay and the f64 power), so the card and the CPU weigh a row
  alike; the reference's ``jnp.power`` may differ in the last bit, so at
  decay < 1 the decayed statistics match the reference's within a few
  ulps, not bit for bit;
- the router's strided warm start follows XLA's folded f32 linspace;
- ``predict`` reads the device once per call for the input validation
  and once for the counted charge (summed on the device); the int8 route
  reads its all-rows-proven flag once per batch. The int8 resolution
  re-ranks against each query block's own f32 slab and selects its
  overflow rows on the device, with no host read. ``partial_fit`` reads
  it once for the batch's live and non-finite rows, once for the
  eviction count, the ring clash and the free pool together, once at a
  refresh for the drift guard's flags, and once for the charge;
- the sparse-repair append writes the arena in place once the free pool
  is known to suffice;
- the checkpoint's ``backend`` is the reference's name for the model's
  backend ("pallas" for kernels, "xla"), and restore maps it back;
- an installed ``ft.chaos.FaultInjector``'s ``exhaust_arena`` fault is
  applied after the batch's free-pool read, and the append plan is then
  made again (one more host read, only under that fault).
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from ..device import as_tensor, resolve
from ..kernels import quant
from ..kernels.center_knn import center_sqdist
from ..kernels.exact_round import exact_sqnorm, sqrt_rn
from ..kernels.ops import (bincount, bounded_predict_assign,
                           bounded_predict_assign_int8,
                           bounded_predict_assign_top2, choose_group_bn,
                           compact, plan_layout_repair, resident_capacity,
                           resident_regroup, scatter_drop, segment_sum,
                           segment_sum_f64, segment_sum_ordered)
from .distance import (bottom_k, chunked_candidate_argmin,
                       chunked_candidate_top2)
from .engine import ResidentState, f32, resident_evict
from .lloyd import KMeansResult
from .opcount import LAYOUT_STATE_LANES, OpCounter

_VALIDATE_MODES = ("raise", "sanitize", "none")
_PRECISIONS = ("f32", "int8")
_BACKENDS = ("kernels", "xla")
# the reference's names of the backends, as a checkpoint records them
_CKPT_BACKEND = {"kernels": "pallas", "xla": "xla"}
_INT32_MAX = torch.iinfo(torch.int32).max
# static f32 re-rank width of the quantized resolution scan (DESIGN.md
# §13): survivor sets beyond it fall back to a full-kn exact re-rank
_RESOLVE_RERANK = 16


def _validate_rows(x: torch.Tensor, mode: str, *, what: str) -> torch.Tensor:
    """"raise" rejects non-finite rows with an error naming them,
    "sanitize" zeroes them, "none" skips the check (one host read)."""
    if mode not in _VALIDATE_MODES:
        raise ValueError(f"validate must be one of {_VALIDATE_MODES}, "
                         f"got {mode!r}")
    if mode == "none":
        return x
    bad = ~torch.isfinite(x).all(dim=1)
    n_bad = int(torch.sum(bad))
    if n_bad == 0:
        return x
    if mode == "raise":
        idx = torch.nonzero(bad).flatten()[:8].tolist()
        raise ValueError(f"{what}: {n_bad} non-finite rows (first at "
                         f"{idx}); pass validate='sanitize' to zero them")
    return torch.where(bad[:, None], 0.0, x)


def _check_backend(backend: str) -> str:
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {_BACKENDS}")
    return backend


def _check_precision(precision: str) -> str:
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; expected one "
                         f"of {_PRECISIONS}")
    return precision


def _default_groups(k: int) -> int:
    """Routing-group count: ~2 sqrt(k), at least 4."""
    return min(k, max(4, int(round(2.0 * math.sqrt(k)))))


def _default_cap(k: int, g: int, kn: int) -> int:
    """Member-list width: ~6x the mean group size, never below kn."""
    return min(k, max(kn, 6 * k // max(g, 1)))


def _strided_ids(k: int, g: int) -> torch.Tensor:
    """``jnp.linspace(0, k - 1, g).round()`` as the reference computes it
    in f32: XLA folds ``(k - 1) * (i / (g - 1))`` into ``i * c`` with the
    constant ``c = (k - 1) * (1 / (g - 1))`` rounded twice; the endpoint
    is exact and ``round`` goes half to even."""
    if g == 1:
        return torch.zeros((1,), dtype=torch.int64)
    one = torch.tensor(1.0)
    c = (k - 1) * (one / (g - 1))
    v = torch.cat([torch.arange(g - 1, dtype=torch.float32) * c,
                   torch.tensor([k - 1.0])])
    return torch.round(v).long()


class Router(typing.NamedTuple):
    """Cluster-closure routing structure. ``mdist[j, i]`` is member i's
    distance to the listing group's centroid, ``modist[j, i]`` to its
    owner group's (``mowner[j, i]``)."""
    gc: torch.Tensor       # (g, d) group centroids
    members: torch.Tensor  # (g, cap) int32 closure member lists
    mdist: torch.Tensor    # (g, cap) d(member, gc[listing group])
    mowner: torch.Tensor   # (g, cap) int32 owner group per member
    modist: torch.Tensor   # (g, cap) d(member, gc[owner group])


def _build_router(c: torch.Tensor, g: int, cap: int, iters: int) -> Router:
    """A tiny k-means over the centers (strided warm start) groups them
    into g groups; each group lists its own members (by distance to its
    centroid) strictly ahead of the nearest non-members, squashed into
    the disjoint score bands [0, 1) and [1, 2), to ``cap`` entries."""
    k = c.shape[0]
    gc = c[_strided_ids(k, g).to(c.device)]
    ones = torch.ones((k,), dtype=c.dtype, device=c.device)
    for _ in range(iters):
        ga = torch.argmin(quant.sqdist_exact(c, gc), dim=1)
        sums = segment_sum_f64(c, ga, g)
        cnt = segment_sum(ones, ga, g)
        gc = torch.where(cnt[:, None] > 0,
                         sums / torch.clamp(cnt, min=1.0)[:, None], gc)
    dgc = quant.sqdist_exact(gc, c)                       # (g, k)
    ga = torch.argmin(dgc, dim=0)                         # owner group
    norm = dgc / (torch.max(dgc) + 1.0)
    assigned = ga[None, :] == torch.arange(g, device=c.device)[:, None]
    members = bottom_k(torch.where(assigned, norm, 1.0 + norm), cap)
    ml = members.long()
    dgc_true = sqrt_rn(dgc)
    mowner = ga[ml]
    return Router(gc, members, torch.gather(dgc_true, 1, ml),
                  mowner.to(torch.int32), dgc_true[mowner, ml])


def _route(q: torch.Tensor, c: torch.Tensor, router: Router, probes: int):
    """Route queries through the closure router: distances to the group
    centroids, then the ``probes`` nearest groups' member lists with
    triangle-inequality pruning against one exact anchor per list (its
    head member). The dense scan still runs; pruned entries cannot win.
    Returns (routed (m,) int32, u_routed (m,) true distance to it,
    n_scanned (m,) the stage's distance charge)."""
    m = q.shape[0]
    cap = router.members.shape[1]
    dg = sqrt_rn(quant.sqdist_exact(q, router.gc))     # (m, g)
    gi = bottom_k(dg, probes).long()
    cand = router.members[gi].reshape(m, -1)              # (m, probes*cap)
    lb1 = torch.abs(torch.gather(dg, 1, gi)[:, :, None]
                    - router.mdist[gi]).reshape(m, -1)
    own = router.mowner[gi].reshape(m, -1).long()
    lb2 = torch.gather(dg, 1, own) - router.modist[gi].reshape(m, -1)
    lb = torch.maximum(lb1, lb2)
    sq = quant.rerank_exact(q, c, cand)
    anchor_cols = torch.arange(probes, device=q.device) * cap
    u_anchor = sqrt_rn(torch.amin(sq[:, anchor_cols], dim=1))
    passing = lb < u_anchor[:, None]
    passing[:, anchor_cols] = True
    sq_m = torch.where(passing, sq, torch.inf)
    j = torch.argmin(sq_m, dim=1, keepdim=True)
    routed = torch.gather(cand, 1, j)[:, 0]
    u_routed = sqrt_rn(torch.gather(sq_m, 1, j)[:, 0])
    return routed, u_routed, router.gc.shape[0] + torch.sum(passing, dim=1)


def _route_groups_int8(q, xq, xsc, xerr, gc, gq: quant.CenterQuant,
                       probes: int):
    """Int8 group-centroid scan that always returns the exact f32
    top-``probes`` group set: the int8 ranking is proven when its
    ambiguity band ``{j : s_hat_j - rad_j <= max over selected of s_hat +
    rad}`` holds exactly ``probes`` groups; otherwise the band is
    re-ranked with exact distances, and the band is the row's f32 charge.
    Returns (gi (m, probes) int32, n_exact (m,))."""
    shat = quant.int8_shat(xq, xsc, gq)                   # (m, g)
    rad = gq.err[None, :] + xerr[:, None]
    gi = bottom_k(shat, probes).long()
    sel = torch.zeros_like(shat, dtype=torch.bool).scatter_(1, gi, True)
    ub_sel = torch.amax(torch.where(sel, shat + rad, -torch.inf), dim=1)
    band = (shat - rad) <= ub_sel[:, None]                # contains sel
    nband = torch.sum(band, dim=1)
    ambiguous = nband > probes
    dg = sqrt_rn(quant.sqdist_exact(q, gc))
    gi_exact = bottom_k(torch.where(band, dg, torch.inf), probes).long()
    gi = torch.where(ambiguous[:, None], gi_exact, gi)
    return gi.to(torch.int32), torch.where(ambiguous, nband, 0)


def _route_members_int8(qb, xq, xsc, xerr, c, cq: quant.CenterQuant, cand):
    """Int8 member scan with an exact f32 re-rank of ALL margin survivors
    (no width cap). A row is accepted (``ok``) unless two distinct
    surviving ids tie exactly at the minimum. The charge is the number of
    unique surviving ids (the probed lists overlap). Returns (routed,
    u_routed, ok, n_rerank)."""
    _, mask = quant.margin_test(xq, xsc, xerr, cq, cand)
    ids = torch.where(mask, cand, -1)
    sq = quant.rerank_exact(qb, c, ids)
    routed, d1, _ = quant.first_min_top2(sq, ids)
    tie_other = torch.any((sq == d1[:, None]) & (ids >= 0)
                          & (ids != routed[:, None]), dim=1)
    big = torch.iinfo(torch.int32).max
    srt = torch.sort(torch.where(mask, cand, big), dim=1).values
    uniq = torch.cat([srt[:, :1] != big,
                      (srt[:, 1:] != srt[:, :-1]) & (srt[:, 1:] != big)],
                     dim=1)
    return routed, sqrt_rn(d1), ~tie_other, torch.sum(uniq, dim=1)


def _graph_with_dists(c: torch.Tensor, kn: int):
    """Center kNN graph and true neighbor distances from one k x k pass
    of K2, with the fit-time selection (``engine.center_knn_graph``), so
    fit and query route through identical neighborhoods."""
    cc = center_sqdist(c)
    neighbors = bottom_k(cc, kn)
    return neighbors, sqrt_rn(torch.gather(cc, 1, neighbors.long()))


def _arena_resort(x_pts, a_pts, w_pts, *, k: int, bn: int, nbt: int):
    """Full re-sort from the insertion-order mirrors: the fit-time
    engine's packing, parked rows riding along in cluster 0 at weight
    0."""
    perm, b2c, fill, openb = resident_regroup(a_pts, k, bn, nbt)
    valid = perm >= 0
    sp = torch.clamp(perm, min=0).long()
    xg = torch.where(valid[:, None], x_pts[sp], 0.0).contiguous()
    wg = torch.where(valid, w_pts[sp], 0.0)
    return xg, perm, wg, b2c, fill, openb


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Row norms of ``v`` (m, d): the square root of the correctly rounded
    squared norm, the same bits on every device."""
    return sqrt_rn(exact_sqnorm(v))


def _delta_update(c, sums, counts, xb, wb, ab, decay: float, floor: float):
    """Sculley's per-center running means as an incremental delta: the
    statistics decay by ``decay`` and absorb the batch, every touched
    center lands on its new mean. Each cluster's rows are added in row
    order onto its decayed sum (``segment_sum_ordered`` from ``init``):
    XLA folds the reference's ``sums * decay + segment_sum(...)`` into
    one scatter-add that starts from the decayed sums, and these are its
    bits. A center whose decayed mass dips under ``floor`` is frozen at
    it with its sums re-anchored (``sums = c * floor``); ``floor = 0``
    leaves an empty center where it is. Returns (c', sums', counts')."""
    k = c.shape[0]
    dev = c.device
    dec = torch.tensor(f32(decay), dtype=torch.float32, device=dev)
    fl = torch.tensor(f32(floor), dtype=torch.float32, device=dev)
    al = ab.long()
    sums2 = segment_sum_ordered(xb * wb[:, None], al, k, init=sums * dec)
    counts2 = segment_sum_ordered(wb, al, k, init=counts * dec)
    frozen = counts2 < fl
    counts2 = torch.where(frozen, torch.maximum(fl, counts2), counts2)
    sums2 = torch.where(frozen[:, None], c * counts2[:, None], sums2)
    c2 = torch.where(counts2[:, None] > 0,
                     sums2 / torch.clamp(counts2, min=1e-12)[:, None], c)
    return c2, sums2, counts2


def _batch_ids(wb: torch.Tensor, n_rows: int, cap: int = 0) -> torch.Tensor:
    """Insertion ids of the live batch rows: dense from ``n_rows`` in lane
    order, -1 for weight-0 padding lanes (they take no id and no room).
    With ``cap`` the ids wrap modulo the capacity (the windowed ring):
    ``n_rows`` is then the rows-streamed clock, and a recycled id is only
    legal once the window has evicted its previous occupant (the caller
    checks)."""
    live = wb > 0
    ids = n_rows + torch.cumsum(live.to(torch.int64), 0) - 1
    if cap:
        ids = ids % cap
    return torch.where(live, ids, -1).to(torch.int32)


def _update_mirrors(x_pts, a_pts, w_pts, e_pts, xb, wb, ab, ids,
                    epoch: int):
    """Write the live batch rows into the insertion-order mirrors and
    stamp their stream epoch; padding lanes (id -1) drop."""
    idx = torch.where(ids >= 0, ids.long(), x_pts.shape[0])
    return (scatter_drop(x_pts, idx, xb.to(x_pts.dtype)),
            scatter_drop(a_pts, idx, ab.to(torch.int32)),
            scatter_drop(w_pts, idx, wb.to(w_pts.dtype)),
            scatter_drop(e_pts, idx, epoch))


def _evict_mirrors(a_pts, w_pts, pid_old, evict):
    """Park the evicted rows in the mirrors (weight 0, cluster 0, the
    parked-capacity convention), so the next full re-sort reclaims their
    holes into cluster 0's parked pool."""
    idx = torch.where(evict & (pid_old >= 0), pid_old.long(),
                      a_pts.shape[0])
    return scatter_drop(a_pts, idx, 0), scatter_drop(w_pts, idx, 0.0)


def _slot_epochs(pid: torch.Tensor, e_pts: torch.Tensor) -> torch.Tensor:
    """Per-slot stream epochs from the epoch mirror; free slots read as
    INT32_MAX, never older than an eviction cutoff."""
    cap = e_pts.shape[0]
    if not cap:
        return torch.full_like(pid, _INT32_MAX)
    eg = e_pts[torch.clamp(pid, 0, cap - 1).long()]
    return torch.where(pid >= 0, eg, _INT32_MAX)


def _append_plan(state: ResidentState, wb, ab, *, bn: int):
    """The sparse-repair plan of one batch's append (every live row moves
    from its parked slot to its cluster's watermark): ``(active,
    dst_slot, b2c', fill', openb', total_new, n_free)``; the free pool
    suffices when ``total_new <= n_free``."""
    active = wb > 0
    return (active,) + plan_layout_repair(state.b2c, state.fill, state.openb,
                                          active, ab, bn=bn)


def _arena_append(state: ResidentState, xb, wb, ids, plan, *, cap: int,
                  n_live: int):
    """Carry out :func:`_append_plan`'s plan in place: each live row's
    parked source slot (found by inverting ``pid``) becomes a hole, its
    destination slot takes the row, its id and weight. A recycled ring id
    whose slot the window already made a hole has no source: its
    destination, a free slot, stands in. ``n_live``: the batch's live
    lanes (the caller's count); with padding lanes the live ones are
    listed first by :func:`ops.compact` at that fixed size, with no host
    read and no data-dependent shape. Returns (xg, pid, wg, b2c, fill,
    openb)."""
    active, dst_slot, b2c2, fill2, openb2, _, _ = plan
    s_total = state.pid.shape[0]
    dev = state.pid.device
    slot_of = torch.full((cap + 1,), s_total, dtype=torch.int64, device=dev)
    slot_of[torch.where(state.pid >= 0, state.pid.long(), cap)] = \
        torch.arange(s_total, device=dev)
    ids_l, dst = ids.long(), dst_slot.long()
    if n_live < active.shape[0]:
        lanes = compact(active, n_live, 0)
        ids_l, dst, xb, wb = ids_l[lanes], dst[lanes], xb[lanes], wb[lanes]
    src = slot_of[torch.clamp(ids_l, 0, cap - 1)]
    src = torch.where(src < s_total, src, dst)
    pid, xg, wg = state.pid, state.xg, state.wg
    pid[src] = -1
    wg[src] = 0.0
    pid[dst] = ids_l.to(torch.int32)
    xg[dst] = xb.to(xg.dtype)
    wg[dst] = wb.to(wg.dtype)
    return xg, pid, wg, b2c2, fill2, openb2


@dataclasses.dataclass
class KMeansModel:
    """A served clustering: centers + center kNN graph + per-cluster
    stats (+ the resident member arena when built from the points).
    Mutable: ``partial_fit`` updates it in place; ``predict`` only reads
    (and caches per-stream bounds).

    ``state`` is a :class:`core.engine.ResidentState`: ``c`` the centers,
    ``prev_nb`` the kNN graph, ``sums``/``counts`` the per-cluster
    statistics, and the slot arrays the member arena (zero slots for
    predict-only models). ``x_pts``/``a_pts``/``w_pts``/``e_pts`` are the
    arena's insertion-order mirrors, with the capacity tail parked in
    cluster 0 at weight 0 (epoch -1)."""
    state: ResidentState
    router: Router
    nb_dist: torch.Tensor       # (k, kn) center-to-neighbor distances
    x_pts: torch.Tensor         # (cap, d) insertion-order mirror
    a_pts: torch.Tensor         # (cap,) int32 assignment mirror
    w_pts: torch.Tensor         # (cap,) weight mirror (0 = not streamed)
    kn: int
    bn: int
    backend: str = "kernels"    # "kernels" | "xla" (predict resolution)
    bkn: int = 8
    route_probes: int = 2       # groups scanned per query
    router_iters: int = 8       # tiny-k-means iterations per router build
    refresh_every: int = 8      # partial_fit batches between graph builds
    decay: float = 1.0          # exponential forgetting of sums/counts
    precision: str = "f32"      # default predict scan precision (§13)
    n_rows: int = 0             # rows in the arena and the mirrors' prefix
    batches_seen: int = 0
    degraded_folds: int = 0     # arena-full batches folded stats-only
    # lazily built int8 scan tables (centers, group centroids), dropped
    # whenever the centers move
    _qt: typing.Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    # -- streaming / drift (DESIGN.md §14) --------------------------------
    window: int = 0             # sliding window in stream epochs (0 = off)
    half_life: float = 0.0      # decay half-life in epochs (0: raw decay)
    count_floor: float = 0.0    # freeze floor for decayed counts
    drift_guard: bool = False   # EWMA drift detection + center repair
    rows_streamed: int = 0      # monotonic live-row clock (ring ids)
    evicted_rows: int = 0       # rows retired by the sliding window
    repaired_centers: int = 0   # centers re-seated by the drift guard
    e_pts: torch.Tensor | None = None     # (cap,) int32 epoch mirror
    c_motion: torch.Tensor | None = None  # (k,) cumulative center drift
    # the drift guard's EWMA state and the per-stream warm-start bounds:
    # runtime caches, not checkpointed
    _dg: typing.Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    _streams: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def __post_init__(self):
        dev = self.x_pts.device
        if self.e_pts is None:
            self.e_pts = torch.full((self.capacity,), -1, dtype=torch.int32,
                                    device=dev)
        if self.c_motion is None:
            self.c_motion = torch.zeros((self.k,), dtype=torch.float32,
                                        device=dev)
        if self.rows_streamed < self.n_rows:
            self.rows_streamed = self.n_rows

    # -- construction ------------------------------------------------------

    @classmethod
    def from_result(cls, result: KMeansResult, x=None, *, kn: int = 30,
                    capacity: int | None = None, backend: str = "kernels",
                    bkn: int = 8,
                    route_groups: int | None = None,
                    route_cap: int | None = None, route_probes: int = 2,
                    router_iters: int = 8, refresh_every: int = 8,
                    decay: float = 1.0, bn: int | None = None,
                    precision: str = "f32", window: int = 0,
                    half_life: float = 0.0, count_floor: float = 0.0,
                    drift_guard: bool = False,
                    device=None) -> "KMeansModel":
        """Build a model from a :class:`KMeansResult` on ``device``
        (default ``cuda``). Without ``x`` the model is predict-only, with
        stats-only ``partial_fit`` (counts from the fit assignment, sums
        ``centers * counts``); with ``x`` the resident arena is built over
        the training rows with room for ``capacity`` rows in all (default
        2n), the training rows at stream epoch 0. ``backend``: the
        resolution's, ``"kernels"`` or ``"xla"``."""
        _check_precision(precision)
        _check_backend(backend)
        if window < 0 or half_life < 0 or count_floor < 0:
            raise ValueError("window, half_life and count_floor must be "
                             ">= 0")
        dev = resolve(device)
        c = as_tensor(result.centers, dev)
        k, d = c.shape
        kn = min(kn, k)
        a0 = as_tensor(result.assignment, dev, torch.int32)
        neighbors, nb_dist = _graph_with_dists(c, kn)
        g = route_groups or _default_groups(k)
        rcap = route_cap or _default_cap(k, g, kn)
        router = _build_router(c, g, rcap, router_iters)
        counts = bincount(a0.long(), k).to(torch.float32)
        common = dict(router=router, nb_dist=nb_dist, kn=kn, backend=backend,
                      bkn=bkn,
                      route_probes=route_probes, router_iters=router_iters,
                      refresh_every=refresh_every, decay=decay,
                      precision=precision, window=window,
                      half_life=half_life, count_floor=count_floor,
                      drift_guard=drift_guard)
        zi = lambda size: torch.zeros(size, dtype=torch.int32,  # noqa: E731
                                      device=dev)
        zf = lambda size: torch.zeros(size, device=dev)         # noqa: E731
        if x is None:
            state = ResidentState(
                c=c, prev_nb=neighbors, sums=c * counts[:, None],
                counts=counts, it=0, first=False, xg=zf((0, d)), pid=zi(0),
                ug=zf(0), lo_g=zf(0), wg=zf(0), b2c=zi(0), fill=zi(k),
                openb=zi(k) - 1)
            return cls(state=state, x_pts=zf((0, d)), a_pts=zi(0),
                       w_pts=zf(0), bn=bn or 8, n_rows=0, **common)
        x = as_tensor(x, dev)
        n = x.shape[0]
        cap = capacity or 2 * n
        if cap < n:
            raise ValueError(f"capacity={cap} < n={n} training rows")
        bn = bn or choose_group_bn(cap, k, d, bkn=bkn)
        x_pts, a_pts, w_pts = zf((cap, d)), zi(cap), zf(cap)
        e_pts = zi(cap) - 1
        x_pts[:n] = x
        a_pts[:n] = a0
        w_pts[:n] = 1.0
        e_pts[:n] = 0
        xg, pid, wg, b2c, fill, openb = _arena_resort(
            x_pts, a_pts, w_pts, k=k, bn=bn,
            nbt=resident_capacity(cap, k, bn))
        state = ResidentState(
            c=c, prev_nb=neighbors, sums=c * counts[:, None], counts=counts,
            it=0, first=False, xg=xg, pid=pid, ug=zf(pid.shape[0]),
            lo_g=zf(pid.shape[0]), wg=wg, b2c=b2c, fill=fill, openb=openb)
        return cls(state=state, x_pts=x_pts, a_pts=a_pts, w_pts=w_pts,
                   bn=bn, n_rows=n, e_pts=e_pts, rows_streamed=n, **common)

    # -- read-side properties ---------------------------------------------

    @property
    def centers(self) -> torch.Tensor:
        return self.state.c

    @property
    def neighbors(self) -> torch.Tensor:
        return self.state.prev_nb

    @property
    def counts(self) -> torch.Tensor:
        return self.state.counts

    @property
    def sums(self) -> torch.Tensor:
        return self.state.sums

    @property
    def k(self) -> int:
        return self.state.c.shape[0]

    @property
    def d(self) -> int:
        return self.state.c.shape[1]

    @property
    def capacity(self) -> int:
        return self.x_pts.shape[0]

    @property
    def has_arena(self) -> bool:
        return self.state.pid.shape[0] > 0

    def assignment(self) -> torch.Tensor:
        """Insertion-order assignment of every streamed row, (n_rows,).
        A windowed model parks evicted rows at weight 0 in cluster 0:
        filter by ``w_pts > 0`` (or :meth:`live_rows`)."""
        return self.a_pts[:self.n_rows]

    @property
    def stream_decay(self) -> float:
        """Forgetting factor per epoch: ``2^(-1/half_life)`` when a
        half-life (in epochs) is set, else ``decay``."""
        if self.half_life > 0:
            return float(2.0 ** (-1.0 / self.half_life))
        return self.decay

    def live_rows(self) -> int:
        """Rows alive in the mirrors (streamed, not evicted)."""
        return int(torch.sum(self.w_pts > 0))

    @property
    def route_groups(self) -> int:
        return self.router.gc.shape[0]

    @property
    def route_cap(self) -> int:
        return self.router.members.shape[1]

    def dense_distances_per_query(self) -> int:
        """Dense (unpruned) distance evaluations per predicted query, the
        upper bound on the counted charge."""
        return (self.route_groups + self.route_probes * self.route_cap
                + self.kn)

    # -- predict -----------------------------------------------------------

    def _quant_tables(self):
        """The int8 scan tables: a ``quant.CenterQuant`` over the centers
        (member scan and resolution slabs) and one over the group
        centroids (routing), built on the first quantized scan."""
        if self._qt is None:
            self._qt = (quant.center_quant(self.state.c),
                        quant.center_quant(self.router.gc))
        return self._qt

    def _route_int8(self, qb: torch.Tensor, probes: int):
        """Int8 routing with exact fallback: the group scan returns the
        exact top-probes groups, the member scan re-ranks its margin
        survivors exactly, and the rows it cannot prove (one host read
        per batch) are re-routed by the f32 :func:`_route`, so ``routed``
        always equals the f32 route's. Returns (routed, u_routed, n_f32)."""
        cq, gq = self._quant_tables()
        xq, xsc = quant.quantize_rows(qb)
        xerr = quant.residual_norm(qb, xq, xsc)
        gi, n_grp = _route_groups_int8(qb, xq, xsc, xerr, self.router.gc,
                                       gq, probes)
        cand = self.router.members[gi.long()].reshape(qb.shape[0], -1)
        routed, u_routed, ok, n_rr = _route_members_int8(
            qb, xq, xsc, xerr, self.state.c, cq, cand)
        n_rr = n_rr + n_grp
        if not bool(torch.all(ok)):
            rf, uf, nf = _route(qb, self.state.c, self.router, probes)
            routed = torch.where(ok, routed, rf)
            u_routed = torch.where(ok, u_routed, uf)
            n_rr = torch.where(ok, n_rr, nf)
        return routed, u_routed, n_rr

    def route(self, q) -> torch.Tensor:
        """Route queries through the closure router ((m,) int32): the best
        center among the ``route_probes`` nearest groups' lists."""
        routed, _, _ = _route(as_tensor(q, self.centers.device),
                              self.state.c, self.router, self.route_probes)
        return routed

    def route_batch(self, qb, probes: int | None = None,
                    precision: str | None = None):
        """The routing stage alone: ``(routed, u_routed, n_scanned)`` for
        one batch, with optional ``probes`` and ``precision`` overrides."""
        p = self.route_probes if probes is None else min(
            probes, self.route_groups)
        prec = _check_precision(precision or self.precision)
        qb = as_tensor(qb, self.centers.device)
        if prec == "int8":
            return self._route_int8(qb, p)
        return _route(qb, self.state.c, self.router, p)

    def _resolve(self, qb: torch.Tensor, routed: torch.Tensor):
        if self.backend == "xla":
            return chunked_candidate_argmin(
                qb, self.state.c, self.state.prev_nb[routed.long()])
        bn = choose_group_bn(qb.shape[0], self.k, self.d, bkn=self.bkn)
        return bounded_predict_assign(qb, self.state.c, self.state.prev_nb,
                                      routed, bn=bn, bkn=self.bkn)

    def _resolve_top2(self, qb: torch.Tensor, routed: torch.Tensor):
        """Resolution with the two best squared distances over the routed
        center's k_n-neighborhood (the Hamerly bound pair): ``(a, d1_sq,
        d2_sq)``. K1 gives them squared; the xla path gives true
        distances, squared here as the reference squares them."""
        if self.backend == "xla":
            a, d1, d2 = chunked_candidate_top2(
                qb, self.state.c, self.state.prev_nb[routed.long()])
            return a, d1 * d1, d2 * d2
        bn = choose_group_bn(qb.shape[0], self.k, self.d, bkn=self.bkn)
        return bounded_predict_assign_top2(qb, self.state.c,
                                           self.state.prev_nb, routed,
                                           bn=bn, bkn=self.bkn)

    def _assign_stream(self, qb: torch.Tensor, stream):
        """Bounded assignment with warm-start Hamerly bounds per stream
        (DESIGN.md §14): a correlated query stream carries ``(a, u, lo)``
        across batches keyed by ``stream``. On re-contact the bounds
        inflate by the query's own motion ``|q - q_prev|`` and the
        centers' drift since (``c_motion`` deltas, a triangle-inequality
        bound); a row whose inflated ``u < lo`` keeps its previous center
        within the k_n-restricted contract and charges 1 distance. Cold
        rows pay the bounded route plus the top-2 resolution and re-arm
        their bounds. Returns (a, d1_sq, n_counted)."""
        m = qb.shape[0]
        routed, u_routed, n_scan = _route(qb, self.state.c, self.router,
                                          self.route_probes)
        a, d1_sq, d2_sq = self._resolve_top2(qb, routed)
        u_new = sqrt_rn(d1_sq)
        lo_new = sqrt_rn(d2_sq)
        n_nb = torch.clamp(torch.sum(self.nb_dist[routed.long()]
                                     < 2.0 * u_routed[:, None], dim=1) - 1,
                           min=0)
        n_counted = n_scan + n_nb
        rec = self._streams.get(stream)
        if rec is not None and rec["a"].shape[0] == m \
                and rec["q"].shape == qb.shape:
            drift = self.c_motion - rec["motion"]
            dq = _norm(qb - rec["q"])
            a_prev = rec["a"].long()
            u_b = rec["u"] + dq + drift[a_prev]
            lo_b = rec["lo"] - dq - torch.amax(
                drift[self.state.prev_nb[a_prev].long()], dim=1)
            warm = u_b < lo_b
            a = torch.where(warm, rec["a"], a)
            d1_sq = torch.where(warm, u_b * u_b, d1_sq)
            u_new = torch.where(warm, u_b, u_new)
            lo_new = torch.where(warm, torch.clamp(lo_b, min=0.0), lo_new)
            n_counted = torch.where(warm, 1, n_counted)
        self._streams[stream] = {"q": qb, "a": a, "u": u_new, "lo": lo_new,
                                 "motion": self.c_motion}
        return a, d1_sq, n_counted

    def _predict_batch(self, qb: torch.Tensor, probes: int | None = None,
                       precision: str | None = None):
        """Route + resolve one batch. Returns (a, sqdist, routed,
        n_counted (m,)): the per-query f32 distance charge of the serial
        bounded algorithm (group scan + surviving members + resolution
        neighbors passing Elkan's ``d(nb, routed) < 2 d(q, routed)``). At
        ``precision="int8"`` both stages scan the int8 tables and
        n_counted is the exactly re-ranked candidates (plus full fallback
        charges)."""
        p = self.route_probes if probes is None else min(
            probes, self.route_groups)
        prec = _check_precision(precision or self.precision)
        if prec == "int8":
            routed, _, n_route = self._route_int8(qb, p)
            cq, _ = self._quant_tables()
            bn = choose_group_bn(qb.shape[0], self.k, self.d, bkn=self.bkn,
                                 itemsize=1)
            a_b, d_b, nsv, fb = bounded_predict_assign_int8(
                qb, self.state.c, cq, self.state.prev_nb, routed, bn=bn,
                bkn=self.bkn, r=_RESOLVE_RERANK, backend=self.backend)
            n_res = torch.where(fb, self.kn,
                                torch.clamp(nsv, max=_RESOLVE_RERANK))
            return a_b, d_b, routed, n_route + n_res
        routed, u_routed, n_scan = _route(qb, self.state.c, self.router, p)
        a_b, d_b = self._resolve(qb, routed)
        # the routing stage already holds d(q, routed): the self-neighbor
        # is not charged twice
        n_nb = torch.clamp(torch.sum(self.nb_dist[routed.long()]
                                     < 2.0 * u_routed[:, None], dim=1) - 1,
                           min=0)
        return a_b, d_b, routed, n_scan + n_nb

    def predict(self, queries, *, batch_size: int = 8192,
                counter: OpCounter | None = None,
                return_sqdist: bool = False, validate: str = "raise",
                retries: int = 3, precision: str | None = None,
                stream: str | None = None):
        """Bounded nearest-center assignment of ``queries`` (n, d).

        Runs ``batch_size`` queries at a time (the tail batch is padded
        up, padding rows charge nothing). Charges the measured bounded
        distance count to ``counter`` (at most ``n *
        dense_distances_per_query()``). Returns the assignment (n,) int32,
        plus each query's squared distance to it when ``return_sqdist``.

        ``precision="int8"`` scans every stage over the quantized tables
        and re-ranks the margin survivors exactly in f32: the same
        assignments, with the int8 scan charged on ``counter.int8_ops`` /
        ``counter.bytes_scanned``. ``validate``: "raise" rejects
        non-finite rows, "sanitize" zeroes them, "none" skips the check.
        bf16/f16 queries are upcast to f32 once, here; integer queries are
        rejected. ``stream`` names a correlated query stream: the f32 path
        then carries warm-start Hamerly bounds across calls
        (:meth:`_assign_stream`), so a repeat batch charges 1 distance a
        warm row; the int8 path ignores it. Transient per-batch failures
        (``ft.chaos.TransientError``, which an installed
        ``ft.chaos.FaultInjector`` raises on its scheduled ``"predict"``
        calls) are retried up to ``retries`` times a batch with
        exponential backoff (``ft.retry_transient``, each retry counted
        on ``counter.retries``); any other exception propagates.
        """
        q = torch.as_tensor(queries)
        if not torch.is_floating_point(q):
            raise TypeError(f"predict queries must be floating point, got "
                            f"{q.dtype}")
        q = q.to(device=self.centers.device, dtype=torch.float32)
        prec = _check_precision(precision or self.precision)
        q = _validate_rows(q, validate, what="predict queries")
        nq = q.shape[0]
        if nq == 0:
            empty_a = torch.zeros((0,), dtype=torch.int32, device=q.device)
            return (empty_a, torch.zeros((0,), device=q.device)) \
                if return_sqdist else empty_a
        from ..ft import chaos as _chaos
        from ..ft.runtime import retry_transient
        bs = min(batch_size, nq)
        a_parts, d_parts = [], []
        counted = torch.zeros((), dtype=torch.int64, device=q.device)
        for lo in range(0, nq, bs):
            qb = q[lo:lo + bs]
            m = qb.shape[0]
            if m < bs:                       # pad the tail batch
                qb = torch.nn.functional.pad(qb, (0, 0, 0, bs - m))
            warm_key = (stream, lo // bs) \
                if stream is not None and prec == "f32" else None

            def _one_batch(qb=qb, warm_key=warm_key):
                inj = _chaos.active()
                if inj is not None:
                    inj.maybe_fail("predict")
                if warm_key is not None:
                    return self._assign_stream(qb, warm_key)
                a_b, d_b, _, n_c = self._predict_batch(qb, precision=prec)
                return a_b, d_b, n_c

            a_b, d_b, n_c = retry_transient(_one_batch, retries=retries,
                                            counter=counter)
            a_parts.append(a_b[:m])
            d_parts.append(d_b[:m])
            counted += torch.sum(n_c[:m])
        if counter is not None:
            n_f32 = int(counted)
            counter.add_distances(n_f32)
            # scan traffic: int8 rows cost d + 4 scale bytes (+ 4d per
            # f32-re-ranked candidate), f32 rows 4d
            dense = self.dense_distances_per_query()
            if prec == "int8":
                counter.add_int8_ops(nq * dense)
                counter.add_scan_bytes(nq * dense * (self.d + 4)
                                       + n_f32 * 4 * self.d)
            else:
                counter.add_scan_bytes(nq * dense * 4 * self.d)
        a = torch.cat(a_parts)
        return (a, torch.cat(d_parts)) if return_sqdist else a

    # -- partial_fit -------------------------------------------------------

    def partial_fit(self, batch, w=None, *, counter: OpCounter | None = None,
                    validate: str = "raise", on_full: str = "raise",
                    stream: str | None = None) -> torch.Tensor:
        """Fold one streamed mini-batch (m, d) into the served clustering.

        Assigns the batch by the bounded route (K1), applies the
        incremental per-center running-mean update, appends the rows into
        the resident arena (sparse repair; a full re-sort when the free
        pool runs out) and rebuilds the center graph (K2) and the router
        every ``refresh_every`` batches. ``w`` (m,): row weights, 0 for
        padding rows (which take no id and no room). Returns the batch's
        assignment (m,) int32.

        ``validate``: "raise" rejects a batch with non-finite live rows,
        naming them; "sanitize" quarantines them at weight 0 (counted on
        ``counter.sanitized_rows``); "none" skips the check. ``on_full``:
        when the batch would overflow the arena (or the ring, windowed),
        "raise" refuses it (after the fold and the eviction, as the
        reference does), "degrade" keeps the fold and drops the rows,
        counted on ``degraded_folds``.

        Every batch is one stream epoch. With ``window = W`` the rows
        older than the W newest epochs leave the arena before the append,
        their decayed weight subtracted from the statistics
        (``engine.resident_evict``; at ``decay = 1`` the statistics equal
        a fold of the surviving window bit for bit), and ring ids recycle
        mirror rows modulo the capacity. ``half_life`` sets the decay to
        ``2^(-1/half_life)`` per epoch, ``count_floor`` freezes starved
        counts. With ``drift_guard`` each fold feeds the EWMA bands
        (``ft.invariants.drift_guard_step``) and, at refresh cadence, the
        flagged centers are re-seated by Lemma-1 splits of the
        highest-energy donors (``ft.invariants.repair_dying_centers``, K3
        inside ``gdi.projective_split``). ``stream`` names a correlated
        stream whose warm-start bounds carry across folds
        (:meth:`_assign_stream`). An installed ``ft.chaos.FaultInjector``
        corrupts the batch first (``corrupt_batch``: late delivery, drift
        bursts, duplicate floods, NaN rows) and may exhaust the arena's
        free pool before the append (``corrupt_arena``), forcing the full
        re-sort.
        """
        if on_full not in ("raise", "degrade"):
            raise ValueError(f"on_full must be 'raise' or 'degrade', "
                             f"got {on_full!r}")
        if validate not in _VALIDATE_MODES:
            raise ValueError(f"validate must be one of {_VALIDATE_MODES}, "
                             f"got {validate!r}")
        dev = self.centers.device
        xb = as_tensor(batch, dev)
        if xb.ndim != 2 or xb.shape[1] != self.d:
            raise ValueError(f"batch shape {tuple(xb.shape)} != (m, "
                             f"{self.d})")
        m = xb.shape[0]
        wb = torch.ones((m,), device=dev) if w is None else as_tensor(w, dev)
        from ..ft import chaos as _chaos
        inj = _chaos.active()
        if inj is not None:
            xb = inj.corrupt_batch(xb)
        live = wb > 0
        # the batch's one read: non-finite live rows and live rows
        bad = ~torch.isfinite(xb).all(dim=1) if validate != "none" \
            else torch.zeros((m,), dtype=torch.bool, device=dev)
        n_bad, m_live = torch.stack([torch.sum(bad & live),
                                     torch.sum(live)]).tolist()
        if n_bad:
            if validate == "raise":
                idx = torch.nonzero(bad).flatten()[:8].tolist()
                raise ValueError(
                    f"partial_fit batch {self.batches_seen}: {n_bad} "
                    f"non-finite rows (first at {idx}); pass "
                    f"validate='sanitize' to quarantine them")
            xb = torch.where(bad[:, None], 0.0, xb)
            wb = torch.where(bad, 0.0, wb)
            m_live -= n_bad
            if counter is not None:
                counter.count_sanitized_rows(n_bad)

        if stream is not None:
            ab, d1_sq, n_counted = self._assign_stream(xb, ("fit", stream))
        else:
            ab, d1_sq, _, n_counted = self._predict_batch(xb)

        c_entry = self.state.c
        decay, floor = self.stream_decay, self.count_floor
        c2, sums2, counts2 = _delta_update(
            self.state.c, self.state.sums, self.state.counts, xb, wb, ab,
            decay, floor)
        st = self.state._replace(c=c2, sums=sums2, counts=counts2,
                                 it=self.state.it + 1)

        # sliding-window eviction: the fold above applied this epoch's
        # decay, so a row folded at epoch e weighs w decay^(now - e)
        epoch_now = self.batches_seen
        n_ev_dev = None
        if self.window and self.has_arena and m_live:
            cutoff = epoch_now - self.window + 1
            if cutoff > 0:
                pid_old = st.pid
                st, evict, n_ev_dev = resident_evict(
                    st, _slot_epochs(st.pid, self.e_pts), cutoff, epoch_now,
                    decay, floor)
                self.a_pts, self.w_pts = _evict_mirrors(
                    self.a_pts, self.w_pts, pid_old, evict)

        resorted = degraded = False
        ids = plan = None
        if self.has_arena and m_live:
            zero = torch.zeros((), dtype=torch.int64, device=dev)
            clash = zero
            if self.window:
                ids = _batch_ids(wb, self.rows_streamed, cap=self.capacity)
                # a recycled ring id whose previous occupant is still live
                # means the window outgrew the capacity
                held = self.w_pts[torch.clamp(ids, 0,
                                              self.capacity - 1).long()]
                clash = torch.sum((ids >= 0) & (held > 0))
            plan = _append_plan(st, wb, ab, bn=self.bn)
            # the second read: evicted rows, ring clash, free pool
            n_ev, clash, ok = torch.stack([
                zero if n_ev_dev is None else n_ev_dev, clash,
                (plan[5] <= plan[6]).to(torch.int64)]).tolist()
            if n_ev:
                self.evicted_rows += n_ev
                if counter is not None:
                    counter.count_evicted_rows(n_ev)
                    # subtracting the delta re-reduces sums/counts
                    counter.add_additions(2 * n_ev)
                    # pid + wg lanes cleared per retired slot
                    counter.add_scatter_bytes(n_ev * 8)
            if self.window:
                full = clash > 0
                full_msg = (
                    f"arena ring full: {clash} of {m_live} batch rows "
                    f"would overwrite live rows (window {self.window} "
                    f"epochs x batch size > capacity {self.capacity})")
            else:
                full = self.n_rows + m_live > self.capacity
                full_msg = (f"arena full: {self.n_rows} rows + batch "
                            f"{m_live} > capacity {self.capacity}")
            if full:
                if on_full == "raise":
                    raise ValueError(full_msg)
                # the fold above already absorbed the batch
                degraded = True
                self.degraded_folds += 1
                if counter is not None:
                    counter.count_degraded_fold()
        if self.has_arena and m_live and not degraded:
            if ids is None:
                ids = _batch_ids(wb, self.n_rows)
            self.x_pts, self.a_pts, self.w_pts, self.e_pts = \
                _update_mirrors(self.x_pts, self.a_pts, self.w_pts,
                                self.e_pts, xb, wb, ab, ids, epoch_now)
            if inj is not None:
                st_c = inj.corrupt_arena(st)
                if st_c is not st:           # the pool was exhausted
                    st = st_c
                    plan = _append_plan(st, wb, ab, bn=self.bn)
                    ok = bool(plan[5] <= plan[6])
            if ok:
                xg, pid, wg, b2c, fill, openb = _arena_append(
                    st, xb, wb, ids, plan, cap=self.capacity,
                    n_live=m_live)
            else:
                resorted = True
                xg, pid, wg, b2c, fill, openb = _arena_resort(
                    self.x_pts, self.a_pts, self.w_pts, k=self.k,
                    bn=self.bn, nbt=st.b2c.shape[0])
            st = st._replace(xg=xg, pid=pid, wg=wg, b2c=b2c, fill=fill,
                             openb=openb)
            self.n_rows = min(self.rows_streamed + m_live, self.capacity) \
                if self.window else self.n_rows + m_live
        self.rows_streamed += m_live
        self.batches_seen += 1
        self.state = st

        dying = None
        if self.drift_guard and m_live:
            from ..ft import invariants as _inv
            if self._dg is None:
                self._dg = _inv.init_drift_guard(self.k, device=dev)
            eb = segment_sum_ordered(torch.clamp(d1_sq, min=0.0) * wb, ab,
                                     self.k)
            self._dg, dying = _inv.drift_guard_step(
                self._dg, self.state.counts, eb, floor)
        refreshed = self.batches_seen % self.refresh_every == 0
        if refreshed and dying is not None and bool(torch.any(dying)):
            from ..ft.invariants import repair_dying_centers
            self.repaired_centers += repair_dying_centers(
                self, dying, counter=counter)
        if refreshed:
            # the center graph (resolution) and the router (routing)
            # re-sync with the moved centers
            nb, self.nb_dist = _graph_with_dists(self.state.c, self.kn)
            self.state = self.state._replace(prev_nb=nb)
            self.router = _build_router(self.state.c, self.route_groups,
                                        self.route_cap, self.router_iters)
        self._qt = None     # the centers moved: the int8 tables are stale
        # one net-displacement increment per fold (a triangle-inequality
        # bound on the motion); the stream bounds inflate by its deltas
        self.c_motion = self.c_motion + _norm(self.state.c - c_entry)

        if counter is not None:
            # weight-0 padding rows charge nothing
            counter.add_distances(int(torch.sum(torch.where(
                wb > 0, n_counted, 0))))
            counter.add_additions(2 * m_live)       # incremental delta
            if refreshed:                           # graph + router build
                counter.add_distances(
                    self.k * self.k
                    + (self.router_iters + 1) * self.route_groups * self.k)
            if self.has_arena and m_live and not degraded:
                moved = self.capacity if resorted else m_live
                row_bytes = (self.d + LAYOUT_STATE_LANES) * 4
                counter.add_gather_bytes(moved * row_bytes)
                counter.add_scatter_bytes(moved * row_bytes)
                if resorted:
                    counter.add_sort_bytes(
                        moved * 8 * max(1.0, math.log2(max(moved, 2))))
        return ab

    # -- checkpointing -----------------------------------------------------

    def _config(self) -> dict:
        """The static config and clocks a restore needs, as the
        reference's ``_config`` writes them (``backend`` under the
        reference's name)."""
        return {"k": self.k, "d": self.d, "kn": self.kn, "bn": self.bn,
                "nbt": int(self.state.b2c.shape[0]),
                "capacity": self.capacity,
                "backend": _CKPT_BACKEND[self.backend],
                "bkn": self.bkn, "route_groups": self.route_groups,
                "route_cap": self.route_cap,
                "route_probes": self.route_probes,
                "router_iters": self.router_iters,
                "refresh_every": self.refresh_every,
                "decay": float(self.decay), "precision": self.precision,
                "n_rows": self.n_rows, "batches_seen": self.batches_seen,
                # the stream leaves (the epoch and motion clocks) ride
                # every checkpoint, as the reference's stream_v2 format
                "stream_v2": True,
                "window": self.window, "half_life": float(self.half_life),
                "count_floor": float(self.count_floor),
                "drift_guard": bool(self.drift_guard),
                "rows_streamed": self.rows_streamed,
                "evicted_rows": self.evicted_rows,
                "repaired_centers": self.repaired_centers,
                "degraded_folds": self.degraded_folds}

    def _tree(self) -> dict:
        """The model's arrays in the reference's tree: the state's ``it``
        and ``first`` as 0-d int32 and bool arrays; an int8 model's
        quantization scales, which restore checks against tables
        recomputed from the centers."""
        st = self.state
        dev = st.c.device
        state = st._replace(
            it=torch.tensor(int(st.it), dtype=torch.int32, device=dev),
            first=torch.tensor(bool(st.first), device=dev))
        tree = {"state": state, "router": self.router,
                "nb_dist": self.nb_dist, "x_pts": self.x_pts,
                "a_pts": self.a_pts, "w_pts": self.w_pts,
                "stream": {"e_pts": self.e_pts, "c_motion": self.c_motion}}
        if self.precision == "int8":
            cq, gq = self._quant_tables()
            tree["qscale"] = {"c": cq.scale, "gc": gq.scale}
        return tree

    @classmethod
    def _like_tree(cls, cfg: dict) -> dict:
        """Shapes and types of a checkpoint's tree, on the ``meta``
        device (no memory)."""
        k, d, kn = cfg["k"], cfg["d"], cfg["kn"]
        nbt, bn, cap = cfg["nbt"], cfg["bn"], cfg["capacity"]
        s = nbt * bn if nbt else 0
        f, i = torch.float32, torch.int32

        def z(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")
        state = ResidentState(
            c=z((k, d), f), prev_nb=z((k, kn), i), sums=z((k, d), f),
            counts=z((k,), f), it=z((), i), first=z((), torch.bool),
            xg=z((s, d), f), pid=z((s,), i), ug=z((s,), f),
            lo_g=z((s,), f), wg=z((s,), f), b2c=z((nbt,), i),
            fill=z((k,), i), openb=z((k,), i))
        g, rcap = cfg["route_groups"], cfg["route_cap"]
        router = Router(gc=z((g, d), f), members=z((g, rcap), i),
                        mdist=z((g, rcap), f), mowner=z((g, rcap), i),
                        modist=z((g, rcap), f))
        tree = {"state": state, "router": router, "nb_dist": z((k, kn), f),
                "x_pts": z((cap, d), f), "a_pts": z((cap,), i),
                "w_pts": z((cap,), f)}
        if cfg.get("stream_v2"):
            tree["stream"] = {"e_pts": z((cap,), i),
                              "c_motion": z((k,), f)}
        if cfg.get("precision", "f32") == "int8":
            tree["qscale"] = {"c": z((k,), f), "gc": z((g,), f)}
        return tree

    def save(self, ckpt_dir: str, step: int = 0) -> str:
        """Atomic checkpoint of the whole model (arrays + config), in the
        reference's format. Returns the step's directory."""
        from ..checkpoint import save_checkpoint
        return save_checkpoint(ckpt_dir, step, self._tree(),
                               extra_meta={"kmeans_model": self._config()})

    @classmethod
    def restore(cls, ckpt_dir: str, step: int | None = None, *,
                device=None) -> "KMeansModel":
        """The model saved at ``step`` (default: the newest complete one),
        by this package or the reference, on ``device`` (default
        ``cuda``). An int8 model's stored scales must equal those of the
        tables recomputed from its centers."""
        from ..checkpoint import (CheckpointCorruptError, latest_step,
                                  load_meta, restore_checkpoint)
        dev = resolve(device)
        if step is None:
            step = latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        cfg = load_meta(ckpt_dir, step)["extra"]["kmeans_model"]
        backend = {v: b for b, v in _CKPT_BACKEND.items()}.get(
            cfg.get("backend", "pallas"))
        if backend is None:
            raise ValueError(f"checkpoint step {step}: unknown backend "
                             f"{cfg['backend']!r}; expected one of "
                             f"{tuple(_CKPT_BACKEND.values())}")
        tree = restore_checkpoint(ckpt_dir, step, cls._like_tree(cfg),
                                  device=dev)
        st = tree["state"]
        st = st._replace(it=int(st.it), first=bool(st.first))
        stream = tree.get("stream", {})
        model = cls(state=st, router=tree["router"],
                    nb_dist=tree["nb_dist"], x_pts=tree["x_pts"],
                    a_pts=tree["a_pts"], w_pts=tree["w_pts"],
                    kn=cfg["kn"], bn=cfg["bn"], backend=backend,
                    bkn=cfg["bkn"],
                    route_probes=cfg["route_probes"],
                    router_iters=cfg["router_iters"],
                    refresh_every=cfg["refresh_every"], decay=cfg["decay"],
                    precision=cfg.get("precision", "f32"),
                    n_rows=cfg["n_rows"], batches_seen=cfg["batches_seen"],
                    window=cfg.get("window", 0),
                    half_life=cfg.get("half_life", 0.0),
                    count_floor=cfg.get("count_floor", 0.0),
                    drift_guard=cfg.get("drift_guard", False),
                    rows_streamed=cfg.get("rows_streamed", cfg["n_rows"]),
                    evicted_rows=cfg.get("evicted_rows", 0),
                    repaired_centers=cfg.get("repaired_centers", 0),
                    degraded_folds=cfg.get("degraded_folds", 0),
                    e_pts=stream.get("e_pts"),
                    c_motion=stream.get("c_motion"))
        if "qscale" in tree:
            cq, gq = model._quant_tables()
            if not (torch.equal(cq.scale, tree["qscale"]["c"])
                    and torch.equal(gq.scale, tree["qscale"]["gc"])):
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: stored quantization scales "
                    f"do not match tables recomputed from the restored "
                    f"centers")
        return model

__all__ = ["KMeansModel", "Router"]
