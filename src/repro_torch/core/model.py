"""Query-time subsystem: the served model and its bounded ``predict``
(port of the read side of ``repro.core.model``, DESIGN.md §10 and §13).

After ``fit`` the clustering becomes a served structure:
:class:`KMeansModel` holds the centers, the center k_n-NN graph, the
per-cluster statistics and, when built from the training points, the
resident grouped arena (:class:`core.engine.ResidentState`).

``predict`` is two-level. *Routing* is a cluster-closure coarse quantizer
over the centers: a tiny k-means groups the k centers into
``route_groups`` groups, each group lists its centers closure-filled to
``route_cap`` with the nearest outside ones, and a query scans its
``route_probes`` nearest groups' lists. *Resolution* takes the routed
center's k_n-neighborhood from the graph through K1
(``kernels.ops.bounded_predict_assign``), or, at ``precision="int8"``,
through the int8 scan K4 and an exact f32 re-rank of its survivors
(``kernels.ops.bounded_predict_assign_int8``), which returns the same
assignments. Triangle-inequality bounds make the *counted* distance
charge smaller than the dense scan; they change the charge, never the
assignment.

Idioms that differ from the reference:
- every ``lax.top_k`` selection is a stable sort (``distance.bottom_k``);
- every norm, product and sum on the path accumulates in f64 and is
  rounded once to f32, as K1 does: the f32 and int8 paths give a (query,
  center) pair one distance, and the card and the CPU give one result;
  candidate products are one (m, k) product whose columns are gathered
  (``quant.rerank_exact``), never an (m, P, d) gather;
- the router's strided warm start follows XLA's folded f32 linspace;
- ``predict`` reads the device once per call for the input validation
  and once for the counted charge (summed on the device); the int8 route
  reads its all-rows-proven flag once per batch. The int8 resolution
  re-ranks against each query block's own f32 slab and selects its
  overflow rows on the device, with no host read.

Not ported in this slice: ``partial_fit`` and ``save``/``restore``
(ROADMAP §1 item 6) and per-stream warm starts (``stream=``, item 8);
each raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from ..device import as_tensor, resolve
from ..kernels import quant
from ..kernels.center_knn import center_sqdist
from ..kernels.ops import (bincount, bounded_predict_assign,
                           bounded_predict_assign_int8, choose_group_bn,
                           resident_capacity, resident_regroup,
                           segment_sum, segment_sum_f64)
from .distance import bottom_k
from .engine import ResidentState
from .lloyd import KMeansResult
from .opcount import OpCounter

_VALIDATE_MODES = ("raise", "sanitize", "none")
_PRECISIONS = ("f32", "int8")
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
    dgc_true = torch.sqrt(dgc)
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
    dg = torch.sqrt(quant.sqdist_exact(q, router.gc))     # (m, g)
    gi = bottom_k(dg, probes).long()
    cand = router.members[gi].reshape(m, -1)              # (m, probes*cap)
    lb1 = torch.abs(torch.gather(dg, 1, gi)[:, :, None]
                    - router.mdist[gi]).reshape(m, -1)
    own = router.mowner[gi].reshape(m, -1).long()
    lb2 = torch.gather(dg, 1, own) - router.modist[gi].reshape(m, -1)
    lb = torch.maximum(lb1, lb2)
    sq = quant.rerank_exact(q, c, cand)
    anchor_cols = torch.arange(probes, device=q.device) * cap
    u_anchor = torch.sqrt(torch.amin(sq[:, anchor_cols], dim=1))
    passing = lb < u_anchor[:, None]
    passing[:, anchor_cols] = True
    sq_m = torch.where(passing, sq, torch.inf)
    j = torch.argmin(sq_m, dim=1, keepdim=True)
    routed = torch.gather(cand, 1, j)[:, 0]
    u_routed = torch.sqrt(torch.gather(sq_m, 1, j)[:, 0])
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
    dg = torch.sqrt(quant.sqdist_exact(q, gc))
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
    return routed, torch.sqrt(d1), ~tie_other, torch.sum(uniq, dim=1)


def _graph_with_dists(c: torch.Tensor, kn: int):
    """Center kNN graph and true neighbor distances from one k x k pass
    of K2, with the fit-time selection (``engine.center_knn_graph``), so
    fit and query route through identical neighborhoods."""
    cc = center_sqdist(c)
    neighbors = bottom_k(cc, kn)
    return neighbors, torch.sqrt(torch.gather(cc, 1, neighbors.long()))


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


@dataclasses.dataclass
class KMeansModel:
    """A served clustering: centers + center kNN graph + per-cluster
    stats (+ the resident member arena when built from the points).

    ``state`` is a :class:`core.engine.ResidentState`: ``c`` the centers,
    ``prev_nb`` the kNN graph, ``sums``/``counts`` the per-cluster
    statistics, and the slot arrays the member arena (zero slots for
    predict-only models). ``x_pts``/``a_pts``/``w_pts`` are the arena's
    insertion-order mirrors, with the capacity tail parked in cluster 0
    at weight 0."""
    state: ResidentState
    router: Router
    nb_dist: torch.Tensor       # (k, kn) center-to-neighbor distances
    x_pts: torch.Tensor         # (cap, d) insertion-order mirror
    a_pts: torch.Tensor         # (cap,) int32 assignment mirror
    w_pts: torch.Tensor         # (cap,) weight mirror (0 = not streamed)
    kn: int
    bn: int
    bkn: int = 8
    route_probes: int = 2       # groups scanned per query
    router_iters: int = 8       # tiny-k-means iterations per router build
    precision: str = "f32"      # default predict scan precision (§13)
    n_rows: int = 0             # rows in the arena and the mirrors' prefix
    # lazily built int8 scan tables (centers, group centroids)
    _qt: typing.Any = dataclasses.field(default=None, repr=False,
                                        compare=False)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_result(cls, result: KMeansResult, x=None, *, kn: int = 30,
                    capacity: int | None = None, bkn: int = 8,
                    route_groups: int | None = None,
                    route_cap: int | None = None, route_probes: int = 2,
                    router_iters: int = 8, bn: int | None = None,
                    precision: str = "f32", device=None) -> "KMeansModel":
        """Build a model from a :class:`KMeansResult` on ``device``
        (default ``cuda``). Without ``x`` the model is predict-only (counts
        from the fit assignment, sums ``centers * counts``); with ``x`` the
        resident arena is built over the training rows with room for
        ``capacity`` rows in all (default 2n)."""
        _check_precision(precision)
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
        common = dict(router=router, nb_dist=nb_dist, kn=kn, bkn=bkn,
                      route_probes=route_probes, router_iters=router_iters,
                      precision=precision)
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
        x_pts[:n] = x
        a_pts[:n] = a0
        w_pts[:n] = 1.0
        xg, pid, wg, b2c, fill, openb = _arena_resort(
            x_pts, a_pts, w_pts, k=k, bn=bn,
            nbt=resident_capacity(cap, k, bn))
        state = ResidentState(
            c=c, prev_nb=neighbors, sums=c * counts[:, None], counts=counts,
            it=0, first=False, xg=xg, pid=pid, ug=zf(pid.shape[0]),
            lo_g=zf(pid.shape[0]), wg=wg, b2c=b2c, fill=fill, openb=openb)
        return cls(state=state, x_pts=x_pts, a_pts=a_pts, w_pts=w_pts,
                   bn=bn, n_rows=n, **common)

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
        """Insertion-order assignment of the arena's rows, (n_rows,)."""
        return self.a_pts[:self.n_rows]

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
        bn = choose_group_bn(qb.shape[0], self.k, self.d, bkn=self.bkn)
        return bounded_predict_assign(qb, self.state.c, self.state.prev_nb,
                                      routed, bn=bn, bkn=self.bkn)

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
                bkn=self.bkn, r=_RESOLVE_RERANK)
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
                precision: str | None = None, stream: str | None = None):
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
        rejected. There is no chaos or retry envelope around a batch
        until fault tolerance is ported (ROADMAP §1 item 9).
        """
        if stream is not None:
            raise NotImplementedError(
                "per-stream warm starts (stream=) are not ported yet "
                "(ROADMAP §1 item 8)")
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
        bs = min(batch_size, nq)
        a_parts, d_parts = [], []
        counted = torch.zeros((), dtype=torch.int64, device=q.device)
        for lo in range(0, nq, bs):
            qb = q[lo:lo + bs]
            m = qb.shape[0]
            if m < bs:                       # pad the tail batch
                qb = torch.nn.functional.pad(qb, (0, 0, 0, bs - m))
            a_b, d_b, _, n_c = self._predict_batch(qb, precision=prec)
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

    # -- not ported yet ----------------------------------------------------

    def partial_fit(self, *args, **kwargs):
        raise NotImplementedError(
            "partial_fit (streaming updates) is not ported yet (ROADMAP §1 "
            "item 6)")

    def save(self, *args, **kwargs):
        raise NotImplementedError(
            "model checkpoints (save/restore) are not ported yet (ROADMAP "
            "§1 item 6)")

    @classmethod
    def restore(cls, *args, **kwargs):
        raise NotImplementedError(
            "model checkpoints (save/restore) are not ported yet (ROADMAP "
            "§1 item 6)")


__all__ = ["KMeansModel", "Router"]
