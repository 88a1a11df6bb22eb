"""Overload-robust serving executor for :class:`core.model.KMeansModel`
(port of ``repro.serve.executor``, DESIGN.md §12).

The executor is an *online execution layer* in front of
the served clustering: a bounded admission queue (``queue.py``, typed
backpressure), continuous micro-batching of predict calls with
pad-to-bucket shapes (``buckets.py`` — one (kind, bucket, rung) shape
per program, each warmed at startup, never a new one per request),
deadline-budgeted EDF batch formation, interleaved ``partial_fit``
folds that yield to predict traffic, and the four-rung
graceful-degradation ladder of ``degrade.py`` driven by measured queue
pressure with hysteresis (the first rung — the §13 int8 scan — costs
nothing in recall: assignments stay bit-identical to full fidelity).

Time is a *virtual clock*: batches advance it by an analytic service
model (``t_batch_overhead + rows × distances_per_query(rung) ×
sec_per_distance`` — the paper's counted-distance metric turned into a
deterministic latency model, calibratable via ``sec_per_distance``).
The arithmetic is real — every assignment comes out of the model's own
``route_batch`` / ``_predict_batch`` (the kernels the offline path
runs), with one host read per batch (its assignments and charges) —
only the *timing* is modeled, which is what makes a replay of the same
arrival trace + seed produce bit-identical responses AND an identical
degradation-rung transcript, in this port as in the reference (the
chaos determinism contract). The wall time a batch really took is kept
apart, in ``wall_s``, and never enters the clock.

Recovery rides the fault-tolerance machinery: per-batch execution is
wrapped in
``ft.retry_transient`` (an installed ``ft.chaos.FaultInjector`` gets to
fail it first), poisoned query rows are quarantined at the assembly
boundary (``counter.sanitized_rows``), injected slow-consumer stalls
inflate the virtual service time (the ladder reacts, then recovers),
and a periodic guard checks the served model's invariants
(``ft.invariants.resident_violations`` over the arena, finiteness
otherwise) and heals by re-sort + refresh when one fires.

Sequential workloads (the KV decode loop in ``launch/serve.py``) ride
the same queue through :meth:`ServeExecutor.call` with registered ops —
same admission bound, retry envelope and accounting as the batched
traffic.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from ..core.opcount import OpCounter
from .buckets import BucketLadder
from .degrade import (FULL, INT8_SCAN, PROBE_SHRINK, ROUTE_ONLY, SHED,
                      DegradeConfig, DegradeLadder, RUNG_NAMES)
from .queue import AdmissionQueue, Overloaded, Request, Response


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Executor knobs (all deterministic given a fixed trace)."""
    queue_bound: int = 256          # admission queue depth (requests)
    ladder: tuple = (64, 256, 1024)  # pad-to-bucket rungs (rows)
    deadline: float = 0.005         # default per-request budget (s)
    degrade: DegradeConfig = dataclasses.field(
        default_factory=DegradeConfig)
    sec_per_distance: float = 2e-8  # analytic service model: s per counted
    t_batch_overhead: float = 2e-4  # distance, + fixed per-batch launch
    fold_yield_every: int = 4       # predict batches between forced folds
    guard_every: int = 32           # executed batches between guard checks
    retries: int = 3                # transient-failure budget per batch


class ServeExecutor:
    """See module docstring. Build with a model for the predict /
    partial_fit plane, or bare + :meth:`register` for generic sequential
    ops (the KV serve loop)."""

    def __init__(self, model=None, config: ServeConfig | None = None,
                 counter: OpCounter | None = None):
        self.model = model
        self.cfg = config or ServeConfig()
        self.counter = counter if counter is not None else OpCounter()
        self.queue = AdmissionQueue(self.cfg.queue_bound)
        self.buckets = BucketLadder(self.cfg.ladder)
        self.ladder = DegradeLadder(self.cfg.degrade)
        self.responses: dict[int, Response] = {}
        self.now = 0.0
        self.batches = 0            # executed batches (ticks that ran work)
        self._rid = 0
        self._consec_predict = 0
        self.compiled_shapes: set[tuple] = set()   # (bucket, d) seen
        self.jit_keys: set[tuple] = set()          # (kind, bucket, rung)
        self.wall_s = 0.0           # host seconds the executed batches took
        self.events: list[tuple] = []              # guard/heal/chaos log
        self._ops: dict[str, tuple] = {}           # kind -> (fn, cost_fn)

    # -- generic op registration (sequential workloads) --------------------

    def register(self, kind: str, fn: typing.Callable,
                 cost: typing.Callable | None = None) -> None:
        """Register a generic op: ``fn(payload) -> result``. ``cost``
        maps the payload to a virtual service time; without it the
        measured wall-clock of the call advances the clock."""
        if kind in ("predict", "partial_fit"):
            raise ValueError(f"{kind!r} is a built-in model kind")
        self._ops[kind] = (fn, cost)

    def call(self, kind: str, payload, *, deadline: float | None = None,
             priority: int = 0) -> Response:
        """Synchronous submit-and-drain for sequential workloads: the
        request rides the same admission queue, retry envelope and
        accounting as the batched traffic, and the executor ticks until
        it is answered."""
        r = Request(rid=self._next_rid(), kind=kind, x=payload,
                    t_arrival=self.now,
                    deadline=self.now + (deadline or self.cfg.deadline),
                    priority=priority)
        reason = self.queue.offer(r)
        if reason is not None:
            resp = Response(rid=r.rid, kind=kind, status="rejected",
                            t_arrival=r.t_arrival, t_done=self.now,
                            reason=reason)
            self.responses[r.rid] = resp
            return resp
        while r.rid not in self.responses:
            self._tick()
        return self.responses[r.rid]

    def _next_rid(self) -> int:
        rid = self._rid
        self._rid += 1
        return rid

    # -- service model ------------------------------------------------------

    def distances_per_query(self, rung: int) -> int:
        """Analytic per-query distance cost of one rung (the dense
        budget of the bounded route at that rung — the deterministic
        basis of the virtual service model and of the rung ordering:
        every rung is strictly cheaper than the one above). Int8 table
        rows cost ~1/4 of an f32 distance in the service model (d+4
        bytes vs 4d), and every rung below INT8_SCAN rides the int8
        scan, which keeps the cost ordering strict."""
        m = self.model
        g, cap, kn = m.route_groups, m.route_cap, m.kn
        if rung <= FULL:
            return g + m.route_probes * cap + kn
        if rung == INT8_SCAN:
            return g + (m.route_probes * cap + kn) // 4
        if rung == PROBE_SHRINK:
            return g + (cap + kn) // 4
        return g + cap // 4                          # ROUTE_ONLY

    def service_time(self, kind: str, rows: int, rung: int) -> float:
        per_row = self.distances_per_query(min(rung, ROUTE_ONLY))
        if kind == "partial_fit":
            # folds always run the full route + the 2-addition delta
            per_row = self.distances_per_query(FULL) + 2
        return (self.cfg.t_batch_overhead
                + rows * per_row * self.cfg.sec_per_distance)

    def sustainable_qps(self) -> float:
        """Row throughput ceiling of the full-fidelity rung at the top
        bucket — the capacity the benchmark's offered-QPS sweep is
        normalized against."""
        b = self.buckets.max_rows
        return b / self.service_time("predict", b, FULL)

    def _drain_estimate(self) -> float:
        """Virtual seconds to drain the queued predict backlog at the
        current rung (batch overhead charged per full bucket)."""
        rows = self.queue.backlog_rows("predict")
        if rows == 0:
            return 0.0
        n_batches = -(-rows // self.buckets.max_rows)
        return (n_batches * self.cfg.t_batch_overhead
                + rows * self.distances_per_query(min(self.ladder.rung,
                                                      ROUTE_ONLY))
                * self.cfg.sec_per_distance)

    def pressure(self) -> float:
        """The ladder's scalar input: max of queue fill fraction and
        backlog drain time over the deadline budget."""
        return max(self.queue.fill_frac(),
                   self._drain_estimate() / self.cfg.deadline)

    # -- trace driving ------------------------------------------------------

    def run_trace(self, requests: list[Request]) -> list[Response]:
        """Drive the executor over a fully-specified arrival trace
        (virtual time). Returns one response per request, rid order —
        zero silent drops by construction."""
        pending = sorted(requests, key=lambda r: (r.t_arrival, r.rid))
        self._rid = max([r.rid for r in pending], default=-1) + 1
        i = 0
        while i < len(pending) or self.queue.depth():
            if self.queue.depth() == 0:
                self.now = max(self.now, pending[i].t_arrival)
            while i < len(pending) and pending[i].t_arrival <= self.now:
                r = pending[i]
                i += 1
                reason = self.queue.offer(r)
                if reason is not None:
                    self.responses[r.rid] = Response(
                        rid=r.rid, kind=r.kind, status="rejected",
                        t_arrival=r.t_arrival, t_done=self.now,
                        reason=reason)
            self._tick()
        return [self.responses[r.rid] for r in
                sorted(requests, key=lambda r: r.rid)]

    # -- the tick -----------------------------------------------------------

    def _tick(self) -> None:
        if self.queue.depth() == 0:
            return
        rung = self.ladder.observe(self.pressure(), self.now)
        if rung >= SHED:
            self._shed()
        kind = self._choose_kind()
        if kind is None:
            return
        if kind == "predict":
            self._consec_predict += 1
            self._exec_predict_batch(min(rung, ROUTE_ONLY))
        elif kind == "partial_fit":
            self._consec_predict = 0
            self._exec_partial_fit()
        else:
            self._exec_generic(kind)
        self.batches += 1
        if self.model is not None and self.cfg.guard_every > 0 \
                and self.batches % self.cfg.guard_every == 0:
            self.guard()

    def _choose_kind(self) -> str | None:
        kinds = self.queue.kinds_waiting()
        if not kinds:
            return None
        pf = "partial_fit" in kinds
        pred = "predict" in kinds
        # folds yield to predict traffic; the fairness valve runs one
        # fold per fold_yield_every predict batches, but only while the
        # ladder is at full fidelity — under degradation folds starve
        # until the burst drains
        if pf and (not pred or (self.ladder.rung == FULL and
                                self._consec_predict
                                >= self.cfg.fold_yield_every)):
            return "partial_fit"
        if pred:
            return "predict"
        others = sorted(k for k in kinds if k != "partial_fit")
        if others:
            return others[0]
        return "partial_fit" if pf else None

    def _shed(self) -> None:
        """Rung 4: shed lowest-priority predict requests until the
        backlog drains within the deadline budget again; every shed
        request gets a typed ``Overloaded`` response."""
        per_row = (self.distances_per_query(ROUTE_ONLY)
                   * self.cfg.sec_per_distance)
        target_rows = max(self.buckets.max_rows,
                          int(self.cfg.deadline / per_row))
        shed = self.queue.shed_rows(target_rows, "predict")
        if not shed:
            return
        self.counter.count_degrade("shed", len(shed))
        self.events.append((round(self.now, 9), "shed", len(shed)))
        for r in shed:
            self.responses[r.rid] = Overloaded(
                rid=r.rid, kind=r.kind, rung=SHED,
                t_arrival=r.t_arrival, t_done=self.now, reason="shed")

    # -- batched predict ----------------------------------------------------

    def _assemble(self, batch: list[Request]):
        """Concatenate + chaos-poison + sanitize the batch rows; returns
        (padded (bucket, d) np.float32, live row count, offsets)."""
        from ..ft import chaos as _chaos
        inj = _chaos.active()
        parts, offsets, off = [], [], 0
        for r in batch:
            x = np.asarray(r.x, np.float32)
            if inj is not None:
                x = inj.corrupt_queries(r.rid, x)
            parts.append(x)
            offsets.append((off, off + x.shape[0]))
            off += x.shape[0]
        rows = np.concatenate(parts) if len(parts) > 1 else parts[0]
        bad = ~np.isfinite(rows).all(axis=1)
        if bad.any():
            rows = np.where(bad[:, None], 0.0, rows)
            self.counter.count_sanitized_rows(int(bad.sum()))
        bucket = self.buckets.bucket_for(off)
        return self.buckets.pad_rows(rows, bucket), off, offsets

    def _device(self):
        return self.model.centers.device

    def _exec_predict_batch(self, rung: int) -> None:
        t0 = time.perf_counter()
        batch = self.queue.pop_batch("predict", self.buckets.max_rows)
        qb, m_live, offsets = self._assemble(batch)
        bucket = qb.shape[0]
        self.compiled_shapes.add((bucket, qb.shape[1]))
        self.jit_keys.add(("predict", bucket, rung))

        from ..ft import chaos as _chaos
        from ..ft.runtime import retry_transient

        def _one():
            inj = _chaos.active()
            if inj is not None:
                inj.maybe_fail("serve_predict")
            q = torch.from_numpy(qb).to(self._device())
            # every degraded rung rides the §13 int8 scan — identical
            # assignments at INT8_SCAN, shrunk probes below it
            if rung >= ROUTE_ONLY:
                routed, _, n_scan = self.model.route_batch(
                    q, probes=1, precision="int8")
                return routed, n_scan
            if rung == FULL:
                a, _, _, n_counted = self.model._predict_batch(q)
            else:
                probes = 1 if rung == PROBE_SHRINK else None
                a, _, _, n_counted = self.model._predict_batch(
                    q, probes=probes, precision="int8")
            return a, n_counted

        a, n_counted = retry_transient(_one, retries=self.cfg.retries,
                                       counter=self.counter)
        # the batch's one host read: its assignments and charges
        a, n_counted = torch.stack([a.to(torch.int64),
                                    n_counted.to(torch.int64)]).cpu().numpy()
        a = a.astype(np.int32)
        self.wall_s += time.perf_counter() - t0
        self.counter.add_distances(int(n_counted[:m_live].sum()))
        if rung == INT8_SCAN:
            self.counter.count_degrade("int8_scan", len(batch))
        elif rung == PROBE_SHRINK:
            self.counter.count_degrade("probe_shrink", len(batch))
        elif rung >= ROUTE_ONLY:
            self.counter.count_degrade("route_only", len(batch))
        if rung > FULL:
            self.counter.add_int8_ops(
                m_live * (self.model.route_groups
                          + self.model.route_probes * self.model.route_cap
                          + self.model.kn))

        svc = self.service_time("predict", bucket, rung)
        svc += self._injected_stall()
        self.now += svc
        for r, (lo, hi) in zip(batch, offsets):
            self.responses[r.rid] = Response(
                rid=r.rid, kind=r.kind, status="ok", rung=rung,
                t_arrival=r.t_arrival, t_done=self.now,
                result=a[lo:hi].copy())

    # -- partial_fit folds --------------------------------------------------

    def _exec_partial_fit(self) -> None:
        t0 = time.perf_counter()
        batch = self.queue.pop_batch("partial_fit", self.buckets.max_rows)
        xb, m_live, offsets = self._assemble(batch)
        bucket = xb.shape[0]
        self.compiled_shapes.add((bucket, xb.shape[1]))
        self.jit_keys.add(("partial_fit", bucket, FULL))
        wb = np.zeros((bucket,), np.float32)
        wb[:m_live] = 1.0

        from ..ft import chaos as _chaos
        from ..ft.runtime import retry_transient

        def _one():
            inj = _chaos.active()
            if inj is not None:
                inj.maybe_fail("serve_partial_fit")
            # per-bucket stream tag: successive folds of one padded shape
            # carry warm-start Hamerly bounds across batches (DESIGN.md
            # §14) — correlated decode streams skip the router on repeat
            # regions, uncorrelated rows just fail the warm test
            dev = self._device()
            return self.model.partial_fit(
                torch.from_numpy(xb).to(dev), torch.from_numpy(wb).to(dev),
                counter=self.counter, validate="sanitize", on_full="degrade",
                stream=f"bucket{bucket}")

        ab = retry_transient(_one, retries=self.cfg.retries,
                             counter=self.counter).cpu().numpy()
        self.wall_s += time.perf_counter() - t0
        self.now += self.service_time("partial_fit", bucket, FULL) \
            + self._injected_stall()
        for r, (lo, hi) in zip(batch, offsets):
            self.responses[r.rid] = Response(
                rid=r.rid, kind=r.kind, status="ok", rung=self.ladder.rung,
                t_arrival=r.t_arrival, t_done=self.now,
                result=ab[lo:hi].copy())

    # -- generic ops --------------------------------------------------------

    def _exec_generic(self, kind: str) -> None:
        if kind not in self._ops:
            batch = self.queue.pop_batch(kind, 1, max_requests=1)
            for r in batch:
                self.responses[r.rid] = Response(
                    rid=r.rid, kind=kind, status="rejected",
                    t_arrival=r.t_arrival, t_done=self.now,
                    reason="unknown_kind")
            return
        fn, cost = self._ops[kind]
        (r,) = self.queue.pop_batch(kind, 1, max_requests=1)

        from ..ft import chaos as _chaos
        from ..ft.runtime import retry_transient

        def _one():
            inj = _chaos.active()
            if inj is not None:
                inj.maybe_fail(kind)
            return fn(r.x)

        t0 = time.perf_counter()
        result = retry_transient(_one, retries=self.cfg.retries,
                                 counter=self.counter)
        self.wall_s += time.perf_counter() - t0
        svc = cost(r.x) if cost is not None else time.perf_counter() - t0
        self.now += svc + self._injected_stall()
        self.responses[r.rid] = Response(
            rid=r.rid, kind=kind, status="ok", rung=self.ladder.rung,
            t_arrival=r.t_arrival, t_done=self.now, result=result)

    def _injected_stall(self) -> float:
        """Chaos slow-consumer stall for this executed batch (virtual
        seconds — no host sleep, so replays stay deterministic)."""
        from ..ft import chaos as _chaos
        inj = _chaos.active()
        if inj is None:
            return 0.0
        secs = inj.consume_stall(self.batches)
        if secs:
            self.events.append((round(self.now, 9), "slow_consumer", secs))
        return secs

    # -- guards -------------------------------------------------------------

    def guard(self) -> np.ndarray:
        """Check the served model's invariants ((4,) violation lanes,
        DESIGN.md §11.1); heal on violation (sanitize stats, re-sort the
        arena from the mirrors, refresh router + graph — counted as a
        ``regroup`` repair). Returns the pre-heal lanes."""
        m = self.model
        if m.has_arena:
            from ..ft.invariants import resident_violations
            # windowed models: evicted ids legally own 0 slots (§14)
            owned = (m.w_pts > 0) if getattr(m, "window", 0) else None
            vio = resident_violations(m.state, n=m.capacity,
                                      owned=owned).cpu().numpy()
        else:
            st = m.state
            nonfinite = lambda t: torch.sum(~torch.isfinite(t))  # noqa: E731
            zero = torch.zeros((), dtype=torch.int64, device=st.c.device)
            vio = torch.stack([
                nonfinite(st.c), nonfinite(st.sums) + nonfinite(st.counts)
                + torch.sum(st.counts < 0), zero, zero]).cpu().numpy()
        self.events.append((round(self.now, 9), "guard", vio.tolist()))
        if vio.any():
            self._heal(vio)
        return vio

    def _heal(self, vio: np.ndarray) -> None:
        from ..core.model import (_arena_resort, _build_router,
                                  _graph_with_dists)
        m = self.model
        st = m.state
        sums = torch.where(torch.isfinite(st.sums), st.sums, 0.0)
        counts = torch.where(torch.isfinite(st.counts) & (st.counts >= 0),
                             st.counts, 0.0)
        c = torch.where(torch.isfinite(st.c), st.c, 0.0)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1e-12)[:, None], c)
        st = st._replace(c=c, sums=sums, counts=counts)
        if m.has_arena and vio[3]:
            # quarantine non-finite mirror rows, then full re-sort
            bad = ~torch.isfinite(m.x_pts).all(dim=1)
            n_bad = int(torch.sum(bad))
            if n_bad:
                m.x_pts = torch.where(bad[:, None], 0.0, m.x_pts)
                m.w_pts = torch.where(bad, 0.0, m.w_pts)
                self.counter.count_sanitized_rows(n_bad)
            xg, pid, wg, b2c, fill, openb = _arena_resort(
                m.x_pts, m.a_pts, m.w_pts, k=m.k, bn=m.bn,
                nbt=st.b2c.shape[0])
            st = st._replace(xg=xg, pid=pid, wg=wg, b2c=b2c, fill=fill,
                             openb=openb)
        nb, m.nb_dist = _graph_with_dists(st.c, m.kn)
        st = st._replace(prev_nb=nb)
        m.router = _build_router(st.c, m.route_groups, m.route_cap,
                                 m.router_iters)
        m.state = st
        m._qt = None        # the int8 tables of the old centers are stale
        self.counter.count_repair("regroup")
        self.events.append((round(self.now, 9), "heal", vio.tolist()))

    # -- jit warmup / cache accounting --------------------------------------

    def warmup(self) -> None:
        """Run every (kind, bucket, rung) shape once on zero batches, so
        serving meets no new one (kernel loads, allocator pools): predict
        at all four fidelity rungs (f32 full, int8 scan, int8
        probe-shrink, int8 route-only) and a weight-0 partial_fit per
        bucket (a no-op fold — the model state and the fold schedule are
        restored). Each shape is recorded in ``jit_keys``."""
        if self.model is None:
            return
        m = self.model
        d = m.d
        # the weight-0 folds are a no-op for the member arena, but a
        # decayed/windowed model still ticks its epoch clock and decays
        # its stats per fold — snapshot and restore everything they touch
        seen, folds = m.batches_seen, m.degraded_folds
        st0, router0, nbd0 = m.state, m.router, m.nb_dist
        cm0, dg0, qt0 = m.c_motion, m._dg, m._qt
        dev = self._device()
        for b in self.buckets.rungs:
            qb = torch.zeros((b, d), dtype=torch.float32, device=dev)
            m._predict_batch(qb)
            m._predict_batch(qb, precision="int8")
            m._predict_batch(qb, probes=1, precision="int8")
            m.route_batch(qb, probes=1, precision="int8")
            m.partial_fit(qb, torch.zeros((b,), device=dev),
                          validate="none")
            self.compiled_shapes.add((b, d))
            self.jit_keys.update(("predict", b, r) for r in
                                 (FULL, INT8_SCAN, PROBE_SHRINK, ROUTE_ONLY))
            self.jit_keys.add(("partial_fit", b, FULL))
        m.batches_seen, m.degraded_folds = seen, folds
        m.state, m.router, m.nb_dist = st0, router0, nbd0
        m.c_motion, m._dg, m._qt = cm0, dg0, qt0

    def jit_cache_sizes(self) -> dict[str, int]:
        """The (kind, bucket, rung) shapes run so far, counted per kind —
        the counterpart of the reference's per-function jit cache sizes
        (PyTorch compiles nothing per shape): tests snapshot this after
        :meth:`warmup` and assert serving adds nothing. Bounded by
        ``len(ladder) × 4`` predict and ``len(ladder)`` fold shapes."""
        out: dict[str, int] = {}
        for kind, _, _ in self.jit_keys:
            out[kind] = out.get(kind, 0) + 1
        return out

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        """End-of-run operator stats (the serve bench's summary and the
        launch driver's stats print both read this)."""
        resp = list(self.responses.values())
        by = lambda s: sum(1 for r in resp if r.status == s)  # noqa: E731
        return {
            "admitted": self.queue.admitted,
            "rejected": self.queue.rejected,
            "max_queue_depth": self.queue.max_depth,
            "queue_bound": self.cfg.queue_bound,
            "batches": self.batches,
            "responses_ok": by("ok"),
            "responses_overloaded": by("overloaded"),
            "responses_rejected": by("rejected"),
            "rung": self.ladder.rung,
            "rung_transitions": len(self.ladder.transcript),
            "degrades": dict(self.counter.degrades),
            "compiled_shapes": len(self.compiled_shapes),
            "bucket_ladder": list(self.buckets.rungs),
            # ft / streaming counters (DESIGN.md §11.5, §14): the fold
            # path's degradations and the sliding window's evictions
            "degraded_folds": int(self.counter.degraded_folds),
            "evicted_rows": int(self.counter.evicted_rows),
            "repairs": dict(self.counter.repairs),
            "retries": int(self.counter.retries),
            "sanitized_rows": int(self.counter.sanitized_rows),
            "wall_s": self.wall_s,
        }


def requests_from_trace(trace: list[dict], q_pool: np.ndarray,
                        pf_pool: np.ndarray | None = None,
                        *, default_deadline: float = 0.005) -> list[Request]:
    """Materialize arrival-trace entries (dicts with ``t``, ``kind``,
    ``rows`` and optional ``deadline``/``priority``) into
    :class:`Request` objects, slicing payload rows cyclically out of the
    deterministic pools — rid == arrival order, so a replay of the same
    trace reproduces the same requests bit-for-bit."""
    reqs = []
    offs = {"predict": 0, "partial_fit": 0}
    pools = {"predict": q_pool,
             "partial_fit": q_pool if pf_pool is None else pf_pool}
    order = sorted(range(len(trace)),
                   key=lambda i: (trace[i]["t"], i))
    for rid, i in enumerate(order):
        e = trace[i]
        kind = e.get("kind", "predict")
        rows = int(e.get("rows", 1))
        pool = pools[kind]
        lo = offs[kind] % pool.shape[0]
        idx = (lo + np.arange(rows)) % pool.shape[0]
        offs[kind] += rows
        reqs.append(Request(
            rid=rid, kind=kind, x=np.asarray(pool[idx], np.float32),
            t_arrival=float(e["t"]),
            deadline=float(e["t"]) + float(e.get("deadline",
                                                 default_deadline)),
            priority=int(e.get("priority", 0)), rows=rows, meta=idx))
    return reqs


__all__ = ["ServeConfig", "ServeExecutor", "requests_from_trace",
           "RUNG_NAMES", "FULL", "INT8_SCAN", "PROBE_SHRINK",
           "ROUTE_ONLY", "SHED"]
