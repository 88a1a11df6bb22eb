"""Deterministic fault injection for the self-healing execution layer
(port of ``repro.ft.chaos``, DESIGN.md §11). A :class:`FaultInjector`
carries a *seeded schedule* of faults keyed by fit-iteration (or, for
the serving paths, by call index) and is installed as a context
manager::

    with FaultInjector(seed=0, nan_rows={3: 32}, drop_host={8: 1}):
        fit(x, k, ...)                    # the loops pick it up

The fit/serve loops poll :func:`active` at their hook points — nothing
in the hot device step ever branches on the injector; faults and their
repairs both happen at host boundaries (the monitor-flush cadence), so
chaos costs nothing when no injector is installed.

Fault taxonomy (one knob per failure mode the guards must survive):

``nan_rows`` / ``inf_rows``
    {iteration: count} — overwrite that many input rows with NaN/Inf
    (a poisoned ingest batch). Healed by quarantine: the rows drop to
    weight 0 (``OpCounter.sanitized_rows``).
``dup_rows``
    {iteration: count} — overwrite rows with copies of one row
    (adversarial duplicates: mass ties, degenerate clusters). Not an
    invariant violation — the algorithm must simply survive it.
``poison_centers``
    {iteration: count} — NaN that many center rows (a torn collective /
    bad reduction). Healed by quarantine + one GDI Lemma-1 split of the
    highest-energy donor cluster per lost center.
``poison_bounds``
    {iteration: count} — NaN that many Hamerly bound lanes. Healed by
    the bound reset to the safe loose state (stale-zero + ``first``).
``poison_slots``
    {iteration: count} — duplicate that many arena ``pid`` entries
    (slot-ownership corruption). Healed by assignment recovery + full
    ``resident_regroup``.
``exhaust_pool``
    iterable of iterations — mark every free arena block as owned, so
    the next sparse repair finds ``n_free == 0`` and the engine's own
    re-sort fallback must kick in (observable as ``OpCounter.resorts``).
``stall``
    {iteration: seconds} — host-side sleep before the step (straggler
    simulation; feeds ``ft.StragglerPolicy``).
``drop_host``
    {iteration: device_index} — simulate losing one device of the debug
    mesh: the driver checkpoints, replans the mesh over the survivors
    (``ft.plan_remesh``) and resumes (``core.distributed``; the
    single-device fit never polls it).
``preempt_at``
    iteration — raise :class:`Preemption` *before* that iteration runs
    (SIGTERM with no grace); a later ``resume=True`` fit picks the run
    back up from the last atomic checkpoint.
``fail_calls``
    {op_name: iterable of call indices} — raise
    :class:`TransientError` on the i-th call to ``maybe_fail(op_name)``
    (flaky RPC / transient device error); absorbed by
    ``ft.retry_transient`` backoff.
``nan_batches``
    {batch_index: count} — per-call input corruption for the streaming
    paths (``KMeansModel.partial_fit``), counted by ``corrupt_batch``
    calls rather than fit iterations.

Stream-shaped faults for the drift-robust streaming path (DESIGN.md
§14 — keyed by ``corrupt_batch`` call index, like ``nan_batches``):

``drift_burst``
    {batch_index: magnitude} — shift every row of that batch by a
    seeded random unit direction × magnitude (a sudden mean shift
    mid-stream). Not an invariant violation: the windowed/decayed
    statistics must *track* it and the drift guard must repair any
    centers the burst strands.
``dup_flood``
    {batch_index: count} — overwrite that many rows with copies of one
    seeded row of the batch (repeated identical batches skewing the
    per-center counts).
``epoch_skew``
    {batch_index: lag} — deliver the batch that arrived ``lag`` calls
    ago instead of this one (out-of-order epoch delivery): the stale
    rows are stamped with the *current* epoch, exactly what a late
    network delivery does to a window.
``exhaust_arena``
    iterable of batch indices — the streaming twin of ``exhaust_pool``:
    mark every free arena block owned right before that batch's append,
    forcing ``partial_fit``'s full re-sort fallback.

Traffic-shaped faults for the serving executor (DESIGN.md §12 — these
key on *request ids* and *executed-batch indices*, the serving plane's
natural coordinates, and all stay deterministic under the same seed):

``poison_queries``
    {request_rid: count} — NaN that many rows of the predict request
    with that rid (a poisoned query batch). The executor quarantines
    them at batch assembly (``OpCounter.sanitized_rows``).
``slow_consumer``
    {batch_index: seconds} — inflate the *virtual* service time of that
    executed batch (a slow downstream consumer / device hiccup): the
    queue backs up, the degradation ladder reacts, then recovers. No
    host sleep — replays stay bit-deterministic.

:func:`poisson_trace` generates the seeded arrival processes the chaos
scenarios ride on: Poisson arrivals with burst windows multiplying the
rate, optionally interleaving ``partial_fit`` folds into the stream
(fold-during-burst).

All row/slot/center choices are drawn on the host from ``numpy``
generators seeded by (seed, kind, iteration) — the same schedule replays
bit-identically, and this port and the reference corrupt the same rows
and record the same ``events`` — which is what makes the recovery tests
deterministic. The corruptions are written into copies of the device
tensors (``index_put_``); the caller's tensors are never changed.
"""
from __future__ import annotations

import time
from typing import Iterable, Mapping

import numpy as np
import torch


def _ids(idx, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def _set_rows(t: torch.Tensor, idx, value) -> torch.Tensor:
    """A copy of ``t`` with the rows ``idx`` set to ``value``."""
    t = t.clone()
    t[_ids(idx, t)] = value
    return t


class TransientError(RuntimeError):
    """A failure that is expected to succeed on retry (flaky RPC,
    transient device error). ``ft.retry_transient`` absorbs these with
    exponential backoff; anything else propagates."""


class Preemption(RuntimeError):
    """Simulated hard preemption (no grace period): the loop dies where
    it stands and a restart must resume from the last atomic
    checkpoint."""


_ACTIVE: "FaultInjector | None" = None


def active() -> "FaultInjector | None":
    """The installed injector, or None outside any chaos context."""
    return _ACTIVE


# kind tags folded into the per-event RNG seed
_TAGS = {"nan": 1, "inf": 2, "dup": 3, "centers": 4, "bounds": 5,
         "slots": 6, "batch": 7, "query": 8, "trace": 9, "burst": 10,
         "flood": 11, "skew": 12}


def _norm(sched: Mapping[int, int] | None) -> dict[int, int]:
    return {int(k): int(v) for k, v in (sched or {}).items()}


class FaultInjector:
    """Seeded, scheduled fault injector (see module docstring).

    Context manager: installs itself as the process-wide active
    injector; the fit/serve loops poll :func:`active`. Injectors do not
    nest. ``events`` records every fault actually fired as
    ``(where, kind, detail)`` tuples for assertions and bench reports.
    """

    def __init__(self, seed: int = 0, *,
                 nan_rows: Mapping[int, int] | None = None,
                 inf_rows: Mapping[int, int] | None = None,
                 dup_rows: Mapping[int, int] | None = None,
                 poison_centers: Mapping[int, int] | None = None,
                 poison_bounds: Mapping[int, int] | None = None,
                 poison_slots: Mapping[int, int] | None = None,
                 exhaust_pool: Iterable[int] = (),
                 stall: Mapping[int, float] | None = None,
                 drop_host: Mapping[int, int] | None = None,
                 preempt_at: int | None = None,
                 fail_calls: Mapping[str, Iterable[int]] | None = None,
                 nan_batches: Mapping[int, int] | None = None,
                 poison_queries: Mapping[int, int] | None = None,
                 slow_consumer: Mapping[int, float] | None = None,
                 drift_burst: Mapping[int, float] | None = None,
                 dup_flood: Mapping[int, int] | None = None,
                 epoch_skew: Mapping[int, int] | None = None,
                 exhaust_arena: Iterable[int] = ()):
        self.seed = int(seed)
        self.nan_rows = _norm(nan_rows)
        self.inf_rows = _norm(inf_rows)
        self.dup_rows = _norm(dup_rows)
        self.poison_centers = _norm(poison_centers)
        self.poison_bounds = _norm(poison_bounds)
        self.poison_slots = _norm(poison_slots)
        self.exhaust_pool = {int(i) for i in exhaust_pool}
        self.stall = {int(k): float(v) for k, v in (stall or {}).items()}
        self.drop_host = _norm(drop_host)
        self.preempt_at = preempt_at
        self.fail_calls = {str(op): {int(i) for i in idxs}
                           for op, idxs in (fail_calls or {}).items()}
        self.nan_batches = _norm(nan_batches)
        self.poison_queries = _norm(poison_queries)
        self.slow_consumer = {int(k): float(v)
                              for k, v in (slow_consumer or {}).items()}
        self.drift_burst = {int(k): float(v)
                            for k, v in (drift_burst or {}).items()}
        self.dup_flood = _norm(dup_flood)
        self.epoch_skew = _norm(epoch_skew)
        self.exhaust_arena = {int(i) for i in exhaust_arena}
        self.events: list[tuple[int, str, int | float]] = []
        self._calls: dict[str, int] = {}
        self._batches = 0
        self._last_rows: list[int] = []
        self._recent_batches: list = []

    # -- context manager ---------------------------------------------------

    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultInjector is already active; "
                               "injectors do not nest")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None

    def _rng(self, kind: str, where: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, _TAGS[kind], where])

    # -- input corruption --------------------------------------------------

    def corrupt_inputs(self, it: int, x, w):
        """Apply this iteration's input faults to point-order (x, w).

        Only live rows (w > 0) are corrupted — poisoning a padding row
        would be invisible by construction. Returns (x, w) (w is
        returned unchanged; quarantine is the *healer's* job)."""
        todo = [(kind, sched[it]) for kind, sched in
                (("nan", self.nan_rows), ("inf", self.inf_rows),
                 ("dup", self.dup_rows)) if it in sched]
        self._last_rows = []
        if not todo:
            return x, w
        live = np.flatnonzero((w > 0).cpu().numpy())
        for kind, count in todo:
            count = min(count, live.size)
            if count == 0:
                continue
            rng = self._rng(kind, it)
            idx = rng.choice(live, size=count, replace=False)
            if kind == "nan":
                x = _set_rows(x, idx, float("nan"))
            elif kind == "inf":
                x = _set_rows(x, idx, float("inf"))
            else:                                        # adversarial dups
                src = int(rng.choice(live))
                x = _set_rows(x, idx, x[src])
            self._last_rows.extend(int(i) for i in idx)
            self.events.append((it, kind, count))
        return x, w

    def mirror_into_arena(self, state, x, nsh: int = 1,
                          shard: int | None = None):
        """Propagate the rows just corrupted by :meth:`corrupt_inputs`
        into the resident arena's grouped copy ``xg``.

        The resident engine reads ``xg``, not ``x`` — point-order rows
        are only re-read at re-sorts — so a mid-fit row fault that never
        touched the arena would be invisible for up to ``regroup_every``
        iterations. Physically the poisoned ingest lands in both copies
        at once; the mirror models that. ``pid`` entries are *local*
        shard indices, so under a mesh the global row ids are mapped
        through the (shard, local) layout (``nsh`` shards). ``state`` is
        the concatenation of every shard's arena, or with ``shard`` given
        that one shard's arena alone (one rank of ``core.distributed``);
        ``x`` is the global rows either way, on the host or the card."""
        rows = getattr(self, "_last_rows", [])
        if not rows or not hasattr(state, "xg"):
            return state
        pid = state.pid.cpu().numpy()
        n = x.shape[0]
        s_loc = pid.shape[0] if shard is not None else pid.shape[0] // nsh
        n_loc = n // nsh
        slots, gids = [], []
        for s in (range(nsh) if shard is None else (shard,)):
            at = 0 if shard is not None else s * s_loc
            pidl = pid[at:at + s_loc]
            local = np.asarray([r - s * n_loc for r in rows
                                if s * n_loc <= r < (s + 1) * n_loc])
            if local.size == 0:
                continue
            sl = np.flatnonzero(np.isin(pidl, local))
            slots.extend((sl + at).tolist())
            gids.extend((pidl[sl] + s * n_loc).tolist())
        if not slots:
            return state
        rows_x = x[_ids(gids, x)].to(state.xg.device)
        xg = _set_rows(state.xg, slots, rows_x)
        return state._replace(xg=xg)

    def corrupt_batch(self, xb):
        """Per-call streaming-batch corruption, keyed by the
        corrupt_batch call index (starting at 0): out-of-order delivery
        (``epoch_skew``), sudden mean shift (``drift_burst``), identical
        -row floods (``dup_flood``) and NaN poisoning (``nan_batches``),
        in that order — a skewed batch can still be burst/poisoned, like
        a real late delivery riding a drifted stream."""
        b = self._batches
        self._batches += 1
        orig = xb
        lag = self.epoch_skew.get(b, 0)
        if lag and self._recent_batches:
            old = self._recent_batches[max(len(self._recent_batches)
                                           - lag, 0)]
            if old.shape == xb.shape:
                xb = old
                self.events.append((b, "epoch_skew", int(lag)))
        mag = self.drift_burst.get(b, 0.0)
        if mag:
            rng = self._rng("burst", b)
            direction = rng.standard_normal(xb.shape[1])
            direction /= max(float(np.linalg.norm(direction)), 1e-9)
            xb = xb + torch.as_tensor((mag * direction).astype(np.float32),
                                      device=xb.device)
            self.events.append((b, "drift_burst", float(mag)))
        cnt = self.dup_flood.get(b, 0)
        if cnt:
            rng = self._rng("flood", b)
            src = int(rng.integers(xb.shape[0]))
            idx = rng.choice(xb.shape[0], size=min(cnt, xb.shape[0]),
                             replace=False)
            xb = _set_rows(xb, idx, xb[src])
            self.events.append((b, "dup_flood", int(cnt)))
        count = self.nan_batches.get(b, 0)
        if count:
            rng = self._rng("batch", b)
            idx = rng.choice(xb.shape[0], size=min(count, xb.shape[0]),
                             replace=False)
            xb = _set_rows(xb, idx, float("nan"))
            self.events.append((b, "nan_batch", int(count)))
        # epoch_skew replays *as-delivered* batches (pre-corruption)
        self._recent_batches.append(orig)
        del self._recent_batches[:-16]
        return xb

    def corrupt_arena(self, state):
        """Streaming-path free-pool exhaustion (``exhaust_arena``, keyed
        by the batch index of the last :meth:`corrupt_batch` call): mark
        every free arena block owned so this batch's sparse append finds
        ``n_free == 0`` and ``partial_fit`` must take its full re-sort
        fallback. Invariant-clean, like ``exhaust_pool``."""
        b = self._batches - 1
        if b in self.exhaust_arena and state.b2c.shape[0]:
            n_free = int(torch.sum(state.b2c < 0))
            state = state._replace(b2c=torch.clamp(state.b2c, min=0))
            self.events.append((b, "exhaust_arena", n_free))
        return state

    def corrupt_queries(self, rid: int, x: "np.ndarray") -> "np.ndarray":
        """Serving-plane poisoned query batch: NaN ``poison_queries[rid]``
        rows of the predict request with id ``rid``. Operates on (and
        returns a copy of) a host array — the request's own payload is
        never mutated, so a replay of the same trace sees the same
        faults."""
        count = self.poison_queries.get(int(rid), 0)
        if not count:
            return x
        rng = self._rng("query", int(rid))
        x = np.array(x, copy=True)
        idx = rng.choice(x.shape[0], size=min(count, x.shape[0]),
                         replace=False)
        x[idx] = np.nan
        self.events.append((int(rid), "poison_queries", int(count)))
        return x

    def consume_stall(self, batch_index: int) -> float:
        """Virtual slow-consumer stall (seconds) scheduled for this
        executed serving batch — the executor adds it to the batch's
        modeled service time; no host sleep happens."""
        secs = self.slow_consumer.get(int(batch_index), 0.0)
        if secs > 0:
            self.events.append((int(batch_index), "slow_consumer", secs))
        return secs

    # -- state corruption --------------------------------------------------

    def corrupt_state(self, it: int, state, resident: bool, mesh=None):
        """Apply this iteration's state faults to a K2State /
        ResidentState (returns the possibly-modified state). With
        ``mesh``, ``state`` is this rank's shard (``core.distributed``):
        a per-row leaf a fault touches is gathered to the concatenation
        of every shard's, corrupted as on one device (every rank draws
        alike), and this shard's rows of it kept."""
        def whole(t):
            return t if mesh is None else mesh.gather_rows(t)

        def mine(t):
            if mesh is None:
                return t
            from ..launch.sharding import shard_rows
            return shard_rows(t, mesh).contiguous()

        k = state.c.shape[0]
        if it in self.poison_centers:
            rng = self._rng("centers", it)
            cnt = min(self.poison_centers[it], k)
            ids = rng.choice(k, size=cnt, replace=False)
            state = state._replace(c=_set_rows(state.c, ids, float("nan")))
            self.events.append((it, "poison_centers", cnt))
        if it in self.poison_bounds:
            rng = self._rng("bounds", it)
            u = whole(state.ug if resident else state.u)
            cnt = min(self.poison_bounds[it], u.shape[0])
            ids = rng.choice(u.shape[0], size=cnt, replace=False)
            u = mine(_set_rows(u, ids, float("nan")))
            state = state._replace(**{"ug" if resident else "u": u})
            self.events.append((it, "poison_bounds", cnt))
        if resident and it in self.poison_slots:
            rng = self._rng("slots", it)
            pid = whole(state.pid).cpu().numpy().copy()
            owned = np.flatnonzero(pid >= 0)
            cnt = min(self.poison_slots[it], owned.size // 2)
            if cnt:
                victims = rng.choice(owned, size=2 * cnt, replace=False)
                # duplicate ownership: slot i claims slot j's point
                pid[victims[:cnt]] = pid[victims[cnt:2 * cnt]]
                state = state._replace(pid=mine(torch.from_numpy(pid).to(
                    state.pid.device)))
                self.events.append((it, "poison_slots", cnt))
        if resident and it in self.exhaust_pool:
            b2c = state.b2c
            n_free = int(torch.sum(whole(b2c) < 0))
            state = state._replace(b2c=torch.clamp(b2c, min=0))
            self.events.append((it, "exhaust_pool", n_free))
        return state

    # -- scheduling faults -------------------------------------------------

    def maybe_stall(self, it: int) -> float:
        """Sleep out this iteration's scheduled straggler stall; returns
        the seconds slept (0.0 when none)."""
        secs = self.stall.get(it, 0.0)
        if secs > 0:
            self.events.append((it, "stall", secs))
            time.sleep(secs)
        return secs

    def host_drop_at(self, it: int) -> int | None:
        """Device index to lose at this iteration (None = no drop).
        One-shot: the drop is consumed so the survivor loop does not
        re-lose the same host every iteration."""
        idx = self.drop_host.pop(it, None)
        if idx is not None:
            self.events.append((it, "drop_host", idx))
        return idx

    def check_preempt(self, it: int) -> None:
        """Raise :class:`Preemption` when this iteration is the
        scheduled kill point (one-shot)."""
        if self.preempt_at is not None and it == self.preempt_at:
            self.preempt_at = None
            self.events.append((it, "preempt", it))
            raise Preemption(f"simulated preemption before iteration {it}")

    def maybe_fail(self, op: str) -> None:
        """Raise :class:`TransientError` when this call index of ``op``
        is scheduled to fail (per-op call counter starts at 0)."""
        i = self._calls.get(op, 0)
        self._calls[op] = i + 1
        if i in self.fail_calls.get(op, ()):
            self.events.append((i, f"transient:{op}", i))
            raise TransientError(f"injected transient failure: {op} "
                                 f"call {i}")


def poisson_trace(seed: int, *, rate: float, horizon: float,
                  rows: int = 32, deadline: float = 0.005,
                  bursts: Iterable[tuple] = (), pf_every: int = 0,
                  pf_rows: int = 64, pf_deadline: float = 0.05,
                  priority_levels: int = 1) -> list[dict]:
    """Seeded Poisson arrival trace for the serving executor.

    Requests of ``rows`` queries arrive at ``rate`` requests/s over
    ``horizon`` seconds; each ``bursts`` window ``(t0, t1, factor)``
    multiplies the instantaneous rate (a traffic burst). When
    ``pf_every`` > 0 every pf_every-th arrival is a ``partial_fit``
    fold riding the same queue at priority -1 (so fold-during-burst is
    one trace away). ``priority_levels`` > 1 cycles predict priorities
    0..levels-1 so shedding has an ordering to respect. Same seed =>
    the same trace, entry for entry."""
    rng = np.random.default_rng([int(seed), _TAGS["trace"]])
    bursts = [(float(a), float(b), float(f)) for a, b, f in bursts]
    out: list[dict] = []
    t, i = 0.0, 0
    while True:
        f = 1.0
        for a, b, fac in bursts:
            if a <= t < b:
                f *= fac
        t += float(rng.exponential(1.0 / (rate * f)))
        if t >= horizon:
            return out
        if pf_every and (i + 1) % pf_every == 0:
            out.append({"t": t, "kind": "partial_fit", "rows": pf_rows,
                        "deadline": pf_deadline, "priority": -1})
        else:
            out.append({"t": t, "kind": "predict", "rows": rows,
                        "deadline": deadline,
                        "priority": i % max(priority_levels, 1)})
        i += 1


def apply_fit_faults(inj: FaultInjector, it: int, x, w, state,
                     resident: bool, nsh: int = 1):
    """One-call driver hook: preemption check, straggler stall, input and
    state corruption for fit iteration ``it``. Returns (x, w, state)."""
    inj.check_preempt(it)
    inj.maybe_stall(it)
    x, w = inj.corrupt_inputs(it, x, w)
    if resident:
        state = inj.mirror_into_arena(state, x, nsh)
    state = inj.corrupt_state(it, state, resident)
    return x, w, state


__all__ = ["FaultInjector", "TransientError", "Preemption", "active",
           "apply_fit_faults", "poisson_trace"]
