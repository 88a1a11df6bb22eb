"""Bounded admission queue + typed request/response envelope (port of
``repro.serve.queue``, DESIGN.md §12).

Admission control is the first line of overload defense:
the queue has a hard depth bound and ``offer`` answers every request
immediately — admitted, or rejected with a *typed reason* (explicit
backpressure the client can act on). Nothing queues unboundedly and
nothing is dropped silently: every request that enters the executor
leaves it as exactly one :class:`Response` (``ok``, ``rejected``, or a
typed :class:`Overloaded` shed).
"""
from __future__ import annotations

import dataclasses


REJECT_QUEUE_FULL = "queue_full"
REJECT_TOO_LARGE = "batch_exceeds_ladder"


@dataclasses.dataclass(frozen=True)
class Request:
    """One admitted unit of work. ``x`` is the payload (query/batch rows
    for the model kinds, an opaque payload for registered ops);
    ``deadline`` is an *absolute* clock value (arrival + budget)."""
    rid: int
    kind: str                   # "predict" | "partial_fit" | registered op
    x: object
    t_arrival: float
    deadline: float
    priority: int = 0           # higher = survives shedding longer
    rows: int = 1
    meta: object = None         # caller bookkeeping (e.g. pool indices)


@dataclasses.dataclass
class Response:
    """The single, typed answer every request gets."""
    rid: int
    kind: str
    status: str                 # "ok" | "rejected" | "overloaded"
    rung: int = 0               # degradation rung the request was served at
    t_arrival: float = 0.0
    t_done: float = 0.0
    result: object = None
    reason: str | None = None

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class Overloaded(Response):
    """Typed load-shed response (the ladder's last rung): the request
    was *admitted* but shed before execution. ``isinstance(r,
    Overloaded)`` is the client-side contract — sheds are never silent
    drops."""
    status: str = "overloaded"


class AdmissionQueue:
    """Bounded FIFO-admission / EDF-service queue.

    ``offer`` never blocks and never grows the queue past ``bound`` —
    it returns a typed reject reason instead (the caller turns it into a
    ``rejected`` :class:`Response`). Service order is earliest-deadline-
    first within a kind (ties broken by rid, so replays are
    bit-deterministic)."""

    def __init__(self, bound: int):
        if bound < 1:
            raise ValueError(f"queue bound must be >= 1, got {bound}")
        self.bound = int(bound)
        self._items: list[Request] = []
        self.admitted = 0
        self.rejected = 0
        self.max_depth = 0

    def depth(self, kind: str | None = None) -> int:
        if kind is None:
            return len(self._items)
        return sum(1 for r in self._items if r.kind == kind)

    def fill_frac(self) -> float:
        return len(self._items) / self.bound

    def backlog_rows(self, kind: str | None = None) -> int:
        return sum(r.rows for r in self._items
                   if kind is None or r.kind == kind)

    def offer(self, req: Request) -> str | None:
        """Admit ``req`` (returns None) or reject it with a typed reason
        (the queue is full). The depth bound is a hard invariant."""
        if len(self._items) >= self.bound:
            self.rejected += 1
            return REJECT_QUEUE_FULL
        self._items.append(req)
        self.admitted += 1
        self.max_depth = max(self.max_depth, len(self._items))
        return None

    def kinds_waiting(self) -> set:
        return {r.kind for r in self._items}

    def pop_batch(self, kind: str, max_rows: int,
                  max_requests: int | None = None) -> list[Request]:
        """EDF batch formation: pop requests of ``kind`` in
        (deadline, rid) order while the batch stays within ``max_rows``
        total rows (always at least one request)."""
        cand = sorted((r for r in self._items if r.kind == kind),
                      key=lambda r: (r.deadline, r.rid))
        batch, rows = [], 0
        for r in cand:
            if batch and rows + r.rows > max_rows:
                break
            if max_requests is not None and len(batch) >= max_requests:
                break
            batch.append(r)
            rows += r.rows
        taken = {r.rid for r in batch}
        self._items = [r for r in self._items if r.rid not in taken]
        return batch

    def shed_rows(self, target_rows: int, kind: str = "predict") \
            -> list[Request]:
        """Shed ``kind`` requests — lowest priority first, latest
        deadline first within a priority — until the kind's queued row
        backlog is within ``target_rows``. Returns the shed requests
        (the executor answers each with a typed :class:`Overloaded`)."""
        backlog = self.backlog_rows(kind)
        if backlog <= target_rows:
            return []
        victims = sorted((r for r in self._items if r.kind == kind),
                         key=lambda r: (r.priority, -r.deadline, -r.rid))
        shed = []
        for r in victims:
            if backlog <= target_rows:
                break
            shed.append(r)
            backlog -= r.rows
        taken = {r.rid for r in shed}
        self._items = [r for r in self._items if r.rid not in taken]
        return shed


__all__ = ["AdmissionQueue", "Request", "Response", "Overloaded",
           "REJECT_QUEUE_FULL", "REJECT_TOO_LARGE"]
