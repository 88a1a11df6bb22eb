"""Graceful-degradation ladder with hysteresis (port of
``repro.serve.degrade``, DESIGN.md §12).

The executor trades accuracy for latency under load in
four measured rungs (the paper's bounded assignment is the knob — each
rung cuts the counted distances per query):

``FULL`` (0)
    the predict path: ``route_probes`` closure probes + exact
    kn-neighborhood resolution, all in f32.
``INT8_SCAN`` (1)
    the DESIGN.md §13 quantized scan: every stage reads the int8 tables
    and exactly re-ranks the margin survivors in f32 — assignments stay
    bit-identical to FULL, only the scan traffic (and service time)
    shrinks ~4x. The cheapest rung with zero recall cost, so it is the
    first one the ladder reaches for.
``PROBE_SHRINK`` (2)
    shrink the router to one closure probe (top-p → 1, still within the
    closure cap) and keep the resolution pass — Wang et al.'s closure
    overlap is what keeps the recall loss bounded here. Rides the int8
    scan (a deeper rung is never more expensive than a shallower one).
``ROUTE_ONLY`` (3)
    skip the kn-neighborhood resolution entirely: the routed center IS
    the assignment (int8 route). Recall falls to the router's own hit
    rate (the acceptance gate holds it >= 0.95 at the k=512 shape).
``SHED`` (4)
    load-shed: lowest-priority admitted requests are answered with a
    typed ``Overloaded`` response until the backlog drains below the
    deadline budget again.

Transitions are driven by one measured *pressure* signal — the max of
queue fill fraction and estimated backlog drain time over the deadline
budget — and are hysteretic: the ladder climbs one rung after
``up_patience`` consecutive ticks above the rung's enter threshold and
descends only after ``down_patience`` consecutive ticks below its
(strictly lower) exit threshold, so a noisy arrival stream cannot make
the executor flap. Every transition is appended to ``transcript`` —
the deterministic degradation log the chaos tests replay bit-for-bit.
"""
from __future__ import annotations

import dataclasses


FULL, INT8_SCAN, PROBE_SHRINK, ROUTE_ONLY, SHED = 0, 1, 2, 3, 4
RUNG_NAMES = ("full", "int8_scan", "probe_shrink", "route_only", "shed")


@dataclasses.dataclass(frozen=True)
class DegradeConfig:
    """Enter (``up``) / exit (``down``) pressure thresholds per rung
    transition 0→1, 1→2, 2→3, 3→4; ``down[i] < up[i]`` is the
    hysteresis band."""
    up: tuple = (0.6, 0.85, 1.0, 1.5)
    down: tuple = (0.3, 0.5, 0.6, 1.0)
    up_patience: int = 1
    down_patience: int = 2

    def __post_init__(self):
        if len(self.up) != 4 or len(self.down) != 4:
            raise ValueError("need exactly 4 up/down thresholds "
                             "(one per rung transition)")
        if any(d >= u for u, d in zip(self.up, self.down)):
            raise ValueError(f"hysteresis requires down < up per rung, "
                             f"got up={self.up} down={self.down}")


class DegradeLadder:
    """Hysteretic rung state machine (one instance per executor)."""

    def __init__(self, cfg: DegradeConfig | None = None):
        self.cfg = cfg or DegradeConfig()
        self.rung = FULL
        self.transcript: list[tuple[float, int, int, float]] = []
        self._up_streak = 0
        self._down_streak = 0

    def observe(self, pressure: float, t: float) -> int:
        """Advance the ladder one tick on the measured ``pressure``;
        returns the (possibly new) rung. At most one rung transition per
        tick — the ladder never jumps."""
        cfg = self.cfg
        if self.rung < SHED and pressure >= cfg.up[self.rung]:
            self._up_streak += 1
            self._down_streak = 0
            if self._up_streak >= cfg.up_patience:
                self._move(self.rung + 1, pressure, t)
        elif self.rung > FULL and pressure < cfg.down[self.rung - 1]:
            self._down_streak += 1
            self._up_streak = 0
            if self._down_streak >= cfg.down_patience:
                self._move(self.rung - 1, pressure, t)
        else:
            self._up_streak = 0
            self._down_streak = 0
        return self.rung

    def _move(self, new: int, pressure: float, t: float) -> None:
        self.transcript.append((round(t, 9), self.rung, new,
                                round(pressure, 6)))
        self.rung = new
        self._up_streak = 0
        self._down_streak = 0


__all__ = ["DegradeConfig", "DegradeLadder", "RUNG_NAMES",
           "FULL", "INT8_SCAN", "PROBE_SHRINK", "ROUTE_ONLY", "SHED"]
