"""Vector-operation accounting following the paper's methodology.

A copy of the reference's counter (``repro.core.opcount``), cut to the
lanes the ported fit, predict, ``partial_fit`` and serving paths
charge: the paper's vector-op metric (distances, inner products,
additions, sorts as ``m log2 m / d`` equivalents), the int8 scan lane,
the memory-traffic lanes, the robustness lanes (the repair rungs,
arena-full folds, retries, quarantined and evicted rows) and the serving
plane's degradation rungs.
Charges are pure Python on host integers, so the port and the reference
compare exactly equal on the same trajectory.
"""
from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class OpCounter:
    """Host-side accumulator of the paper's vector-op metric."""
    distances: float = 0.0
    inner_products: float = 0.0
    additions: float = 0.0
    sort_equivalents: float = 0.0
    # quantized-scan lane (DESIGN.md §13): int8 approximate distances,
    # kept off ``total`` (an int8 scan op is neither free nor an f32
    # distance)
    int8_ops: float = 0.0
    # memory-traffic lane (bytes): layout gathers/scatters and sort passes
    bytes_gathered: float = 0.0
    bytes_scattered: float = 0.0
    bytes_sorted: float = 0.0
    # table bytes the scans read (4d per f32 row, d + 4 per int8 row)
    bytes_scanned: float = 0.0
    rows_moved: float = 0.0
    resorts: float = 0.0
    # robustness lane (DESIGN.md §11): one counter per rung of the repair
    # lattice, arena-full folds taken stats-only, quarantined rows
    repairs: dict = dataclasses.field(
        default_factory=lambda: {"bound_reset": 0, "regroup": 0,
                                 "split": 0, "restore": 0})
    degraded_folds: float = 0.0
    retries: float = 0.0
    sanitized_rows: float = 0.0
    # streaming lane (DESIGN.md §14): rows retired by the sliding window
    # (their subtraction deltas charge ``additions``)
    evicted_rows: float = 0.0
    # serving-plane degradation lane (DESIGN.md §12): requests served on
    # each rung of the executor's ladder, and load-shed requests
    degrades: dict = dataclasses.field(
        default_factory=lambda: {"int8_scan": 0, "probe_shrink": 0,
                                 "route_only": 0, "shed": 0})
    wall_t0: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def total(self) -> float:
        return (self.distances + self.inner_products + self.additions
                + self.sort_equivalents)

    @property
    def bytes_moved(self) -> float:
        """Total layout memory traffic (gather + scatter + sort bytes)."""
        return self.bytes_gathered + self.bytes_scattered + self.bytes_sorted

    @property
    def wall(self) -> float:
        return time.perf_counter() - self.wall_t0

    @staticmethod
    def _integral(n, kind: str) -> float:
        """Whole-op charges must be integral (sort equivalents are the one
        fractional lane)."""
        v = float(n)
        if v != int(v):
            raise ValueError(f"{kind} charge must be an integer op count, "
                             f"got {n!r}")
        return v

    def add_distances(self, n: float) -> None:
        self.distances += self._integral(n, "distances")

    def add_inner(self, n: float) -> None:
        self.inner_products += self._integral(n, "inner_products")

    def add_additions(self, n: float) -> None:
        self.additions += self._integral(n, "additions")

    def add_int8_ops(self, n: float) -> None:
        """Charge ``n`` int8 approximate-distance ops (off ``total``)."""
        self.int8_ops += self._integral(n, "int8_ops")

    def add_scan_bytes(self, b: float) -> None:
        self.bytes_scanned += float(b)

    def add_sort(self, m: float, d: int) -> None:
        """Charge an m-element sort as m*log2(m)/d vector ops (paper §2.2)."""
        if m > 1:
            self.sort_equivalents += m * math.log2(m) / max(d, 1)

    def add_gather_bytes(self, b: float) -> None:
        self.bytes_gathered += float(b)

    def add_scatter_bytes(self, b: float) -> None:
        self.bytes_scattered += float(b)

    def add_sort_bytes(self, b: float) -> None:
        self.bytes_sorted += float(b)

    @property
    def total_repairs(self) -> int:
        return int(sum(self.repairs.values()))

    def count_repair(self, kind: str, n: int = 1) -> None:
        """Record ``n`` repairs of one lattice rung (``bound_reset`` |
        ``regroup`` | ``split`` | ``restore``)."""
        if kind not in self.repairs:
            raise ValueError(f"unknown repair kind {kind!r}; expected one "
                             f"of {sorted(self.repairs)}")
        self.repairs[kind] += int(n)

    def count_degraded_fold(self, n: int = 1) -> None:
        self.degraded_folds += int(n)

    @property
    def total_degrades(self) -> int:
        return int(sum(self.degrades.values()))

    def count_degrade(self, kind: str, n: int = 1) -> None:
        """Record ``n`` requests served on one degradation rung
        (``int8_scan`` | ``probe_shrink`` | ``route_only`` | ``shed``)."""
        if kind not in self.degrades:
            raise ValueError(f"unknown degrade kind {kind!r}; expected one "
                             f"of {sorted(self.degrades)}")
        self.degrades[kind] += int(n)

    def count_retry(self, n: int = 1) -> None:
        self.retries += int(n)

    def count_sanitized_rows(self, n: int) -> None:
        self.sanitized_rows += int(n)

    def count_evicted_rows(self, n: int) -> None:
        self.evicted_rows += int(n)

    def snapshot(self) -> float:
        return self.total

    def profile(self) -> dict:
        """Machine-readable counter state for ``fit(..., profile=True)``."""
        return {
            "distances": self.distances,
            "inner_products": self.inner_products,
            "additions": self.additions,
            "sort_equivalents": self.sort_equivalents,
            "total_ops": self.total,
            "int8_ops": self.int8_ops,
            "bytes_gathered": self.bytes_gathered,
            "bytes_scattered": self.bytes_scattered,
            "bytes_sorted": self.bytes_sorted,
            "bytes_moved": self.bytes_moved,
            "bytes_scanned": self.bytes_scanned,
            "rows_moved": self.rows_moved,
            "resorts": self.resorts,
            "repairs": dict(self.repairs),
            "total_repairs": self.total_repairs,
            "degraded_folds": self.degraded_folds,
            "degrades": dict(self.degrades),
            "total_degrades": self.total_degrades,
            "retries": self.retries,
            "sanitized_rows": self.sanitized_rows,
            "evicted_rows": self.evicted_rows,
            "wall_s": self.wall,
        }


# state lanes that ride along with a moved row besides its d features:
# (u, lo, w) — the point id travels inside the sort/scatter key charge
LAYOUT_STATE_LANES = 3


def charge_iteration(counter: OpCounter, *, n: int, d: int, k: int, kn: int,
                     stats, resident: bool = False,
                     precision: str = "f32") -> float:
    """Charge one k²-means iteration from its host-read ``StepStats``
    values ``(n_need, changed, energy, moved, resorted[, reranked])``.

    Paper ops: the k²-NN graph build, k_n candidate distances per
    recomputed point, k movement norms, and the mean update's additions
    (``n`` for a full re-reduction, ``2*moved`` for the resident engine's
    incremental delta). Memory traffic: ``moved`` rows × (d + state lanes)
    gathered and scattered, plus m·log2(m) key passes over them. Under
    ``precision="int8"`` the k_n candidate scan charges int8 ops instead
    of f32 distances (only the ``reranked`` survivors cost f32
    distances), the scan reads d + 4 bytes a candidate plus 4d a
    re-ranked one, and a moved arena row carries d int8 bytes and one f32
    scale lane beside its state lanes. Returns the iteration's
    post-update energy.
    """
    n_need, changed, energy, moved, resorted = (float(s) for s in stats[:5])
    reranked = float(stats[5]) if len(stats) > 5 else 0.0
    if precision == "int8":
        counter.add_distances(k * k + k + reranked)
        counter.add_int8_ops(n_need * kn)
        counter.add_scan_bytes(n_need * kn * (d + 4) + reranked * 4 * d)
        row_bytes = d + (LAYOUT_STATE_LANES + 1) * 4
    else:
        counter.add_distances(k * k + n_need * kn + k)
        counter.add_scan_bytes(n_need * kn * 4 * d)
        row_bytes = (d + LAYOUT_STATE_LANES) * 4
    full_update = (not resident) or resorted > 0
    counter.add_additions(n if full_update else 2.0 * moved)
    counter.rows_moved += moved
    counter.resorts += resorted
    if moved > 0:
        counter.add_gather_bytes(moved * row_bytes)
        counter.add_scatter_bytes(moved * row_bytes)
        counter.add_sort_bytes(moved * 8
                               * max(1.0, math.log2(max(moved, 2.0))))
    return energy
