"""Pad-to-bucket batch shapes for the serving executor (port of
``repro.serve.buckets``, DESIGN.md §12).

Every batch the executor hands to the model is padded up to one rung of
a small fixed *bucket ladder*, so the set of batch shapes the device
sees is static: at most ``len(ladder) × rung-modes`` (kind, bucket, rung)
programs, each warmed once at startup, and a request never brings a new
shape at serving time (the executor records the shapes it ran and the
tests hold them inside the ladder).
"""
from __future__ import annotations

import numpy as np


class BucketLadder:
    """A sorted tuple of batch-row bucket sizes (powers of two by
    default). ``bucket_for(m)`` returns the smallest rung that fits
    ``m`` rows; callers never form batches above ``max_rows``."""

    def __init__(self, rungs=(64, 256, 1024)):
        rungs = tuple(sorted({int(r) for r in rungs}))
        if not rungs or rungs[0] < 1:
            raise ValueError(f"bucket ladder must be positive, got {rungs}")
        self.rungs = rungs

    @property
    def max_rows(self) -> int:
        return self.rungs[-1]

    def __len__(self) -> int:
        return len(self.rungs)

    def bucket_for(self, m: int) -> int:
        """Smallest rung >= m (m must not exceed the ladder top — batch
        formation is capped at ``max_rows``)."""
        if m > self.max_rows:
            raise ValueError(f"batch of {m} rows exceeds ladder top "
                             f"{self.max_rows}")
        for r in self.rungs:
            if m <= r:
                return r
        raise AssertionError  # unreachable

    def pad_rows(self, x: np.ndarray, bucket: int) -> np.ndarray:
        """Zero-pad a (m, d) row block up to (bucket, d)."""
        m = x.shape[0]
        if m == bucket:
            return x
        return np.pad(x, ((0, bucket - m), (0, 0)))


__all__ = ["BucketLadder"]
