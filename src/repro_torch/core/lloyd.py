"""The fit result type (port of ``repro.core.lloyd.KMeansResult``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KMeansResult:
    centers: torch.Tensor
    assignment: torch.Tensor
    energy: float
    iterations: int
    ops: float
    # (cumulative_ops, energy) after every iteration
    history: list
    # OpCounter.profile() (plus phase timings), attached by
    # ``api.fit(..., profile=True)``; None otherwise
    profile: dict | None = None
