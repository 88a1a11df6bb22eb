"""Random init and nearest-center assignment (the subset of
``repro.core.kmeanspp`` the ported fit path needs)."""
from __future__ import annotations

import torch

from .distance import chunked_argmin_sqdist
from .opcount import OpCounter


def random_init(x: torch.Tensor, k: int,
                generator: torch.Generator) -> torch.Tensor:
    """Uniform sample of k distinct points (no distance computations)."""
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=x.device)[:k]
    return x[idx]


def assign_nearest(x: torch.Tensor, centers: torch.Tensor,
                   counter: OpCounter | None = None) -> torch.Tensor:
    """Nearest center per point, (n,) int32; charges n*k distances."""
    a, _ = chunked_argmin_sqdist(x, centers)
    if counter is not None:
        counter.add_distances(x.shape[0] * centers.shape[0])
    return a
