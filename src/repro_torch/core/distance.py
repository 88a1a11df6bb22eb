"""Squared-Euclidean helpers (port of part of ``repro.core.distance``):
row norms, the stable bottom-k selection and the clustering energy.

The (point, center) distances themselves, ``||x||^2 - 2 x.c + ||c||^2``
clamped at 0 from norms and products rounded once from f64, are
``kernels.ref.exact_sqdist`` and the kernels that match it.
"""
from __future__ import annotations

import torch


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared l2 norm: (n, d) -> (n,)."""
    return torch.sum(x * x, dim=-1)


def bottom_k(v: torch.Tensor, n: int) -> torch.Tensor:
    """Column indices of the n smallest entries of each row, (rows, n)
    int32, ties to the lower index: ``lax.top_k(-v, n)`` as a stable
    ascending sort (``torch.topk`` promises no tie order)."""
    order = torch.sort(v, dim=1, stable=True).indices
    return order[:, :n].to(torch.int32).contiguous()


def clustering_energy(x: torch.Tensor, c: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """Total k-means energy sum_j sum_{x in X_j} ||x - c_j||^2."""
    return torch.sum(sqnorm(x - c[a.long()]))
