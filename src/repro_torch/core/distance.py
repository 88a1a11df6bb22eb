"""Squared-Euclidean distance primitives (port of ``repro.core.distance``).

Every distance uses the expansion ``||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2``
clamped at 0, in the reference's evaluation order, so rounding follows
the reference.
"""
from __future__ import annotations

import torch


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared l2 norm: (n, d) -> (n,)."""
    return torch.sum(x * x, dim=-1)


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor,
                    x_sq: torch.Tensor | None = None,
                    c_sq: torch.Tensor | None = None) -> torch.Tensor:
    """All-pairs squared distances: (n, d) x (k, d) -> (n, k)."""
    if x_sq is None:
        x_sq = sqnorm(x)
    if c_sq is None:
        c_sq = sqnorm(c)
    cross = x @ c.T
    return torch.clamp(x_sq[:, None] - 2.0 * cross + c_sq[None, :], min=0.0)


def bottom_k(v: torch.Tensor, n: int) -> torch.Tensor:
    """Column indices of the n smallest entries of each row, (rows, n)
    int32, ties to the lower index: ``lax.top_k(-v, n)`` as a stable
    ascending sort (``torch.topk`` promises no tie order)."""
    order = torch.sort(v, dim=1, stable=True).indices
    return order[:, :n].to(torch.int32).contiguous()


def chunked_argmin_sqdist(x: torch.Tensor, c: torch.Tensor,
                          chunk: int = 4096):
    """Nearest-center assignment in row chunks of ``chunk`` (bounds the
    transient (chunk, k) matrix). Returns (assignment int32, min sqdist)."""
    c_sq = sqnorm(c)
    a, dmin = [], []
    for xb in torch.split(x, chunk):
        dist = pairwise_sqdist(xb, c, c_sq=c_sq)
        m, j = torch.min(dist, dim=1)
        a.append(j.to(torch.int32))
        dmin.append(m)
    return torch.cat(a), torch.cat(dmin)


def clustering_energy(x: torch.Tensor, c: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """Total k-means energy sum_j sum_{x in X_j} ||x - c_j||^2."""
    return torch.sum(sqnorm(x - c[a.long()]))
