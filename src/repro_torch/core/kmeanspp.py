"""k-means++ seeding (Arthur & Vassilvitskii 2007), the paper's init
baseline, plus random init and nearest-center assignment (port of
``repro.core.kmeanspp``).

k-means++ is O(nkd): each of the k draws computes n distances to the
newly added center. Draws are taken on the device by inverse CDF from an
explicit ``torch.Generator`` (what ``jax.random.choice(p=...)`` does), so
the draw loop makes no host read.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.exact_round import exact_rowdot, exact_sqnorm
from .opcount import OpCounter


def _draw(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One index in [0, n) drawn with probability proportional to the
    weights ``w`` (n,) >= 0, as a (1,) int64 tensor on w's device: the
    first i whose cumulative weight reaches ``total * (1 - u)``, u
    uniform in [0, 1), so a zero-weight index is never drawn."""
    cdf = torch.cumsum(w.double(), 0)
    u = torch.rand((1,), generator=generator, dtype=torch.float64,
                   device=w.device)
    return torch.searchsorted(cdf, cdf[-1:] * (1.0 - u))


def _ppp_update(x, x_sq, dmin, new_center, zeros):
    """Each point's squared distance to its nearest chosen center, after
    adding ``new_center`` (d,): norms and products correctly rounded, as
    every distance of the port; the products are one ``exact_rowdot``
    against the new center (``zeros``: (n,) row ids, all 0)."""
    c = new_center[None]
    d_new = torch.clamp(x_sq - 2.0 * exact_rowdot(x, c, zeros)
                        + exact_sqnorm(c)[0], min=0.0)
    return torch.minimum(dmin, d_new)


def kmeanspp_init(x: torch.Tensor, k: int, generator: torch.Generator,
                  counter: OpCounter | None = None) -> torch.Tensor:
    """Sample k centers with D^2 weighting from ``x``'s rows on x's
    device. Returns (k, d) centers; charges n distances per center."""
    counter = counter or OpCounter()
    n, d = x.shape
    x_sq = exact_sqnorm(x)
    zeros = torch.zeros((n,), dtype=torch.int64, device=x.device)
    centers = torch.empty((k, d), dtype=x.dtype, device=x.device)
    dmin = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
    idx = _draw(torch.ones((n,), device=x.device), generator)   # uniform
    for j in range(k):
        if j:
            idx = _draw(dmin, generator)
        centers[j] = x.index_select(0, idx)[0]
        dmin = _ppp_update(x, x_sq, dmin, centers[j], zeros)
        counter.add_distances(n)
    return centers


def random_init(x: torch.Tensor, k: int,
                generator: torch.Generator) -> torch.Tensor:
    """Uniform sample of k distinct points (no distance computations)."""
    idx = torch.randperm(x.shape[0], generator=generator,
                         device=x.device)[:k]
    return x[idx]


def assign_nearest(x: torch.Tensor, centers: torch.Tensor,
                   counter: OpCounter | None = None) -> torch.Tensor:
    """Nearest center per point through K5, (n,) int32; charges n*k
    distances."""
    a, _ = ops.assign_nearest_kernel(x, centers)
    if counter is not None:
        counter.add_distances(x.shape[0] * centers.shape[0])
    return a
