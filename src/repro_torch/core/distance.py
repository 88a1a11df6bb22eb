"""Squared-Euclidean helpers (port of ``repro.core.distance``): row
norms, the stable bottom-k selection, the clustering energy, and the
distance helpers of the ungrouped ``xla`` backend, MiniBatch and AKM.

Every (point, center) value is ``max((|x|^2 - 2 x.c) + |c|^2, 0)`` in
f32 from correctly rounded norms and products
(``kernels.exact_round``), the value the port's kernels give the pair
(``quant.sqdist_exact``): the card's assignments are the CPU's.
:func:`chunked_argmin_sqdist` is K5. The candidate helpers form one
product per (row, candidate) pair over a chunk's flattened pairs
(``exact_round.candidate_sqdist``), never the dense (m, k) product;
ties go to the first candidate in list order, as the reference's
``argmin`` and ``lax.top_k`` break them, and ``-1`` padding reads
PAD_SQDIST.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.exact_round import candidate_sqdist, exact_sqdist, sqrt_rn
from ..kernels.quant import first_min_top2


def sqnorm(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared l2 norm: (n, d) -> (n,)."""
    return torch.sum(x * x, dim=-1)


def bottom_k(v: torch.Tensor, n: int) -> torch.Tensor:
    """Column indices of the n smallest entries of each row, (rows, n)
    int32, ties to the lower index: ``lax.top_k(-v, n)`` as a stable
    ascending sort (``torch.topk`` promises no tie order)."""
    order = torch.sort(v, dim=1, stable=True).indices
    return order[:, :n].to(torch.int32).contiguous()


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs squared distances: (n, d) x (k, d) -> (n, k)."""
    return exact_sqdist(x, c)


def chunked_argmin_sqdist(x: torch.Tensor, c: torch.Tensor):
    """Nearest center per point through K5, with no (n, k) matrix:
    (assignment (n,) int32, min sqdist (n,)), ties to the first center."""
    return ops.assign_nearest_kernel(x, c)


def gather_candidate_sqdist(x: torch.Tensor, c: torch.Tensor,
                            cand: torch.Tensor, *,
                            chunk: int = 2048) -> torch.Tensor:
    """Distances from each point to its own candidate list: x (n, d), c
    (k, d), cand (n, kn) int (-1 = padding) -> (n, kn) squared
    distances, the pairs of ``chunk`` rows at a time."""
    return candidate_sqdist(x, c, cand, chunk=chunk)


def chunked_candidate_argmin(x: torch.Tensor, c: torch.Tensor,
                             cand: torch.Tensor, chunk: int = 2048):
    """Restricted nearest-candidate assignment: each row of ``x``
    competes only among its own list ``cand[i]``. Returns (assignment
    (n,) int32, min sqdist (n,))."""
    sq = candidate_sqdist(x, c, cand, chunk=chunk)
    loc = torch.argmin(sq, dim=1, keepdim=True)           # first minimum
    return (torch.gather(cand, 1, loc)[:, 0].to(torch.int32),
            torch.gather(sq, 1, loc)[:, 0])


def chunked_candidate_top2(x: torch.Tensor, c: torch.Tensor,
                           cand: torch.Tensor, chunk: int = 2048):
    """Best and second-best candidate per row as *true* distances, the
    Hamerly bound pair of the ``xla`` iteration: (assignment (n,) int32,
    d1 (n,), d2 (n,)), d1 <= d2. Ranked on the square roots, as the
    reference's ``lax.top_k(-dist, 2)`` ranks them, correctly rounded
    (``exact_round.sqrt_rn``) as XLA's and the card's are."""
    return first_min_top2(sqrt_rn(candidate_sqdist(x, c, cand, chunk=chunk)),
                          cand)


def clustering_energy(x: torch.Tensor, c: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """Total k-means energy sum_j sum_{x in X_j} ||x - c_j||^2."""
    return torch.sum(sqnorm(x - c[a.long()]))
