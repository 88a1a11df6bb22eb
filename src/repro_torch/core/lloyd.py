"""Standard k-means (Lloyd's algorithm), the paper's accuracy reference
(port of ``repro.core.lloyd``), and the fit result type.

The assignment step is K5 (``ops.assign_nearest_kernel``); the update is
a segment sum in row order (the card's bits are the CPU's) in which
empty clusters keep their previous center. The convergence test
compares the assignment with the previous one on the device and reads
the flag together with the energy: one host read per iteration (the
reference reads the whole assignment back).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..device import as_tensor, resolve
from ..kernels import ops
from .distance import clustering_energy
from .opcount import OpCounter


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


def update_centers(x: torch.Tensor, a: torch.Tensor,
                   c_prev: torch.Tensor) -> torch.Tensor:
    """Mean of members per cluster; empty clusters keep their old center.
    The sums add members in row order on every device, as the
    reference's f32 scatter does: the card's centers are the CPU's bit
    for bit."""
    k = c_prev.shape[0]
    sums = ops.segment_sum_ordered(x, a, k)
    counts = ops.segment_sum(torch.ones((x.shape[0],), dtype=x.dtype,
                                        device=x.device), a, k)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, means, c_prev)


def lloyd_step(x: torch.Tensor, c: torch.Tensor):
    """One Lloyd iteration -> (new centers, assignment (n,) int32, energy
    of the assignment as a 0-d tensor on the device)."""
    a, dmin = ops.assign_nearest_kernel(x, c)
    return update_centers(x, a, c), a, torch.sum(dmin)


def fit_lloyd(x, centers, *, max_iters: int = 100,
              counter: OpCounter | None = None,
              callback: Callable | None = None, device=None) -> KMeansResult:
    """Lloyd's algorithm from ``centers`` on ``device`` (default ``cuda``)
    until the assignment stops changing or ``max_iters`` (>= 1)
    iterations. Charges n*k distances and n additions per iteration;
    ``callback(it, c, a, energy)`` sees every iteration."""
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    dev = resolve(device)
    x, c = as_tensor(x, dev), as_tensor(centers, dev)
    counter = counter or OpCounter()
    n, k = x.shape[0], c.shape[0]
    a_prev = None
    history = []
    it = 0
    for it in range(1, max_iters + 1):
        c, a, energy = lloyd_step(x, c)
        counter.add_distances(n * k)      # assignment: n*k distances
        counter.add_additions(n)          # update: n vector additions
        changed = torch.ones((), dtype=torch.bool, device=dev) \
            if a_prev is None else torch.any(a != a_prev)
        # the iteration's one host read: the flag and the energy together
        flag, e = torch.stack([changed.double(),
                               energy.double()]).tolist()
        history.append((counter.snapshot(), e))
        if callback is not None:
            callback(it, c, a, e)
        if not flag:
            break
        a_prev = a
    energy = float(clustering_energy(x, c, a))
    return KMeansResult(c, a, energy, it, counter.total, history)
