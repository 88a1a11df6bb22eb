"""Approximate k-means (AKM, Philbin et al. CVPR 2007) baseline (port of
``repro.core.akm``).

The original AKM prunes the assignment with a forest of randomised
kd-trees over the centers (m distance checks per point); the reference
realises the same O(n m d) contract with an IVF-style coarse quantiser,
and so does the port. Each iteration:

  1. group the k centers into g = ceil(k/m) groups (a few Lloyd
     iterations on the k centers: K5 steps and ``lloyd.update_centers``'
     ordered sums);
  2. route each point to its nearest group (K5, n*g counted distances)
     and score only that group's members, padded to a static capacity
     with overflow dropped (the counted member distances,
     ``distance.chunked_candidate_argmin``), keeping the point's current
     center unless a member is strictly nearer, so the energy never
     rises.

The current center's distance is ``exact_sqnorm(x - c[a])``, correctly
rounded (the reference sums the squared differences in f32), so the
keep-or-move decision is the same on the card and the CPU. The loop
stops when the assignment stops changing (one host read an iteration).
"""
from __future__ import annotations

import torch

from ..device import as_tensor, resolve
from ..kernels import ops
from ..kernels.exact_round import exact_sqnorm
from .distance import chunked_candidate_argmin, clustering_energy
from .lloyd import KMeansResult, update_centers
from .opcount import OpCounter


def _group_centers(c: torch.Tensor, idx, group_iters: int = 3):
    """Cluster the k centers into g groups from the g seed centers
    ``idx`` (distinct ids): ``group_iters`` Lloyd steps. Returns
    (group centroids (g, d), gid (k,) int32)."""
    gc = c[as_tensor(idx, c.device, torch.int64)]
    for _ in range(group_iters):
        gid, _ = ops.assign_nearest_kernel(c, gc)
        gc = update_centers(c, gid, gc)
    gid, _ = ops.assign_nearest_kernel(c, gc)
    return gc, gid


def _member_table(gid: torch.Tensor, g: int, cap: int) -> torch.Tensor:
    """(g, cap) int32 member table: each group's centers in id order,
    -1 padding, members past ``cap`` dropped."""
    k = gid.shape[0]
    dev = gid.device
    gl = gid.long()
    order = torch.argsort(gl, stable=True)
    sg = gl[order]
    pos = torch.arange(k, device=dev) - torch.searchsorted(sg, sg)
    keep = pos < cap
    table = torch.full((g + 1, cap), -1, dtype=torch.int32, device=dev)
    table[torch.where(keep, sg, g), torch.where(keep, pos, 0)] = \
        order.to(torch.int32)
    return table[:g]


def _akm_assign(x, c, gc, gid, cap: int, chunk: int = 2048):
    """Assignment through the coarse routing: each point's nearest group
    (K5), then the nearest of that group's members. Returns (a (n,)
    int32, its sqdist (n,), the member distances evaluated, a device
    scalar)."""
    table = _member_table(gid, gc.shape[0], cap)
    grp, _ = ops.assign_nearest_kernel(x, gc)
    cand = table[grp.long()]                           # (n, cap)
    a, dmin = chunked_candidate_argmin(x, c, cand, chunk=chunk)
    return a, dmin, torch.sum(cand >= 0)


def fit_akm(x, centers, *, generator: torch.Generator | None = None,
            m: int = 30, max_iters: int = 100,
            counter: OpCounter | None = None, chunk: int = 2048,
            group_draws=None, device=None) -> KMeansResult:
    """AKM from ``centers`` on ``device`` (default ``cuda``) with ``m``
    distance evaluations per point and iteration: g = ceil(k/m) groups,
    each scanned up to cap = min(k, 4m) members. Charges 3kg distances
    for the grouping, n*g + the member evaluations + n (the current
    centers) for the assignment and n additions for the update, per
    iteration, until the assignment stops changing or ``max_iters``.
    ``generator``: the CPU generator of each iteration's g distinct group
    seeds (seed 0 when None); ``group_draws``: optional per-iteration seed
    ids instead (tests feed the reference's ``jax.random.choice``
    draws)."""
    dev = resolve(device)
    x, c = as_tensor(x, dev), as_tensor(centers, dev)
    counter = counter or OpCounter()
    n = x.shape[0]
    k = c.shape[0]
    m = min(m, k)
    g = max(1, -(-k // m))
    cap = min(k, 4 * m)
    if generator is None and group_draws is None:
        generator = torch.Generator().manual_seed(0)
    group_draws = iter(group_draws) if group_draws is not None else None
    a = torch.zeros((n,), dtype=torch.int32, device=dev)
    a_prev = None
    history = []
    it = 0
    for it in range(1, max_iters + 1):
        idx = next(group_draws) if group_draws is not None else \
            torch.randperm(k, generator=generator)[:g]
        gc, gid = _group_centers(c, idx)
        counter.add_distances(3 * k * g)    # the coarse quantiser's build
        a_cand, dmin_cand, evals = _akm_assign(x, c, gc, gid, cap, chunk)
        # the current-center fallback, n counted distances
        d_cur = exact_sqnorm(x - c[a.long()])
        a = torch.where(dmin_cand < d_cur, a_cand, a)
        c = update_centers(x, a, c)
        counter.add_additions(n)
        same = torch.zeros((), dtype=torch.bool, device=dev) \
            if a_prev is None else torch.all(a == a_prev)
        # the iteration's one host read: evaluations, energy, convergence
        ev, energy, stop = torch.stack([
            evals.double(), clustering_energy(x, c, a).double(),
            same.double()]).tolist()
        counter.add_distances(n * g + ev + n)
        history.append((counter.snapshot(), energy))
        if stop:
            break
        a_prev = a
    return KMeansResult(c, a, history[-1][1], it, counter.total, history)
