"""Elkan's exact accelerated k-means (ICML 2003), the paper's strongest
exact baseline (port of ``repro.core.elkan``).

Vectorised as in the reference: the per-point/per-center skip conditions
become boolean masks over a dense (n, k) distance evaluation, and the
counted vector ops charge only the entries Elkan's serial algorithm
would compute. The distances are the correctly rounded ones of
``exact_round.exact_sqdist``, so a (point, center)
pair has the value K5 gives it on Lloyd's path and the assignments equal
Lloyd's.
"""
from __future__ import annotations

import torch

from ..device import as_tensor, resolve
from ..kernels.exact_round import exact_sqdist, exact_sqnorm, sqrt_rn
from .distance import clustering_energy
from .lloyd import KMeansResult, update_centers
from .opcount import OpCounter


def _moved(c_next: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Distance each center moved, (k,)."""
    return sqrt_rn(torch.clamp(exact_sqnorm(c_next - c), min=0.0))


def elkan_step(x, c, a, u, lb, stale):
    """One Elkan iteration with full (n, k) lower bounds.

    ``stale`` is Elkan's r(x) flag: True iff the cached upper bound ``u``
    is not the exact assigned-center distance. It is cleared by the
    tightening step (one exact distance) and set again only when the
    assigned center moved.

    Returns (c', a', u', lb', stale', computed_count, changed) with the
    two counts as 0-d tensors on the device.
    """
    n = x.shape[0]
    k = c.shape[0]
    rows = torch.arange(n, device=x.device)
    al = a.long()
    dist_cc = sqrt_rn(exact_sqdist(c, c))
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    s = 0.5 * torch.amin(torch.where(eye, float("inf"), dist_cc), dim=1)

    # Step 2-3: points with u <= s[a] skip the whole iteration.
    active = u > s[al]

    # Dense distance evaluation; only the entries Elkan computes are
    # charged (the tightening below and ``cond``).
    dist = sqrt_rn(exact_sqdist(x, c))
    d_xa = dist[rows, al]
    compute_u = active & stale
    u_t = torch.where(compute_u, d_xa, u)
    lb_t = lb.clone()
    lb_t[rows, al] = torch.where(compute_u, d_xa, lb[rows, al])

    # Candidate mask per (point, center): Elkan conditions 3(a-b).
    cond = (u_t[:, None] > lb_t) & (u_t[:, None] > 0.5 * dist_cc[al]) \
        & (torch.arange(k, device=x.device)[None, :] != al[:, None]) \
        & active[:, None]
    lb_new = torch.where(cond, dist, lb_t)
    # Effective distance for argmin: computed entries + own-center distance.
    eff = torch.where(cond, dist, float("inf"))
    eff[rows, al] = u_t
    a_new = torch.argmin(eff, dim=1).to(torch.int32)
    u_new = torch.amin(eff, dim=1)

    c_next = update_centers(x, a_new, c)
    delta = _moved(c_next, c)
    an = a_new.long()
    lb_adj = torch.clamp(lb_new - delta[None, :], min=0.0)
    u_adj = u_new + delta[an]
    computed = torch.sum(compute_u) + torch.sum(cond)
    changed = torch.sum(a_new != a)
    # r(x) after this iteration: u_new is exact for every active point, so
    # staleness survives only on skipped stale points, and the adjustment
    # re-stales exactly the points whose center moved.
    stale_next = (stale & ~compute_u) | (delta[an] > 0.0)
    return c_next, a_new, u_adj, lb_adj, stale_next, computed, changed


def fit_elkan(x, centers, *, max_iters: int = 100,
              counter: OpCounter | None = None, device=None) -> KMeansResult:
    """Elkan's k-means from ``centers`` on ``device`` (default ``cuda``):
    the assignments of :func:`core.lloyd.fit_lloyd` at fewer counted
    distances. One host read per iteration (the counted distances, the
    changed count and the energy together)."""
    dev = resolve(device)
    x, c = as_tensor(x, dev), as_tensor(centers, dev)
    counter = counter or OpCounter()
    n = x.shape[0]
    k = c.shape[0]
    # Initial exact assignment (one full Lloyd-style pass, as Elkan requires).
    dist = sqrt_rn(exact_sqdist(x, c))
    a = torch.argmin(dist, dim=1).to(torch.int32)
    u = torch.amin(dist, dim=1)
    lb = dist
    counter.add_distances(n * k)
    # First update step + bound adjustment (Elkan's loop starts after one
    # full Lloyd-style pass: assignment above, center update here).
    c_next = update_centers(x, a, c)
    delta = _moved(c_next, c)
    lb = torch.clamp(lb - delta[None, :], min=0.0)
    u = u + delta[a.long()]
    c = c_next
    counter.add_distances(k)
    counter.add_additions(n)
    # u was exact before the adjustment: only moved-center points are stale
    stale = delta[a.long()] > 0.0
    history = [(counter.snapshot(), float(clustering_energy(x, c, a)))]
    it = 0
    for it in range(1, max_iters + 1):
        c, a, u, lb, stale, computed, changed = elkan_step(x, c, a, u, lb,
                                                           stale)
        n_comp, n_changed, energy = torch.stack([
            computed.double(), changed.double(),
            clustering_energy(x, c, a).double()]).tolist()
        # k*k//2 symmetric inter-center distances, the recomputed point
        # distances, and k movement norms
        counter.add_distances(k * k // 2 + int(n_comp) + k)
        counter.add_additions(n)
        history.append((counter.snapshot(), energy))
        if int(n_changed) == 0:
            break
    return KMeansResult(c, a, float(history[-1][1]), it, counter.total,
                        history)
