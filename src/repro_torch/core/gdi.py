"""Greedy Divisive Initialization, frontier-batched and device-resident
(port of ``repro.core.gdi``: ``gdi_round_step`` / ``gdi_device_init``).

One round splits the top-energy frontier leaves all at once over the
cluster-grouped layout: per-leaf seed pairs from uniform draws, the
direction projection, one stable (leaf, projection) sort, the segmented
Lemma-1 scan (kernel K3, ``kernels.segmented_scan``), a per-segment
masked argmin for the split, and one scatter for the B side. The host
reads one scalar (the leaf count) per round.

``torch.Generator`` draws differ from ``jax.random``'s, so the round
step takes optional ``draws`` (the two (n,) uniform vectors of
Algorithm 3 line 2); tests feed it the reference's to compare leaf for
leaf. The sort by (leaf, projection) is two stable sorts: projection
first, then leaf.
"""
from __future__ import annotations

import torch

from ..device import as_tensor, resolve
from ..kernels.exact_round import exact_rowdot, exact_sqnorm
from ..kernels.ops import (choose_group_bn, group_by_cluster_device,
                           grouped_capacity, scatter_drop)
from ..kernels.segmented_scan import segmented_scan
from .opcount import OpCounter

_INF = float("inf")


def _segment_reduce(v, seg, k, how, init):
    """``jax.ops.segment_max/min``: ``init`` on empty segments."""
    out = torch.full((k,), init, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, seg.long(), v, how, include_self=False)


def _segment_argmax(g, a, k):
    """Per-segment argmax of ``g`` over segments ``a``: (k,) row indices,
    ``n`` for empty segments (earliest row wins ties)."""
    n = g.shape[0]
    m = _segment_reduce(g, a, k, "amax", -_INF)
    rows = torch.arange(n, device=g.device)
    idx = torch.where(g >= m[a.long()], rows, n)
    return torch.clamp(_segment_reduce(idx, a, k, "amin", n), max=n)


def _grouped_layout(a, k: int, bn: int):
    """Leaf-grouped row layout: (row_seg (R,), valid (R,), perm (R,),
    block2seg (R/bn,))."""
    perm, b2s = group_by_cluster_device(a, k, bn)
    return torch.repeat_interleave(b2s.long(), bn), perm >= 0, perm, b2s


def _segmented_sweep(x, a, row_seg, valid, perm, b2s, dirs, split_flag, *,
                     k: int, bn: int):
    """One Lemma-1 sweep over every flagged leaf at once. Returns
    (perm2, rmin, found, cnt_a, c_a, c_b, phi_a, phi_b); rmin is the split
    row of the sorted layout (R when no valid split), side A = rows <=
    rmin of the leaf's segment. The leaf totals are the scan's own values
    at each segment's last row (the reference takes them with a
    ``segment_sum`` before the sweep): one fixed order on every device,
    and no second pass over x. The projections and the split scores'
    squared norms are correctly rounded and K3's sums have one fixed
    order, so the card splits where the CPU does."""
    r = row_seg.shape[0]
    dev = x.device
    proj_pt = exact_rowdot(x, dirs, a)
    safe = torch.clamp(perm, min=0).long()
    proj = torch.where(valid, proj_pt[safe], _INF)
    rows = torch.arange(r, device=dev)
    o1 = torch.sort(proj, stable=True).indices
    o2 = torch.sort(row_seg[o1], stable=True).indices
    order2 = o1[o2]
    perm2 = perm[order2]
    safe2 = torch.clamp(perm2, min=0).long()
    ws = (perm2 >= 0).to(x.dtype)
    xgs = x[safe2].contiguous()                      # the one (R, d) gather
    csum, qsum, cnt = segmented_scan(xgs, ws, b2s, bn=bn)
    last = _segment_reduce(rows, row_seg, k, "amax", -1)
    has = last >= 0
    at = torch.clamp(last, min=0)
    tot_s = torch.where(has[:, None], csum[at], 0.0)
    tot_q = torch.where(has, qsum[at], 0.0)
    tot_c = torch.where(has, cnt[at], 0.0)
    rem = tot_c[row_seg] - cnt
    phi_p = qsum - exact_sqnorm(csum) / torch.clamp(cnt, min=1.0)
    sfx = tot_s[row_seg] - csum
    phi_s = (tot_q[row_seg] - qsum) \
        - exact_sqnorm(sfx) / torch.clamp(rem, min=1.0)
    ok = (ws > 0) & (cnt >= 1.0) & (rem >= 1.0) & split_flag[row_seg]
    score = torch.where(ok, phi_p + phi_s, _INF)
    smin = _segment_reduce(score, row_seg, k, "amin", _INF)
    hit = ok & (score <= smin[row_seg])
    rmin = torch.clamp(_segment_reduce(torch.where(hit, rows, r), row_seg,
                                       k, "amin", r), max=r)
    found = rmin < r
    rsafe = torch.clamp(rmin, max=r - 1)
    cnt_a = cnt[rsafe]
    c_a = csum[rsafe] / torch.clamp(cnt_a, min=1.0)[:, None]
    c_b = (tot_s - csum[rsafe]) \
        / torch.clamp(tot_c - cnt_a, min=1.0)[:, None]
    phi_a = torch.clamp(phi_p[rsafe], min=0.0)
    phi_b = torch.clamp(phi_s[rsafe], min=0.0)
    return perm2, rmin, found, cnt_a, c_a, c_b, phi_a, phi_b


def segmented_split_sweep(x, a, c_a, c_b, *, k: int, bn: int = 8):
    """Standalone single sweep: split every leaf of ``a`` with >= 2
    members along its (c_a - c_b) direction. Returns (found (k,), cnt_a
    (k,), c_a' (k, d), c_b' (k, d), phi_a (k,), phi_b (k,))."""
    row_seg, valid, perm, b2s = _grouped_layout(a, k, bn)
    sizes = torch.zeros(k, dtype=torch.int64, device=x.device).index_add_(
        0, a.long(), torch.ones_like(a, dtype=torch.int64))
    out = _segmented_sweep(x, a, row_seg, valid, perm, b2s, c_a - c_b,
                           sizes >= 2, k=k, bn=bn)
    return out[2:]


def gdi_round_step(x, a, centers, energies, sizes, nleaf, *, k: int,
                   bn: int, split_iters: int = 2, frontier: float = 0.125,
                   generator: torch.Generator | None = None, draws=None):
    """One frontier round: split the top-t leaves by energy all at once.

    State: a (n,) int32 leaf assignment, centers (k, d), energies (k,),
    sizes (k,) int32, nleaf () int64, all on the device. t = min(
    #splittable, k - nleaf, max(1, floor(frontier * min(nleaf, k -
    nleaf)))). Side A of leaf j keeps id j; side B takes the next free
    slot. ``draws``: optional (g1, g2) uniform (n,) draws; else drawn
    from ``generator``. Returns the updated state tuple.
    """
    n, d = x.shape
    dev = x.device
    slot = torch.arange(k, device=dev)
    eligible = (slot < nleaf) & (sizes >= 2)
    t = torch.minimum(torch.sum(eligible), k - nleaf)
    if frontier < 1.0:
        t = torch.minimum(t, torch.clamp(
            (torch.minimum(nleaf, k - nleaf).to(torch.float32)
             * frontier).to(torch.int64), min=1))
    order = torch.argsort(torch.where(eligible, -energies, _INF), stable=True)
    rank = torch.empty((k,), dtype=torch.int64, device=dev)
    rank[order] = slot
    split_flag = eligible & (rank < t)

    row_seg, valid, perm, b2s = _grouped_layout(a, k, bn)

    # two uniform random members per leaf as the initial split direction
    # (Algorithm 3 line 2): per-segment argmax of uniform draws, the
    # second excluding the first member
    if draws is None:
        g1 = torch.rand((n,), generator=generator, device=dev)
        g2 = torch.rand((n,), generator=generator, device=dev)
    else:
        g1, g2 = (as_tensor(g, dev) for g in draws)
    i_a = _segment_argmax(g1, a, k)
    g2 = scatter_drop(g2, torch.where(i_a < n, i_a, n), -1.0)
    i_b = _segment_argmax(g2, a, k)
    c_a = x[torch.clamp(i_a, max=n - 1)]
    c_b = x[torch.clamp(i_b, max=n - 1)]

    for _ in range(split_iters):
        perm2, rmin, found, cnt_a, c_a_new, c_b_new, phi_a, phi_b = \
            _segmented_sweep(x, a, row_seg, valid, perm, b2s, c_a - c_b,
                             split_flag, k=k, bn=bn)
        upd = (split_flag & found)[:, None]
        c_a = torch.where(upd, c_a_new, c_a)
        c_b = torch.where(upd, c_b_new, c_b)

    success = split_flag & found
    # children take the next free slots in slot order (dense, so nleaf
    # stays the exact count of live leaves)
    child = nleaf + torch.cumsum(success.to(torch.int64), 0) - 1
    child_idx = torch.where(success, child, k)

    r = row_seg.shape[0]
    in_b = (torch.arange(r, device=dev) > rmin[row_seg]) & success[row_seg]
    new_id = torch.where(in_b, child[row_seg], row_seg).to(torch.int32)
    a_new = scatter_drop(a, torch.where(perm2 >= 0, perm2.long(), n), new_id)

    size_a = cnt_a.to(torch.int32)
    succ = success[:, None]
    centers = torch.where(succ, c_a, centers)
    centers = scatter_drop(centers, child_idx,
                           torch.where(succ, c_b, 0.0))
    energies = torch.where(success, phi_a, energies)
    energies = scatter_drop(energies, child_idx,
                            torch.where(success, phi_b, 0.0))
    sizes_new = torch.where(success, size_a, sizes)
    sizes_new = scatter_drop(sizes_new, child_idx,
                             torch.where(success, sizes - size_a, 0)
                             .to(torch.int32))
    nleaf = nleaf + torch.sum(success)
    return a_new, centers, energies, sizes_new, nleaf


def _device_state(x, k: int):
    """Initial round-step state: one leaf holding everything."""
    n, d = x.shape
    dev = x.device
    mu = torch.mean(x, dim=0)
    centers = torch.zeros((k, d), dtype=x.dtype, device=dev)
    centers[0] = mu
    energies = torch.zeros((k,), dtype=x.dtype, device=dev)
    energies[0] = torch.sum(torch.square(x - mu))
    sizes = torch.zeros((k,), dtype=torch.int32, device=dev)
    sizes[0] = n
    return (torch.zeros((n,), dtype=torch.int32, device=dev), centers,
            energies, sizes, torch.tensor(1, device=dev))


def _charge_round(counter: OpCounter, r: int, n: int, d: int,
                  split_iters: int) -> None:
    """Paper-unit accounting of one device round: one grouping sort, the
    totals segment-sum, and split_iters x (projection inner products +
    sweep sort + scan additions) over the full R-row layout."""
    counter.add_inner(split_iters * r)
    counter.add_additions(split_iters * r + n)
    for _ in range(split_iters + 1):
        counter.add_sort(r, d)


def gdi_device_init(x, k: int, *, generator: torch.Generator | None = None,
                    split_iters: int = 2, counter: OpCounter | None = None,
                    bn: int | None = None, frontier: float = 0.125,
                    draws=None, device=None):
    """Frontier-batched greedy divisive initialization on ``device``
    (default ``cuda``). Each round re-ranks the leaves by energy and
    splits the top ``frontier`` fraction at once; the host reads the leaf
    count once per round. ``bn`` defaults to ``choose_group_bn`` as the
    reference's Pallas path takes it. ``draws``: optional iterable of
    per-round (g1, g2) uniform draws (tests feed the reference's).
    Returns (centers (k, d), assignment (n,) int32)."""
    dev = resolve(device)
    x = as_tensor(x, dev)
    counter = counter or OpCounter()
    n, d = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")
    if generator is None and draws is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    bn = bn or choose_group_bn(n, k, d)
    r = grouped_capacity(n, k, bn) * bn
    draws = iter(draws) if draws is not None else None

    state = _device_state(x, k)
    counter.add_additions(n)                    # initial mean
    nleaf = 1
    while nleaf < k:
        state = gdi_round_step(
            x, *state, k=k, bn=bn, split_iters=split_iters,
            frontier=frontier, generator=generator,
            draws=next(draws) if draws is not None else None)
        _charge_round(counter, r, n, d, split_iters)
        new_nleaf = int(state[4])               # the round's one host read
        if new_nleaf == nleaf:
            break                               # nothing splittable left
        nleaf = new_nleaf
    a, centers = state[0], state[1]
    if nleaf < k:   # pathological tiny-n fallback: pad with copies
        keep = (torch.arange(k, device=dev) < nleaf)[:, None]
        centers = torch.where(keep, centers, centers[max(nleaf - 1, 0)])
    return centers, a
