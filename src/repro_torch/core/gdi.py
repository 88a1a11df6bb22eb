"""Greedy Divisive Initialization (port of ``repro.core.gdi``): the
frontier-batched device init (``gdi_round_step`` / ``gdi_device_init``),
the host loop ``gdi_init``, the round-parallel ``gdi_parallel_init`` and
the fixed-round ``gdi_fixed_rounds`` of the sharded seed.

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

:func:`projective_split` is Algorithm 3 on one masked subset (port of
the reference's ``projective_split``), the Lemma-1 split that the
streaming model's drift repair re-seats a center with. Its two member
draws go through :func:`_split_draws`, which tests replace with the
reference's draws.

:func:`gdi_init` is Algorithm 2 as the reference's host loop runs it:
one :func:`projective_split` of the highest-energy leaf at a time, each
split's side sizes and energies read to the host (one read per split),
k - 1 splits in all. :func:`gdi_parallel_init` is the round-parallel
variant (paper footnote 2): :func:`gdi_round_step` at ``frontier=1.0``
over a power-of-two slot count, every leaf split each round. Both draw
from a CPU ``torch.Generator`` (the round draws made on the CPU and
moved), so the card draws what the CPU draws.
"""
from __future__ import annotations

import math

import torch

from ..device import as_tensor, resolve
from ..kernels.exact_round import exact_rowdot, exact_split_sqnorms
from ..kernels.ops import (choose_group_bn, group_by_cluster_device,
                           grouped_capacity, scatter_drop)
from ..kernels.segmented_scan import segmented_scan
from .distance import bottom_k, chunked_argmin_sqdist
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
    squared norms are correctly rounded (the suffix norms from the totals
    and the prefixes in one pass, with no (R, d) suffix formed) and K3's
    sums have one fixed order, so the card splits where the CPU does."""
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
    sq_p, sq_s = exact_split_sqnorms(csum, tot_s, row_seg)
    phi_p = qsum - sq_p / torch.clamp(cnt, min=1.0)
    phi_s = (tot_q[row_seg] - qsum) - sq_s / torch.clamp(rem, min=1.0)
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


def _split_draws(mask: torch.Tensor, generator: torch.Generator):
    """Algorithm 3 line 2: two members of ``mask`` (n,) bool drawn
    uniformly, the second among the others (the reference's two
    ``jax.random.choice`` draws). Inverse CDF over the 0/1 weights, whose
    f64 cumulative sums are exact in any order; the two uniforms come
    from ``generator``, a CPU generator, so the card draws the members
    the CPU draws. Returns (i_a, i_b), (1,) int64 tensors on mask's
    device."""
    u = torch.rand((2,), generator=generator, dtype=torch.float64)
    u = u.to(mask.device)
    w = mask.to(torch.float64)
    cdf = torch.cumsum(w, 0)
    i_a = torch.searchsorted(cdf, cdf[-1:] * (1.0 - u[:1]))
    w2 = w.clone()
    w2[torch.clamp(i_a, max=w.shape[0] - 1)] = 0.0
    cdf2 = torch.cumsum(w2, 0)
    i_b = torch.searchsorted(cdf2, cdf2[-1:] * (1.0 - u[1:]))
    n = w.shape[0]
    return torch.clamp(i_a, max=n - 1), torch.clamp(i_b, max=n - 1)


def projective_split(x: torch.Tensor, mask: torch.Tensor,
                     generator: torch.Generator | None = None,
                     iters: int = 2):
    """Min-energy split of the rows ``mask`` (n,) bool selects along the
    c_a - c_b direction (Algorithm 3 with Lemma 1's prefix identity),
    ``iters`` sweeps from two drawn members (:func:`_split_draws`, from
    ``generator``, a CPU ``torch.Generator``; seed 0 when None).

    Each sweep projects the rows on the direction (correctly rounded,
    ``exact_rowdot``), sorts the members by projection (stable; other
    rows last), and takes the running sums of x, |x|^2 and the count as
    one segment through K3 (``segmented_scan``: one fixed f64 order,
    so the card gives the CPU's sums); the split scores' squared norms
    are correctly rounded (``exact_split_sqnorms``). The split is the
    first row of least score. Returns (mask_a, mask_b, c_a, c_b, phi_a,
    phi_b)."""
    n, d = x.shape
    dev = x.device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    i_a, i_b = _split_draws(mask, generator)
    c_a, c_b = x[i_a][0], x[i_b][0]
    fmask = mask.to(x.dtype)
    # one segment over ceil(n / bn) blocks: pad rows sort last at weight 0
    bn = 64
    r = -(-n // bn) * bn
    b2s = torch.zeros((r // bn,), dtype=torch.int32, device=dev)
    row_seg = torch.zeros((r,), dtype=torch.int64, device=dev)
    zeros = torch.zeros((n,), dtype=torch.int64, device=dev)
    rows = torch.arange(r, device=dev)
    for _ in range(iters):
        proj = exact_rowdot(x, (c_a - c_b)[None], zeros)
        order = torch.sort(torch.where(mask, proj, _INF), stable=True).indices
        xs = torch.zeros((r, d), dtype=x.dtype, device=dev)
        xs[:n] = x[order]
        ms = torch.zeros((r,), dtype=x.dtype, device=dev)
        ms[:n] = fmask[order]
        csum, qsum, cnt = segmented_scan(xs, ms, b2s, bn=bn)
        tot_s, tot_q, tot_c = csum[-1], qsum[-1], cnt[-1]
        sq_p, sq_s = exact_split_sqnorms(csum, tot_s[None], row_seg)
        phi_p = qsum - sq_p / torch.clamp(cnt, min=1.0)
        sc = tot_c - cnt
        phi_s = (tot_q - qsum) - sq_s / torch.clamp(sc, min=1.0)
        valid = (cnt >= 1.0) & (sc >= 1.0) & (ms > 0)
        l_ = torch.argmin(torch.where(valid, phi_p + phi_s, _INF))
        c_a = csum[l_] / torch.clamp(cnt[l_], min=1.0)
        c_b = (tot_s - csum[l_]) / torch.clamp(tot_c - cnt[l_], min=1.0)
        in_a = ((rows <= l_) & (ms > 0))[:n]
        mask_a = torch.zeros((n,), dtype=torch.bool, device=dev)
        mask_a[order] = in_a
        phi_a, phi_b = phi_p[l_], phi_s[l_]
    return mask_a, mask & ~mask_a, c_a, c_b, phi_a, phi_b


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


def _check_k(k: int, n: int) -> None:
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got k={k}, n={n}")


def _pad_leaves(centers: torch.Tensor, nleaf: int, k: int) -> torch.Tensor:
    """The tiny-n fallback: slots past the ``nleaf`` live leaves copy the
    last live center."""
    keep = (torch.arange(k, device=centers.device) < nleaf)[:, None]
    return torch.where(keep, centers, centers[max(nleaf - 1, 0)])


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
    _check_k(k, n)
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
        centers = _pad_leaves(centers, nleaf, k)
    return centers, a


def frontier_round_bound(k: int, frontier: float) -> int:
    """Rounds the frontier schedule needs to reach ``k`` leaves when every
    flagged leaf splits (the optimistic trip count of
    :func:`gdi_round_step`'s t formula with every leaf eligible).
    Fixed-trip-count callers add slack rounds for failed splits; surplus
    rounds change nothing once there are k leaves."""
    leaves, rounds = 1, 0
    while leaves < k:
        t = min(leaves, k - leaves)
        if frontier < 1.0:
            t = min(t, max(1, int(frontier * min(leaves, k - leaves))))
        leaves += t
        rounds += 1
    return rounds


def gdi_fixed_rounds(x, kcap: int, *, rounds: int | None = None,
                     split_iters: int = 2, bn: int = 8,
                     frontier: float = 1.0,
                     generator: torch.Generator | None = None, draws=None):
    """A fixed number of frontier rounds of :func:`gdi_round_step` toward
    ``kcap`` leaves with no host read (the per-shard seed of
    ``core.distributed``). ``rounds`` defaults to
    :func:`frontier_round_bound`. ``draws``: optional per-round (g1, g2)
    uniform draws (tests feed the reference's); else each round's two
    (n,) uniforms come from ``generator``, a CPU ``torch.Generator``
    (seed 0 when None), so the card draws what the CPU draws. Returns the
    round-step state ``(a, centers, energies, sizes, nleaf)``."""
    if rounds is None:
        rounds = frontier_round_bound(kcap, frontier)
    n, dev = x.shape[0], x.device
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(0)
    draws = iter(draws) if draws is not None else None
    state = _device_state(x, kcap)
    for _ in range(rounds):
        g = next(draws) if draws is not None else tuple(
            torch.rand((n,), generator=generator).to(dev) for _ in range(2))
        state = gdi_round_step(x, *state, k=kcap, bn=bn,
                               split_iters=split_iters, frontier=frontier,
                               draws=g)
    return state


def gdi_init(x, k: int, *, generator: torch.Generator | None = None,
             split_iters: int = 2, counter: OpCounter | None = None,
             device=None):
    """Algorithm 2, the greedy divisive host loop, on ``device`` (default
    ``cuda``): split the highest-energy leaf (the largest one when that
    is a singleton) with :func:`projective_split` until there are k
    leaves. A leaf of m >= 2 rows always splits into two non-empty
    sides, and k <= n, so a splittable leaf is always left. Each split
    charges, per sweep over its leaf, m inner products, m additions and
    the sort's m log2 m / d, and reads one side's size and the two
    energies to the host in one read. ``generator``: the CPU generator of
    the splits' member draws (seed 0 when None). Returns (centers (k,
    d), assignment (n,) int32)."""
    dev = resolve(device)
    x = as_tensor(x, dev)
    counter = counter or OpCounter()
    n, d = x.shape
    _check_k(k, n)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    mu = torch.mean(x, dim=0)
    centers = [mu]
    energies = [float(torch.sum(torch.square(x - mu)))]
    sizes = [n]
    a = torch.zeros((n,), dtype=torch.int32, device=dev)
    counter.add_additions(n)                    # initial mean
    while len(centers) < k:
        j = max(range(len(energies)), key=energies.__getitem__)
        if sizes[j] < 2:    # a singleton cannot split: take the largest
            j = max(range(len(sizes)), key=sizes.__getitem__)
        _, mask_b, c_a, c_b, phi_a, phi_b = projective_split(
            x, a == j, generator, iters=split_iters)
        m = sizes[j]
        counter.add_inner(split_iters * m)
        counter.add_additions(split_iters * m)
        for _ in range(split_iters):
            counter.add_sort(m, d)
        a = torch.where(mask_b, len(centers), a).to(torch.int32)
        sb, e_a, e_b = torch.stack([torch.sum(mask_b).double(),
                                    phi_a.double(), phi_b.double()]
                                   ).tolist()   # the split's one host read
        centers[j] = c_a
        energies[j] = e_a
        sizes[j] = m - int(sb)
        centers.append(c_b)
        energies.append(e_b)
        sizes.append(int(sb))
    return torch.stack(centers), a


def gdi_parallel_init(x, k: int, *, generator: torch.Generator | None = None,
                      split_iters: int = 2, counter: OpCounter | None = None,
                      bn: int | None = None, draws=None, device=None):
    """Round-parallel divisive init on ``device`` (default ``cuda``):
    every round splits all current leaves at once
    (:func:`gdi_round_step` at ``frontier=1.0``), ceil(log2 k) rounds
    over k2 = 2^ceil(log2 k) slots, one host read of the leaf count a
    round. When k is not a power of two the k highest-energy leaves are
    kept (ties to the lower slot, as ``lax.top_k``) and the dropped
    leaves' rows go to their nearest kept center through K5, charging
    n*k distances. ``bn`` defaults as :func:`gdi_device_init` takes it.
    ``generator``: the CPU generator of the rounds' uniform draws (seed
    0 when None); ``draws``: optional per-round (g1, g2) draws instead
    (tests feed the reference's). Returns (centers (k, d), assignment
    (n,) int32)."""
    dev = resolve(device)
    x = as_tensor(x, dev)
    counter = counter or OpCounter()
    n, d = x.shape
    _check_k(k, n)
    if generator is None and draws is None:
        generator = torch.Generator().manual_seed(0)
    rounds = math.ceil(math.log2(k)) if k > 1 else 0
    k2 = 1 << rounds
    bn = bn or choose_group_bn(n, k2, d)
    r = grouped_capacity(n, k2, bn) * bn
    draws = iter(draws) if draws is not None else None

    state = _device_state(x, k2)
    counter.add_additions(n)                    # initial mean
    nleaf = 1
    for _ in range(rounds):
        g = next(draws) if draws is not None else tuple(
            torch.rand((n,), generator=generator).to(dev) for _ in range(2))
        state = gdi_round_step(x, *state, k=k2, bn=bn,
                               split_iters=split_iters, frontier=1.0,
                               draws=g)
        _charge_round(counter, r, n, d, split_iters)
        new_nleaf = int(state[4])               # the round's one host read
        if new_nleaf == nleaf:
            break
        nleaf = new_nleaf
    a, centers, energies = state[0], state[1], state[2]
    if k2 == k:
        return _pad_leaves(centers, nleaf, k) if nleaf < k else centers, a
    # keep the k highest-energy leaves; the dropped leaves' rows go to the
    # nearest kept center
    exists = torch.arange(k2, device=dev) < nleaf
    keep = bottom_k(torch.where(exists, -energies, _INF)[None], k)[0].long()
    kept = centers[keep]
    kept = torch.where(exists[keep][:, None], kept, kept[0])
    remap = torch.full((k2,), -1, dtype=torch.int64, device=dev)
    remap[keep] = torch.arange(k, device=dev)
    near, _ = chunked_argmin_sqdist(x, kept)
    counter.add_distances(n * k)
    ra = remap[a.long()]
    return kept, torch.where(ra >= 0, ra, near.long()).to(torch.int32)
