"""Runtime invariant guards, self-heal for the fit engines, and the drift
guard of the streaming model (port of ``repro.ft.invariants``, DESIGN.md
§11 and §14).

- :func:`resident_violations`: the §9.1 slot-ownership invariants of a
  resident arena as device counters, lanes ``[centers, sums, bounds,
  arena]`` (non-finite centers; non-finite or negative sums and counts;
  non-finite bound lanes; index-range, ownership and watermark
  violations); :func:`k2_violations`, the rebuild residency's lanes;
  :func:`make_guard`, the fit loop's guard over either;
- the repair lattice of a fit (:func:`heal_fit`): ``bound_reset`` (the
  stale-zero loose bounds with ``first``), ``regroup`` (quarantine
  non-finite rows, recover the assignment from the surviving slots
  (:func:`recover_assignment_np`), re-assign the untrusted rows exactly,
  rebuild the arena), ``split`` (:func:`split_repair`: a non-finite
  center re-seated by one Lemma-1 split of the highest-energy donor);
- :func:`streaming_violations`: the eviction-side counters ``[stale,
  occupancy, floor]``;
- :class:`DriftGuard`, :func:`init_drift_guard`, :func:`drift_guard_step`:
  per-center EWMA bands over the decayed counts and the batch energy,
  which flag starved and dying centers each ``partial_fit`` fold;
- :func:`repair_dying_centers`: re-seat flagged centers by one Lemma-1
  ``projective_split`` of the highest-energy donor, then one full
  re-sort.

The counters only count, in int64 (exact in any order, so the card and
the CPU agree). The repair's bookkeeping is host-side numpy, as the
reference's: decayed member masses ``w * decay^age`` summed in f64,
where ``decay^age`` is :func:`core.engine.decay_pow` (f64 binary
exponentiation, the one form the port uses, in place of the reference's
``np.power``).

The heal is host-side and rare, as the reference's. It differs from the
reference in its arithmetic only where the port's paths do everywhere:
the donors' energies are correctly rounded squared distances summed in
f64 in row order, the untrusted rows are re-assigned through K5 (the
correctly rounded argmin), and the split runs
:func:`core.gdi.projective_split` (K3), its two member draws from a CPU
``torch.Generator`` (``gdi._split_draws``) where the reference folds the
split's index into a ``jax.random`` key.

On a mesh (``K2Step(mesh=...)``, ``core.distributed``) each rank counts
its own shard's violations and :func:`make_guard` sums the lanes across
the shards, so every rank takes the same rung; :func:`heal_fit` then
gathers the assignment every shard recovers, heals the global arrays the
same way on every rank, and places the healed rows on the mesh again.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from ..core.engine import K2State, ResidentState, decay_pow, f32, init_state
from ..kernels.exact_round import exact_sqnorm
from ..kernels.ops import assign_nearest_kernel
from ..kernels.segment_sum import segment_sum_f64

VIOLATION_LANES = ("centers", "sums", "bounds", "arena")
STREAM_LANES = ("stale", "occupancy", "floor")


def resident_violations(state: ResidentState, *, n: int,
                        owned: torch.Tensor | None = None) -> torch.Tensor:
    """(4,) int64 violation counters of a resident state; ``n`` is the
    point count the arena covers. ``owned`` ((n,) bool) marks the ids
    expected to own a slot under a sliding window: an evicted id owns 0
    or 1 slots (re-parked by a re-sort), a live id exactly one. Default:
    every id owns exactly one."""
    k = state.fill.shape[0]
    s_total = state.pid.shape[0]
    nbt = state.b2c.shape[0]
    bn = s_total // nbt
    dev = state.pid.device
    nonfinite = lambda t: torch.sum(~torch.isfinite(t))  # noqa: E731
    centers = nonfinite(state.c)
    sums = (nonfinite(state.sums) + nonfinite(state.counts)
            + torch.sum(state.counts < 0))
    bounds = nonfinite(state.ug) + nonfinite(state.lo_g)
    arena = torch.sum((state.b2c < -1) | (state.b2c >= k))
    arena = arena + torch.sum((state.fill < 0) | (state.fill > bn))
    arena = arena + torch.sum(state.pid >= n)
    occ = torch.zeros((n,), dtype=torch.int64, device=dev).index_add_(
        0, torch.clamp(state.pid, 0, n - 1).long(),
        (state.pid >= 0).to(torch.int64))
    if owned is None:
        arena = arena + torch.sum(occ != 1)
    else:
        arena = arena + torch.sum(torch.where(owned, occ != 1, occ > 1))
    freeb = torch.repeat_interleave(state.b2c < 0, bn)
    arena = arena + torch.sum(freeb & (state.pid >= 0))
    ob = state.openb.long()
    has_open = ob >= 0
    obc = state.b2c[torch.clamp(ob, 0, nbt - 1)]
    kk = torch.arange(k, device=dev)
    arena = arena + torch.sum(torch.where(
        has_open, (obc != kk) | (state.fill < 1), state.fill != 0))
    lanes = torch.arange(bn, device=dev)
    tail_rows = torch.clamp(ob, 0, nbt - 1)[:, None] * bn + lanes[None, :]
    tail_pid = state.pid[torch.clamp(tail_rows, 0, s_total - 1)]
    in_tail = has_open[:, None] & (lanes[None, :] >= state.fill[:, None])
    arena = arena + torch.sum(in_tail & (tail_pid >= 0))
    return torch.stack([centers, sums, bounds, arena]).to(torch.int64)


def streaming_violations(state: ResidentState, e_pts: torch.Tensor,
                         w_pts: torch.Tensor, epoch_now: int, floor: float,
                         *, window: int) -> torch.Tensor:
    """(3,) int64 streaming counters: ``stale`` live slots older than the
    ``window`` newest epochs (eviction missed them); ``occupancy`` live
    slots whose mirror row is dead, plus the difference between the live
    slot and live mirror-row counts; ``floor`` decayed counts under the
    freeze floor."""
    cap = e_pts.shape[0]
    live = (state.pid >= 0) & (state.wg > 0)
    idx = torch.clamp(state.pid, 0, max(cap - 1, 0)).long()
    if window:
        eg = torch.where(live, e_pts[idx], epoch_now)
        stale = torch.sum(live & (eg < epoch_now - window + 1))
    else:
        stale = torch.zeros((), dtype=torch.int64, device=live.device)
    mirror_live = torch.where(live, w_pts[idx] > 0, True)
    occ = torch.sum(~mirror_live) + torch.abs(
        torch.sum(live) - torch.sum(w_pts > 0))
    fl = torch.tensor(f32(floor), dtype=torch.float32,
                      device=state.counts.device)
    under = torch.sum(state.counts < fl - 1e-6 * (1.0 + fl))
    return torch.stack([stale, occ, under]).to(torch.int64)


def k2_violations(state: K2State, *, n: int) -> torch.Tensor:
    """(4,) int64 violation counters of a rebuild-residency state (no
    arena and no running sums: the sums lane counts out-of-range
    assignments, the arena lane is 0)."""
    del n
    k = state.c.shape[0]
    nonfinite = lambda t: torch.sum(~torch.isfinite(t))  # noqa: E731
    return torch.stack([
        nonfinite(state.c), torch.sum((state.a < 0) | (state.a >= k)),
        nonfinite(state.u) + nonfinite(state.lo),
        torch.zeros((), dtype=torch.int64, device=state.c.device)]
    ).to(torch.int64)


def make_guard(sb, n: int):
    """``guard(state) -> (4,)`` violation counters for a
    :class:`core.engine.K2Step`; ``n`` is the (padded, global) row count.
    On a mesh each shard counts over its own rows and the lanes are
    summed across the shards."""
    fn = resident_violations if sb.residency == "resident" \
        else k2_violations
    n_loc, psum = n // sb.shards(), sb.psum()

    def guard(state):
        v = fn(state, n=n_loc)
        return v if psum is None else psum(v)
    return guard


def recover_assignment_np(pid, b2c, bn: int, n: int) -> np.ndarray:
    """Best-effort point-order assignment from a (possibly corrupted)
    arena, on the host. Rows claimed by zero or several slots, or by a
    slot of an out-of-range cluster, come back as -1: *untrusted*, to be
    re-assigned exactly by the healer."""
    pid = np.asarray(pid).astype(np.int64)
    b2c = np.asarray(b2c).astype(np.int64)
    a = np.full((n,), -1, np.int64)
    a_slot = np.repeat(np.clip(b2c, 0, None), bn)
    owned = (pid >= 0) & (pid < n)
    occ = np.zeros((n,), np.int64)
    np.add.at(occ, pid[owned], 1)
    trust = occ[pid[owned]] == 1
    a[pid[owned][trust]] = a_slot[owned][trust]
    return a


def split_repair(x, w, a, c, bad, generator: torch.Generator | None = None,
                 counter=None):
    """Quarantine the ``bad`` (non-finite) centers and re-seat each with
    one Lemma-1 split of the highest-energy healthy donor cluster
    (``core.gdi.projective_split``): the donor keeps side A, the repaired
    center takes side B and its members. Without a donor of >= 2 members
    the center is re-seated on a live row. ``generator``: the CPU
    generator of the splits' draws. Returns (c, a); every split lands on
    ``counter.repairs["split"]``."""
    from ..core.gdi import projective_split
    k = c.shape[0]
    c = torch.where(torch.isfinite(c), c, 0.0)
    a = a.to(torch.int32)
    bad_set = set(int(b) for b in bad)
    wpos = w > 0
    live = np.flatnonzero(wpos.cpu().numpy())
    for i, j in enumerate(sorted(bad_set)):
        d2 = exact_sqnorm(x - c[a.long()])
        if counter is not None:   # donor-energy scan: n residual distances
            counter.add_distances(x.shape[0])
        e = segment_sum_f64(w * d2, a.long(), k).cpu().numpy()
        e = e.astype(np.float64)
        cnt = segment_sum_f64(w, a.long(), k).cpu().numpy()
        e[list(bad_set)] = -np.inf
        e[cnt < 2] = -np.inf
        donor = int(np.argmax(e))
        if not np.isfinite(e[donor]):
            seat = int(live[i % max(live.size, 1)]) if live.size else 0
            c = c.clone()
            c[j] = x[seat]
        else:
            mask = (a == donor) & wpos
            _ma, mb, ca, cb, _pa, _pb = projective_split(x, mask, generator)
            c = c.clone()
            c[donor] = ca
            c[j] = cb
            a = torch.where(mb, j, a).to(torch.int32)
        bad_set.discard(j)
        if counter is not None:
            counter.count_repair("split")
    return c, a


def heal_fit(x, w, state, sb, n: int, counter, generator, vio):
    """Repair a fit loop's (x, w, state) after a guard fired.

    ``sb`` is the :class:`core.engine.K2Step` the loop built its step
    from; ``vio`` the host (4,) violation counters; ``generator`` the CPU
    generator of the split rung's draws. Takes the cheapest sufficient
    rung of the repair lattice (module docstring) and returns the healed
    (x, w, state), which always carries ``first=True``, so the next
    iteration recomputes every live row exactly.

    On a mesh, ``x``/``w`` are the global (padded, ``n``-row) arrays every
    rank holds on the host and ``state`` this rank's shard on its card:
    the assignment is gathered, every rank heals the same global arrays
    alike (the split's draws from the same generator; its scan brings
    every row to the card for the repair only), and the state is rebuilt
    over this rank's rows of the healed arrays. The healed (x, w) come
    back where ``x`` and ``w`` were.
    """
    resident = sb.residency == "resident"
    mesh = sb.mesh
    vio = np.asarray(vio)
    dev = state.c.device
    only_bounds = bool(vio[2]) and not (vio[0] or vio[1] or vio[3])
    if only_bounds:
        # cheapest rung: the stale-zero safe loose state
        if resident:
            zeros = torch.zeros_like(state.ug)
            state = state._replace(ug=zeros, lo_g=zeros.clone(), first=True)
        else:
            zeros = torch.zeros_like(state.u)
            state = state._replace(u=zeros, lo=zeros.clone(), first=True)
        counter.count_repair("bound_reset")
        return x, w, state

    k = state.c.shape[0]
    x_h = x.cpu().numpy().astype(np.float32)
    w_h = w.cpu().numpy().astype(np.float32)

    # 1. quarantine non-finite rows (weight 0, zeroed features)
    bad_rows = ~np.isfinite(x_h).all(axis=1)
    n_sanitized = int((bad_rows & (w_h > 0)).sum())
    if bad_rows.any():
        x_h[bad_rows] = 0.0
        w_h[bad_rows] = 0.0
    if n_sanitized:
        counter.count_sanitized_rows(n_sanitized)

    # 2. best-effort assignment recovery from the surviving state
    n_loc = n // sb.shards()
    if resident:
        pid_h, b2c_h = state.pid.cpu().numpy(), state.b2c.cpu().numpy()
        a_loc = torch.from_numpy(recover_assignment_np(
            pid_h, b2c_h, pid_h.shape[0] // b2c_h.shape[0], n_loc)).to(dev)
    else:
        a_loc = state.a.to(torch.int64)
    a_h = (a_loc if mesh is None else mesh.gather_rows(a_loc)) \
        .cpu().numpy().astype(np.int64)
    a_h[(a_h < 0) | (a_h >= k)] = -1
    untrusted = a_h < 0
    a_h[untrusted] = 0                    # placeholder until re-assigned

    # 3. quarantine + split-repair non-finite centers
    c_h = state.c.cpu().numpy().astype(np.float32)
    bad_centers = np.flatnonzero(~np.isfinite(c_h).all(axis=1))
    c_dev = torch.from_numpy(np.where(np.isfinite(c_h), c_h, 0.0)).to(dev)
    x_out = torch.from_numpy(x_h).to(x.device)
    if bad_centers.size:
        x_dev = x_out.to(dev)
        # untrusted rows must not anchor a split: weight them out of the
        # donor-energy scan (they are re-assigned exactly right after)
        w_trust = torch.from_numpy(np.where(untrusted, 0.0, w_h).astype(
            np.float32)).to(dev)
        c_dev, a_dev = split_repair(
            x_dev, w_trust, torch.from_numpy(a_h.astype(np.int32)).to(dev),
            c_dev, bad_centers, generator, counter)
        a_h = a_dev.cpu().numpy().astype(np.int64)

    # 4. exact re-assignment of the untrusted live rows
    unc = np.flatnonzero(untrusted & (w_h > 0))
    if unc.size:
        au, _ = assign_nearest_kernel(torch.from_numpy(x_h[unc]).to(dev),
                                      c_dev)
        counter.add_distances(int(unc.size) * k)
        a_h[unc] = au.cpu().numpy()
    a_all = torch.from_numpy(a_h.astype(np.int32)).to(x.device)

    # 5. rebuild the loop state from the healed primals (this rank's rows
    # of them on a mesh)
    w_out = torch.from_numpy(w_h).to(w.device)
    x_s, w_s, a_s = x_out, w_out, a_all
    if mesh is not None:
        from ..launch.sharding import shard_rows
        x_s, w_s, a_s = (shard_rows(t, mesh) for t in (x_s, w_s, a_s))
    x_s, w_s, a_s = (t.to(dev) for t in (x_s, w_s, a_s))
    if resident:
        state = sb.init_resident(x_s, w_s, c_dev, a_s)
        counter.count_repair("regroup")
    else:
        state = init_state(c_dev, a_s, min(sb.kn, k))
        counter.count_repair("bound_reset")
    return x_out, w_out, state


class DriftGuard(typing.NamedTuple):
    """Per-center EWMA bands of the drift detector: the decayed count and
    the batch's within-cluster energy, and ``it``, the folds observed (a
    host int: it gates the warm-up)."""
    cnt_ewma: torch.Tensor   # (k,)
    en_ewma: torch.Tensor    # (k,)
    it: int


def init_drift_guard(k: int, device=None) -> DriftGuard:
    z = torch.zeros((k,), dtype=torch.float32, device=device)
    return DriftGuard(z, z.clone(), 0)


def drift_guard_step(dg: DriftGuard, counts: torch.Tensor,
                     energy: torch.Tensor, floor: float, beta: float = 0.2,
                     dying_frac: float = 0.05, warmup: int = 8):
    """One observation. ``counts``: the decayed counts after the fold;
    ``energy``: the batch's ``sum w d^2(x, c_a)`` per center. A center is
    *starved* when its mass sits at the floor (``counts <= 2 floor``, or
    empty at floor 0) and *dying* when its count fell under half its
    EWMA and under ``dying_frac`` of the mean center mass (the mean's sum
    in f64 in row order, rounded once, so the card flags what the CPU
    flags). Flags
    stay off for the first ``warmup`` observations. The energy EWMA ranks
    donors for :func:`repair_dying_centers`. Arithmetic in f32 as the
    reference's. Returns ``(dg', flags (k,) bool)``."""
    dev = counts.device
    b = torch.tensor(beta, dtype=torch.float32, device=dev)
    if dg.it == 0:
        cnt2, en2 = counts, energy
    else:
        cnt2 = (1.0 - b) * dg.cnt_ewma + b * counts
        en2 = (1.0 - b) * dg.en_ewma + b * energy
    if dg.it < warmup:
        flags = torch.zeros(counts.shape, dtype=torch.bool, device=dev)
    else:
        fl = torch.tensor(f32(floor), dtype=torch.float32, device=dev)
        starved = counts <= 2.0 * fl + 1e-30
        total = segment_sum_f64(counts, torch.zeros_like(counts,
                                                         dtype=torch.int64),
                                1)[0]
        mean = total / counts.shape[0]
        dying = (counts < 0.5 * dg.cnt_ewma) & (counts < dying_frac * mean)
        flags = starved | dying
    return DriftGuard(cnt2, en2, dg.it + 1), flags


def repair_dying_centers(model, dying: torch.Tensor, *, counter=None,
                         max_repairs: int = 4) -> int:
    """Re-seat the worst flagged centers.

    Each repair is one ``core.gdi.projective_split`` of the donor with
    the highest energy EWMA (and >= 2 live members): the donor keeps side
    A, the victim (the flagged center with the least decayed count) takes
    side B and its rows. The touched centers' counts are recomputed from
    the mirrors (``w * decay^age`` summed in f64 on the host, clamped at
    the floor) with sums re-anchored to ``c * counts``. Up to
    ``max_repairs`` victims a call, each donor used once; then one full
    re-sort of the arena. Every repair lands on
    ``counter.repairs["split"]``. The split draws come from a CPU
    generator seeded with ``model.batches_seen`` (the reference keys them
    with ``PRNGKey(batches_seen)``). Returns the number of centers
    re-seated (0 without an arena or a donor)."""
    from ..core.gdi import projective_split
    from ..core.model import _arena_resort
    if not model.has_arena:
        return 0
    dying_idx = np.flatnonzero(dying.cpu().numpy()).tolist()
    if not dying_idx:
        return 0
    st = model.state
    k = model.k
    generator = torch.Generator().manual_seed(model.batches_seen)
    counts_h = st.counts.cpu().numpy().astype(np.float64)
    a_h = model.a_pts.cpu().numpy().astype(np.int64)
    w_h = model.w_pts.cpu().numpy().astype(np.float64)
    live = w_h > 0
    age = model.batches_seen - 1 - model.e_pts.cpu().to(torch.int64)
    pw = decay_pow(model.stream_decay, age, model.batches_seen).numpy()
    w_eff = np.where(live, w_h * pw, 0.0)
    en = (model._dg.en_ewma.cpu().numpy().astype(np.float64)
          if model._dg is not None else counts_h.copy())
    en[np.asarray(dying_idx, np.int64)] = -np.inf
    c2, sums2, counts2 = st.c.clone(), st.sums.clone(), st.counts.clone()
    repaired = 0
    while dying_idx and repaired < max_repairs:
        member_cnt = np.bincount(a_h[live], minlength=k)
        en_now = en.copy()
        en_now[member_cnt < 2] = -np.inf
        donor = int(np.argmax(en_now))
        if not np.isfinite(en_now[donor]):
            break
        victim = int(min(dying_idx, key=lambda j: counts_h[j]))
        dying_idx.remove(victim)
        mask = torch.from_numpy(live & (a_h == donor)).to(model.x_pts.device)
        _ma, mb, ca, cb, _pa, _pb = projective_split(model.x_pts, mask,
                                                     generator)
        a_h = np.where(mb.cpu().numpy(), victim, a_h)
        en[donor] = -np.inf          # stale after the split: use once
        for j, cj in ((donor, ca), (victim, cb)):
            cnt_j = f32(max(float(w_eff[(a_h == j) & live].sum()),
                            model.count_floor))
            cnt_t = torch.tensor(cnt_j, dtype=torch.float32,
                                 device=cj.device)
            counts2[j] = cnt_t
            sums2[j] = cj * cnt_t
        c2[donor] = ca
        c2[victim] = cb
        repaired += 1
        if counter is not None:
            counter.count_repair("split")
    if not repaired:
        return 0
    model.a_pts = torch.from_numpy(a_h.astype(np.int32)).to(
        model.a_pts.device)
    xg, pid, wg, b2c, fill, openb = _arena_resort(
        model.x_pts, model.a_pts, model.w_pts, k=k, bn=model.bn,
        nbt=st.b2c.shape[0])
    model.state = st._replace(c=c2, sums=sums2, counts=counts2, xg=xg,
                              pid=pid, wg=wg, b2c=b2c, fill=fill,
                              openb=openb)
    return repaired
