"""Distributed k²-means over ``torch.distributed`` (port of
``repro.core.distributed``).

One process per shard: every rank calls the fit with the same global
``x`` and the same :class:`launch.mesh.Mesh`, keeps its own rows (the
``launch.sharding`` row placement: n padded to a multiple of the shard
count with duplicate head rows at weight 0) and runs the engine's
iteration on them (:class:`core.engine.K2Step` with ``mesh=``, K1 over
each shard's arena on ``backend="kernels"``); centers and the k_n-NN
graph are replicated, and the center sums, the resident deltas and the
statistics are summed across the shards in shard order
(:meth:`launch.mesh.Mesh.sum`), so every rank holds the same centers and
returns the same :class:`KMeansResult`, with the full (n,) assignment.
The global rows stay on the host: each rank's card holds its shard (and
its arena), never the whole of ``x``, so the data may outgrow one card.
Only the replicated inits (``kmeanspp``, ``gdi_replicated``) and a heal's
split rung bring every row to the card, for their own duration.

Convergence is the summed changed count, read at the monitor flush, as on
one device: the rebuild iteration reads nothing else, the resident one
its one host read of the re-sort triggers (after a cross-shard sum of the
overflow flag).

``init="gdi"`` is the shard-aware seed: each shard runs a fixed number of
greedy frontier rounds (``core.gdi.gdi_fixed_rounds``, K3) on its own
rows toward k local leaves, the P·k leaf centers are gathered, and a
weighted Lloyd over them (:func:`_gdi_merge`) merges them to k; each row
inherits its leaf's meta-cluster, so no full assignment pass is needed.
A shard's round draws come from a CPU generator seeded from (seed,
shard index), where the reference folds the shard index into its key.
``init="gdi_replicated"`` runs the device GDI on every rank.

The bound-free legacy step (``backend="legacy"``,
:func:`make_distributed_k2means_step`) recomputes every row's k_n
candidates every iteration: the baseline the bounded engine is held
against.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..device import as_tensor
from ..kernels.ops import grouped_capacity, segment_sum_ordered
from ..launch.mesh import dp_axes
from ..launch.sharding import Rows, pad_rows, shard_rows
from .distance import (bottom_k, chunked_argmin_sqdist,
                       chunked_candidate_argmin, sqnorm)
from .engine import K2State, K2Step, center_knn_graph, init_state
from .lloyd import KMeansResult
from .opcount import OpCounter

_SHARDED_INITS = ("random", "kmeanspp", "gdi", "gdi_replicated")
_BACKENDS = ("kernels", "xla", "legacy")


def _axes(mesh, data_axes) -> tuple:
    return tuple(data_axes) if data_axes else dp_axes(mesh)


def _nshards(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _psum(mesh, axes):
    return lambda *ts: mesh.sum(*ts, axes=axes)


def make_distributed_k2means_step(mesh, kn: int, k: int, *, data_axes=None,
                                  chunk: int = 2048):
    """The legacy bound-free step: ``step(x, w, c, a) -> (c', a', energy,
    changed)`` on this shard's rows. The replicated k_n-NN graph (K2),
    every row's restricted argmin over its center's list, the summed mean
    update; ``energy`` is the post-update energy and ``changed`` the
    summed count of flips (padding rows, ``w = 0``, never count)."""
    psum = _psum(mesh, _axes(mesh, data_axes))

    def step(x, w, c, a):
        neighbors = center_knn_graph(c, kn)
        a_new, _ = chunked_candidate_argmin(x, c, neighbors[a.long()],
                                            chunk=chunk)
        al = a_new.long()
        sums, counts, changed = psum(
            segment_sum_ordered(x * w[:, None], al, k),
            segment_sum_ordered(w, al, k),
            torch.sum((a_new != a) & (w > 0)))
        c_new = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts, min=1.0)[:, None], c)
        energy = psum(torch.sum(w * sqnorm(x - c_new[al])))
        return c_new, a_new, energy, changed
    return step


def make_distributed_lloyd_step(mesh, k: int, *, data_axes=None):
    """Sharded full-assignment Lloyd step: ``step(x, w, c) -> (c', a,
    energy)`` on this shard's rows, the assignment through K5."""
    psum = _psum(mesh, _axes(mesh, data_axes))

    def step(x, w, c):
        a, dmin = chunked_argmin_sqdist(x, c)
        al = a.long()
        sums, counts, energy = psum(
            segment_sum_ordered(x * w[:, None], al, k),
            segment_sum_ordered(w, al, k), torch.sum(w * dmin))
        c_new = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts, min=1.0)[:, None], c)
        return c_new, a, energy
    return step


def make_distributed_assign(mesh, k: int, *, data_axes=None):
    """Sharded full assignment (no update) through K5: ``assign(x, c) ->
    a`` on this shard's rows; seeds k²-means so the sharded trajectory
    matches the single-device one."""
    del mesh, k, data_axes

    def assign(x, c):
        return chunked_argmin_sqdist(x, c)[0]
    return assign


# ---------------------------------------------------------------------------
# Shard-aware GDI seeding
# ---------------------------------------------------------------------------


def shard_generator(seed: int, shard: int) -> torch.Generator:
    """The CPU generator of shard ``shard``'s seed rounds."""
    mix = np.random.SeedSequence([int(seed), int(shard)])
    return torch.Generator().manual_seed(int(mix.generate_state(1)[0]))


def make_distributed_gdi_seed(mesh, k: int, *, data_axes=None,
                              split_iters: int = 2, bn: int = 8,
                              rounds: int | None = None,
                              frontier: float = 0.125):
    """Per-shard frontier rounds toward ``k`` local leaves
    (:func:`core.gdi.gdi_fixed_rounds` on this shard's rows). Returns
    ``seed(x, seed, draws=None) -> (leaf_ids, centers, weights)``:
    ``leaf_ids`` (this shard's rows) in the global leaf space, shard p
    owning slots [p*k, (p+1)*k); ``centers`` (P*k, d) and ``weights``
    (P*k,) gathered in the same slot order (weights = member counts, 0
    on dead slots). ``draws``: this shard's per-round (g1, g2) uniforms
    (tests feed the reference's); else from :func:`shard_generator`."""
    from .gdi import gdi_fixed_rounds
    del data_axes      # the shards are the mesh's (the fit checks)

    def seed_fn(x, seed: int, draws=None):
        idx = mesh.index
        a, centers, _energies, sizes, nleaf = gdi_fixed_rounds(
            x, k, rounds=rounds, split_iters=split_iters, bn=bn,
            frontier=frontier, draws=draws,
            generator=None if draws is not None
            else shard_generator(seed, idx))
        live = torch.arange(k, device=x.device) < nleaf
        weights = torch.where(live, sizes, 0).to(x.dtype)
        return (a + idx * k, mesh.gather_rows(centers),
                mesh.gather_rows(weights))
    return seed_fn


def _gdi_merge(centers_g: torch.Tensor, weights_g: torch.Tensor, k: int,
               iters: int = 8):
    """Weighted Lloyd over the P·k leaf centers down to k meta-centers,
    replicated (O(P·k²·d) an iteration over centers, never points);
    weight-0 slots never move a meta-center. Starts from shard 0's
    leaves, a dead slot taking the heaviest leaves instead (ties to the
    lower slot). Returns (meta (k, d), leaf2meta (P*k,) int32)."""
    heavy = bottom_k(-weights_g[None], k)[0].long()
    c = torch.where((weights_g[:k] > 0)[:, None], centers_g[:k],
                    centers_g[heavy])
    a = torch.zeros((centers_g.shape[0],), dtype=torch.int32,
                    device=centers_g.device)
    for _ in range(iters):
        a = chunked_argmin_sqdist(centers_g, c)[0]
        al = a.long()
        sums = segment_sum_ordered(centers_g * weights_g[:, None], al, k)
        cnts = segment_sum_ordered(weights_g, al, k)
        c = torch.where(cnts[:, None] > 0,
                        sums / torch.clamp(cnts, min=1.0)[:, None], c)
    return c, a


def _sharded_gdi_seed(x, k: int, mesh, seed: int, data_axes, counter, *,
                      split_iters: int = 2, frontier: float = 0.125,
                      merge_iters: int = 8, draws=None):
    """``init="gdi"``: frontier rounds per shard, the merge of the P·k
    leaves to k, and each row's meta-cluster through its leaf. ``x`` is
    this shard's rows. Charges ``rounds * P`` rounds of the shard's
    layout and ``merge_iters * P·k * k`` distances. Returns (centers (k,
    d), a0 (this shard's rows,) int32)."""
    from .gdi import _charge_round, frontier_round_bound
    n_loc, d = x.shape
    nsh = _nshards(mesh, data_axes)
    bn = 8            # the reference's xla seed: least grouped padding
    # +2 slack rounds absorb failed splits on degenerate leaves; surplus
    # rounds change nothing once a shard has k leaves
    rounds = frontier_round_bound(k, frontier) + 2
    seed_fn = make_distributed_gdi_seed(
        mesh, k, data_axes=data_axes, split_iters=split_iters, bn=bn,
        rounds=rounds, frontier=frontier)
    leaf_ids, centers_g, weights_g = seed_fn(x, seed, draws)
    r_loc = grouped_capacity(n_loc, k, bn) * bn
    for _ in range(rounds * nsh):          # every shard runs each round
        _charge_round(counter, r_loc, n_loc, d, split_iters)
    meta, leaf2meta = _gdi_merge(centers_g, weights_g, k, merge_iters)
    counter.add_distances(merge_iters * centers_g.shape[0] * k)
    return meta, leaf2meta[leaf_ids.long()]


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------


def _adopt(counter: OpCounter, state: dict) -> None:
    """Make ``counter`` hold another rank's counter ``state``."""
    for name, val in state.items():
        setattr(counter, name, val)


def fit_distributed_k2means(x_global, k: int, kn: int, mesh, key=None, *,
                            max_iters: int = 50, init_centers=None,
                            init: str = "random", backend: str = "kernels",
                            counter: OpCounter | None = None,
                            monitor_every: int = 1, chunk: int = 2048,
                            bn: int | None = None, bkn: int = 8,
                            data_axes=None, split_iters: int = 2,
                            residency: str | None = None,
                            regroup_every: int = 16,
                            move_cap: int | None = None,
                            guards: bool | None = None,
                            ckpt_dir: str | None = None,
                            ckpt_every: int = 0, resume: bool = False,
                            straggler_policy=None, gdi_draws=None,
                            profile: bool = False) -> KMeansResult:
    """The host loop around the sharded engine step, run by every rank
    of ``mesh`` with the same ``x_global`` (n, d), which stays on (or
    is copied to) the host: only this rank's rows go to its card.

    Trajectory-equivalent to the single-device ``fit_k2means`` with the
    same ``backend`` from the same init (seeded by assignment only),
    with the centers equal to it within f32 reduction order (the sums
    are added per shard, then across shards); with one shard, equal to
    it bit for bit. ``key``: a ``torch.Generator`` on the mesh's device,
    or a seed (default 0), the same on every rank; it draws the
    ``random``, ``kmeanspp`` and ``gdi_replicated`` inits, seeds the
    sharded GDI's per-shard CPU generators and the heal's split draws.

    ``backend``: ``"kernels"`` (the reference's ``"pallas"``: K1 over
    each shard's grouped layout), ``"xla"`` (the ungrouped bounded step)
    or ``"legacy"`` (the bound-free baseline step). ``residency``:
    ``"resident"`` (each shard's arena repaired in place, the deltas
    summed across shards) or ``"rebuild"``; None resolves to resident on
    kernels and rebuild otherwise. ``init``: one of
    ``("random", "kmeanspp", "gdi", "gdi_replicated")``, ignored when
    ``init_centers`` is given; ``gdi_draws``: this rank's shard's
    per-round seed draws (tests feed the reference's).

    Counted ops charge as the single-device fit does, from the summed
    statistics; a statistic is read at the monitor flush only.

    Self-healing, as ``fit_k2means``: an active ``ft.chaos.FaultInjector``
    corrupts the (global) inputs and the state at iteration boundaries,
    the guards (``guards``; default on iff an injector is active) sum
    their lanes across shards at each flush and heal through
    ``ft.invariants.heal_fit``, and ``ckpt_dir``/``ckpt_every``/
    ``resume`` checkpoint (shard 0 writes) and restart. A simulated host
    loss (the injector's ``drop_host``) or a ``straggler_policy``
    escalation on any rank fails over: the live state is gathered to a
    host snapshot (and checkpointed when configured), ``ft.plan_remesh``
    picks the survivors, every rank joins the survivor mesh's group, the
    dropped or cordoned ranks leave the shard loop and take the result by
    broadcast at the end, and the survivors resume from the snapshot with
    a full recompute (one ``restore`` repair). Failover needs a mesh over
    every rank of the process group. ``profile=True`` attaches the
    counter's profile and the seconds of the init and the iterations
    (each ended by a device synchronize) to ``result.profile``.
    """
    from .. import ft
    from ..ft import chaos as chaos_mod
    from ..ft.invariants import heal_fit, make_guard
    from .k2means import _heal_generator, _MonitorLoop

    counter = counter or OpCounter()
    if monitor_every < 1:
        raise ValueError(f"monitor_every must be >= 1, got {monitor_every}")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")
    dev = mesh.device
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(0 if key is None else key)
    seed = gen.initial_seed()

    def clock():
        if profile and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    t0 = clock()
    x_global = as_tensor(x_global, torch.device("cpu"))
    n, d = x_global.shape
    kn = min(kn, k)
    data_axes = _axes(mesh, data_axes)
    if set(data_axes) != set(dp_axes(mesh)):
        raise ValueError(f"the rows are placed over every data axis of "
                         f"the mesh {dp_axes(mesh)}, got {data_axes}")
    nsh = _nshards(mesh, data_axes)
    if residency is None:
        residency = "resident" if backend == "kernels" else "rebuild"
    resident = backend != "legacy" and residency == "resident"
    # duplicate-row padding: weight 0 in the iteration; duplicates are
    # harmless to the divisive seeding (they only re-weight split scans)
    xp, wp = pad_rows(x_global, nsh)
    x_loc, w_loc = Rows(mesh).place(xp), Rows(mesh).place(wp)

    inj = chaos_mod.active()
    if guards is None:
        guards = inj is not None
    ckpt = ft.FitCheckpointer(ckpt_dir, every=ckpt_every) \
        if ckpt_dir else None
    it0 = 0
    a0 = None                  # this shard's initial assignment
    b_host = None              # rebuild-residency Hamerly state {u, lo, nb}
    if resume and ckpt is not None:
        got = ckpt.latest(n, k, d)
        if got is not None:
            # checkpoints are mesh-independent (c, a, it): re-pad and take
            # this shard's rows
            it0, c_h, a_h, b_host = got
            init_centers = c_h
            a0 = shard_rows(pad_rows(torch.from_numpy(a_h), nsh)[0], mesh)
            counter.count_repair("restore")

    # --- initialization (skipped on resume) -------------------------------
    if init_centers is None:
        if init == "random":
            # random_init's draw, on the card; its rows from the host
            idx = torch.randperm(n, generator=gen, device=dev)[:k]
            init_centers = x_global[idx.cpu()]
        elif init == "kmeanspp":
            from .kmeanspp import kmeanspp_init
            # replicated: every row on the card for the init's duration
            init_centers = kmeanspp_init(x_global.to(dev), k, gen, counter)
        elif init == "gdi":
            init_centers, a0 = _sharded_gdi_seed(
                x_loc, k, mesh, seed, data_axes, counter,
                split_iters=split_iters, draws=gdi_draws)
        elif init == "gdi_replicated":
            from .gdi import gdi_device_init
            init_centers, a_real = gdi_device_init(
                x_global, k, generator=gen, counter=counter, device=dev)
            a0 = shard_rows(pad_rows(a_real, nsh)[0], mesh)
        else:
            raise ValueError(f"unknown init {init!r}; expected one of "
                             f"{_SHARDED_INITS}")
    c = as_tensor(init_centers, dev)
    if tuple(c.shape) != (k, d):
        raise ValueError(f"init_centers of shape {tuple(c.shape)}, "
                         f"expected ({k}, {d})")
    if a0 is None:
        a0 = make_distributed_assign(mesh, k)(x_loc, c)
        counter.add_distances(n * k)
    a0 = as_tensor(a0, dev, torch.int32)
    t1 = clock()

    # --- iteration: one epoch per mesh incarnation ----------------------
    # A failover snapshots the mesh-independent (c, a, bounds), replans
    # the survivor mesh, re-places, and starts the next epoch from the
    # last completed iteration.
    mon = _MonitorLoop(counter, n=n, d=d, k=k, kn=kn, resident=resident)
    heal_gen = _heal_generator(seed) if guards else None
    root, cur, cur_axes = mesh, mesh, data_axes
    failed_over = False
    epoch_it0 = it0
    c_host = a_host = None
    while True:
        if cur.index is None:
            # this rank left the mesh: follow the survivors' messages
            msg = root.broadcast_object(None, src=cur.ranks[0])
            if msg[0] == "done":
                return _finished(msg[1], counter, dev)
            cur = root.submesh(msg[1])
            continue
        nsh_e = _nshards(cur, cur_axes)
        # the global (padded) rows on the host, this shard's on the card
        if cur is mesh:
            xg_e, wg_e, x_e, w_e = xp, wp, x_loc, w_loc
            c_e, a_e = c, a0
        else:
            xg_e, wg_e = pad_rows(x_global, nsh_e)
            x_e, w_e = Rows(cur).place(xg_e), Rows(cur).place(wg_e)
            c_e = torch.from_numpy(c_host).to(dev)
            a_e = shard_rows(pad_rows(torch.from_numpy(a_host), nsh_e)[0],
                             cur).to(dev)
        n_pad_e = xg_e.shape[0]
        x_loc = w_loc = None        # the epoch's shard is x_e, w_e

        sb = state = legacy = None
        if backend == "legacy":
            legacy = make_distributed_k2means_step(cur, kn, k,
                                                   data_axes=cur_axes,
                                                   chunk=chunk)
        else:
            sb = K2Step(k=k, kn=kn, backend=backend, mesh=cur,
                        data_axes=cur_axes, chunk=chunk, bn=bn, bkn=bkn,
                        residency=residency, regroup_every=regroup_every,
                        move_cap=move_cap)
            step = sb.build(n_pad_e, d)
            if resident:
                state = sb.init_resident(x_e, w_e, c_e, a_e)
            elif b_host is not None and b_host["nb"].shape == (k, kn):
                # the restored or carried Hamerly state resumes the gated
                # trajectory bit for bit (pad rows copy the head rows'
                # bounds: weight 0, they move nothing)
                def rows(v):
                    return shard_rows(pad_rows(torch.from_numpy(v),
                                               nsh_e)[0], cur).to(dev)
                state = K2State(c_e, a_e, rows(b_host["u"]),
                                rows(b_host["lo"]),
                                torch.from_numpy(b_host["nb"]).to(dev),
                                False)
            else:
                state = init_state(c_e, a_e, kn)
        guard = make_guard(sb, n_pad_e) if (guards and sb is not None) \
            else None

        def snapshot():
            """Mesh-independent host (c, a, bounds) of the live state:
            bounds are the point-order Hamerly state of the rebuild
            engines (None otherwise: legacy is stateless, resident
            rebuilds loose)."""
            bounds = None
            if backend == "legacy":
                c_s, a_s = c_e, cur.gather_rows(a_e)
            elif resident:
                c_s, a_s = state.c, sb.final_assignment(state, n_pad_e)
            else:
                c_s, a_s = state.c, cur.gather_rows(state.a)
                bounds = {"u": cur.gather_rows(state.u).cpu().numpy()[:n],
                          "lo": cur.gather_rows(state.lo).cpu().numpy()[:n],
                          "nb": state.prev_nb.cpu().numpy()}
            return (c_s.cpu().numpy().astype(np.float32),
                    a_s.cpu().numpy().astype(np.int32)[:n], bounds)

        failover_drop = None
        for it in range(epoch_it0 + 1, max_iters + 1):
            t_it = time.perf_counter()
            if inj is not None:
                inj.check_preempt(it)
                inj.maybe_stall(it)
                xg_c, wg_c = inj.corrupt_inputs(it, xg_e, wg_e)
                if xg_c is not xg_e or wg_c is not wg_e:
                    xg_e, wg_e = xg_c, wg_c
                    x_e, w_e = Rows(cur).place(xg_e), Rows(cur).place(wg_e)
                if state is not None:
                    if resident:
                        state = inj.mirror_into_arena(state, xg_e, nsh_e,
                                                      shard=cur.index)
                    state = inj.corrupt_state(it, state, resident, mesh=cur)
                drop = inj.host_drop_at(it)
                if drop is not None and cur.size > 1:
                    failover_drop = drop
                    epoch_it0 = it - 1     # it never ran: replay it
                    break
            if backend == "legacy":
                c_e, a_e, energy_d, changed = legacy(x_e, w_e, c_e, a_e)
                # bound-free: every row recomputes, no grouped layout
                zero = torch.zeros((), dtype=torch.int64, device=dev)
                mon.pending.append((torch.tensor(n, device=dev), changed,
                                    energy_d, zero, zero))
            else:
                state, stats = step(x_e, w_e, state)
                mon.pending.append(tuple(stats))
            if it % monitor_every == 0 or it == max_iters:
                mon.flush()
                healed = False
                if guard is not None:
                    vio = guard(state).cpu().numpy()    # summed lanes
                    bad_energy = bool(mon.history) and \
                        not math.isfinite(mon.history[-1][1])
                    if vio.any() or bad_energy:
                        if bad_energy and not vio.any():
                            vio = np.array([0, 1, 0, 0])   # full heal
                        xg_e, wg_e, state = heal_fit(
                            xg_e, wg_e, state, sb, n_pad_e, counter,
                            heal_gen, vio)
                        x_e, w_e = Rows(cur).place(xg_e), \
                            Rows(cur).place(wg_e)
                        mon.converged = False
                        healed = True
                if ckpt is not None and not healed and ckpt.due(it):
                    c_s, a_s, b_s = snapshot()
                    if cur.index == 0:
                        ckpt.save(it, c_s, a_s, **(b_s or {}))
                if mon.converged:
                    break
            if straggler_policy is not None:
                slow = straggler_policy.observe(
                    time.perf_counter() - t_it) == "escalate"
                # every rank acts on the same verdict
                slow = int(cur.sum(torch.tensor(int(slow), device=dev)))
                if slow and cur.size > 1:
                    # cordon the straggler (the mesh's last rank in this
                    # host-local simulation) and fail over
                    failover_drop = cur.size - 1
                    epoch_it0 = it         # it completed: keep it
                    break
        if failover_drop is None:
            break                          # converged or max_iters done

        # --- failover: snapshot -> replan -> next epoch -----------------
        c_host, a_host, b_host = snapshot()
        if ckpt is not None and epoch_it0 > 0 and cur.index == 0:
            # coordinated-eviction checkpoint at the last completed step
            ckpt.save(epoch_it0, c_host, a_host, **(b_host or {}))
        survivors = [r for i, r in enumerate(cur.ranks)
                     if i != failover_drop % cur.size]
        plan = ft.plan_remesh(len(survivors), model_parallel=1)
        new_ranks = survivors[:plan["chips"]]
        root.broadcast_object(("remesh", new_ranks), src=cur.ranks[0])
        cur, cur_axes = root.submesh(new_ranks), ("data",)
        counter.count_repair("restore")
        failed_over = True

    # --- the result, on every rank ------------------------------------------
    if backend == "legacy":
        c_fin, a_fin = c_e, cur.gather_rows(a_e)
    elif resident:
        c_fin, a_fin = state.c, sb.final_assignment(state, n_pad_e)
    else:
        c_fin, a_fin = state.c, cur.gather_rows(state.a)
    if mon.history and math.isfinite(mon.history[-1][1]):
        energy = mon.history[-1][1]
    else:
        a_loc = shard_rows(a_fin, cur)
        energy = float(cur.sum(torch.sum(w_e * sqnorm(
            x_e - c_fin[a_loc.long()]))))
    out = {"c": c_fin, "a": a_fin[:n].contiguous(), "energy": energy,
           "iterations": mon.it_done, "history": mon.history}
    t2 = clock()
    if profile:
        out["profile"] = counter.profile() | {"init_s": t1 - t0,
                                              "iterate_s": t2 - t1}
    if failed_over:
        # the ranks that left the mesh wait for the result
        host = {key_: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for key_, v in out.items()}
        host["counter"] = dict(vars(counter))
        root.broadcast_object(("done", host), src=cur.ranks[0])
    return _result(out, counter)


def _result(out: dict, counter: OpCounter) -> KMeansResult:
    r = KMeansResult(out["c"], out["a"], out["energy"], out["iterations"],
                     counter.total, out["history"])
    r.profile = out.get("profile")
    return r


def _finished(host: dict, counter: OpCounter, dev) -> KMeansResult:
    """The survivors' result on a rank that left the mesh."""
    _adopt(counter, host.pop("counter"))
    out = {key: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                 else v) for key, v in host.items()}
    return _result(out, counter)


__all__ = ["fit_distributed_k2means", "make_distributed_assign",
           "make_distributed_gdi_seed", "make_distributed_k2means_step",
           "make_distributed_lloyd_step", "shard_generator"]
