"""k²-means — the paper's Algorithm 1 (port of ``repro.core.k2means``).

Per iteration: the k_n-NN graph over the centers, each point competing
only among the k_n neighbours of its current center with Hamerly bounds
that skip points whose assignment provably cannot change, and the mean
update. The iteration itself lives in :mod:`core.engine`; this module
is the fit loop, which keeps every statistic on the device and reads
them back every ``monitor_every`` iterations (the deferred host read),
with the self-healing hooks of DESIGN.md §11: an active
``ft.chaos.FaultInjector`` corrupts inputs and state at iteration
boundaries, the invariant guards (``ft.invariants.make_guard``) run at
each monitor flush and trigger the repair lattice
(``ft.invariants.heal_fit``), and ``ckpt_dir``/``ckpt_every``/``resume``
give the loop atomic mid-fit checkpoints and a restart
(``ft.FitCheckpointer``). Unused, the hooks cost nothing.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import as_tensor, resolve
from .distance import sqnorm
from .engine import K2State, K2Step, init_state
from .lloyd import KMeansResult
from .opcount import OpCounter, charge_iteration


class _MonitorLoop:
    """Deferred-host-read fit loop: stats stay on the device and are
    flushed (ops charged, convergence checked) every ``monitor_every``
    iterations, in one device-to-host read per flush."""

    def __init__(self, counter, *, n, d, k, kn, resident, precision="f32"):
        self.counter = counter
        self.args = dict(n=n, d=d, k=k, kn=kn, resident=resident,
                         precision=precision)
        self.pending = []
        self.history = []
        self.it_done = 0
        self.converged = False

    def flush(self):
        if self.pending:
            rows = torch.stack([torch.stack([torch.as_tensor(
                s, device=st[0].device).to(torch.float64) for s in st])
                for st in self.pending]).cpu().tolist()
        else:
            rows = []
        for stats in rows:
            self.it_done += 1
            energy = charge_iteration(self.counter, stats=stats,
                                      **self.args)
            self.history.append((self.counter.snapshot(), float(energy)))
            if self.it_done > 1 and int(stats[1]) == 0:
                self.converged = True   # fixed point: later pending
                break                   # iterations are identical, drop
        self.pending.clear()


def _heal_generator(key) -> torch.Generator:
    """The split rung's draws come from a CPU generator
    (``gdi._split_draws`` draws on the CPU, so every device splits
    alike): ``key`` itself, or one seeded with ``key`` (default 0)."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(0 if key is None else int(key))


def fit_k2means(x, centers, assignment, *, kn: int = 30,
                max_iters: int = 100, counter: OpCounter | None = None,
                backend: str = "kernels", chunk: int = 2048,
                monitor_every: int = 1,
                bn: int | None = None, bkn: int = 8,
                residency: str | None = None, regroup_every: int = 16,
                move_cap: int | None = None, precision: str = "f32",
                guards: bool | None = None, ckpt_dir: str | None = None,
                ckpt_every: int = 0, resume: bool = False,
                key: torch.Generator | int | None = None,
                device=None) -> KMeansResult:
    """Run k²-means from an initialisation (centers + assignment) on
    ``device`` (default ``cuda``).

    ``backend``: ``"kernels"``, the cluster-grouped kernel path (the
    reference's ``"pallas"``), or ``"xla"``, the ungrouped path that
    scores every row's candidate list, ``chunk`` rows at a time
    (``core.engine``). Both give the same assignments.
    ``residency``: ``"resident"`` or ``"rebuild"``; None resolves to
    ``"resident"`` on kernels or under int8 and to ``"rebuild"`` on xla,
    as the reference resolves it.
    ``monitor_every`` defers the stats' host reads (and the convergence
    check) to every that-many iterations; ``bn``/``bkn`` pick the
    point-block size and the candidate padding width.
    ``precision``: ``"f32"`` or ``"int8"``, the quantized resident arena
    (DESIGN.md §13): the scan reads int8 rows and slabs through K4 and
    re-ranks its survivors exactly in f32, so the trajectory is the f32
    fit's bit for bit while the scan and layout bytes fall. It needs the
    resident residency and refuses guards and fault injection.

    Self-healing (DESIGN.md §11): ``guards=True`` evaluates the invariant
    guards at every monitor flush (one host read) and heals through the
    repair lattice (``None``: on exactly when a
    ``ft.chaos.FaultInjector`` is active); ``ckpt_dir``/``ckpt_every``
    write atomic checkpoints of (centers, assignment, iteration; the
    rebuild residency adds its bounds) and ``resume=True`` restarts from
    the newest complete one, counted as a ``restore`` repair. The resumed
    trajectory is the uninterrupted one bit for bit on the rebuild
    residency; a resident resume rebuilds loose bounds and is of
    equivalent quality (DESIGN.md §11.3). ``key`` (a CPU
    ``torch.Generator`` or a seed; default seed 0) draws the split
    rung's members, where the reference takes a ``jax.random`` key.
    """
    if backend not in ("kernels", "xla"):
        raise ValueError(f"unknown backend {backend!r}; "
                         "expected 'kernels' or 'xla'")
    if precision not in ("f32", "int8"):
        raise ValueError(f"unknown precision {precision!r}; "
                         "expected 'f32' or 'int8'")
    if monitor_every < 1:
        raise ValueError(f"monitor_every must be >= 1, got {monitor_every}")
    if residency is None:
        residency = "resident" if (backend == "kernels"
                                   or precision == "int8") else "rebuild"
    if residency not in ("rebuild", "resident"):
        raise ValueError(f"unknown residency {residency!r}; "
                         "expected 'rebuild' or 'resident'")
    from .. import ft
    from ..ft import chaos as chaos_mod
    from ..ft.invariants import heal_fit, make_guard

    dev = resolve(device)
    x, centers = as_tensor(x, dev), as_tensor(centers, dev)
    assignment = as_tensor(assignment, dev, torch.int32)
    counter = counter or OpCounter()
    n, d = x.shape
    k = centers.shape[0]
    kn = min(kn, k)
    resident = residency == "resident"
    sb = K2Step(k=k, kn=kn, backend=backend, chunk=chunk, bn=bn, bkn=bkn,
                residency=residency, regroup_every=regroup_every,
                move_cap=move_cap, precision=precision)
    step = sb.build(n, d)
    w = torch.ones((n,), dtype=x.dtype, device=dev)
    inj = chaos_mod.active()
    if guards is None:
        guards = inj is not None
    if guards and precision == "int8":
        # the guards and the repair lattice read f32 arena rows; the
        # quantized arena is a scan-path optimisation, not a fault domain
        raise ValueError("precision='int8' does not support invariant "
                         "guards or fault injection; fit with the f32 "
                         "arena when guards/chaos are active")
    ckpt = ft.FitCheckpointer(ckpt_dir, every=ckpt_every) \
        if ckpt_dir else None
    it0 = 0
    bnds = None
    if resume and ckpt is not None:
        got = ckpt.latest(n, k, d)
        if got is not None:
            it0, c_h, a_h, bnds = got
            centers = torch.from_numpy(c_h).to(dev)
            assignment = torch.from_numpy(a_h).to(dev)
            counter.count_repair("restore")
    if resident:
        state = sb.init_resident(x, w, centers, assignment)
    else:
        state = init_state(centers, assignment, kn)
        if bnds is not None and bnds["nb"].shape == state.prev_nb.shape:
            # the restored Hamerly state resumes the gated trajectory bit
            # for bit rather than forcing a full recompute
            state = K2State(state.c, state.a,
                            torch.from_numpy(bnds["u"]).to(dev),
                            torch.from_numpy(bnds["lo"]).to(dev),
                            torch.from_numpy(bnds["nb"]).to(dev), False)
    guard = make_guard(sb, n) if guards else None
    heal_gen = _heal_generator(key) if guards else None
    mon = _MonitorLoop(counter, n=n, d=d, k=k, kn=kn, resident=resident,
                       precision=precision)
    for it in range(it0 + 1, max_iters + 1):
        if inj is not None:
            x, w, state = chaos_mod.apply_fit_faults(inj, it, x, w, state,
                                                     resident)
        state, stats = step(x, w, state)
        mon.pending.append(tuple(stats))
        if it % monitor_every == 0 or it == max_iters:
            mon.flush()
            healed = False
            if guard is not None:
                vio = guard(state).cpu().numpy()      # one read a flush
                bad_energy = bool(mon.history) and \
                    not math.isfinite(mon.history[-1][1])
                if vio.any() or bad_energy:
                    if bad_energy and not vio.any():
                        vio = np.array([0, 1, 0, 0])   # full-heal route
                    x, w, state = heal_fit(x, w, state, sb, n, counter,
                                           heal_gen, vio)
                    mon.converged = False   # healed state must re-iterate
                    healed = True
            if ckpt is not None and not healed and ckpt.due(it):
                if resident:
                    ckpt.save(it, state.c, sb.final_assignment(state, n))
                else:
                    ckpt.save(it, state.c, state.a, u=state.u, lo=state.lo,
                              nb=state.prev_nb)
            if mon.converged:
                break
    a = sb.final_assignment(state, n) if resident else state.a
    c = state.c
    if mon.history and math.isfinite(mon.history[-1][1]):
        energy = mon.history[-1][1]
    else:       # no iterations ran, or the last flush preceded a heal
        counter.add_distances(n)   # n residual distances
        energy = float(torch.sum(w * sqnorm(x - c[a.long()])))
    return KMeansResult(c, a, energy, mon.it_done, counter.total,
                        mon.history)
