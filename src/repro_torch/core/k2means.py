"""k²-means — the paper's Algorithm 1 (port of ``repro.core.k2means``).

Per iteration: the k_n-NN graph over the centers, each point competing
only among the k_n neighbours of its current center with Hamerly bounds
that skip points whose assignment provably cannot change, and the mean
update. The iteration itself lives in :mod:`core.engine`; this module
is the fit loop, which keeps every statistic on the device and reads
them back every ``monitor_every`` iterations (the deferred host read).
"""
from __future__ import annotations

import torch

from ..device import as_tensor, resolve
from .distance import sqnorm
from .engine import K2Step, init_state
from .lloyd import KMeansResult
from .opcount import OpCounter, charge_iteration



class _MonitorLoop:
    """Deferred-host-read fit loop: stats stay on the device and are
    flushed (ops charged, convergence checked) every ``monitor_every``
    iterations, in one device-to-host read per flush."""

    def __init__(self, counter, *, n, d, k, kn, resident):
        self.counter = counter
        self.args = dict(n=n, d=d, k=k, kn=kn, resident=resident)
        self.pending = []
        self.history = []
        self.it_done = 0
        self.converged = False

    def flush(self):
        if self.pending:
            rows = torch.stack([torch.stack([s.to(torch.float64) for s in st])
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


def fit_k2means(x, centers, assignment, *, kn: int = 30,
                max_iters: int = 100, counter: OpCounter | None = None,
                backend: str = "kernels", monitor_every: int = 1,
                bn: int | None = None, bkn: int = 8,
                residency: str | None = None, regroup_every: int = 16,
                move_cap: int | None = None, precision: str = "f32",
                guards: bool | None = None, ckpt_dir: str | None = None,
                device=None) -> KMeansResult:
    """Run k²-means from an initialisation (centers + assignment) on
    ``device`` (default ``cuda``).

    ``backend``: ``"kernels"``, the cluster-grouped kernel path (the
    reference's ``"pallas"``).
    ``residency``: ``"resident"`` (default) or ``"rebuild"``.
    ``monitor_every`` defers the stats' host reads (and the convergence
    check) to every that-many iterations; ``bn``/``bkn`` pick the
    point-block size and the candidate padding width.
    """
    if backend == "xla":
        raise NotImplementedError(
            "the ungrouped 'xla' backend is not ported yet (ROADMAP §1 "
            "item 11); the grouped kernel path is backend='kernels'")
    if backend != "kernels":
        raise ValueError(f"unknown backend {backend!r}; expected 'kernels'")
    if precision == "int8":
        raise NotImplementedError(
            "precision='int8' is not ported yet (ROADMAP §1 item 7)")
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    if guards or ckpt_dir:
        raise NotImplementedError(
            "invariant guards and fit checkpoints are not ported yet "
            "(ROADMAP §1 item 9)")
    if monitor_every < 1:
        raise ValueError(f"monitor_every must be >= 1, got {monitor_every}")
    residency = residency or "resident"
    if residency not in ("rebuild", "resident"):
        raise ValueError(f"unknown residency {residency!r}; "
                         "expected 'rebuild' or 'resident'")
    dev = resolve(device)
    x, centers = as_tensor(x, dev), as_tensor(centers, dev)
    assignment = as_tensor(assignment, dev, torch.int32)
    counter = counter or OpCounter()
    n, d = x.shape
    k = centers.shape[0]
    kn = min(kn, k)
    resident = residency == "resident"
    sb = K2Step(k=k, kn=kn, bn=bn, bkn=bkn, residency=residency,
                regroup_every=regroup_every, move_cap=move_cap)
    step = sb.build(n, d)
    w = torch.ones((n,), dtype=x.dtype, device=dev)
    state = sb.init_resident(x, w, centers, assignment) if resident \
        else init_state(centers, assignment, kn)
    mon = _MonitorLoop(counter, n=n, d=d, k=k, kn=kn, resident=resident)
    for it in range(1, max_iters + 1):
        state, stats = step(x, w, state)
        mon.pending.append(tuple(stats))
        if it % monitor_every == 0 or it == max_iters:
            mon.flush()
            if mon.converged:
                break
    a = sb.final_assignment(state, n) if resident else state.a
    c = state.c
    if mon.history:
        energy = mon.history[-1][1]
    else:       # no iterations ran
        counter.add_distances(n)   # n residual distances
        energy = float(torch.sum(w * sqnorm(x - c[a.long()])))
    return KMeansResult(c, a, energy, mon.it_done, counter.total,
                        mon.history)
