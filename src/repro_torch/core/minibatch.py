"""MiniBatch k-means (Sculley, WWW 2010), the web-scale online baseline
(port of ``repro.core.minibatch``).

Algorithm 1 of the paper: per batch, assign each sample to its nearest
center (K5, ``ops.assign_nearest_kernel``), then apply the per-center
learning-rate updates in batch order, in the reference's f32
operations: ``v[a] += 1``, ``eta = 1 / v[a]``, ``c[a] = (1 - eta) *
c[a] + eta * x``. The reference runs them as a scan over the batch; the
port vectorises across centers instead: round j updates, in one step,
the j-th sample (in batch order) of every center that has one. A
center's samples keep their order, and the updates of different centers
touch different rows, so this is the reference's sequence of
operations, not the closed-form running mean (which rounds differently).
The batch's multiplicity (its rounds) is the one host read a batch.
"""
from __future__ import annotations

import torch

from ..device import as_tensor, resolve
from ..kernels import ops
from .lloyd import KMeansResult
from .opcount import OpCounter

# default batch count: this many passes over the data (the reference's)
DEFAULT_PASSES = 2


def minibatch_step(xb: torch.Tensor, c: torch.Tensor, v: torch.Tensor):
    """One Sculley iteration on the batch ``xb`` (b, d) from centers ``c``
    (k, d) and per-center counts ``v`` (k,) f32. Returns (c', v').

    Round j takes each center's j-th sample. Its count after the round
    is ``v`` plus the samples so far (the reference's repeated ``+ 1.0``,
    exact below 2^24) and its ``eta`` and ``eta * x`` depend on nothing
    else, so they are formed for every round at once; only ``c =
    (1 - eta) * c + eta * x`` runs round by round, one multiply, add and
    select a round."""
    b = xb.shape[0]
    k = c.shape[0]
    dev = c.device
    a, _ = ops.assign_nearest_kernel(xb, c)
    al = a.long()
    # each sample's rank among its center's samples, in batch order
    order = torch.argsort(al, stable=True)
    sa = al[order]
    rank = torch.empty((b,), dtype=torch.int64, device=dev)
    rank[order] = torch.arange(b, device=dev) - torch.searchsorted(sa, sa)
    rounds = int(torch.max(rank)) + 1           # the batch's one host read
    # table[j, c]: the batch row of center c's j-th sample, -1 for none
    table = torch.full((rounds, k), -1, dtype=torch.int64, device=dev)
    table[rank, al] = torch.arange(b, device=dev)
    has = table >= 0
    vr = v + torch.cumsum(has, 0).to(v.dtype)   # counts after each round
    eta = 1.0 / vr
    keep = 1.0 - eta
    step = eta[..., None] * xb[torch.clamp(table, min=0)]   # eta * x
    for j in range(rounds):
        c = torch.where(has[j, :, None], keep[j, :, None] * c + step[j], c)
    return c, vr[-1]


def fit_minibatch(x, centers, *, generator: torch.Generator | None = None,
                  batch: int = 100, iters: int | None = None,
                  counter: OpCounter | None = None, eval_every: int = 50,
                  batches=None, device=None) -> KMeansResult:
    """Sculley's MiniBatch k-means from ``centers`` on ``device``
    (default ``cuda``): ``iters`` batches of ``batch`` rows drawn
    uniformly with replacement (default: enough batches for
    ``DEFAULT_PASSES`` passes over the data). Each batch charges batch*k
    distances and batch additions; every ``eval_every`` batches and after
    the last one the energy is evaluated (K5 over all n rows, n*k
    distances) and logged in the history. ``generator``: the CPU
    generator of the batch draws (seed 0 when None), so the card draws
    what the CPU draws; ``batches``: optional per-batch row indices
    instead (tests feed the reference's ``jax.random.randint`` rows)."""
    dev = resolve(device)
    x, c = as_tensor(x, dev), as_tensor(centers, dev)
    counter = counter or OpCounter()
    n = x.shape[0]
    k = c.shape[0]
    if iters is None:
        iters = max(1, (DEFAULT_PASSES * n + batch - 1) // batch)
    if generator is None and batches is None:
        generator = torch.Generator().manual_seed(0)
    batches = iter(batches) if batches is not None else None
    v = torch.zeros((k,), dtype=torch.float32, device=dev)
    history = []
    a = dmin = None
    for t in range(iters):
        idx = next(batches) if batches is not None else torch.randint(
            0, n, (batch,), generator=generator)
        c, v = minibatch_step(x[as_tensor(idx, dev, torch.int64)], c, v)
        counter.add_distances(batch * k)
        counter.add_additions(batch)
        if (t + 1) % eval_every == 0 or t == iters - 1:
            # the energy evaluation is measured work: n*k distances
            counter.add_distances(n * k)
            a, dmin = ops.assign_nearest_kernel(x, c)
            history.append((counter.snapshot(), float(torch.sum(dmin))))
    if a is None:                       # iters=0: evaluate the init as is
        counter.add_distances(n * k)
        a, dmin = ops.assign_nearest_kernel(x, c)
        history.append((counter.snapshot(), float(torch.sum(dmin))))
    return KMeansResult(c, a, history[-1][1], iters, counter.total, history)
