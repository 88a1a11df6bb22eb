"""Single entry point: ``fit(x, k, method=..., init=...)`` (port of
``repro.core.api``: k²-means on either backend and the baselines Lloyd,
Elkan, MiniBatch and AKM, from random, k-means++ or one of the three GDI
inits, with the served model of ``return_model=True``; k²-means also
row-sharded over a ``launch.mesh.Mesh`` through ``mesh=``)."""
from __future__ import annotations

import time
from typing import Any

import torch

from ..device import as_tensor, resolve
from .akm import fit_akm
from .elkan import fit_elkan
from .gdi import gdi_device_init, gdi_init, gdi_parallel_init
from .k2means import fit_k2means
from .kmeanspp import assign_nearest, kmeanspp_init, random_init
from .lloyd import fit_lloyd
from .minibatch import fit_minibatch
from .model import KMeansModel
from .opcount import OpCounter

METHODS = ("lloyd", "elkan", "k2means", "minibatch", "akm")
INITS = ("random", "kmeanspp", "gdi", "gdi_host", "gdi_device",
         "gdi_parallel")


def host_generator(generator: torch.Generator) -> torch.Generator:
    """The CPU generator of the host-drawn inits and methods (gdi_host,
    gdi_parallel, MiniBatch, AKM): ``generator`` itself on the CPU, else
    a CPU generator with its seed, so the card draws what the CPU draws
    from one seed."""
    if generator.device.type == "cpu":
        return generator
    return torch.Generator().manual_seed(generator.initial_seed())


def initialize(x: torch.Tensor, k: int, init: str,
               generator: torch.Generator, counter: OpCounter, *,
               device_gdi: bool = True,
               host_gen: torch.Generator | None = None):
    """Returns (centers, assignment_or_None). ``"gdi"`` is the
    frontier-batched device GDI when ``device_gdi`` (a k²-means fit on
    the kernels backend, the reference's Pallas path) and the host loop
    ``gdi_init`` otherwise, as the reference resolves it; ``"gdi_host"``
    and ``"gdi_device"`` pin one of the two. The host-drawn inits draw
    from ``host_gen`` (default: ``host_generator(generator)``)."""
    if host_gen is None:
        host_gen = host_generator(generator)
    if init == "random":
        return random_init(x, k, generator), None
    if init == "kmeanspp":
        return kmeanspp_init(x, k, generator, counter), None
    if init == "gdi_device" or (init == "gdi" and device_gdi):
        return gdi_device_init(x, k, generator=generator, counter=counter,
                               device=x.device)
    if init in ("gdi", "gdi_host"):
        return gdi_init(x, k, generator=host_gen, counter=counter,
                        device=x.device)
    if init == "gdi_parallel":
        return gdi_parallel_init(x, k, generator=host_gen, counter=counter,
                                 device=x.device)
    raise ValueError(f"unknown init {init!r}; expected one of {INITS}")


def fit(x, k: int, *, method: str = "k2means", init: str = "gdi",
        generator: torch.Generator | None = None, seed: int = 0,
        max_iters: int = 100, kn: int = 30, m: int = 30, batch: int = 100,
        minibatch_iters: int | None = None,
        counter: OpCounter | None = None, mesh: Any = None,
        profile: bool = False, validate: str = "raise",
        return_model: bool = False, model_capacity: int | None = None,
        device=None, **kw: Any):
    """Cluster ``x`` into ``k`` clusters on ``device`` (default ``cuda``)
    -> :class:`KMeansResult`, or ``(result, model)`` with
    ``return_model=True``: the :class:`core.model.KMeansModel` served from
    the fit, its resident arena built over ``x`` with room for
    ``model_capacity`` rows (default 2n).

    ``generator`` (default: a new one on the device seeded with ``seed``)
    drives the init's draws; the host-drawn inits and methods take theirs
    from the CPU generator :func:`host_generator` gives for it (init
    first, then the method's). ``m`` is AKM's distance evaluations per
    point, ``batch`` and ``minibatch_iters`` MiniBatch's batch size and
    batch count. Extra keywords flow to the method's fit function:
    :func:`core.k2means.fit_k2means` (``backend``, ``residency``,
    ``monitor_every``, ``regroup_every``, ``bn``, ``precision``,
    ``guards``, ``ckpt_dir``, ``ckpt_every``, ``resume``, ``key``, ...),
    :func:`core.lloyd.fit_lloyd` (``callback``),
    :func:`core.elkan.fit_elkan`, :func:`core.minibatch.fit_minibatch`
    (``eval_every``) or :func:`core.akm.fit_akm` (``chunk``).
    ``init="gdi"`` is the device GDI for a k²-means fit on the kernels
    backend (the default) and the host loop otherwise, as the reference
    resolves it. ``profile=True`` attaches the
    counter's op and memory-traffic breakdown plus the host-clock seconds
    of the init and of the iterations (each ended by a device
    synchronize) to ``result.profile``. ``validate``: "raise" rejects
    non-finite rows, "sanitize" zeroes them, "none" skips the check.

    ``mesh=<launch.mesh.Mesh>`` runs the same k²-means iteration
    row-sharded (``core.distributed.fit_distributed_k2means``; every rank
    of the mesh calls ``fit`` with the same ``x`` and gets the same
    result): ``method="k2means"`` only, ``init`` one of ``("random",
    "kmeanspp", "gdi", "gdi_replicated")`` ("gdi" seeds per shard), on
    each rank's device (``mesh.device``, where ``device`` must agree when
    given), which holds this rank's rows only. The same extra keywords
    apply.
    """
    if mesh is not None:
        if method != "k2means":
            raise ValueError(f"mesh placement supports method='k2means' "
                             f"only, got {method!r}")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    if validate not in ("raise", "sanitize", "none"):
        raise ValueError(f"validate must be 'raise' | 'sanitize' | "
                         f"'none', got {validate!r}")
    dev = resolve(device)
    counter = counter or OpCounter()
    # on a mesh the rows stay on the host: each rank's card takes its shard
    x = as_tensor(x, dev if mesh is None else torch.device("cpu"))
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (n, d), got shape {tuple(x.shape)}")
    if validate != "none":
        bad = ~torch.isfinite(x).all(dim=1)
        n_bad = int(torch.sum(bad))
        if n_bad:
            if validate == "raise":
                idx = torch.nonzero(bad).flatten()[:8].tolist()
                raise ValueError(
                    f"fit input: {n_bad} non-finite rows (first at {idx}); "
                    "pass validate='sanitize' to zero them")
            x = torch.where(bad[:, None], 0.0, x)
            counter.count_sanitized_rows(n_bad)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)

    def sync_clock():
        if profile and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    backend = kw.get("backend", "kernels")
    if mesh is not None:
        from .distributed import fit_distributed_k2means
        result = fit_distributed_k2means(
            x, k, kn, mesh, generator, max_iters=max_iters, init=init,
            counter=counter, profile=profile, **kw)
        if return_model:
            return result, KMeansModel.from_result(
                result, x, kn=min(kn, k), capacity=model_capacity,
                backend=backend, device=dev)
        return result
    host_gen = host_generator(generator)
    t0 = sync_clock()
    centers, assignment = initialize(
        x, k, init, generator, counter,
        device_gdi=method == "k2means" and backend == "kernels",
        host_gen=host_gen)
    if method == "k2means" and assignment is None:
        assignment = assign_nearest(x, centers, counter)
    t1 = sync_clock()
    if method == "lloyd":
        result = fit_lloyd(x, centers, max_iters=max_iters, counter=counter,
                           device=dev, **kw)
    elif method == "elkan":
        result = fit_elkan(x, centers, max_iters=max_iters, counter=counter,
                           device=dev, **kw)
    elif method == "minibatch":
        result = fit_minibatch(x, centers, generator=host_gen, batch=batch,
                               iters=minibatch_iters, counter=counter,
                               device=dev, **kw)
    elif method == "akm":
        result = fit_akm(x, centers, generator=host_gen, m=m,
                         max_iters=max_iters, counter=counter, device=dev,
                         **kw)
    else:
        result = fit_k2means(x, centers, assignment, kn=kn,
                             max_iters=max_iters, counter=counter,
                             device=dev, **kw)
    t2 = sync_clock()
    if profile:
        result.profile = counter.profile() | {"init_s": t1 - t0,
                                              "iterate_s": t2 - t1}
    if return_model:
        return result, KMeansModel.from_result(
            result, x, kn=min(kn, k), capacity=model_capacity,
            backend=backend, device=dev)
    return result
