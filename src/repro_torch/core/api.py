"""Single entry point: ``fit(x, k, method=..., init=...)`` (port of
``repro.core.api`` for the single-device f32 fit: k²-means and the
paper's Lloyd and Elkan baselines, with the served model of
``return_model=True``)."""
from __future__ import annotations

import time
from typing import Any

import torch

from ..device import as_tensor, resolve
from .elkan import fit_elkan
from .gdi import gdi_device_init
from .k2means import fit_k2means
from .kmeanspp import assign_nearest, kmeanspp_init, random_init
from .lloyd import fit_lloyd
from .model import KMeansModel
from .opcount import OpCounter

METHODS = ("lloyd", "elkan", "k2means")
INITS = ("random", "kmeanspp", "gdi", "gdi_device")
# reference inits and methods the port does not have yet, by ROADMAP item
_LATER = {"gdi_host": 11, "gdi_parallel": 11, "gdi_replicated": 12,
          "minibatch": 11, "akm": 11}


def _not_ported(what: str, name: str):
    return NotImplementedError(f"{what} {name!r} is not ported yet "
                               f"(ROADMAP §1 item {_LATER[name]})")


def initialize(x: torch.Tensor, k: int, init: str,
               generator: torch.Generator, counter: OpCounter):
    """Returns (centers, assignment_or_None). ``"gdi"`` is the
    frontier-batched device GDI, as on the reference's Pallas path."""
    if init == "random":
        return random_init(x, k, generator), None
    if init == "kmeanspp":
        return kmeanspp_init(x, k, generator, counter), None
    if init in ("gdi", "gdi_device"):
        return gdi_device_init(x, k, generator=generator, counter=counter,
                               device=x.device)
    if init in _LATER:
        raise _not_ported("init", init)
    raise ValueError(f"unknown init {init!r}; expected one of {INITS}")


def fit(x, k: int, *, method: str = "k2means", init: str = "gdi",
        generator: torch.Generator | None = None, seed: int = 0,
        max_iters: int = 100, kn: int = 30,
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
    drives the init's draws. Extra keywords flow to the method's fit
    function: :func:`core.k2means.fit_k2means` (``residency``,
    ``monitor_every``, ``regroup_every``, ``bn``, ``precision``,
    ``guards``, ``ckpt_dir``, ``ckpt_every``, ``resume``, ``key``, ...),
    :func:`core.lloyd.fit_lloyd` (``callback``) or
    :func:`core.elkan.fit_elkan`. ``profile=True`` attaches the
    counter's op and memory-traffic breakdown plus the host-clock seconds
    of the init and of the iterations (each ended by a device
    synchronize) to ``result.profile``. ``validate``: "raise" rejects
    non-finite rows, "sanitize" zeroes them, "none" skips the check.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh placement is not ported yet (ROADMAP §1 item 12)")
    if method not in METHODS:
        if method in _LATER:
            raise _not_ported("method", method)
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    if validate not in ("raise", "sanitize", "none"):
        raise ValueError(f"validate must be 'raise' | 'sanitize' | "
                         f"'none', got {validate!r}")
    dev = resolve(device)
    counter = counter or OpCounter()
    x = as_tensor(x, dev)
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

    t0 = sync_clock()
    centers, assignment = initialize(x, k, init, generator, counter)
    if method == "k2means" and assignment is None:
        assignment = assign_nearest(x, centers, counter)
    t1 = sync_clock()
    if method == "lloyd":
        result = fit_lloyd(x, centers, max_iters=max_iters, counter=counter,
                           device=dev, **kw)
    elif method == "elkan":
        result = fit_elkan(x, centers, max_iters=max_iters, counter=counter,
                           device=dev, **kw)
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
            result, x, kn=min(kn, k), capacity=model_capacity, device=dev)
    return result
