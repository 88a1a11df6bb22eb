"""Synthetic data (port of ``repro.data.synthetic``): Gaussian-mixture
stand-ins for the paper's datasets, drawn from a ``torch.Generator``.

The same seed gives other numbers than the reference's ``jax.random``
stream; tests that compare the two packages draw their inputs with numpy
and hand them to both.
"""
from __future__ import annotations

import torch

from ..device import resolve

# (n, d) of the paper's datasets (Table 5) — used to size the stand-ins.
DATASET_SHAPES = {
    "cifar": (50000, 3072),
    "cnnvoc": (15662, 4096),
    "covtype": (150000, 54),
    "mnist": (60000, 784),
    "mnist50": (60000, 50),
    "tinygist10k": (10000, 384),
    "usps": (7291, 256),
    "yale": (2414, 32256),
}


def gmm_blobs(n: int, d: int, true_k: int, spread: float = 4.0,
              noise: float = 1.0, *, generator: torch.Generator | None = None,
              seed: int = 0, device=None) -> torch.Tensor:
    """n points from a true_k-component GMM with power-law weights, drawn
    on ``device`` (default ``cuda``) from ``generator`` (default: a new
    one seeded with ``seed`` on that device)."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    mus = torch.randn(true_k, d, generator=generator, device=dev) * spread
    w = 1.0 / torch.arange(1, true_k + 1, dtype=torch.float32, device=dev)
    comp = torch.multinomial(w / w.sum(), n, replacement=True,
                             generator=generator)
    return mus[comp] + noise * torch.randn(n, d, generator=generator,
                                           device=dev)
