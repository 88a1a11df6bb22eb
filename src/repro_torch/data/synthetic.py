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


def rounding_fixture(n: int, k: int, d: int, *, seed: int = 0,
                     device=None):
    """Rows whose dot product with their own center lies just above an
    f32 rounding midpoint, so that f64 sums of the exact products taken in
    different orders round to either side of it: the inputs that hold
    the port's correctly rounded ``x.c`` to one value on every path.

    Center j is +-1 on a random set of m_j >= d / 2 coordinates and 2^-20
    on three more. Point i (of center ``a[i] = i % k``) copies its center
    on m = m_j - (i // k) % 4 of those coordinates, scales one of them by
    1 + 2^(e - 24) (e = floor(log2 m)) and carries 2^(e - 33) on the three
    small ones: ``x.c = m + 2^(e - 24) + 3 * 2^(e - 53)`` exactly, the
    midpoint above m plus 1.5 f64 ulps, whose correctly rounded f32 is
    ``m + 2^(e - 23)``. Drawn with numpy from ``seed``. Returns (x (n, d),
    c (k, d), a (n,) int32) on ``device`` (default ``cuda``). d >= 16."""
    import numpy as np
    if d < 16:
        raise ValueError(f"rounding_fixture needs d >= 16, got {d}")
    dev = resolve(device)
    rng = np.random.RandomState(seed)
    c = np.zeros((k, d), np.float32)
    ones, small = [], []
    for j in range(k):
        perm = rng.permutation(d)
        m = rng.randint(d // 2, d - 3)
        ones.append(perm[:m])
        small.append(perm[m:m + 3])
        c[j, ones[j]] = rng.choice([-1.0, 1.0], m)
        c[j, small[j]] = 2.0 ** -20
    a = (np.arange(n) % k).astype(np.int32)
    x = np.zeros((n, d), np.float32)
    for i in range(n):
        j = a[i]
        m = len(ones[j]) - (i // k) % 4
        keep = rng.permutation(ones[j])[:m]
        e = int(np.floor(np.log2(m)))
        x[i, keep] = c[j, keep]
        x[i, keep[0]] *= np.float32(1.0 + 2.0 ** (e - 24))
        x[i, small[j]] = 2.0 ** (e - 33)
    return (torch.tensor(x, device=dev), torch.tensor(c, device=dev),
            torch.tensor(a, device=dev))
