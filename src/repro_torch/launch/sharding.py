"""Row placement of the clustering data over a :class:`launch.mesh.Mesh`
(port of ``repro.launch.sharding.clustering_specs``).

Points and every per-point array are row-sharded over the mesh's shards
in shard order; centers, the k_n-NN graph and the statistics are
replicated. n is padded to a multiple of the shard count with duplicates
of the head rows at weight 0, which never move a center, the energy or
a count. :class:`Rows` and :class:`Replicated` name a leaf's placement
for ``checkpoint.reshard_restore``.

The reference module's parameter, optimizer, batch and cache specs belong
to the LM and are not ported here.
"""
from __future__ import annotations

import dataclasses

import torch

from .mesh import Mesh


def pad_rows(x: torch.Tensor, shards: int):
    """``(x_pad, w)``: ``x`` padded to a multiple of ``shards`` rows with
    copies of its head rows, and the row weights (1 real, 0 padding)."""
    n = x.shape[0]
    pad = (-n) % shards
    w = torch.ones((n + pad,), dtype=torch.float32, device=x.device)
    if not pad:
        return x, w
    w[n:] = 0.0
    return torch.cat([x, x[:pad]]), w


def shard_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t``'s rows (a view): shard ``mesh.index``
    of ``mesh.size`` equal blocks."""
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{mesh.size} shards; pad them first")
    n_loc = t.shape[0] // mesh.size
    return t[mesh.index * n_loc:(mesh.index + 1) * n_loc]


@dataclasses.dataclass(frozen=True)
class Rows:
    """A leaf whose rows are split over ``mesh``'s shards."""
    mesh: Mesh

    def place(self, t: torch.Tensor) -> torch.Tensor:
        return shard_rows(t, self.mesh).to(self.mesh.device).contiguous()


@dataclasses.dataclass(frozen=True)
class Replicated:
    """A leaf held whole on every rank of ``mesh``."""
    mesh: Mesh

    def place(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.mesh.device)


__all__ = ["Replicated", "Rows", "pad_rows", "shard_rows"]
