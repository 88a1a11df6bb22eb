"""Placement rules (port of ``repro.launch.sharding``): the LM's
parameter, optimizer, batch and cache specs, and the clustering data's
row placement, over a :class:`launch.mesh.Mesh` or a stand-in
:class:`launch.mesh.MeshShape`.

Rules, the reference's (DESIGN.md §7):
- tensor parallel over ``"model"``: fan-out projections column-sharded,
  fan-in row-sharded, MoE experts on the expert axis, the embedding
  vocab-sharded (d_model when the vocab does not divide, as Whisper's
  51,865);
- FSDP: every leaf of at least 2^21 elements also shards its first free
  dimension that the data size divides over the data axes; the optimizer
  state's ``m`` and ``v`` take the same specs (ZeRO-1), its step count is
  replicated;
- the batch shards its batch axis over the data axes; the decode cache
  shards the cluster-major tables' CLUSTER axis over the data axes (the
  sharded k²-attention reads only its own clusters), keeps the centroids
  and the ring replicated, and shards other leaves' batch axis, else the
  longest axis (context parallelism), then a head axis over TP;
- a rule that does not divide leaves the dimension whole.

The spec functions read only ``mesh.shape`` and ``mesh.axis_names``, so
they take the reference's production meshes as stand-ins (a mesh without
a ``"model"`` axis, which the reference's would refuse, counts as TP
size 1), and walk the
port's own trees: ``models.model.param_shapes`` (meta tensors),
``models.model.cache_shapes`` ((shape, dtype) leaves) and
``optim.init_opt_shapes``. :func:`to_placements`, the counterpart of
``to_named``, turns a spec tree into :class:`Sharded` placements over an
executable mesh, which carries a ``"model"`` axis only of size 1 (tensor
parallel execution is ROADMAP §1 item 16).

The clustering's row placement: points and every per-point array are
row-sharded over the mesh's shards in shard order (:class:`Rows`, the
spec ``P(data axes)``); centers, the k_n-NN graph and the statistics are
replicated (:class:`Replicated`, ``P()``). n is padded to a multiple of
the shard count with duplicates of the head rows at weight 0, which never
move a center, the energy or a count.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.layers import TP, PartitionSpec as P
from .mesh import Mesh, dp_axes

# fan-out (column) sharded projection names; fan-in (row) sharded names
_COL = {"wq", "wk", "wv", "wi", "wg", "wuk", "wuv", "in_proj", "w2"}
_ROW = {"wo", "out_proj"}
_STACKED = {"stack", "prefix", "enc"}


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's (meta or not), or a (shape, dtype)
    pair's (``cache_shapes``)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts (path: the keys)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _dp(mesh) -> tuple:
    """(the data axes, the spec entry over them, their size)."""
    dp = dp_axes(mesh)
    return dp, (dp if len(dp) > 1 else dp[0]), math.prod(
        mesh.shape[a] for a in dp)


def _leaf_spec(names, shape, tp_size: int) -> P:
    stacked = bool(names) and names[0] in _STACKED
    base = names[-2] if len(names) >= 2 else ""      # {"w": ...} parent name
    dims = list(shape)
    spec = [None] * len(dims)
    body = 1 if stacked else 0                       # skip the layer axis
    if names[-1] == "embed":
        if dims[0] % tp_size == 0:
            spec[0] = TP          # vocab-sharded
        elif dims[1] % tp_size == 0:
            spec[1] = TP          # odd vocab (whisper 51865): shard d_model
        return P(*spec)
    if names[-1] in {"wi", "wg", "wo"} and len(dims) - body == 3:
        spec[body] = TP                              # MoE expert axis (EP)
        return P(*spec)
    if base in _COL and len(dims) - body == 2:
        if dims[-1] % tp_size == 0:
            spec[-1] = TP
        return P(*spec)
    if base in _ROW and len(dims) - body == 2:
        if dims[-2] % tp_size == 0:
            spec[-2] = TP
    return P(*spec)


def _extend_dp(spec: P, shape, dpx, dp_size: int, stacked: bool) -> P:
    """FSDP/ZeRO extension: shard one free dim over the data axes."""
    if dp_size <= 1:
        return spec
    s = list(spec) + [None] * (len(shape) - len(spec))
    for i in range(1 if stacked else 0, len(shape)):
        if s[i] is None and shape[i] % dp_size == 0 and shape[i] >= dp_size:
            s[i] = dpx
            break
    return P(*s)


def param_specs(cfg, params_shape, mesh, *, fsdp: bool = True):
    """The spec tree of ``params_shape`` (``model.param_shapes(cfg)``):
    TP by name, then FSDP on leaves of at least 2^21 elements."""
    tp = mesh.shape.get(TP, 1)     # a data-only mesh: no TP
    _, dpx, dsz = _dp(mesh)

    def one(names, leaf):
        shape = _shape(leaf)
        spec = _leaf_spec(names, shape, tp)
        if fsdp and math.prod(shape) * 2 >= (1 << 22):     # only big leaves
            spec = _extend_dp(spec, shape, dpx, dsz,
                              bool(names) and names[0] in _STACKED)
        return spec
    return _map(one, params_shape)


def opt_specs(cfg, params_shape, mesh) -> dict:
    """The optimizer state's specs: ``m`` and ``v`` as the params under
    FSDP (ZeRO-1), the step count replicated."""
    ps = param_specs(cfg, params_shape, mesh, fsdp=True)
    return {"m": ps, "v": ps, "step": P()}


def batch_specs(cfg, mesh, kind: str) -> dict:
    """The batch's specs: its batch axis over the data axes."""
    _, dpx, _ = _dp(mesh)
    s = {"tokens": P(dpx, None), "labels": P(dpx, None)}
    if cfg.family == "audio":
        s["frames"] = P(dpx, None, None)
    if cfg.n_patches:
        s["patches"] = P(dpx, None, None)
    return s


def cache_specs(cfg, cache_shape, mesh, batch: int):
    """The decode cache's specs (``model.cache_shapes``' tree): the
    cluster-major ``kt``/``vt``/``sizes`` shard the cluster axis over the
    data axes; ``cent`` and the ring are replicated; other leaves shard
    the batch axis over the data axes when it divides, else the longest
    later axis (context parallelism), then a head, cluster or feature
    axis over TP."""
    _, dpx, dsz = _dp(mesh)
    tp = mesh.shape.get(TP, 1)     # a data-only mesh: no TP

    def one(names, leaf):
        shape = _shape(leaf)
        stacked = names[0] in {"stack", "prefix"} or \
            (names[0] == "shared" and len(shape) >= 4)
        b_axis = 1 if stacked else 0
        spec = [None] * len(shape)
        if names[-1] in ("kt", "vt", "sizes"):
            if shape[b_axis + 2] % dsz == 0:
                spec[b_axis + 2] = dpx
            return P(*spec)
        if names[-1] in ("cent", "ring_k", "ring_v", "ring_fill"):
            return P(*spec)       # replicated: selection + recent ring
        if shape[b_axis] % dsz == 0:
            spec[b_axis] = dpx
        else:
            rest = [(shape[i], i) for i in range(b_axis + 1, len(shape))]
            if rest:
                mx, mi = max(rest)
                if mx % dsz == 0 and mx >= 4 * dsz:
                    spec[mi] = dpx
        for i in range(b_axis + 1, len(shape)):
            if spec[i] is None and shape[i] % tp == 0 and shape[i] >= tp \
                    and shape[i] > 8:
                spec[i] = TP
                break
        return P(*spec)
    return _map(one, cache_shape)


def _entry_axes(e) -> tuple:
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one device's block of a leaf of ``shape`` under
    ``spec`` on ``mesh`` (a dimension split n ways holds ⌈size / n⌉)."""
    out = list(shape)
    for i, e in enumerate(spec):
        n = math.prod(mesh.shape.get(a, 1) for a in _entry_axes(e))
        out[i] = -(-out[i] // n)
    return tuple(out)


def local_bytes(tree, specs, mesh) -> int:
    """One device's bytes of a tree (tensors or (shape, dtype) leaves)
    under its spec tree."""
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
            return
        dtype = t.dtype if hasattr(t, "dtype") else t[1]
        total += math.prod(local_shape(_shape(t), s, mesh)) \
            * torch.empty((), dtype=dtype).element_size()
    walk(tree, specs)
    return total


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A leaf placed by ``spec`` over an executable ``mesh``: every split
    dimension holds this rank's block, by its coordinates along the
    entry's axes (major first)."""
    spec: P
    mesh: Mesh

    def _blocks(self, t: torch.Tensor):
        """[(dim, blocks, this rank's block)] of the split dimensions."""
        co = self.mesh.coords()
        out = []
        for i, e in enumerate(self.spec):
            axes = [a for a in _entry_axes(e) if a in self.mesh.shape]
            n = math.prod(self.mesh.shape[a] for a in axes)
            if n == 1:
                continue
            if t.shape[i] % n:
                raise ValueError(f"dim {i} of {tuple(t.shape)} does not "
                                 f"split over {n} shards ({self.spec})")
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + co[a]
            out.append((i, n, idx))
        return out

    def place(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``, contiguous, on the mesh's device."""
        for i, n, idx in self._blocks(t):
            size = t.shape[i] // n
            t = t.narrow(i, idx * size, size)
        return t.to(self.mesh.device).contiguous()

    def split_dim(self) -> int | None:
        """The one dimension split over the mesh's shards in shard order
        (None: the leaf is whole on every rank); raises for a placement
        that :meth:`gather` does not join."""
        dims = [i for i, e in enumerate(self.spec)
                if math.prod(self.mesh.shape.get(a, 1)
                             for a in _entry_axes(e)) > 1]
        if not dims:
            return None
        axes = [a for a in _entry_axes(self.spec[dims[0]])
                if self.mesh.shape.get(a, 1) > 1]
        mesh_axes = [a for a in self.mesh.axis_names
                     if self.mesh.shape[a] > 1]
        if len(dims) > 1 or axes != mesh_axes:
            raise NotImplementedError(
                f"{self.spec} over {self.mesh.shape}: the port joins blocks "
                f"split along one dimension over every axis of the mesh")
        return dims[0]

    def gather(self, t_local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's block (one gather)."""
        dim = self.split_dim()
        return t_local if dim is None else self.mesh.gather_blocks(t_local,
                                                                   dim)


class Rows(Sharded):
    """A leaf whose rows are split over ``mesh``'s shards: ``P(data
    axes)``."""

    def __init__(self, mesh: Mesh):
        super().__init__(P(_dp(mesh)[1]), mesh)


class Replicated(Sharded):
    """A leaf held whole on every rank of ``mesh``: ``P()``."""

    def __init__(self, mesh: Mesh):
        super().__init__(P(), mesh)


def to_placements(tree_specs, mesh: Mesh):
    """The counterpart of the reference's ``to_named``: every spec of a
    tree as a :class:`Sharded` placement over ``mesh``."""
    return _map(lambda _, s: Sharded(s, mesh), tree_specs)


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


__all__ = ["Replicated", "Rows", "Sharded", "batch_specs", "cache_specs",
           "local_bytes", "local_shape", "opt_specs", "pad_rows",
           "param_specs", "shard_rows", "to_placements"]
