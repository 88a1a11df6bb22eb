"""Shared neural building blocks (port of ``repro.models.layers``):
param dicts of tensors, no framework.

The reference's orders of operations are kept: ``rmsnorm`` normalises in
f32, casts to the input's type and then scales by ``g`` in that type;
``apply_rope`` rotates split halves; ``dense`` is ``x @ w`` with ``w``
laid out (d_in, d_out). A Python constant that multiplies a bf16 tensor
is rounded to bf16 first (:func:`scale`), as XLA rounds a weakly typed
constant to the tensor's type. Inits take an explicit
``torch.Generator`` and draw other numbers than ``jax.random``: tests
carry the reference's params across with
``convert.params_from_reference``. An init fills tensors it
asks of ``new(shape, dtype)`` (default: a fresh tensor on the
generator's device), so a layer stack can hand out slices of its
stacked leaves (``transformer.stack_init``). On ``device="meta"``
(``model.param_shapes``, through :class:`MetaGenerator`) an init
allocates meta tensors and draws nothing.

Placement: :class:`PartitionSpec` is the port's own spec (one entry a
dimension: ``None``, a mesh axis name or a tuple of them), which
``launch.sharding`` gives every leaf of the params, the optimizer state,
the batch and the cache. The reference's activation hints are kept at
its call sites (:func:`shard`, :func:`head_spec`, :func:`sanitize_spec`)
so a reader finds them, and :func:`shard` does nothing: the reference's
is a no-op off a mesh, and on one GSPMD propagates the placement through
the program. The port executes placement only where the reference
writes it out (``shard_map``: the sharded k²-attention decode,
``models.attention``) and where the dry run's step receives its inputs
(the batch and the ZeRO optimizer state of ``launch.train``, the
cluster-sharded cache of ``launch.serve``), never by propagation.

Training: where autograd records an op (:func:`recorded`), the callers
that update a tensor in place to save memory on the serving path
(attention's softmax and mask, the MoE's expert SwiGLU) take the same
arithmetic out of place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


DP = ("pod", "data")      # flattened data-parallel axes (multi-pod aware)
TP = "model"


class PartitionSpec(tuple):
    """A leaf's placement over a mesh's named axes, one entry a dimension
    (``None``: not split; an axis name; a tuple of names, split over
    their product in that order, major first). Trailing dimensions
    without an entry are not split. The reference's
    ``jax.sharding.PartitionSpec`` as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def sanitize_spec(spec: PartitionSpec, mesh) -> PartitionSpec | None:
    """``spec`` with the axes ``mesh`` lacks dropped (e.g. "pod" on a
    single-pod mesh), so one set of hints serves every mesh; None without
    a mesh (the reference reads the ambient mesh; the port has none and
    takes it as an argument)."""
    if mesh is None:
        return None
    names = set(mesh.axis_names)
    clean = []
    for e in spec:
        if e is None or isinstance(e, str):
            clean.append(e if e in names else None)
        else:
            t = tuple(a for a in e if a in names)
            clean.append(t if t else None)
    return PartitionSpec(*clean)


def shard(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """The reference's activation sharding hint: ``x`` unchanged (see the
    module's docstring: the port places no activation)."""
    return x


def head_spec(n_heads: int, tp_size: int = 16) -> PartitionSpec:
    """Shard the head axis only when it divides the TP axis."""
    if n_heads % tp_size == 0:
        return PartitionSpec(DP, None, TP, None)
    return PartitionSpec(DP, None, None, None)


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device: inits
    given it allocate meta tensors (shapes and types, no storage) and
    draw nothing."""
    device = torch.device("meta")


def recorded(*ts) -> bool:
    """True when autograd records ops on any of ``ts``: grad mode is on
    and one requires grad. An in-place update there would overwrite what
    the backward reads, so callers then compute out of place."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts)


def allocator(device, new=None):
    """``new``, or one that makes an empty tensor on ``device``."""
    return new or (lambda shape, dtype: torch.empty(
        shape, dtype=dtype, device=device))


def normal_into(w: torch.Tensor, gen: torch.Generator, scale: float):
    """Fill ``w`` with normal draws from ``gen``, made in f32, times
    ``scale``, then cast to ``w``'s type. Returns ``w`` (a meta tensor
    as it is)."""
    if w.is_meta:
        return w
    return w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32,
                               device=gen.device).mul_(scale))


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16, new=None) -> dict:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return {"w": normal_into(allocator(gen.device, new)((d_in, d_out), dtype),
                             gen, scale)}


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None,
                 new=None) -> dict:
    return {"g": allocator(device, new)((d,), dtype).fill_(1)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["g"]


def swiglu_init(gen: torch.Generator, d: int, f: int,
                dtype=torch.bfloat16, new=None) -> dict:
    return {"wi": dense_init(gen, d, f, dtype, new),
            "wg": dense_init(gen, d, f, dtype, new),
            "wo": dense_init(gen, f, d, dtype, new)}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["wo"], F.silu(dense(p["wg"], x)) * dense(p["wi"], x))


def scale(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` with ``s`` rounded to ``x``'s type first (XLA's weak
    typing of a Python constant)."""
    return x * torch.tensor(s, dtype=x.dtype, device=x.device)


def rope_freqs(dh: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    ang = positions[..., None].float() * freqs            # (..., S, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy; logits (B, S, V), labels (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
