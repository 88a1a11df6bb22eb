"""AdamW, its cosine schedule and global-norm clipping as plain functions
on tensor trees (nested dicts), port of ``repro.optim.adamw``.

The moments ``m`` and ``v`` are f32; params stay in their type (bf16),
and the update runs in f32 and is cast back, as the reference's. The
reference's order of operations is kept, each op rounded to f32 (a
Python constant is rounded to f32 first, as XLA rounds a weakly typed
constant), and every f32 root is correctly rounded (``ref.sqrt_rn``:
the card's and the CPU's ``sqrt`` can differ in the last bit, ROADMAP
§3 entry 18). The step counter and the learning rate stay on the
params' device: an update reads nothing to the host.
"""
from __future__ import annotations

import math

import torch

from ..kernels.ref import sqrt_rn


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(step: torch.Tensor, *, base_lr: float = 3e-4,
                    warmup: int = 200, total: int = 10000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor): linear warmup to
    ``base_lr``, then a cosine down to ``min_frac`` of it at ``total``."""
    step = step.to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(
        _f32(math.pi, step) * prog))
    return base_lr * torch.where(step < warmup, warm, cos)


def tree_leaves(tree):
    """The leaves of a tree of dicts, keys in sorted order (the order
    ``jax.tree_util`` gives the reference's trees)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    else:
        yield tree


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts): a new
    tree of the results."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in trees[0]}
    return fn(*trees)


def adamw_init(params) -> dict:
    """Zero f32 moments shaped as ``params`` and step 0 (int32), on the
    params' device (meta tensors too)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = next(tree_leaves(params))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def init_opt_shapes(params_shape) -> dict:
    """:func:`adamw_init` of a tree of meta tensors: the optimizer state's
    shapes and types, no storage."""
    return adamw_init(params_shape)


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """(grads scaled by min(1, max_norm / max(gn, 1e-9)), gn): gn the f32
    norm over every leaf, the leaves' sums of squares added in the
    trees' key order."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    gn = sqrt_rn(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_update(grads, opt, params, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 lr_fn=cosine_schedule):
    """One AdamW step: returns (new params, {"m", "v", "step"}), new
    trees (nothing updated in place)."""
    step = opt["step"] + 1
    lr = lr_fn(step)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(_f32(b1, sf), sf)
    bc2 = 1 - torch.pow(_f32(b2, sf), sf)
    c1, c2 = 1 - b1, 1 - b2

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + c1 * g
        v = b2 * v + c2 * g * g
        u = (m / bc1) / (sqrt_rn(v / bc2) + eps)
        u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v
    out = tree_map(upd, grads, opt["m"], opt["v"], params)
    new_p, m, v = (tree_map(lambda t, i=i: t[i], out) for i in range(3))
    return new_p, {"m": m, "v": v, "step": step}
