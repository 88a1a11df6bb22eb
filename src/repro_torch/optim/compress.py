"""Int8 block quantisation of gradients (port of
``repro.optim.compress``): per block of 256 values one f32 scale, the
block's largest magnitude / 127, and int8 codes rounded half to even
(``torch.round``, as ``jnp.round``); the error of a value is at most
half its block's scale. :func:`compressed_grads` quantises and
dequantises every leaf before the optimizer, the reference's jit-path
semantics (the error explicit and testable); a reduction over several
cards would move the int8 payload.
"""
from __future__ import annotations

import torch

BLOCK = 256


def compress_int8(g: torch.Tensor):
    """g -> (int8 codes (n_blocks, BLOCK), f32 scales (n_blocks, 1),
    g's shape)."""
    flat = g.float().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    flat = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(flat / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, tuple(g.shape)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    """The f32 values of :func:`compress_int8`'s codes, in ``shape``."""
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compressed_grads(grads):
    """Quantise then dequantise every leaf of a tree (dicts), each back
    in its type."""
    if isinstance(grads, dict):
        return {k: compressed_grads(v) for k, v in grads.items()}
    return decompress_int8(*compress_int8(grads)).to(grads.dtype)
