"""Layer-stack assembly for the dense GQA and MoE families (port of those
parts of ``repro.models.transformer``).

Layer params are stacked on a leading axis, as in the reference; the
stack runs as a Python loop over layers (the reference's ``lax.scan``),
forward only (no remat). The prefill keeps each layer's (k, v), which
the reference's ``_attn_apply`` drops, so the flat cache is filled from
one chunked forward. Decode takes the ``"kt"`` branch (cluster-major
k²-attention) or the flat-cache branch; the cluster tables are read-only
in decode, which writes only the ring (in place). The MLP is a SwiGLU
or, in the MoE family, ``moe.moe_apply`` with Arctic's parallel dense
residual. MLA, SSM, the audio and VLM branches, Zamba's shared block and
the flat-cache clustered variant wait for ROADMAP §1 item 13.
"""
from __future__ import annotations

import itertools

import torch

from . import attention as attn
from . import moe as moe_mod
from .layers import rmsnorm, rmsnorm_init, swiglu, swiglu_init


def layer_init(cfg, gen: torch.Generator, new=None) -> dict:
    """One decoder layer's params (dense GQA, or MoE with its optional
    dense residual), each tensor asked of ``new`` (layers.allocator)."""
    if cfg.family not in ("dense", "moe") or cfg.mla or cfg.ssm:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA and MoE families are ported "
            f"(ROADMAP §1 item 13)")
    d = cfg.d_model
    p = {"ln1": rmsnorm_init(d, device=gen.device, new=new),
         "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head, cfg.qk_norm, new=new),
         "ln2": rmsnorm_init(d, device=gen.device, new=new)}
    if cfg.moe:
        p["mlp"] = moe_mod.moe_init(gen, d, cfg.moe_d_ff, cfg.n_experts,
                                    cfg.n_shared_experts, new=new)
        if cfg.dense_residual:
            p["dense_mlp"] = swiglu_init(gen, d, cfg.d_ff, new=new)
    else:
        p["mlp"] = swiglu_init(gen, d, cfg.d_ff, new=new)
    return p


def stack_init(cfg, gen: torch.Generator, init_fn, n_layers: int) -> dict:
    """Stack ``n_layers`` inits on a leading axis. Each stacked leaf is
    allocated once, at layer 0, and every layer's init fills its slice in
    place (``init_fn(cfg, gen, new=...)``), so the peak is the stack plus
    the largest f32 block one init draws: an Arctic layer holds 13.6 B
    parameters, and stacking finished layers would hold two copies."""
    leaves: list[torch.Tensor] = []

    def slices(i):
        asked = itertools.count()

        def new(shape, dtype):
            j = next(asked)
            if i == 0:
                leaves.append(torch.empty((n_layers,) + tuple(shape),
                                          dtype=dtype, device=gen.device))
            leaf = leaves[j]
            if leaf.shape[1:] != tuple(shape) or leaf.dtype != dtype:
                raise ValueError(f"layer {i} asked for {tuple(shape)} "
                                 f"{dtype} where layer 0 had "
                                 f"{tuple(leaf.shape[1:])} {leaf.dtype}")
            return leaf[i]
        return new

    tree = init_fn(cfg, gen, new=slices(0))
    for i in range(1, n_layers):
        init_fn(cfg, gen, new=slices(i))

    def stacked(t):                 # layer 0's slice -> its stacked leaf
        if isinstance(t, dict):
            return {k: stacked(v) for k, v in t.items()}
        if not any(t._base is leaf for leaf in leaves):
            raise ValueError("an init returned a tensor it did not ask of "
                             "new()")
        return t._base
    return stacked(tree)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params (views) out of a stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def n_layers_of(stacked: dict) -> int:
    v = stacked
    while isinstance(v, dict):
        v = next(iter(v.values()))
    return v.shape[0]


def _mlp_apply(cfg, p, h, moe_stepped: bool = False):
    """The layer's MLP on ``h``: (y, aux), aux the MoE's load-balance
    loss (0.0 for a dense MLP). ``moe_stepped``: route the MoE's tokens
    one position at a time (``moe.moe_apply_stepped``)."""
    if cfg.moe:
        dense_fn = (lambda xf: swiglu(p["dense_mlp"], xf)) \
            if cfg.dense_residual else None
        apply = moe_mod.moe_apply_stepped if moe_stepped \
            else moe_mod.moe_apply
        return apply(p["mlp"], h, top_k=cfg.top_k,
                     dense_residual_fn=dense_fn)
    return swiglu(p["mlp"], h), 0.0


def decoder_layer_fwd(cfg, p, h, q_chunk: int = 512,
                      moe_stepped: bool = False):
    """One decoder layer, prefill path. Returns (h, aux, (k, v)): the
    reference's (h, aux), and k and v (B, S, Hkv, dh) for the cache.
    ``moe_stepped``: as :func:`_mlp_apply`."""
    o, kv = attn.gqa_apply(p["attn"], rmsnorm(p["ln1"], h),
                           n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                           d_head=cfg.d_head, rope_theta=cfg.rope_theta,
                           qk_norm=cfg.qk_norm, q_chunk=q_chunk)
    h = h + o
    y, aux = _mlp_apply(cfg, p, rmsnorm(p["ln2"], h), moe_stepped)
    return h + y, aux, kv


def run_stack(cfg, stacked, h, q_chunk: int = 512, kv_sink=None,
              moe_stepped: bool = False):
    """Run the stacked decoder layers over h. Returns h. ``kv_sink(i, k,
    v)``, when given, receives layer i's keys and values before the next
    layer runs. ``moe_stepped``: as :func:`_mlp_apply`."""
    for i in range(n_layers_of(stacked)):
        h, _, (k, v) = decoder_layer_fwd(cfg, layer_params(stacked, i), h,
                                         q_chunk=q_chunk,
                                         moe_stepped=moe_stepped)
        if kv_sink is not None:
            kv_sink(i, k, v)
        del k, v
    return h


def decoder_layer_decode(cfg, p, cache_l, h, pos: int):
    """One-token decode through one layer. cache_l holds this layer's
    state (views of the stacked cache, updated in place). Returns h."""
    if "kt" in cache_l:
        o, _ = attn.gqa_decode_cluster_major(
            p["attn"], rmsnorm(p["ln1"], h), cache_l, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            top_p=cfg.cluster_top_p)
    else:
        o, _, _, _ = attn.gqa_decode(
            p["attn"], rmsnorm(p["ln1"], h), cache_l["k"], cache_l["v"],
            pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm)
    h = h + o
    return h + _mlp_apply(cfg, p, rmsnorm(p["ln2"], h))[0]


def run_stack_decode(cfg, stacked, cache, h, pos: int):
    """Decode one token through the layer stack with per-layer caches
    (``cache``: the stacked cache dict, updated in place). Returns h."""
    for i in range(n_layers_of(stacked)):
        cache_l = {f: v[i] for f, v in cache.items()}
        h = decoder_layer_decode(cfg, layer_params(stacked, i), cache_l, h,
                                 pos)
    return h
