"""Layer-stack assembly for the dense GQA and MoE families, with GQA or
MLA attention (port of those parts of ``repro.models.transformer``).

Layer params are stacked on a leading axis, as in the reference; the
stack runs as a Python loop over layers (the reference's ``lax.scan``),
forward only (no remat). The prefill keeps each layer's (k, v), or its
MLA latent, which the reference's ``_attn_apply`` drops, so the cache is
filled from one chunked forward. Decode takes the MLA branch (the latent
cache), the ``"kt"`` branch (cluster-major k²-attention) or the
flat-cache branch, which is k²-attention over member lists when the
cache holds ``"mem"`` (``kv_cluster.cluster_append`` then files the
token); the cluster-major tables are read-only in decode, which writes
only the ring (in place). The MLP is a SwiGLU or, in the MoE family,
``moe.moe_apply`` with shared experts or Arctic's parallel dense
residual. DeepSeek's dense first layers are :func:`dense_layer_init`
layers. SSM, the audio and VLM branches and Zamba's shared block wait
for ROADMAP §1 item 13.
"""
from __future__ import annotations

import itertools

import torch

from . import attention as attn
from . import moe as moe_mod
from .kv_cluster import cluster_append
from .layers import rmsnorm, rmsnorm_init, swiglu, swiglu_init


def layer_init(cfg, gen: torch.Generator, new=None) -> dict:
    """One decoder layer's params (dense GQA, or MoE with its optional
    dense residual), each tensor asked of ``new`` (layers.allocator)."""
    if cfg.family not in ("dense", "moe") or cfg.ssm:
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA and MoE families are ported "
            f"(ROADMAP §1 item 13)")
    d = cfg.d_model
    if cfg.mla:
        a = attn.mla_init(gen, d, cfg.n_heads, mla_dims(cfg), new=new)
    else:
        a = attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.qk_norm, new=new)
    p = {"ln1": rmsnorm_init(d, device=gen.device, new=new), "attn": a,
         "ln2": rmsnorm_init(d, device=gen.device, new=new)}
    if cfg.moe:
        p["mlp"] = moe_mod.moe_init(gen, d, cfg.moe_d_ff, cfg.n_experts,
                                    cfg.n_shared_experts, new=new)
        if cfg.dense_residual:
            p["dense_mlp"] = swiglu_init(gen, d, cfg.d_ff, new=new)
    else:
        p["mlp"] = swiglu_init(gen, d, cfg.d_ff, new=new)
    return p


def dense_layer_init(cfg, gen: torch.Generator, new=None) -> dict:
    """A plain dense layer (DeepSeek's ``first_dense`` prefix): GQA
    attention and a SwiGLU of ``d_ff``, whatever the config's MoE and MLA
    say."""
    d = cfg.d_model
    return {"ln1": rmsnorm_init(d, device=gen.device, new=new),
            "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, cfg.qk_norm, new=new),
            "ln2": rmsnorm_init(d, device=gen.device, new=new),
            "mlp": swiglu_init(gen, d, cfg.d_ff, new=new)}


def mla_dims(cfg) -> attn.MLADims:
    return attn.MLADims(cfg.kv_lora, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim)


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
    """One decoder layer, prefill path. Returns (h, aux, kv): the
    reference's (h, aux), and for the cache kv = (k, v), each (B, S, Hkv,
    dh), or with MLA (latent,), (B, S, r + rope). ``moe_stepped``: as
    :func:`_mlp_apply`."""
    x = rmsnorm(p["ln1"], h)
    if cfg.mla:
        o, lat = attn.mla_apply(p["attn"], x, n_heads=cfg.n_heads,
                                dims=mla_dims(cfg),
                                rope_theta=cfg.rope_theta, q_chunk=q_chunk)
        kv = (lat,)
    else:
        o, kv = attn.gqa_apply(p["attn"], x, n_heads=cfg.n_heads,
                               n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                               rope_theta=cfg.rope_theta,
                               qk_norm=cfg.qk_norm, q_chunk=q_chunk)
    del x
    h = h + o
    y, aux = _mlp_apply(cfg, p, rmsnorm(p["ln2"], h), moe_stepped)
    return h + y, aux, kv


def run_stack(cfg, stacked, h, q_chunk: int = 512, kv_sink=None,
              moe_stepped: bool = False):
    """Run the stacked decoder layers over h. Returns h. ``kv_sink(i, k,
    v)``, when given, receives layer i's keys and values before the next
    layer runs (``kv_sink(i, latent)`` with MLA). ``moe_stepped``: as
    :func:`_mlp_apply`."""
    for i in range(n_layers_of(stacked)):
        h, _, kv = decoder_layer_fwd(cfg, layer_params(stacked, i), h,
                                     q_chunk=q_chunk,
                                     moe_stepped=moe_stepped)
        if kv_sink is not None:
            kv_sink(i, *kv)
        del kv
    return h


def _clusters_of(cache_l):
    if "mem" in cache_l:
        return (cache_l["cent"], cache_l["mem"], cache_l["mmask"])
    return None


def decoder_layer_decode(cfg, p, cache_l, h, pos: int):
    """One-token decode through one layer. cache_l holds this layer's
    state (views of the stacked cache, updated in place). Returns h."""
    if cfg.mla:
        o, _ = attn.mla_decode(p["attn"], rmsnorm(p["ln1"], h),
                               cache_l["lat"], pos, n_heads=cfg.n_heads,
                               dims=mla_dims(cfg), rope_theta=cfg.rope_theta)
    elif "kt" in cache_l:
        o, _ = attn.gqa_decode_cluster_major(
            p["attn"], rmsnorm(p["ln1"], h), cache_l, pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            top_p=cfg.cluster_top_p)
    else:
        o, _, _, k_new = attn.gqa_decode(
            p["attn"], rmsnorm(p["ln1"], h), cache_l["k"], cache_l["v"],
            pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            clusters=_clusters_of(cache_l), top_p=cfg.cluster_top_p)
        if "mem" in cache_l:
            cluster_append(cache_l["cent"], cache_l["mem"], cache_l["mmask"],
                           cache_l["sizes"], k_new, pos)
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
