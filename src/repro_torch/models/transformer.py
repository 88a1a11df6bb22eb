"""Layer-stack assembly for the dense GQA family (port of the dense part
of ``repro.models.transformer``).

Layer params are stacked on a leading axis, as in the reference; the
stack runs as a Python loop over layers (the reference's ``lax.scan``),
forward only (no remat). The prefill keeps each layer's (k, v), which
the reference's ``_attn_apply`` drops, so the flat cache is filled from
one chunked forward. Decode takes the ``"kt"`` branch (cluster-major
k²-attention) or the flat-cache branch; the cluster tables are read-only
in decode, which writes only the ring (in place). MoE, MLA, SSM, the
audio and VLM branches, Zamba's shared block and the flat-cache clustered
variant wait for ROADMAP §1 item 13.
"""
from __future__ import annotations

import torch

from . import attention as attn
from .layers import rmsnorm, rmsnorm_init, swiglu, swiglu_init


def layer_init(cfg, gen: torch.Generator) -> dict:
    """One dense decoder layer's params."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported "
            f"(ROADMAP §1 item 13)")
    d = cfg.d_model
    return {"ln1": rmsnorm_init(d, device=gen.device),
            "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, cfg.qk_norm),
            "ln2": rmsnorm_init(d, device=gen.device),
            "mlp": swiglu_init(gen, d, cfg.d_ff)}


def stack_init(cfg, gen: torch.Generator, init_fn, n_layers: int) -> dict:
    """Stack ``n_layers`` inits on a leading axis."""
    layers = [init_fn(cfg, gen) for _ in range(n_layers)]

    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        return torch.stack(parts)
    return stack(layers)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params (views) out of a stacked tree."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def n_layers_of(stacked: dict) -> int:
    v = stacked
    while isinstance(v, dict):
        v = next(iter(v.values()))
    return v.shape[0]


def decoder_layer_fwd(cfg, p, h, q_chunk: int = 512):
    """One decoder layer, prefill path. Returns (h, (k, v)), k and v
    (B, S, Hkv, dh). (The reference's auxiliary loss is MoE's: 0 here.)"""
    o, kv = attn.gqa_apply(p["attn"], rmsnorm(p["ln1"], h),
                           n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                           d_head=cfg.d_head, rope_theta=cfg.rope_theta,
                           qk_norm=cfg.qk_norm, q_chunk=q_chunk)
    h = h + o
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h)), kv


def run_stack(cfg, stacked, h, q_chunk: int = 512, kv_sink=None):
    """Run the stacked decoder layers over h. Returns h. ``kv_sink(i, k,
    v)``, when given, receives layer i's keys and values before the next
    layer runs."""
    for i in range(n_layers_of(stacked)):
        h, (k, v) = decoder_layer_fwd(cfg, layer_params(stacked, i), h,
                                      q_chunk=q_chunk)
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
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h))


def run_stack_decode(cfg, stacked, cache, h, pos: int):
    """Decode one token through the layer stack with per-layer caches
    (``cache``: the stacked cache dict, updated in place). Returns h."""
    for i in range(n_layers_of(stacked)):
        cache_l = {f: v[i] for f, v in cache.items()}
        h = decoder_layer_decode(cfg, layer_params(stacked, i), cache_l, h,
                                 pos)
    return h
