"""Top-level model: the dense GQA and MoE families, with GQA or MLA
attention and DeepSeek's dense prefix, and the SSM (RWKV6) and hybrid
(Zamba2: Mamba2 layers and a shared attention block) families (port of
``repro.models.model``): config -> params, prefill forward, caches and
the serve step.

Params are nested dicts of tensors whose paths and shapes are the
reference's (``convert.params_from_reference`` carries them across),
plus ``"embed_f32"``: one f32 copy of the tied embedding, which
``unembed`` multiplies in f32 as the reference does (it converts the
whole table on every call). A config with ``first_dense`` layers has a
``"prefix"`` stack of dense GQA layers run before the ``"stack"`` (under
:func:`prefix_config`, as the reference), with a flat k/v cache of its
own. A config with ``attn_every`` has ``"shared"`` params, one
attention + MLP block, and a ``"shared"`` cache with one slot for each of
its ⌈n_layers / attn_every⌉ applications. An SSM layer's cache is its
recurrent state (f32) and, for RWKV6, the previous token's normed input
``xprev``. The caches are updated in place by ``serve_step``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import host_input, resolve
from . import transformer as tf
from .layers import rmsnorm, rmsnorm_init


def init_params(cfg, gen: torch.Generator, *, device=None) -> dict:
    """Random params from ``gen`` on ``device`` (the card by default),
    which must be the generator's device."""
    dev = resolve(device)
    if gen.device.type != dev.type or (
            dev.index is not None and gen.device.index != dev.index):
        raise ValueError(f"init_params: generator on {gen.device}, params "
                         f"asked for on {dev}")
    d, v = cfg.d_model, cfg.vocab
    tf.check_family(cfg)
    emb = torch.randn((v, d), generator=gen, dtype=torch.float32,
                      device=gen.device) * d ** -0.5
    params = {"embed": emb.to(torch.bfloat16),
              "out_norm": rmsnorm_init(d, device=gen.device)}
    if cfg.first_dense:
        params["prefix"] = tf.stack_init(cfg, gen, tf.dense_layer_init,
                                         cfg.first_dense)
    params["stack"] = tf.stack_init(cfg, gen, tf.layer_init,
                                    cfg.n_layers - cfg.first_dense)
    if cfg.attn_every:
        params["shared"] = tf.shared_attn_init(cfg, gen)
    return with_unembed_table(params)


def prefix_config(cfg):
    """The config the ``first_dense`` prefix runs under: no MoE, no MLA."""
    return dataclasses.replace(cfg, moe=False, mla=False)


def with_unembed_table(params: dict) -> dict:
    """Add the f32 copy of the embedding that ``unembed`` reads."""
    params["embed_f32"] = params["embed"].float()
    return params


def embed_tokens(cfg, params, tokens):
    return params["embed"][tokens.long()]


def unembed(cfg, params, h):
    """h (..., d) -> f32 logits (..., vocab): h in f32 against the f32
    tied embedding."""
    return h.float() @ params["embed_f32"].T


def forward_prefill(cfg, params, tokens, *, q_chunk: int = 512,
                    kv_sink=None, prefix_sink=None, shared_sink=None,
                    moe_stepped: bool = False):
    """Prefill forward: logits for the LAST position only, (B, vocab).
    ``kv_sink(i, fields)`` receives every stack layer's cache fields, a
    dict keyed by the cache's field names (``transformer.
    decoder_layer_fwd``), ``prefix_sink(i, fields)`` every prefix layer's
    and ``shared_sink(app, k, v)`` the shared block's keys and values at
    each application. ``moe_stepped``: route the MoE's tokens as a
    decode step over each position would (``moe.moe_apply_stepped``) and
    not as one call over all B·S tokens, whose capacity drops pairs the
    steps keep."""
    h = embed_tokens(cfg, params, tokens)
    if cfg.first_dense:
        h = tf.run_stack(prefix_config(cfg), params["prefix"], h,
                         q_chunk=q_chunk, kv_sink=prefix_sink)
    h = tf.run_stack(cfg, params["stack"], h, shared_p=params.get("shared"),
                     q_chunk=q_chunk, kv_sink=kv_sink,
                     shared_sink=shared_sink, moe_stepped=moe_stepped)
    h_last = rmsnorm(params["out_norm"], h[:, -1:])
    return unembed(cfg, params, h_last)[:, 0]


def _layer_cache_shape(cfg, B: int, S: int, clustered: bool) -> dict:
    dh, hkv = cfg.d_head, cfg.n_kv_heads
    if cfg.ssm == "rwkv6":     # the state, whatever ``clustered`` says
        dhead = cfg.d_model // cfg.n_heads
        return {"state": ((B, cfg.n_heads, dhead, dhead), torch.float32),
                "xprev": ((B, 1, cfg.d_model), torch.bfloat16)}
    if cfg.ssm == "mamba2":
        d_in = cfg.ssm_expand * cfg.d_model
        return {"state": ((B, cfg.n_heads, d_in // cfg.n_heads,
                           cfg.ssm_state), torch.float32)}
    if cfg.mla:             # the latent, whatever ``clustered`` says
        return {"lat": ((B, S, cfg.kv_lora + cfg.qk_rope_dim),
                        torch.bfloat16)}
    if clustered:
        kc, cap, R = cfg.kv_clusters, cfg.cluster_cap, cfg.cluster_ring
        return {"kt": ((B, hkv, kc, cap, dh), torch.bfloat16),
                "vt": ((B, hkv, kc, cap, dh), torch.bfloat16),
                "cent": ((B, hkv, kc, dh), torch.bfloat16),
                "sizes": ((B, hkv, kc), torch.int32),
                "ring_k": ((B, hkv, R, dh), torch.bfloat16),
                "ring_v": ((B, hkv, R, dh), torch.bfloat16),
                "ring_fill": ((), torch.int32)}
    # decode-native layout (B, Hkv, S, dh)
    return {"k": ((B, hkv, S, dh), torch.bfloat16),
            "v": ((B, hkv, S, dh), torch.bfloat16)}


def n_shared_apps(cfg) -> int:
    """The applications of the shared block: ⌈n_layers / attn_every⌉."""
    return -(-cfg.n_layers // cfg.attn_every)


def cache_shapes(cfg, B: int, S: int, *, clustered: bool | None = None):
    """{"stack": {field: (shape, dtype)}} of the stacked decode cache,
    {"prefix": ...} (a flat k/v cache) with ``first_dense`` layers, and
    {"shared": ...} with ``attn_every``: the shared block's cache (flat or
    cluster-major as ``clustered`` says) stacked over its applications,
    the ring's fill one per application. ``clustered=None``: clustered
    from ``long_context_threshold`` on, never for an SSM config."""
    if clustered is None:
        clustered = S >= cfg.long_context_threshold and not cfg.ssm

    def stacked(c, n, clus):
        return {f: ((n,) + shape, dt) for f, (shape, dt) in
                _layer_cache_shape(c, B, S, clus).items()}
    out = {"stack": stacked(cfg, cfg.n_layers - cfg.first_dense, clustered)}
    if cfg.first_dense:
        out["prefix"] = stacked(prefix_config(cfg), cfg.first_dense, False)
    if cfg.attn_every:
        attn_cfg = dataclasses.replace(cfg, ssm="")
        out["shared"] = stacked(attn_cfg, n_shared_apps(cfg), clustered)
    return out


def init_cache(cfg, B: int, S: int, *, clustered: bool | None = None,
               device=None) -> dict:
    """Zero-initialised decode cache, stacked over layers, on ``device``
    (the card by default)."""
    dev = resolve(device)
    return {part: {f: torch.zeros(shape, dtype=dt, device=dev)
                   for f, (shape, dt) in fields.items()}
            for part, fields in cache_shapes(cfg, B, S,
                                             clustered=clustered).items()}


def serve_step(cfg, params, cache, tokens, pos: int, *, device=None):
    """Decode one token. tokens: (B, 1) int; pos: the slot (host int).
    Returns (logits (B, vocab) f32, cache), the cache updated in place.
    Whether attention is full or clustered is decided by the cache's
    contents: a cluster-major cache carries ``kt``, a flat cache with
    member lists ``mem`` (Zamba2's shared block: its ``"shared"``
    cache). The step runs where
    params and cache lie; host-array tokens go to ``device`` (the card
    by default), which must be theirs."""
    tokens = host_input(tokens, device)
    if tokens.device != params["embed"].device:
        raise ValueError(f"serve_step: tokens on {tokens.device}, params "
                         f"on {params['embed'].device}")
    h = embed_tokens(cfg, params, tokens)
    if cfg.first_dense:
        h = tf.run_stack_decode(prefix_config(cfg), params["prefix"],
                                cache["prefix"], h, pos)
    h = tf.run_stack_decode(cfg, params["stack"], cache["stack"], h, pos,
                            shared_p=params.get("shared"),
                            shared_cache=cache.get("shared"))
    h = rmsnorm(params["out_norm"], h)
    return unembed(cfg, params, h)[:, 0], cache
