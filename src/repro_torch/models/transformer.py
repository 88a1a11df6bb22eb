"""Layer-stack assembly for every family of the reference: dense GQA
(and the VLM, whose LLM is one), MoE, SSM, hybrid and the audio
encoder-decoder, with GQA or MLA attention (port of
``repro.models.transformer``).

Layer params are stacked on a leading axis, as in the reference; the
stack runs as a Python loop over layers (the reference's ``lax.scan``).
:func:`run_stack_train` is the training stack: each layer under
:func:`remat`, the reference's ``REMAT_POLICIES`` on
``torch.utils.checkpoint``, and the MoE's load-balance losses summed; a
layer's slice of a stacked leaf (:func:`layer_params`) is a view, so its
gradient lands in the stacked leaf. The prefill keeps what each layer's
decode cache holds, which the reference's forward drops, so the cache is
filled from one chunked forward: a dict keyed by the cache's own field
names, (``k``, ``v``) of GQA, MLA's ``lat``, an SSM mixer's ``state``
(and RWKV6's ``xprev``), and Zamba's shared block's (``k``, ``v``) for
its application. Decode takes the SSM branches (the recurrent state, in
place), the MLA branch (the latent cache), the ``"kt"`` branch (cluster-
major k²-attention) or the flat-cache branch, which is k²-attention over
member lists when the cache holds ``"mem"``
(``kv_cluster.cluster_append`` then files the token); the cluster-major
tables are read-only in decode, which writes only the ring (in place).
The MLP is a SwiGLU or, in the MoE family, ``moe.moe_apply`` with shared
experts or Arctic's parallel dense residual; a Mamba2 layer has none.
DeepSeek's dense first layers are :func:`dense_layer_init` layers.
Zamba2's shared attention + MLP block (one set of weights) runs after
the mixer of every layer i with i % ``attn_every`` == 0, application
i // ``attn_every``, with a cache slot of its own. Whisper's encoder
layers (:func:`encoder_layer_fwd`) are dense layers with bidirectional
attention; its decoder layers (:func:`cross_layer_init`) add cross
attention (``lnx``, ``xattn``) over the encoder's keys and values between
the self attention and the MLP. In decode they read those keys and
values from the cache's ``xk``/``xv`` (:func:`cross_layer_decode`), which
the prefill fills from the encoder's output (``model.encode``).
"""
from __future__ import annotations

import functools
import itertools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .kv_cluster import cluster_append
from .layers import dense, rmsnorm, rmsnorm_init, swiglu, swiglu_init


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

_aten = torch.ops.aten
# the reference's REMAT_POLICIES: the matrix products a layer's backward
# keeps from its forward ("dots": every product, jax's checkpoint_dots;
# "dots_no_batch": those without batch dimensions); the rest of the layer
# is recomputed. "none" keeps everything, "full" nothing.
REMAT_POLICIES = {
    "none": None,
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
    "full": (),
}


def _save_only(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, policy: str, *args):
    """``fn(*args)`` with its activations kept as ``policy`` says (a key
    of :data:`REMAT_POLICIES`): all of them ("none"), none but the
    inputs ("full", a plain checkpoint), or the matrix products' outputs
    (a selective checkpoint). The numbers do not depend on the policy: a
    recomputed op repeats its forward's arithmetic."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat: {policy!r} is not one of "
                         f"{sorted(REMAT_POLICIES)}")
    ops = REMAT_POLICIES[policy]
    if ops is None:
        return fn(*args)
    if not ops:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          functools.partial(_save_only, ops)))


def check_family(cfg) -> None:
    """Raise for a family string the reference does not have."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: no family {cfg.family!r} in the reference, whose "
            f"families {FAMILIES} the port serves and trains; what ROADMAP §1 "
            f"item 13 leaves is its slice g (LM placement)")


def layer_init(cfg, gen: torch.Generator, new=None) -> dict:
    """One decoder layer's params (dense GQA, MoE with its optional dense
    residual, an RWKV6 layer, or a Mamba2 layer, which has no MLP), each
    tensor asked of ``new`` (layers.allocator)."""
    check_family(cfg)
    d = cfg.d_model
    ln = lambda: rmsnorm_init(d, device=gen.device, new=new)  # noqa: E731
    if cfg.ssm == "rwkv6":
        return {"ln1": ln(), "mix": ssm_mod.rwkv6_init(gen, d, cfg.n_heads,
                                                       new=new),
                "ln2": ln(), "mlp": swiglu_init(gen, d, cfg.d_ff, new=new)}
    if cfg.ssm == "mamba2":
        return {"ln1": ln(), "mix": ssm_mod.mamba2_init(
            gen, d, cfg.n_heads, cfg.ssm_state, cfg.ssm_expand, new=new)}
    if cfg.mla:
        a = attn.mla_init(gen, d, cfg.n_heads, mla_dims(cfg), new=new)
    else:
        a = attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.qk_norm, new=new)
    p = {"ln1": ln(), "attn": a, "ln2": ln()}
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


def shared_attn_init(cfg, gen: torch.Generator, new=None) -> dict:
    """Zamba2's shared attention + MLP block (one set of weights): GQA
    without qk-norm and a SwiGLU of ``d_ff``."""
    d = cfg.d_model
    return {"ln1": rmsnorm_init(d, device=gen.device, new=new),
            "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, False, new=new),
            "ln2": rmsnorm_init(d, device=gen.device, new=new),
            "mlp": swiglu_init(gen, d, cfg.d_ff, new=new)}


def cross_layer_init(cfg, gen: torch.Generator, new=None) -> dict:
    """Whisper's decoder layer: self attention, cross attention (GQA
    without qk-norm, each) and a SwiGLU of ``d_ff``."""
    d = cfg.d_model
    ln = lambda: rmsnorm_init(d, device=gen.device, new=new)  # noqa: E731
    gqa = lambda: attn.gqa_init(gen, d, cfg.n_heads,  # noqa: E731
                                cfg.n_kv_heads, cfg.d_head, False, new=new)
    return {"ln1": ln(), "attn": gqa(), "lnx": ln(), "xattn": gqa(),
            "ln2": ln(), "mlp": swiglu_init(gen, d, cfg.d_ff, new=new)}


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


def shared_block_fwd(cfg, sp, h, q_chunk: int = 512):
    """Zamba2's shared block, prefill path: (h, (k, v)), the keys and
    values (B, S, Hkv, dh) for the application's cache."""
    o, kv = attn.gqa_apply(sp["attn"], rmsnorm(sp["ln1"], h),
                           n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                           d_head=cfg.d_head, rope_theta=cfg.rope_theta,
                           q_chunk=q_chunk)
    h = h + o
    return h + swiglu(sp["mlp"], rmsnorm(sp["ln2"], h)), kv


def decoder_layer_fwd(cfg, p, h, q_chunk: int = 512,
                      moe_stepped: bool = False):
    """One decoder layer, prefill path. Returns (h, aux, fields): the
    reference's (h, aux), and what the layer's decode cache keeps, keyed
    by the cache's field names: ``k``, ``v`` (B, S, Hkv, dh); with MLA
    ``lat`` (B, S, r + rope); an RWKV6 layer's ``state`` (B, H, dh, dh)
    and ``xprev`` (B, 1, d); a Mamba2 layer's ``state`` (B, H, P, N).
    ``moe_stepped``: as :func:`_mlp_apply`."""
    x = rmsnorm(p["ln1"], h)
    if cfg.ssm == "rwkv6":
        o, state, xprev = ssm_mod.rwkv6_apply(p["mix"], x,
                                              n_heads=cfg.n_heads)
        h = h + o
        return (h + swiglu(p["mlp"], rmsnorm(p["ln2"], h)), 0.0,
                {"state": state, "xprev": xprev})
    if cfg.ssm == "mamba2":
        o, state = ssm_mod.mamba2_apply(p["mix"], x, n_heads=cfg.n_heads)
        return h + o, 0.0, {"state": state}
    if cfg.mla:
        o, lat = attn.mla_apply(p["attn"], x, n_heads=cfg.n_heads,
                                dims=mla_dims(cfg),
                                rope_theta=cfg.rope_theta, q_chunk=q_chunk)
        fields = {"lat": lat}
    else:
        o, (k, v) = attn.gqa_apply(p["attn"], x, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
                                   rope_theta=cfg.rope_theta,
                                   qk_norm=cfg.qk_norm, q_chunk=q_chunk)
        fields = {"k": k, "v": v}
    del x
    h = h + o
    y, aux = _mlp_apply(cfg, p, rmsnorm(p["ln2"], h), moe_stepped)
    return h + y, aux, fields


def encoder_layer_fwd(cfg, p, h, q_chunk: int = 512):
    """Whisper's encoder layer: bidirectional (non-causal) attention, with
    RoPE on the encoder positions through ``gqa_project`` and no
    qk-norm, as the reference; then the SwiGLU."""
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :]
    q, k, v = attn.gqa_project(p["attn"], rmsnorm(p["ln1"], h), cfg.n_heads,
                               cfg.n_kv_heads, cfg.d_head, positions,
                               cfg.rope_theta, False)
    o = attn.causal_attention(q, k, v, causal=False, q_chunk=q_chunk)
    del q, k, v
    h = h + dense(p["attn"]["wo"], o.reshape(B, S, -1))
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h))


def cross_kv(cfg, p, enc_out):
    """A decoder layer's cross-attention keys and values of the normed
    encoder output (B, Skv, d): ``dense(xattn.wk|wv, enc_out)`` in the
    cache's layout (B, Hkv, Skv, dh)."""
    B = enc_out.shape[0]
    return tuple(dense(p["xattn"][w], enc_out).reshape(
        B, -1, cfg.n_kv_heads, cfg.d_head).transpose(1, 2)
        for w in ("wk", "wv"))


def cross_layer_fwd(cfg, p, h, enc_out=None, q_chunk: int = 512, xkv=None):
    """Whisper's decoder layer, prefill path: causal self attention, cross
    attention of h's queries over the encoder's keys and values, the
    SwiGLU. The cross keys and values are ``cross_kv(enc_out)``, or
    ``xkv`` (xk, xv), already in the cache's layout (B, Hkv, Skv, dh).
    Returns (h, fields): the self attention's ``k``, ``v``
    (B, S, Hkv, dh), keyed as the cache keys them."""
    o, (k, v) = attn.gqa_apply(p["attn"], rmsnorm(p["ln1"], h),
                               n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                               d_head=cfg.d_head, rope_theta=cfg.rope_theta,
                               q_chunk=q_chunk)
    h = h + o
    B, S, _ = h.shape
    xk, xv = xkv if xkv is not None else cross_kv(cfg, p, enc_out)
    q = dense(p["xattn"]["wq"], rmsnorm(p["lnx"], h)).reshape(
        B, S, cfg.n_heads, cfg.d_head)
    o = attn.causal_attention(q, xk.transpose(1, 2), xv.transpose(1, 2),
                              causal=False, q_chunk=q_chunk)
    h = h + dense(p["xattn"]["wo"], o.reshape(B, S, -1))
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h)), {"k": k, "v": v}


def run_stack(cfg, stacked, h, shared_p=None, q_chunk: int = 512,
              kv_sink=None, shared_sink=None, moe_stepped: bool = False,
              cross=None):
    """Run the stacked decoder layers over h. Returns h. ``kv_sink(i,
    fields)``, when given, receives layer i's cache fields
    (:func:`decoder_layer_fwd`) before the next layer runs. With
    ``shared_p`` (Zamba2), layer i with i % attn_every == 0 is followed
    by the shared block, and ``shared_sink(app, k, v)`` receives its keys
    and values at application i // attn_every. ``moe_stepped``: as
    :func:`_mlp_apply`. ``cross`` (an audio config's stack: cross
    layers): {"xk", "xv"} stacked over the layers (L, B, Hkv, Skv, dh),
    each layer's cross keys and values (``model.encode``)."""
    for i in range(n_layers_of(stacked)):
        if cross is not None:
            h, fields = cross_layer_fwd(
                cfg, layer_params(stacked, i), h, q_chunk=q_chunk,
                xkv=(cross["xk"][i], cross["xv"][i]))
        else:
            h, _, fields = decoder_layer_fwd(cfg, layer_params(stacked, i),
                                             h, q_chunk=q_chunk,
                                             moe_stepped=moe_stepped)
        if kv_sink is not None:
            kv_sink(i, fields)
        del fields
        if cfg.attn_every and shared_p is not None \
                and i % cfg.attn_every == 0:
            h, (k, v) = shared_block_fwd(cfg, shared_p, h, q_chunk)
            if shared_sink is not None:
                shared_sink(i // cfg.attn_every, k, v)
            del k, v
    return h


def run_stack_train(cfg, stacked, h, shared_p=None, remat_policy: str = "dots",
                    q_chunk: int = 512):
    """The training stack: each decoder layer (with Zamba2's shared block
    after it when i % attn_every == 0, as the reference's layer body
    holds it) under :func:`remat`. Returns (h, aux): the summed MoE
    load-balance losses, 0-d f32 (0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def body(i, h, p):
        h, a, _ = decoder_layer_fwd(cfg, p, h, q_chunk=q_chunk)
        if cfg.attn_every and shared_p is not None \
                and i % cfg.attn_every == 0:
            h = shared_block_fwd(cfg, shared_p, h, q_chunk)[0]
        return h, a
    for i in range(n_layers_of(stacked)):
        h, a = remat(functools.partial(body, i), remat_policy, h,
                     layer_params(stacked, i))
        aux = aux + a
    return h, aux


def _clusters_of(cache_l):
    if "mem" in cache_l:
        return (cache_l["cent"], cache_l["mem"], cache_l["mmask"])
    return None


def decoder_layer_decode(cfg, p, cache_l, h, pos: int):
    """One-token decode through one layer. cache_l holds this layer's
    state (views of the stacked cache, updated in place). Returns h."""
    if cfg.ssm == "rwkv6":
        xt = rmsnorm(p["ln1"], h)
        o, _, _ = ssm_mod.rwkv6_decode(p["mix"], xt, cache_l["xprev"],
                                       cache_l["state"], n_heads=cfg.n_heads)
        cache_l["xprev"].copy_(xt)
        h = h + o
        return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h))
    if cfg.ssm == "mamba2":
        o, _ = ssm_mod.mamba2_decode(p["mix"], rmsnorm(p["ln1"], h),
                                     cache_l["state"], n_heads=cfg.n_heads)
        return h + o
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


def cross_layer_decode(cfg, p, cache_l, h, pos: int):
    """Whisper's decoder layer, one-token decode: self attention over the
    cluster-major cache (``"kt"``, K6) or the flat one (with member lists
    when it holds ``"mem"``; as the reference, this branch files no token
    into them), then cross attention of the token's query over all
    enc_len slots of ``xk``/``xv``, then the SwiGLU. The caches are
    updated in place. Returns h."""
    x = rmsnorm(p["ln1"], h)
    if "kt" in cache_l:
        o, _ = attn.gqa_decode_cluster_major(
            p["attn"], x, cache_l, pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            top_p=cfg.cluster_top_p)
    else:
        o, _, _, _ = attn.gqa_decode(
            p["attn"], x, cache_l["k"], cache_l["v"], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
            rope_theta=cfg.rope_theta, clusters=_clusters_of(cache_l),
            top_p=cfg.cluster_top_p)
    del x
    h = h + o
    B = h.shape[0]
    q = dense(p["xattn"]["wq"], rmsnorm(p["lnx"], h)).reshape(
        B, cfg.n_heads, cfg.d_head)
    o = attn.decode_attention(q, cache_l["xk"], cache_l["xv"])
    h = h + dense(p["xattn"]["wo"], o.reshape(B, 1, -1))
    return h + swiglu(p["mlp"], rmsnorm(p["ln2"], h))


def shared_block_decode(cfg, sp, sc_app, h, pos: int):
    """Zamba2's shared block, one-token decode, over its application's
    cache ``sc_app`` (views, updated in place): the flat ``k``/``v``
    (B, Hkv, S, dh), or the cluster-major tables (read-only) and ring.
    Returns h."""
    x = rmsnorm(sp["ln1"], h)
    if "kt" in sc_app:
        o, _ = attn.gqa_decode_cluster_major(
            sp["attn"], x, sc_app, pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
            top_p=cfg.cluster_top_p)
    else:
        o, _, _, _ = attn.gqa_decode(
            sp["attn"], x, sc_app["k"], sc_app["v"], pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta)
    h = h + o
    return h + swiglu(sp["mlp"], rmsnorm(sp["ln2"], h))


def run_stack_decode(cfg, stacked, cache, h, pos: int, shared_p=None,
                     shared_cache=None, layer_decode_fn=None):
    """Decode one token through the layer stack with per-layer caches
    (``cache``: the stacked cache dict, updated in place), each layer
    through ``layer_decode_fn`` (default :func:`decoder_layer_decode`;
    :func:`cross_layer_decode` for an audio stack). With ``shared_p``
    (Zamba2), layer i with i % attn_every == 0 then runs the shared block
    over application i // attn_every of ``shared_cache`` (leading axis
    the applications). Returns h."""
    fn = layer_decode_fn or decoder_layer_decode
    for i in range(n_layers_of(stacked)):
        cache_l = {f: v[i] for f, v in cache.items()}
        h = fn(cfg, layer_params(stacked, i), cache_l, h, pos)
        if cfg.attn_every and shared_p is not None \
                and i % cfg.attn_every == 0:
            app = i // cfg.attn_every
            h = shared_block_decode(
                cfg, shared_p, {f: v[app] for f, v in shared_cache.items()},
                h, pos)
    return h
