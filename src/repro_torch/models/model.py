"""Top-level model: the dense GQA and MoE families, with GQA or MLA
attention and DeepSeek's dense prefix, the SSM (RWKV6) and hybrid
(Zamba2: Mamba2 layers and a shared attention block) families, the VLM
(InternVL2: a dense LLM whose first ``n_patches`` positions take patch
embeddings) and the audio encoder-decoder (Whisper) (port of
``repro.models.model``): config -> params, the training forward, the
encoder, prefill forward, caches and the serve step.

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
``xprev``. An audio config has an ``"enc"`` stack of dense encoder
layers and ``"enc_norm"``, and its ``"stack"`` is of cross layers
(``transformer.cross_layer_init``), whose cache holds the cross
attention's keys and values ``xk``/``xv`` (B, Hkv, enc_len, dh) beside
the self attention's: :func:`encode` computes them from the frames. The
caches are updated in place by ``serve_step``.

Differences from the reference: its ``forward_prefill`` on an audio
config runs the cross layers as plain decoder layers, with neither the
encoder nor the cross attention (ROADMAP §3 entry 26); this one runs
both, and raises without frames. ``serve_step`` takes ``patches=`` (the
reference's ignores patches), so a patched prompt can also be stepped.

Training (:func:`forward_train`) reads no ``"embed_f32"``: its
unembedding converts ``params["embed"]`` to f32 inside the autograd
graph, as the reference does, so the tied table takes its gradient
through both ends. The training state is made without the copy
(``init_params(..., unembed_table=False)``); a trained model gets it
again with :func:`with_unembed_table` before it serves.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import host_input, resolve
from . import transformer as tf
from .layers import MetaGenerator, rmsnorm, rmsnorm_init, softmax_xent


def init_params(cfg, gen: torch.Generator, *, device=None,
                unembed_table: bool = True) -> dict:
    """Random params from ``gen`` on ``device`` (the card by default),
    which must be the generator's device; with ``unembed_table`` the f32
    copy of the embedding that serving's ``unembed`` reads (a training
    state goes without it)."""
    dev = resolve(device)
    if gen.device.type != dev.type or (
            dev.index is not None and gen.device.index != dev.index):
        raise ValueError(f"init_params: generator on {gen.device}, params "
                         f"asked for on {dev}")
    d, v = cfg.d_model, cfg.vocab
    tf.check_family(cfg)
    if dev.type == "meta":
        emb = torch.empty((v, d), dtype=torch.float32, device=dev)
    else:
        emb = torch.randn((v, d), generator=gen, dtype=torch.float32,
                          device=gen.device) * d ** -0.5
    params = {"embed": emb.to(torch.bfloat16),
              "out_norm": rmsnorm_init(d, device=gen.device)}
    if cfg.family == "audio":
        params["enc"] = tf.stack_init(cfg, gen, tf.dense_layer_init,
                                      cfg.encoder_layers)
        params["enc_norm"] = rmsnorm_init(d, device=gen.device)
        params["stack"] = tf.stack_init(cfg, gen, tf.cross_layer_init,
                                        cfg.n_layers)
    else:
        if cfg.first_dense:
            params["prefix"] = tf.stack_init(cfg, gen, tf.dense_layer_init,
                                             cfg.first_dense)
        params["stack"] = tf.stack_init(cfg, gen, tf.layer_init,
                                        cfg.n_layers - cfg.first_dense)
        if cfg.attn_every:
            params["shared"] = tf.shared_attn_init(cfg, gen)
    return with_unembed_table(params) if unembed_table else params


def param_shapes(cfg) -> dict:
    """The training params' tree of meta tensors (shapes and types, no
    storage): the reference's ``param_shapes``."""
    return init_params(cfg, MetaGenerator(), device="meta",
                       unembed_table=False)


def prefix_config(cfg):
    """The config the ``first_dense`` prefix runs under: no MoE, no MLA."""
    return dataclasses.replace(cfg, moe=False, mla=False)


def with_unembed_table(params: dict) -> dict:
    """Add the f32 copy of the embedding that ``unembed`` reads."""
    params["embed_f32"] = params["embed"].float()
    return params


def embed_tokens(cfg, params, tokens, patches=None, *, start: int = 0):
    """The token embeddings of ``tokens`` (B, S) at positions start, ...,
    start + S - 1. With ``patches`` (B, n_patches, d) on a VLM config the
    positions below ``n_patches`` take their patch rows instead, cast to
    the embedding's type (the vision tower's output, stubbed); with
    ``start`` 0 and S >= n_patches this is the reference's
    ``embed_tokens``."""
    h = params["embed"][tokens.long()]
    n = min(cfg.n_patches, start + h.shape[1]) - start
    if patches is not None and n > 0:
        if patches.shape[1] != cfg.n_patches:
            raise ValueError(f"{cfg.name}: patches {tuple(patches.shape)}, "
                             f"want (B, {cfg.n_patches}, {cfg.d_model})")
        h[:, :n] = patches[:, start:start + n].to(h.dtype)
    return h


def unembed(cfg, params, h):
    """h (..., d) -> f32 logits (..., vocab): h in f32 against the f32
    tied embedding."""
    return h.float() @ params["embed_f32"].T


def forward_train(cfg, params, batch, *, remat: str = "dots",
                  q_chunk: int = 512):
    """The training loss of ``batch`` ({"tokens", "labels"} (B, S) ints,
    with ``"frames"`` (B, S_enc, d) on an audio config, ``"patches"`` (B,
    n_patches, d) on a VLM one): (loss + 0.01 aux, {"loss", "aux"}), the
    reference's ``forward_train``. ``remat`` is the stack's policy
    (``transformer.REMAT_POLICIES``); as the reference, the audio
    encoder's and decoder's layers are checkpointed whole and the
    ``first_dense`` prefix not at all. The unembedding multiplies h in
    f32 by ``params["embed"]`` converted to f32 in the graph."""
    tokens = batch["tokens"]
    if cfg.family == "audio":
        # the stubbed frontend's frame embeddings, cast to bf16 as the
        # reference casts them
        h = batch["frames"].to(torch.bfloat16)
        for i in range(tf.n_layers_of(params["enc"])):
            h = tf.remat(lambda x, p: tf.encoder_layer_fwd(
                cfg, p, x, q_chunk=q_chunk), "full", h,
                tf.layer_params(params["enc"], i))
        enc_out = rmsnorm(params["enc_norm"], h)
        h = embed_tokens(cfg, params, tokens)
        for i in range(tf.n_layers_of(params["stack"])):
            h = tf.remat(lambda x, p: tf.cross_layer_fwd(
                cfg, p, x, enc_out, q_chunk=q_chunk)[0], "full", h,
                tf.layer_params(params["stack"], i))
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        h = embed_tokens(cfg, params, tokens, batch.get("patches"))
        if cfg.first_dense:
            h, _ = tf.run_stack_train(prefix_config(cfg), params["prefix"], h,
                                      remat_policy="none", q_chunk=q_chunk)
        h, aux = tf.run_stack_train(cfg, params["stack"], h,
                                    shared_p=params.get("shared"),
                                    remat_policy=remat, q_chunk=q_chunk)
    h = rmsnorm(params["out_norm"], h)
    logits = h.float() @ params["embed"].float().T
    del h
    loss = softmax_xent(logits, batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def encode(cfg, params, frames, *, q_chunk: int = 512):
    """Whisper's encoder over ``frames`` (B, enc_len, d), the stubbed
    frontend's frame embeddings, cast to the embedding's type: the dense
    encoder layers (bidirectional attention), then ``enc_norm``. Returns
    (the normed encoder output (B, enc_len, d), {"xk", "xv"}): every
    decoder layer's cross-attention keys and values of that output,
    ``dense(xattn.wk|wv, ·)``, stacked over the layers in the cache's
    layout (L, B, Hkv, enc_len, dh), which ``cross_layer_decode`` reads
    and the reference's cache never gets filled with (ROADMAP §3 entry
    26)."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: encode runs an audio config's "
                         f"encoder, not a {cfg.family} config's")
    h = frames.to(params["embed"].dtype)
    for i in range(tf.n_layers_of(params["enc"])):
        h = tf.encoder_layer_fwd(cfg, tf.layer_params(params["enc"], i), h,
                                 q_chunk=q_chunk)
    out = rmsnorm(params["enc_norm"], h)
    del h
    kv = [tf.cross_kv(cfg, tf.layer_params(params["stack"], i), out)
          for i in range(cfg.n_layers)]
    return out, {"xk": torch.stack([k for k, _ in kv]),
                 "xv": torch.stack([v for _, v in kv])}


def forward_prefill(cfg, params, tokens, *, q_chunk: int = 512,
                    kv_sink=None, prefix_sink=None, shared_sink=None,
                    moe_stepped: bool = False, patches=None, frames=None,
                    cross=None):
    """Prefill forward: logits for the LAST position only, (B, vocab).
    ``kv_sink(i, fields)`` receives every stack layer's cache fields, a
    dict keyed by the cache's field names (``transformer.
    decoder_layer_fwd``), ``prefix_sink(i, fields)`` every prefix layer's
    and ``shared_sink(app, k, v)`` the shared block's keys and values at
    each application. ``moe_stepped``: route the MoE's tokens as a
    decode step over each position would (``moe.moe_apply_stepped``) and
    not as one call over all B·S tokens, whose capacity drops pairs the
    steps keep. ``patches`` (B, n_patches, d): a VLM's patch rows in
    place of the first positions' embeddings (:func:`embed_tokens`). An
    audio config needs ``frames`` (B, enc_len, d), which :func:`encode`
    runs through the encoder, or ``cross``, :func:`encode`'s keys and
    values, and runs its cross layers over them."""
    if cfg.family == "audio":
        if cross is None:
            if frames is None:
                raise ValueError(
                    f"{cfg.name}: an audio prefill needs frames= (or the "
                    f"encoder's cross= keys and values); the reference's "
                    f"forward_prefill runs its cross layers without the "
                    f"encoder (ROADMAP §3 entry 26)")
            cross = encode(cfg, params, frames, q_chunk=q_chunk)[1]
    elif frames is not None or cross is not None:
        raise ValueError(f"{cfg.name}: frames are an audio config's input")
    h = embed_tokens(cfg, params, tokens, patches)
    if cfg.first_dense:
        h = tf.run_stack(prefix_config(cfg), params["prefix"], h,
                         q_chunk=q_chunk, kv_sink=prefix_sink)
    h = tf.run_stack(cfg, params["stack"], h, shared_p=params.get("shared"),
                     q_chunk=q_chunk, kv_sink=kv_sink,
                     shared_sink=shared_sink, moe_stepped=moe_stepped,
                     cross=cross)
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


def cache_shapes(cfg, B: int, S: int, *, clustered: bool | None = None,
                 enc_len: int = 1500):
    """{"stack": {field: (shape, dtype)}} of the stacked decode cache,
    {"prefix": ...} (a flat k/v cache) with ``first_dense`` layers, and
    {"shared": ...} with ``attn_every``: the shared block's cache (flat or
    cluster-major as ``clustered`` says) stacked over its applications,
    the ring's fill one per application. An audio config's stack also
    holds ``xk``/``xv`` (L, B, Hkv, enc_len, dh) bf16, the cross
    attention's keys and values. ``clustered=None``: clustered from
    ``long_context_threshold`` on, never for an SSM config."""
    if clustered is None:
        clustered = S >= cfg.long_context_threshold and not cfg.ssm

    def stacked(c, n, clus):
        return {f: ((n,) + shape, dt) for f, (shape, dt) in
                _layer_cache_shape(c, B, S, clus).items()}
    out = {"stack": stacked(cfg, cfg.n_layers - cfg.first_dense, clustered)}
    if cfg.family == "audio":
        xs = ((cfg.n_layers, B, cfg.n_kv_heads, enc_len, cfg.d_head),
              torch.bfloat16)
        out["stack"].update(xk=xs, xv=xs)
    if cfg.first_dense:
        out["prefix"] = stacked(prefix_config(cfg), cfg.first_dense, False)
    if cfg.attn_every:
        attn_cfg = dataclasses.replace(cfg, ssm="")
        out["shared"] = stacked(attn_cfg, n_shared_apps(cfg), clustered)
    return out


def init_cache(cfg, B: int, S: int, *, clustered: bool | None = None,
               enc_len: int = 1500, device=None) -> dict:
    """Zero-initialised decode cache, stacked over layers, on ``device``
    (the card by default); ``enc_len``: an audio config's encoder
    length."""
    dev = resolve(device)
    return {part: {f: torch.zeros(shape, dtype=dt, device=dev)
                   for f, (shape, dt) in fields.items()}
            for part, fields in cache_shapes(
                cfg, B, S, clustered=clustered, enc_len=enc_len).items()}


def serve_step(cfg, params, cache, tokens, pos: int, *, patches=None,
               device=None):
    """Decode one token. tokens: (B, 1) int; pos: the slot (host int).
    Returns (logits (B, vocab) f32, cache), the cache updated in place.
    Whether attention is full or clustered is decided by the cache's
    contents: a cluster-major cache carries ``kt``, a flat cache with
    member lists ``mem`` (Zamba2's shared block: its ``"shared"``
    cache). An audio config's stack decodes through
    ``transformer.cross_layer_decode`` (cross attention over ``xk``/
    ``xv``). ``patches``: a VLM's patch rows (B, n_patches, d), the row
    at ``pos`` taken in place of the token's embedding while pos <
    n_patches (:func:`embed_tokens`). The step runs where params and
    cache lie; host-array tokens go to ``device`` (the card by default),
    which must be theirs."""
    tokens = host_input(tokens, device)
    if tokens.device != params["embed"].device:
        raise ValueError(f"serve_step: tokens on {tokens.device}, params "
                         f"on {params['embed'].device}")
    h = embed_tokens(cfg, params, tokens, patches, start=pos)
    if cfg.first_dense:
        h = tf.run_stack_decode(prefix_config(cfg), params["prefix"],
                                cache["prefix"], h, pos)
    h = tf.run_stack_decode(
        cfg, params["stack"], cache["stack"], h, pos,
        shared_p=params.get("shared"), shared_cache=cache.get("shared"),
        layer_decode_fn=tf.cross_layer_decode if cfg.family == "audio"
        else None)
    h = rmsnorm(params["out_norm"], h)
    return unembed(cfg, params, h)[:, 0], cache
