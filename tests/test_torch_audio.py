"""The audio family of the port (Whisper: ``transformer.encoder_layer_fwd``,
``cross_layer_fwd``, ``cross_layer_decode``, ``model.encode`` and the
serve path over the cross K/V cache) against the JAX reference, on the
CPU.

The chain runs the reference's ``whisper-base`` smoke config (2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, kc 8, cap 16, top-p
2). Params come from ``PRNGKey(0)`` and are carried across with
``convert.params_from_reference``, caches with
``convert.cache_from_reference``; the prompt (2 x 48 tokens), then the
frames (2 x 24 x d_model), are drawn from one ``RandomState(0)``.

The reference has no audio prefill to hold the port to: its
``forward_prefill`` runs the cross layers as plain decoder layers, with
neither the encoder nor the cross attention, and its serve never fills
the cross K/V cache (ROADMAP §3 entry 26; pinned below). So the oracle is
the reference's own composition: its encoder layers, ``enc_norm``, then
``cross_layer_fwd`` (chunked), and for the stepped prefill and decode
its ``serve_step`` on a cache whose ``xk``/``xv`` that composition
filled, ``dense(xattn.wk|wv, enc_out)`` in the cache's layout.

Tolerances, and why:
- attention and each layer: within 1e-5 of the largest output in f32
  (sums in other orders), within ``BF16_REL`` (2e-2) in bf16 (the two
  frameworks round bf16 at other places, ``test_torch_lm``'s module doc);
- the chains in f32: within 1e-4 of the largest logit and of every cache
  field's largest entry (f32 sums in other orders through the layers);
- the serve prefill in bf16: the reference's chunked composition and its
  stepped prefill part by 9.2e-3 of the largest logit, and its bf16
  results from its f32 ones by 1.6e-2 (chunked) and 1.3e-2 (stepped), so
  the port's bf16 logits are held within max(``BF16_REL``, 1.5 x the
  largest of those gaps), each measured first;
- the cluster-major decode as ``test_torch_lm``'s (bf16; a batch row
  whose top-p selection parts at a bf16 near tie is not compared at that
  step, ROADMAP §3 entry 20).
"""
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.launch.serve import attach_clusters as jax_attach_clusters
from repro.launch.serve import prefill_into_cache as jax_prefill
from repro.models import attention as jattn
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import transformer as jtf
from repro.models.layers import dense as jdense
from repro.models.layers import rmsnorm as jrmsnorm
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.model import (cache_shapes, encode, forward_prefill,
                                     init_cache, init_params, serve_step)
from test_torch_lm import (B, BF16_REL, PROMPT, S_TOTAL, _close, _jax_step,
                           _np_tree, _Selections, _cluster_major_steps_agree)
from test_torch_ssm import _f32

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-base"
ENC = 24                         # encoder frames of the CPU chain
Q_CHUNK = 8                      # divides 24 and 48 (the reference asserts)
# the reference's own gaps as a share of the largest logit (smoke config,
# PRNGKey(0), RandomState(0)): its bf16 stepped prefill against its bf16
# chunked composition, and its bf16 results against its f32 ones
GAP_STEPPED, GAP_BF16_CHUNKED, GAP_BF16_STEPPED = 9.2e-3, 1.6e-2, 1.3e-2


def _ref_encode(cfg, params, frames):
    """The reference's encoder composition (``forward_train``'s): its
    encoder layers over the frames in the params' type, ``enc_norm``,
    then every decoder layer's ``dense(xattn.wk|wv, enc_out)`` in the
    cache's layout (L, B, Hkv, enc_len, dh)."""
    dt = params["embed"].dtype
    h = jnp.asarray(frames).astype(dt)
    for i in range(cfg.encoder_layers):
        p = jax.tree.map(lambda a: a[i], params["enc"])
        h = jtf.encoder_layer_fwd(cfg, p, h, q_chunk=Q_CHUNK)
    enc_out = jrmsnorm(params["enc_norm"], h)
    xk, xv = [], []
    for i in range(cfg.n_layers):
        xa = jax.tree.map(lambda a: a[i], params["stack"]["xattn"])
        for w, acc in (("wk", xk), ("wv", xv)):
            acc.append(jdense(xa[w], enc_out).reshape(
                B, -1, cfg.n_kv_heads, cfg.d_head).transpose(0, 2, 1, 3))
    return enc_out, jnp.stack(xk), jnp.stack(xv)


def _ref_chunked(cfg, params, tokens, enc_out):
    """The reference's chunked encoder-decoder forward: ``cross_layer_fwd``
    over every decoder layer, the logits after the prompt."""
    from repro.models.model import embed_tokens, unembed
    h = embed_tokens(cfg, params, jnp.asarray(tokens))
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], params["stack"])
        h = jtf.cross_layer_fwd(cfg, p, h, enc_out, q_chunk=Q_CHUNK)
    return np.asarray(unembed(cfg, params, jrmsnorm(params["out_norm"],
                                                    h[:, -1:]))[:, 0])


def _ref_chain(params, dtype):
    """The reference's chain in ``dtype`` (params and cache): the encoder
    composition, the chunked forward's logits, and its stepped prefill
    (``prefill_into_cache``) on a cache whose ``xk``/``xv`` the
    composition filled."""
    cfg = jax_smoke_config(ARCH)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    frames = rs.randn(B, ENC, cfg.d_model).astype(np.float32)
    if dtype == "float32":
        params = jax.tree.map(jnp.asarray, _f32(params))
    enc_out, xk, xv = _ref_encode(cfg, params, frames)
    cache = jax_init_cache(cfg, B, S_TOTAL, clustered=False, enc_len=ENC)
    cast = (lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a) \
        if dtype == "float32" else (lambda a: a)
    cache = jax.tree.map(cast, cache)
    st = dict(cache["stack"], xk=xk.astype(cache["stack"]["xk"].dtype),
              xv=xv.astype(cache["stack"]["xv"].dtype))
    logits, cache = jax_prefill(cfg, params, {"stack": st},
                                jnp.asarray(prompt))
    return dict(arch=ARCH, cfg=cfg, params=params, prompt=prompt,
                frames=frames, enc_out=enc_out, xk=xk, xv=xv, cache=cache,
                logits=np.asarray(logits),
                chunked=_ref_chunked(cfg, params, prompt, enc_out))


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def chain(jparams):
    """The reference's chains in bf16 and f32, and the port's params of
    each."""
    cfg = get_smoke_config(ARCH)
    out = {}
    for dtype in ("bfloat16", "float32"):
        r = _ref_chain(jparams, dtype)
        out[dtype] = dict(r, port=params_from_reference(
            _np_tree(r["params"]), cfg, device="cpu"))
    return out


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _check(got, want, dtype, what):
    _close(got, np.asarray(want, np.float32),
           rel=1e-5 if dtype == "float32" else BF16_REL, what=what)


# --------------------------------------------------------------------------
# config, params, caches
# --------------------------------------------------------------------------

def test_params_and_cache_shapes_match_reference(jparams):
    """The reference's params cross path for path and type for type (the
    encoder stack, ``enc_norm``, the cross layers' ``lnx``/``xattn``), the
    port's own init lays out the same tree, and the caches (enc_len 24,
    flat and cluster-major) have the reference's fields, shapes and
    types; ``params_estimate`` is the reference's, encoder included."""
    from repro.configs.base import get_config as jax_get_config
    from repro.models import cache_shapes as jax_cache_shapes
    cfg = get_smoke_config(ARCH)
    port = params_from_reference(_np_tree(jparams), cfg, device="cpu")
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        for tree in (port, own):
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    assert set(own) == set(jparams) | {"embed_f32"}
    assert set(own["stack"]) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
    for clustered in (False, True):
        want = jax_cache_shapes(jax_smoke_config(ARCH), B, S_TOTAL,
                                clustered=clustered, enc_len=ENC)
        got = cache_shapes(cfg, B, S_TOTAL, clustered=clustered, enc_len=ENC)
        assert set(got) == set(want)
        for part in got:
            assert set(got[part]) == set(want[part])
            for f, (shape, dt) in got[part].items():
                assert shape == want[part][f].shape, (part, f)
                assert str(dt).split(".")[-1] == str(want[part][f].dtype)
    from repro_torch.configs.base import get_config
    assert cfg.params_estimate() == jax_smoke_config(ARCH).params_estimate()
    assert get_config(ARCH).params_estimate() == \
        jax_get_config(ARCH).params_estimate() == 76886528


# --------------------------------------------------------------------------
# attention and the layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noncausal_attention_matches_reference(dtype):
    """``causal_attention(causal=False)`` with S = 16 queries over Skv = 24
    keys (grouped, 8 q-heads over 2 kv-heads) against the reference's, at
    a chunk that divides S and at a ragged one (5); and the decode
    attention over all 24 slots, the cross attention's read."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 16, 8, 16)
    k = rng.randn(2, 24, 2, 16)
    v = rng.randn(2, 24, 2, 16)
    want = jattn.causal_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                  causal=False, q_chunk=8)
    for qc in (8, 5):
        got = tattn.causal_attention(_t(q, dtype), _t(k, dtype),
                                     _t(v, dtype), causal=False, q_chunk=qc)
        assert got.shape == (2, 16, 8, 16) and str(got.dtype).endswith(dtype)
        _check(got, want, dtype, f"non-causal, q_chunk {qc}")
    kd, vd = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    want = jattn.decode_attention(_j(q[:, 0], dtype), _j(kd, dtype),
                                  _j(vd, dtype))
    got = tattn.decode_attention(_t(q[:, 0], dtype), _t(kd, dtype),
                                 _t(vd, dtype))
    _check(got, want, dtype, "decode over every slot")


def _layer(jparams, part, i, dtype):
    """Layer i of the reference's ``part`` stack in ``dtype``, for both
    packages."""
    p = jax.tree.map(lambda a: np.asarray(a[i], np.float32), jparams[part])
    return (jax.tree.map(lambda a: _j(a, dtype), p),
            jax.tree.map(lambda a: _t(a, dtype), p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_matches_reference(jparams, dtype):
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _layer(jparams, "enc", 1, dtype)
    h = np.random.RandomState(4).randn(B, ENC, cfg.d_model)
    want = jtf.encoder_layer_fwd(jcfg, jp, _j(h, dtype), q_chunk=Q_CHUNK)
    got = ttf.encoder_layer_fwd(cfg, tp, _t(h, dtype), q_chunk=5)
    _check(got, want, dtype, "encoder layer")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_layer_fwd_matches_reference(jparams, dtype):
    """``cross_layer_fwd`` from the encoder output and from its keys and
    values in the cache's layout (``cross_kv``), against the reference's;
    the sink's fields are the self attention's keys and values."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _layer(jparams, "stack", 1, dtype)
    rng = np.random.RandomState(5)
    h = rng.randn(B, 16, cfg.d_model)
    enc = rng.randn(B, ENC, cfg.d_model)
    want = jtf.cross_layer_fwd(jcfg, jp, _j(h, dtype), _j(enc, dtype),
                               q_chunk=Q_CHUNK)
    _, kw, vw = jattn.gqa_project(
        jp["attn"], jrmsnorm(jp["ln1"], _j(h, dtype)), cfg.n_heads,
        cfg.n_kv_heads, cfg.d_head, jnp.arange(16)[None, :], cfg.rope_theta,
        False)
    for xkv in (None, ttf.cross_kv(cfg, tp, _t(enc, dtype))):
        got, fields = ttf.cross_layer_fwd(cfg, tp, _t(h, dtype),
                                          _t(enc, dtype), q_chunk=16,
                                          xkv=xkv)
        _check(got, want, dtype, "cross layer")
        assert set(fields) == {"k", "v"}
        _check(fields["k"], kw, dtype, "self-attention keys")
        _check(fields["v"], vw, dtype, "self-attention values")


def _decode_cache(jcfg, kind, dtype, seed=6):
    """One layer's decode cache (numpy, f32 values): a flat k/v of 30
    filled slots, or the cluster-major tables of
    ``kv_cluster.build_cluster_major`` over them with 3 ring rows; with
    random ``xk``/``xv`` over 24 encoder slots."""
    from repro.models.kv_cluster import build_cluster_major
    rng = np.random.RandomState(seed)
    Hkv, dh, S = jcfg.n_kv_heads, jcfg.d_head, 40
    k = np.zeros((B, Hkv, S, dh), np.float32)
    v = np.zeros((B, Hkv, S, dh), np.float32)
    k[:, :, :30] = rng.randn(B, Hkv, 30, dh)
    v[:, :, :30] = rng.randn(B, Hkv, 30, dh)
    c = {"xk": rng.randn(B, Hkv, ENC, dh).astype(np.float32),
         "xv": rng.randn(B, Hkv, ENC, dh).astype(np.float32)}
    if kind == "flat":
        c.update(k=k, v=v)
        return c
    kt, vt, cent, sizes = build_cluster_major(
        _j(k[:, :, :30], dtype), _j(v[:, :, :30], dtype), jcfg.kv_clusters,
        jcfg.cluster_cap)
    R = jcfg.cluster_ring
    ring_k = np.zeros((B, Hkv, R, dh), np.float32)
    ring_v = np.zeros((B, Hkv, R, dh), np.float32)
    ring_k[:, :, :3] = rng.randn(B, Hkv, 3, dh)
    ring_v[:, :, :3] = rng.randn(B, Hkv, 3, dh)
    c.update(kt=np.asarray(kt, np.float32), vt=np.asarray(vt, np.float32),
             cent=np.asarray(cent, np.float32), sizes=np.asarray(sizes),
             ring_k=ring_k, ring_v=ring_v, ring_fill=np.int32(3))
    return c


@pytest.mark.parametrize("kind", ["flat", "kt"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_layer_decode_matches_reference(jparams, kind, dtype):
    """One decode step of a cross layer at slot 30: self attention over the
    flat cache (slot 30 written in place) or over the cluster-major tables
    (K6's plain version; the ring's next slot written), then cross
    attention over every ``xk``/``xv`` slot; h and the written cache
    fields against the reference's."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    jp, tp = _layer(jparams, "stack", 0, dtype)
    c = _decode_cache(jcfg, kind, dtype)
    h = np.random.RandomState(7).randn(B, 1, cfg.d_model)

    def conv(a, to):
        return to(a, dtype) if np.asarray(a).dtype == np.float32 else (
            jnp.asarray(a) if to is _j else torch.tensor(np.asarray(a)))
    jc = {f: conv(a, _j) for f, a in c.items()}
    tc = {f: conv(a, _t) for f, a in c.items()}
    want, new = jtf.cross_layer_decode(jcfg, jp, jc, _j(h, dtype), 30)
    _build.reset_launches()
    got = ttf.cross_layer_decode(cfg, tp, tc, _t(h, dtype), 30)
    assert not any(_build.launches().values())        # CPU: plain K6
    _check(got, want, dtype, "h")
    for f in (("k", "v") if kind == "flat" else ("ring_k", "ring_v")):
        _check(tc[f], new[f], dtype, f)
    if kind == "kt":
        assert int(tc["ring_fill"]) == int(new["ring_fill"]) == 4
    for f in ("xk", "xv"):                    # read, never written
        assert torch.equal(tc[f], conv(c[f], _t))


def test_encode_matches_reference(chain):
    """``model.encode``: the normed encoder output and every decoder
    layer's ``xk``/``xv`` against the reference's encoder stack,
    ``enc_norm`` and ``dense(xattn.wk|wv)``; in f32 within 1e-5, in bf16
    within ``BF16_REL``."""
    cfg = get_smoke_config(ARCH)
    for dtype, rel in (("float32", 1e-5), ("bfloat16", BF16_REL)):
        r = chain[dtype]
        out, kv = encode(cfg, r["port"], torch.tensor(r["frames"]),
                         q_chunk=Q_CHUNK)
        assert out.dtype == r["port"]["embed"].dtype
        assert kv["xk"].shape == (cfg.n_layers, B, cfg.n_kv_heads, ENC,
                                  cfg.d_head)
        _close(out, np.asarray(r["enc_out"], np.float32), rel=rel,
               what=f"{dtype} enc_out")
        for f in ("xk", "xv"):
            _close(kv[f], np.asarray(r[f], np.float32), rel=rel,
                   what=f"{dtype} {f}")


# --------------------------------------------------------------------------
# the chain: prefill, decode flat and cluster-major
# --------------------------------------------------------------------------

def test_serve_prefill_matches_reference_composition(chain):
    """The port's serve prefill (encode, then one chunked decoder forward
    whose sinks fill the cache) against the reference's stepped prefill
    on a cache whose ``xk``/``xv`` its composition filled. In f32 (params
    and caches in f32): the logits and every cache field within 1e-4,
    and ``forward_prefill(frames=)`` within 1e-4 of the reference's
    chunked composition. In bf16: the reference's own gaps are measured
    first (fact pinned in the module doc), then the logits within
    max(``BF16_REL``, 1.5 x the largest gap) of the stepped reference's
    and of the chunked one's, and every cache field within
    ``BF16_REL``."""
    cfg = get_smoke_config(ARCH)
    r16, r32 = chain["bfloat16"], chain["float32"]

    def gap(a, b):
        return np.abs(a - b).max() / np.abs(b).max()
    gaps = (gap(r16["logits"], r16["chunked"]),
            gap(r16["chunked"], r32["chunked"]),
            gap(r16["logits"], r32["logits"]))
    for got, want in zip(gaps, (GAP_STEPPED, GAP_BF16_CHUNKED,
                                GAP_BF16_STEPPED)):
        assert abs(got - want) <= 1e-3, gaps
    assert gap(r32["logits"], r32["chunked"]) <= 1e-5
    loose = max(BF16_REL, 1.5 * max(gaps))
    for dtype, r in (("float32", r32), ("bfloat16", r16)):
        tdt = getattr(torch, dtype)
        cache = init_cache(cfg, B, S_TOTAL, clustered=False, enc_len=ENC,
                           device="cpu")
        cache = {p: {f: t.to(tdt) if t.is_floating_point() else t
                     for f, t in fs.items()} for p, fs in cache.items()}
        _build.reset_launches()
        logits, cache = serve.prefill_into_cache(
            cfg, r["port"], cache, torch.tensor(r["prompt"]),
            frames=torch.tensor(r["frames"]), q_chunk=Q_CHUNK)
        assert not any(_build.launches().values())
        want = _np_tree(r["cache"])["stack"]
        assert set(cache["stack"]) == set(want) == {"k", "v", "xk", "xv"}
        rel = 1e-4 if dtype == "float32" else BF16_REL
        for f, t in cache["stack"].items():
            _close(t, want[f].astype(np.float32), rel=rel, what=f"{dtype} {f}")
        assert (cache["stack"]["k"][:, :, :, PROMPT:] == 0).all()
        if dtype == "float32":
            _close(logits, r["logits"], rel=1e-4, what="f32 logits")
            fwd = forward_prefill(cfg, r["port"], torch.tensor(r["prompt"]),
                                  frames=torch.tensor(r["frames"]),
                                  q_chunk=16)
            _close(fwd, r["chunked"], rel=1e-4, what="f32 forward_prefill")
        else:
            _close(logits, r["logits"], rel=loose, what="bf16 logits")
            _close(logits, r["chunked"], rel=loose,
                   what="bf16 logits against the chunked composition")


def test_serve_steps_flat_match_reference(chain):
    """8 flat decode steps from the reference's f32 stepped-prefill cache
    carried across (``xk``/``xv`` included), teacher-forced with the
    reference's greedy tokens: the logits at every step and every cache
    field after within 1e-4 of their largest magnitude."""
    cfg = get_smoke_config(ARCH)
    r = chain["float32"]
    cache = cache_from_reference(_np_tree(r["cache"]), device="cpu")
    jcache, step = r["cache"], _jax_step(r)
    tok = r["prompt"][:, -1:]
    for i in range(8):
        want, jcache = step(r["params"], jcache, jnp.asarray(tok),
                            jnp.int32(PROMPT + i))
        got, cache = serve_step(cfg, r["port"], cache, torch.tensor(tok),
                                PROMPT + i)
        _close(got, np.asarray(want), rel=1e-4, what=f"logits step {i}")
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    want_c = _np_tree(jcache)["stack"]
    for f, t in cache["stack"].items():
        _close(t, want_c[f], rel=1e-4, what=f)


@pytest.fixture(scope="module")
def clustered(chain):
    r = chain["bfloat16"]
    return jax_attach_clusters(r["cfg"], dict(r["cache"]), length=PROMPT)


def test_attach_clusters_keeps_the_cross_cache(chain, clustered):
    """``attach_clusters`` on the bf16 stepped-prefill cache: the tables
    equal the reference's (centroids within one bf16 ulp), and the cross
    keys and values stay, unchanged."""
    cfg = get_smoke_config(ARCH)
    flat = cache_from_reference(_np_tree(chain["bfloat16"]["cache"]),
                                device="cpu")
    got = serve.attach_clusters(cfg, flat, length=PROMPT)["stack"]
    want = _np_tree(clustered)["stack"]
    assert set(got) == set(want) and {"xk", "xv"} <= set(got)
    for f in ("kt", "vt", "sizes", "ring_k", "ring_v", "ring_fill", "xk",
              "xv"):
        g = got[f].float().numpy() if got[f].dtype == torch.bfloat16 \
            else got[f].numpy()
        np.testing.assert_array_equal(g, want[f].astype(g.dtype), err_msg=f)
    assert got["xk"] is flat["stack"]["xk"]
    np.testing.assert_allclose(got["cent"].float().numpy(),
                               want["cent"].astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_serve_steps_cluster_major_match_reference(chain, clustered,
                                                   monkeypatch):
    """Five k²-attention steps over the cluster-major self-attention cache
    (cross attention over ``xk``/``xv``), a ``fold_ring`` against the
    reference's, and a step after it, as ``test_torch_lm``'s chain: a
    batch row whose top-p selection parted at a bf16 near tie is counted,
    not compared, and at most one step parts."""
    r = chain["bfloat16"]
    _cluster_major_steps_agree(r, r["port"], clustered,
                               sel=_Selections(monkeypatch))


# --------------------------------------------------------------------------
# the reference's audio forward_prefill (ROADMAP §3 entry 26) and the CLI
# --------------------------------------------------------------------------

def test_reference_forward_prefill_skips_the_cross_attention(jparams):
    """Fact pinned: zeroing every ``xattn`` weight leaves the reference's
    ``forward_prefill`` logits on the Whisper smoke config unchanged (it
    runs the cross layers as plain decoder layers, without the encoder),
    while its chunked composition moves. The port's ``forward_prefill``
    raises on an audio config without frames."""
    from repro.models.model import forward_prefill as jax_forward_prefill
    jcfg = jax_smoke_config(ARCH)
    tokens = {"tokens": jnp.asarray(np.random.RandomState(0).randint(
        0, jcfg.vocab, (B, PROMPT)), jnp.int32)}
    zeroed = dict(jparams, stack=dict(
        jparams["stack"], xattn=jax.tree.map(jnp.zeros_like,
                                             jparams["stack"]["xattn"])))
    a = np.asarray(jax_forward_prefill(jcfg, jparams, tokens))
    b = np.asarray(jax_forward_prefill(jcfg, zeroed, tokens))
    np.testing.assert_array_equal(a, b)
    enc = _ref_encode(jcfg, jparams, np.ones((B, ENC, jcfg.d_model)))[0]
    moved = [_ref_chunked(jcfg, p, np.asarray(tokens["tokens"]), enc)
             for p in (jparams, zeroed)]
    assert np.abs(moved[0] - moved[1]).max() > 0
    cfg = get_smoke_config(ARCH)
    port = params_from_reference(_np_tree(jparams), cfg, device="cpu")
    with pytest.raises(ValueError, match="entry 26"):
        forward_prefill(cfg, port, torch.tensor(np.asarray(
            tokens["tokens"])))
    with pytest.raises(ValueError, match="frames"):
        serve.prefill_into_cache(
            cfg, port, init_cache(cfg, B, S_TOTAL, enc_len=ENC,
                                  clustered=False, device="cpu"),
            torch.tensor(np.asarray(tokens["tokens"])))


def test_serve_main_runs_whisper_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch whisper-base --smoke
    --device cpu`` prints the reference serve's five lines (8 encoder
    frames, as the reference sizes its cross cache), with 16 decode steps
    and a fold every 8 through the executor."""
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", str(PROMPT), "--decode", "16",
                "--fold-every", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 5, out
    assert re.fullmatch(r"decoded 16 tokens: full=\d+\.\d\ds "
                        r"clustered=\d+\.\d\ds  token agreement=\d\.\d\d",
                        out[0]), out[0]
    assert out[1].startswith("partial_fit folds: 32 ring slots (16 tokens x "
                             "2 layers) absorbed into the cluster tables")
    assert out[2] == ("attention reads/token: full=65 clustered=40 "
                      "(1.6x fewer)")
    assert out[3] == "serve queue: admitted=19 rejected=0 max_depth=1/8"


def test_serve_run_encodes_and_clusters():
    """``serve.run`` on the smoke config: the cross cache holds the
    encoder's keys and values of the drawn frames (bf16, all ``enc_len``
    slots), kept through ``attach_clusters`` and the folds; finite logits
    of the right shape; the CLI in a fresh interpreter imports neither
    JAX nor the reference."""
    cfg = get_smoke_config(ARCH)
    r = serve.run(cfg, batch=B, prompt_len=PROMPT, decode_len=8,
                  fold_every=4, device="cpu", enc_len=ENC,
                  echo=lambda s: None)
    assert r["frames"].shape == (B, ENC, cfg.d_model)
    assert r["frames"].dtype == torch.bfloat16 and r["t_encode"] >= 0
    _, kv = encode(cfg, r["params"], r["frames"])
    for f in ("xk", "xv"):
        assert torch.equal(r["cache"]["stack"][f], kv[f])
        assert r["cache"]["stack"][f] is r["flat_cache"]["stack"][f]
    for f in ("prefill_logits", "full_logits", "clus_logits"):
        assert r[f].shape == (B, cfg.vocab) and torch.isfinite(r[f]).all()
    assert r["folded"] == 8 * cfg.n_layers
    code = ("import sys\n"
            "from repro_torch.launch import serve\n"
            "serve.main(['--arch', 'whisper-base', '--smoke', '--device', "
            "'cpu', '--decode', '4'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("decoded 4 tokens: full=")
