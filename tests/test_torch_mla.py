"""MLA, DeepSeek-V2-Lite and the flat-cache k²-attention variant of the
port (``repro_torch.models``) against the JAX reference, on the CPU.

The DeepSeek chain runs the reference's ``deepseek-v2-lite-16b`` smoke
config (a dense GQA first layer, then 2 MLA + MoE layers: 8 experts
top-3, 1 shared expert); the flat clustered decode runs ``qwen3-8b``'s
smoke config. Params come from ``PRNGKey(0)`` and are carried across
with ``convert.params_from_reference``, caches with
``convert.cache_from_reference``; prompts are 2 x 48 tokens from
``RandomState(0)`` (``test_torch_lm._reference``).

Tolerances, and why:
- f32 layers: rtol 1e-5 (atol 1e-5): sums in other orders;
- bf16 layers, logits and caches: within ``BF16_REL`` (2e-2) of the
  largest magnitude: the two frameworks round bf16 at other places
  (``test_torch_lm``'s module doc);
- the port's serve prefill against the reference's stepped prefill: the
  prefill's MLA takes the explicit route (bf16 ``k_nope``/``v``) and a
  decode step the absorbed one (f32 ``q·W_ukᵀ``); the reference's own
  two prefills part by about 1.7e-2 of the largest logit with the MoE's
  capacity lifted (ROADMAP §3 entry 23), so the logits are held within
  max(``BF16_REL``, 1.5 x that gap);
- the DeepSeek chains (``forward_prefill``, 8 decode steps) in f32 in
  both packages: within 1e-4 of the largest magnitude (f32 sums in other
  orders through three layers); in bf16 each package parts from its own
  f32 result by up to 2.4% and routes a token to another expert at near
  ties (ROADMAP §3 entry 24);
- cluster structures: ints bit-equal; ``cluster_append``'s centroids
  rtol 1e-5 in f32, one bf16 ulp (rtol 2^-7) in bf16; after decode steps
  (keys that differ in bf16) within ``BF16_REL``.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import attention as jattn
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models.kv_cluster import cluster_append
from repro_torch.models.model import (cache_shapes, forward_prefill,
                                     init_cache, init_params, serve_step)
from test_torch_lm import (B, BF16_REL, PROMPT, S_TOTAL, _agreeing_rows_close,
                           _close, _jax_step, _np_tree, _port_params,
                           _reference, _Selections)

ARCH = "deepseek-v2-lite-16b"
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ds():
    """The reference's DeepSeek smoke chain (params, prompt, the cache of
    its stepped prefill and the logits after it) and the port's params."""
    r = _reference(ARCH)
    return dict(r, port=_port_params(r))


def _tree_to(tree, dtype):
    """numpy-array leaves of a reference tree as port tensors in
    ``dtype`` (floating leaves) on the CPU."""
    return {k: _tree_to(v, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _mla_case(dtype, S=24, seed=0):
    """A small MLA layer from the reference's init (d 32, 4 heads, kv_lora
    16, nope 8, rope 4, v 8) and x (2, S, 32), both in ``dtype``."""
    dims = jattn.MLADims(16, 8, 4, 8)
    jd = getattr(jnp, dtype)
    p = jattn.mla_init(jax.random.PRNGKey(seed), 32, 4, dims, dtype=jd)
    x = np.random.RandomState(seed).randn(2, S, 32).astype(np.float32)
    td = getattr(torch, dtype)
    return (dims, p, jnp.asarray(x).astype(jd),
            _tree_to(_np_tree(p), td), torch.tensor(x).to(td))


def _check(got, want, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **F32,
                                   err_msg=what)
    else:
        _close(got, want, what=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_reference(dtype):
    """The prefill MLA (explicit route, chunked attention with a value
    head narrower than the query head): output and latent; f32 rtol 1e-5,
    bf16 within ``BF16_REL``."""
    dims, jp, jx, tp, tx = _mla_case(dtype)
    want, want_lat = jattn.mla_apply(jp, jx, n_heads=4, dims=dims,
                                     q_chunk=24)
    got, lat = tattn.mla_apply(tp, tx, n_heads=4,
                               dims=tattn.MLADims(*dims), q_chunk=8)
    assert lat.shape == (2, 24, dims.kv_lora + dims.rope)
    _check(got, want, dtype, "out")
    _check(lat, want_lat, dtype, "latent")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference(dtype):
    """One absorbed-route decode step at slot 17 of a 24-slot latent cache
    (slots < 17 filled, the rest 0): the output and the cache, whose slot
    17 takes the token's latent in place; f32 rtol 1e-5, bf16 within
    ``BF16_REL``."""
    dims, jp, jx, tp, tx = _mla_case(dtype, S=1, seed=1)
    lat = np.zeros((2, 24, dims.kv_lora + dims.rope), np.float32)
    lat[:, :17] = np.random.RandomState(2).randn(2, 17, lat.shape[-1])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_lat = jattn.mla_decode(jp, jx, jnp.asarray(lat).astype(jd),
                                      17, n_heads=4, dims=dims)
    cache = torch.tensor(lat).to(td)
    got, out_lat = tattn.mla_decode(tp, tx, cache, 17, n_heads=4,
                                    dims=tattn.MLADims(*dims))
    assert out_lat is cache
    _check(got, want, dtype, "out")
    _check(cache, want_lat, dtype, "latent cache")
    assert (cache[:, 18:] == 0).all()


def test_deepseek_params_and_caches_carry_across(ds):
    """The reference's DeepSeek params cross with their paths and types
    (the GQA ``prefix``, MLA's ``wq``/``wdkv``/``wkpe``/``wuk``/``wuv``/
    ``wo``/``kvn``, the MoE with its shared expert), the port's own init
    lays out the same tree, and the cache shapes match the reference's
    (the latent ``lat`` whatever ``clustered`` says, the prefix's flat
    k/v); the reference's stepped-prefill cache carries across."""
    from repro.models import cache_shapes as jax_cache_shapes
    cfg = get_smoke_config(ARCH)
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(own) == set(ds["port"]) == {"embed", "out_norm", "prefix",
                                           "stack", "embed_f32"}
    for path, leaf in jax.tree_util.tree_flatten_with_path(ds["params"])[0]:
        for tree in (ds["port"], own):
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    assert set(own["stack"]["attn"]) == {"wq", "wdkv", "wkpe", "wuk", "wuv",
                                         "wo", "kvn"}
    assert set(own["prefix"]["attn"]) == {"wq", "wk", "wv", "wo"}
    for clustered in (False, True):
        want = jax_cache_shapes(ds["cfg"], B, S_TOTAL, clustered=clustered,
                                enc_len=8)
        got = cache_shapes(cfg, B, S_TOTAL, clustered=clustered)
        assert set(got) == set(want) == {"stack", "prefix"}
        for part in got:
            assert set(got[part]) == set(want[part])
            for f, (shape, dtype) in got[part].items():
                assert shape == want[part][f].shape, (part, f)
                assert str(dtype).split(".")[-1] == \
                    str(want[part][f].dtype), (part, f)
    cache = cache_from_reference(_np_tree(ds["cache"]), device="cpu")
    for part in ("stack", "prefix"):
        for f, t in cache[part].items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(ds["cache"][part][f], np.float32))


def test_params_estimate_matches_reference():
    """``params_estimate`` of every ported config equals the reference's
    (MLA's branch for DeepSeek)."""
    for arch in ARCH_IDS:
        assert get_config(arch).params_estimate() == \
            jax_get_config(arch).params_estimate(), arch


def _reference_latents(ref):
    """The reference's chunked forward over the prompt, layer by layer
    (one jitted program): the prefix's keys and values (1, B, Hkv, S, dh)
    and every stack layer's latent (L, B, S, r + rope), as f32 numpy
    arrays."""
    import dataclasses
    from repro.models import transformer as jtf
    from repro.models.layers import rmsnorm as jrmsnorm
    from repro.models.model import embed_tokens
    cfg = ref["cfg"]
    dcfg = dataclasses.replace(cfg, moe=False, mla=False)
    dims = jattn.MLADims(cfg.kv_lora, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)

    @jax.jit
    def run(params, tokens):
        h = embed_tokens(cfg, params, tokens)
        p = jax.tree.map(lambda a: a[0], params["prefix"])
        _, k, v = jattn.gqa_project(
            p["attn"], jrmsnorm(p["ln1"], h), cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, jnp.arange(PROMPT)[None, :], cfg.rope_theta, False)
        h, _ = jtf.decoder_layer_fwd(dcfg, p, h)
        lats = []
        for i in range(cfg.n_layers - cfg.first_dense):
            p = jax.tree.map(lambda a: a[i], params["stack"])
            lats.append(jattn.mla_apply(p["attn"], jrmsnorm(p["ln1"], h),
                                        n_heads=cfg.n_heads, dims=dims)[1])
            h, _ = jtf.decoder_layer_fwd(cfg, p, h)
        return k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3), \
            jnp.stack(lats)
    k, v, lats = (np.asarray(a, np.float32) for a in run(
        ref["params"], jnp.asarray(ref["prompt"])))
    return {"k": k[None], "v": v[None]}, lats


def test_deepseek_forward_prefill_matches_reference(ds):
    """The port's chunked ``forward_prefill`` (``moe_stepped=False``: one
    router call over the B·S tokens, at its capacity) against the
    reference's, both with the reference's params in f32: the logits
    after the prompt, the prefix's keys and values and every MLA layer's
    latent within 1e-4 of their largest magnitude (f32 sums in other
    orders, through three layers). In bf16 the two part beyond
    ``BF16_REL``: at a routing near tie (the third and fourth experts'
    probabilities 7.3e-5 apart) bf16 rounding sends one token of stack
    layer 0 to another expert, and the capacity then keeps another pair
    (ROADMAP §3 entry 24)."""
    from repro.models.model import forward_prefill as jax_forward_prefill
    cfg = get_smoke_config(ARCH)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), ds["params"])
    got = {"lat": [], "k": [], "v": []}

    def sink(i, fields):
        got["lat"].append(fields["lat"])

    def prefix_sink(i, fields):
        for f in ("k", "v"):
            got[f].append(fields[f].transpose(1, 2))
    logits = forward_prefill(
        cfg, params_from_reference(p32, cfg, device="cpu"),
        torch.tensor(ds["prompt"]), kv_sink=sink, prefix_sink=prefix_sink,
        moe_stepped=False)
    ref32 = dict(ds, params=jax.tree.map(jnp.asarray, p32))
    want = jax_forward_prefill(ds["cfg"], ref32["params"],
                               {"tokens": jnp.asarray(ds["prompt"])})
    assert logits.dtype == torch.float32
    _close(logits, np.asarray(want), rel=1e-4, what="logits")
    prefix, lats = _reference_latents(ref32)
    assert len(got["lat"]) == cfg.n_layers - cfg.first_dense
    _close(torch.stack(got["lat"]), lats, rel=1e-4, what="latents")
    for f in ("k", "v"):
        _close(torch.stack(got[f]), prefix[f], rel=1e-4, what=f"prefix {f}")


def test_deepseek_serve_steps_match_reference(ds):
    """8 full-attention decode steps (the prefix's flat cache, MLA's
    absorbed route over the latent cache, the MoE per step) from the
    reference's stepped-prefill cache carried across, teacher-forced with
    the reference's greedy tokens, params and caches in f32 in both
    packages: logits at every step and the caches after within 1e-4 of
    their largest magnitude (f32 sums in other orders). In bf16 each
    package's logits part from its own f32 logits by 1.0-2.4% of the
    largest, and at the eighth step the reference's bf16 router picks
    another expert at a near tie (10.5%), so a bf16 comparison holds
    rounding noise, not the port (ROADMAP §3 entry 24)."""
    cfg = get_smoke_config(ARCH)
    p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), ds["params"])
    params = params_from_reference(p32, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, p32)
    c32 = jax.tree.map(lambda a: np.asarray(a, np.float32), ds["cache"])
    cache = cache_from_reference(c32, device="cpu")
    jcache, step = jax.tree.map(jnp.asarray, c32), _jax_step(ds)
    tok = ds["prompt"][:, -1:]
    _build.reset_launches()
    for i in range(8):
        want, jcache = step(jparams, jcache, jnp.asarray(tok),
                            jnp.int32(PROMPT + i))
        got, cache = serve_step(cfg, params, cache, torch.tensor(tok),
                                PROMPT + i)
        _close(got, np.asarray(want), rel=1e-4, what=f"logits step {i}")
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    assert not any(_build.launches().values())
    want_c = _np_tree(jcache)
    assert cache["stack"]["lat"].dtype == torch.float32
    _close(cache["stack"]["lat"], want_c["stack"]["lat"], rel=1e-4,
           what="latent cache")
    for f in ("k", "v"):
        _close(cache["prefix"][f], want_c["prefix"][f], rel=1e-4,
               what=f"prefix {f}")


def test_deepseek_serve_prefill_matches_stepped_reference(ds, monkeypatch):
    """The port's serve prefill (one chunked forward, the MoE routed per
    position) against the reference's stepped prefill: layer 0's latent
    and the prefix's keys and values within ``BF16_REL``; the logits
    within max(``BF16_REL``, 1.5 x the reference's own gap between its
    stepped prefill and its chunked forward with the MoE's capacity
    lifted), a gap of 1.7e-2 of the largest logit (MLA's explicit route
    against its absorbed one, ROADMAP §3 entry 23)."""
    import repro.models.moe as jmoe
    from repro.models.model import forward_prefill as jax_forward_prefill
    cfg = get_smoke_config(ARCH)
    cache = init_cache(cfg, B, S_TOTAL, clustered=False, device="cpu")
    logits, cache = serve.prefill_into_cache(cfg, ds["port"], cache,
                                             torch.tensor(ds["prompt"]))
    want = _np_tree(ds["cache"])
    _close(cache["stack"]["lat"][0, :, :PROMPT],
           want["stack"]["lat"][0, :, :PROMPT].astype(np.float32),
           what="layer 0 latent")
    assert (cache["stack"]["lat"][:, :, PROMPT:] == 0).all()
    for f in ("k", "v"):
        _close(cache["prefix"][f][..., :PROMPT, :],
               want["prefix"][f][..., :PROMPT, :].astype(np.float32),
               what=f"prefix {f}")
    monkeypatch.setattr(jmoe, "moe_apply",
                        functools.partial(jmoe.moe_apply,
                                          capacity_factor=100.0))
    chunked = np.asarray(jax_forward_prefill(
        ds["cfg"], ds["params"], {"tokens": jnp.asarray(ds["prompt"])}))
    gap = np.abs(chunked - ds["logits"]).max() / np.abs(ds["logits"]).max()
    assert 1.5e-2 <= gap <= 1.9e-2, gap
    _close(logits, ds["logits"], rel=max(BF16_REL, 1.5 * gap),
           what="logits")


def test_reference_attach_clusters_raises_and_port_run_says_so(ds):
    """The reference's ``attach_clusters`` on a DeepSeek cache raises
    ``KeyError: 'k'`` (the MLA layers cache a latent); the port's ``run``
    decodes with full attention and says that k²-attention does not
    apply, with its clustered fields ``None``."""
    from repro.launch.serve import attach_clusters as jax_attach_clusters
    with pytest.raises(KeyError, match="'k'"):
        jax_attach_clusters(ds["cfg"], dict(ds["cache"]), length=PROMPT)
    cfg = get_smoke_config(ARCH)
    lines = []
    r = serve.run(cfg, batch=B, prompt_len=PROMPT, decode_len=4,
                  device="cpu", echo=lines.append)
    assert lines[1] == ("deepseek-smoke: k²-attention does not apply to "
                        "the MLA latent cache; decoded with full attention "
                        "only"), lines
    assert len(r["full_toks"]) == 4 and r["clus_logits"] is None \
        and r["cache"] is None and r["executor"] is None
    for f in ("prefill_logits", "full_logits"):
        assert r[f].shape == (B, cfg.vocab) and torch.isfinite(r[f]).all()


def test_serve_main_runs_deepseek_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --smoke --device cpu``: the full-decode line, then the line that
    k²-attention does not apply."""
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", str(PROMPT), "--decode", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2, out
    assert re.fullmatch(r"decoded 16 tokens: full=\d+\.\d\ds", out[0]), out
    assert out[1].startswith("deepseek-smoke: k²-attention does not apply")


# --------------------------------------------------------------------------
# the flat-cache k²-attention variant
# --------------------------------------------------------------------------

def _flat_case(seed=0, B_=2, Hkv=2, g=3, S=40, dh=8, kc=6, cap=8):
    """Random q (B, H, dh) and a flat cache (B, Hkv, S, dh) in f32, with
    the reference's ``build_kv_clusters`` over its keys (cap < the
    largest cluster, so some members are dropped)."""
    from repro.models.kv_cluster import build_kv_clusters
    rng = np.random.RandomState(seed)
    q = rng.randn(B_, Hkv * g, dh).astype(np.float32)
    k = rng.randn(B_, Hkv, S, dh).astype(np.float32)
    v = rng.randn(B_, Hkv, S, dh).astype(np.float32)
    kn = rng.randn(B_, Hkv, dh).astype(np.float32)
    vn = rng.randn(B_, Hkv, dh).astype(np.float32)
    clus = [np.asarray(a) for a in build_kv_clusters(jnp.asarray(k), kc,
                                                     cap)]
    return q, k, v, kn, vn, clus


@pytest.mark.parametrize("with_self", [False, True])
def test_clustered_decode_attention_matches_reference(with_self):
    """k²-attention over the flat cache (top-p 3 of 6 clusters, members
    gathered by slot, the token itself joined exactly or not) against
    the reference's, f32, rtol 1e-5."""
    q, k, v, kn, vn, (cent, mem, mmask, _) = _flat_case()
    assert not mmask.all()                   # masked member slots exist
    want = jattn.clustered_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cent),
        jnp.asarray(mem), jnp.asarray(mmask), 3,
        self_kv=(jnp.asarray(kn), jnp.asarray(vn)) if with_self else None)
    T = torch.tensor
    got = tattn.clustered_decode_attention(
        T(q), T(k), T(v), T(cent), T(mem), T(mmask), 3,
        self_kv=(T(kn), T(vn)) if with_self else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_append_matches_reference(dtype):
    """Three inserts of decoded keys into the member lists, the third into
    full clusters (every cluster's size set to cap, so it drops): member
    slots, masks and sizes bit-equal, the EMA-drifted centroids within
    rtol 1e-5 (f32) or one bf16 ulp, updated in place."""
    from repro.models.kv_cluster import cluster_append as jax_append
    q, k, v, kn, vn, (cent, mem, mmask, sizes) = _flat_case(seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jst = (jnp.asarray(cent).astype(jd), jnp.asarray(mem),
           jnp.asarray(mmask), jnp.asarray(sizes))
    st = (torch.tensor(cent).to(td), torch.tensor(mem), torch.tensor(mmask),
          torch.tensor(sizes))
    rng = np.random.RandomState(4)
    for n, pos in enumerate((40, 41, 42)):
        if n == 2:                           # every cluster full: dropped
            jst = jst[:3] + (jnp.full_like(jst[3], mem.shape[-1]),)
            st[3].fill_(mem.shape[-1])
            kept = int(st[2].sum())
        key = rng.randn(*kn.shape).astype(np.float32)
        jst = jax_append(*jst, jnp.asarray(key).astype(jd), jnp.int32(pos))
        out = cluster_append(*st, torch.tensor(key).to(td), pos)
        assert all(a is b for a, b in zip(out, st))
        for got, want, what in zip(st[1:], jst[1:],
                                   ("members", "mask", "sizes")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{what} after {n}")
        rtol = 1e-5 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(st[0].float().numpy(),
                                   np.asarray(jst[0], np.float32), rtol=rtol,
                                   atol=1e-6)
        if n == 0:
            assert int(st[2].sum()) > int(mmask.sum())   # an insert landed
    assert int(st[2].sum()) == kept                  # the full insert dropped


class _FlatSelections(_Selections):
    """:class:`test_torch_lm._Selections` for the flat-cache variant: the
    reference's ``clustered_decode_attention`` selects inline, so a spy
    around it runs the spied ``_select_top_clusters`` on the same
    query rows and centroids (the same expression in the same jitted
    step)."""

    def __init__(self, monkeypatch):
        super().__init__(monkeypatch)
        orig = jattn.clustered_decode_attention

        def spy(q, k, v, centroids, members, member_mask, top_p,
                self_kv=None):
            Bq, H, dh = q.shape
            Hkv = centroids.shape[1]
            jattn._select_top_clusters(q.reshape(Bq, Hkv, H // Hkv, dh),
                                       centroids, top_p)
            return orig(q, k, v, centroids, members, member_mask, top_p,
                        self_kv=self_kv)
        monkeypatch.setattr(jattn, "clustered_decode_attention", spy)


def test_flat_clustered_serve_step_matches_reference(monkeypatch):
    """qwen3-8b's smoke config: member lists from the reference's
    ``build_kv_clusters`` over each layer's prompt keys beside the flat
    cache (``cent``, ``mem``, ``mmask``, ``sizes``), then 5 teacher-forced
    decode steps of both packages (k²-attention over the flat cache and
    ``cluster_append``): logits within ``BF16_REL`` for the batch rows
    whose top-p selections agreed, one row at least each step (a row
    that parts is asserted to part at a bf16 near tie, ROADMAP §3 entry
    20; the member lists change slowly, so such a tie can recur from step
    to step); afterwards the member lists and sizes bit-equal, the
    centroids (drifted toward keys that differ in bf16) and the flat
    cache within ``BF16_REL``, and no kernel launched."""
    from repro.models.kv_cluster import build_kv_clusters
    ref = _reference("qwen3-8b")
    cfg = get_smoke_config("qwen3-8b")
    params = _port_params(ref)
    st = ref["cache"]["stack"]
    cent, mem, mmask, sizes = jax.vmap(lambda k: build_kv_clusters(
        k[:, :, :PROMPT], cfg.kv_clusters, cfg.cluster_cap))(st["k"])
    jcache = {"stack": dict(st, cent=cent, mem=mem, mmask=mmask,
                            sizes=sizes)}
    cache = cache_from_reference(_np_tree(jcache), device="cpu")
    sel = _FlatSelections(monkeypatch)
    step = _jax_step(ref)
    tok = ref["prompt"][:, -1:]
    _build.reset_launches()
    parted = set()
    for i in range(5):
        sel.clear()
        want, jcache = step(ref["params"], jcache, jnp.asarray(tok),
                            jnp.int32(PROMPT + i))
        got, cache = serve_step(cfg, params, cache, torch.tensor(tok),
                                PROMPT + i)
        assert len(sel.port) == len(sel.ref) == cfg.n_layers
        rows = _agreeing_rows_close(got, want, sel, f"logits step {i}")
        assert len(rows) < B, (i, rows)
        parted |= rows
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    assert not any(_build.launches().values())
    want_c = _np_tree(jcache)["stack"]
    for f in ("mem", "mmask", "sizes"):
        np.testing.assert_array_equal(cache["stack"][f].numpy(), want_c[f],
                                      err_msg=f)
    assert int(cache["stack"]["sizes"].sum()) > int(np.asarray(sizes).sum())
    for f in ("cent", "k", "v"):
        _close(cache["stack"][f], want_c[f].astype(np.float32), what=f)
