"""The port's LM serving path (``repro_torch.models``,
``repro_torch.launch.serve``) against the JAX reference, on the CPU.

The config is the reference's ``qwen3-8b`` smoke config (2 layers,
d_model 128, 8 q-heads over 2 kv-heads, d_head 16, kc 8, cap 16,
top_p 2); the reference's params are carried across with
``convert.params_from_reference`` and its caches with
``convert.cache_from_reference``; prompts are 48 tokens drawn with numpy.

Tolerances, and why:
- logits: within 2e-2 * max|logits| of the reference's. Weights, caches
  and activations are bf16, and the two frameworks round bf16 products
  and sums at other places (XLA keeps f32 through fused elementwise
  chains, PyTorch rounds after each op), so activations part by a few
  bf16 ulps.
- cached keys and values (bf16): within 2e-2 * max|entry| of the
  reference's, for the same reason.
- cluster structures built from the same bf16 cache: equal (both
  cluster in f32 from the same keys); bf16 centroids within one bf16
  ulp (rtol 2^-7): the f32 centroids agree to rtol 1e-5 and the cast to
  bf16 may round a value on either side of a boundary.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.launch.serve import attach_clusters as jax_attach_clusters
from repro.launch.serve import fold_ring as jax_fold_ring
from repro.launch.serve import prefill_into_cache as jax_prefill
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import serve_step as jax_serve_step
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.models.model import (cache_shapes, init_cache, init_params,
                                     serve_step)

ARCH = "qwen3-8b"
B, PROMPT, DECODE = 2, 48, 16
S_TOTAL = PROMPT + DECODE + 1
BF16_REL = 2e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=BF16_REL, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _reference(arch):
    """The reference's params for ``arch``'s smoke config, a 48-token
    prompt and the flat cache after its stepped prefill, with the logits
    after the prompt."""
    cfg = jax_smoke_config(arch)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.RandomState(0).randint(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    cache = jax_init_cache(cfg, B, S_TOTAL, clustered=False, enc_len=8)
    logits, cache = jax_prefill(cfg, params, cache, jnp.asarray(prompt))
    return dict(arch=arch, cfg=cfg, params=params, prompt=prompt,
                cache=cache, logits=np.asarray(logits))


def _port_params(ref):
    return params_from_reference(_np_tree(ref["params"]),
                                 get_smoke_config(ref["arch"]), device="cpu")


@pytest.fixture(scope="module")
def ref():
    return _reference(ARCH)


@pytest.fixture(scope="module")
def port_params(ref):
    return _port_params(ref)


def _jax_step(ref):
    return jax.jit(lambda p, c, t, i: jax_serve_step(ref["cfg"], p, c, t, i))


def test_config_matches_reference():
    """Every architecture of the reference (all ten ids) has the port's
    config, field for field, full and smoke."""
    from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS
    from repro.configs.base import get_config as jax_get_config
    assert sorted(ARCH_IDS) == sorted(JAX_ARCH_IDS) and len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for port, jx in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
            for f in ("name", "family", "n_layers", "d_model", "n_heads",
                      "n_kv_heads", "d_ff", "vocab", "d_head", "qk_norm",
                      "rope_theta", "kv_clusters", "cluster_cap",
                      "cluster_top_p", "cluster_ring",
                      "long_context_threshold", "moe", "n_experts",
                      "top_k", "n_shared_experts", "moe_d_ff",
                      "dense_residual", "first_dense", "mla", "kv_lora",
                      "qk_nope_dim", "qk_rope_dim", "v_head_dim", "ssm",
                      "ssm_state", "ssm_expand", "attn_every",
                      "encoder_layers", "frontend_stub", "n_patches"):
                assert getattr(port, f) == getattr(jx, f), (arch, f)
            assert port.params_estimate() == jx.params_estimate(), arch
    with pytest.raises(NotImplementedError, match="not an architecture"):
        get_config("whisper-large")


def test_unported_families_raise_naming_item_13():
    """A family string the reference does not have raises
    NotImplementedError naming what ROADMAP §1 item 13 leaves (its
    slice g), from the model, the layer init and the converter;
    so does a param key the reference's families do not have (a cross
    layer's ``xattn`` outside the audio family among them)."""
    import dataclasses
    from repro_torch.models.transformer import layer_init
    arctic = get_smoke_config("arctic-480b")
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(arctic, family="video")
    with pytest.raises(NotImplementedError, match="item 13 .*slice g"):
        init_params(cfg, gen, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13 .*slice g"):
        layer_init(cfg, gen)
    emb = np.zeros((4, 2), np.float32)
    with pytest.raises(NotImplementedError, match="item 13 .*slice g"):
        params_from_reference({"embed": emb}, cfg, device="cpu")
    for bad in ({"embed": emb, "stack": {"xattn": {}}},
                {"embed": emb, "stack": {"attn": {"wq": emb, "wz": emb}}},
                {"embed": emb, "enc": {}},
                {"embed": emb, "vision": {}}):
        with pytest.raises(NotImplementedError, match="unknown keys"):
            params_from_reference(bad, arctic, device="cpu")
    whisper = get_smoke_config("whisper-base")
    with pytest.raises(NotImplementedError, match="'wz'"):
        params_from_reference({"embed": emb, "stack": {"xattn": {"wz": emb}}},
                              whisper, device="cpu")


def test_params_and_cache_shapes_match_reference(ref, port_params):
    from repro.models import cache_shapes as jax_cache_shapes
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    for path, leaf in flat_ref:
        node = port_params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype)
    assert port_params["embed_f32"].dtype == torch.float32
    cfg = get_smoke_config(ARCH)
    for clustered in (False, True):
        want = jax_cache_shapes(ref["cfg"], B, S_TOTAL, clustered=clustered,
                                enc_len=8)["stack"]
        got = cache_shapes(cfg, B, S_TOTAL, clustered=clustered)["stack"]
        assert set(got) == set(want)
        for f, (shape, dtype) in got.items():
            assert shape == want[f].shape, f
            assert str(dtype).split(".")[-1] == str(want[f].dtype), f
    # the port's own init draws other numbers but the same layout
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert own["stack"]["attn"]["wq"]["w"].shape == \
        port_params["stack"]["attn"]["wq"]["w"].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    """rmsnorm, rope, SwiGLU and the cross entropy on the same inputs. f32
    within rtol 1e-5 (transcendentals and sums in other orders); bf16
    within 2e-2 of the largest magnitude (rounding places, module doc)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    g = rng.rand(16).astype(np.float32) + 0.5
    w = {k: (rng.randn(*s) * 0.2).astype(np.float32) for k, s in
         (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    pos = np.array([[0, 3, 7, 65536, 100000]])
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def J(a):
        return jnp.asarray(a).astype(jd)

    def Tt(a):
        return torch.tensor(a).to(td)
    tol = (lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-5, atol=1e-5)) if dtype == "float32" else \
        (lambda a, b: _close(a, b))
    got = tl.rmsnorm({"g": Tt(g)}, Tt(x))
    tol(got.float().numpy(), np.asarray(jl.rmsnorm({"g": J(g)}, J(x)),
                                        np.float32))
    got = tl.apply_rope(Tt(x), torch.tensor(pos), 1e4)
    tol(got.float().numpy(), np.asarray(jl.apply_rope(J(x), jnp.asarray(
        pos), 1e4), np.float32))
    got = tl.swiglu({k: {"w": Tt(v)} for k, v in w.items()}, Tt(x))
    tol(got.float().numpy(), np.asarray(jl.swiglu(
        {k: {"w": J(v)} for k, v in w.items()}, J(x)), np.float32))
    logits = rng.randn(2, 5, 32).astype(np.float32)
    labels = rng.randint(0, 32, (2, 5))
    np.testing.assert_allclose(
        float(tl.softmax_xent(torch.tensor(logits), torch.tensor(labels))),
        float(jl.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-5)


@pytest.mark.parametrize("S,q_chunk", [(48, 16), (40, 16), (33, 512)])
def test_attention_matches_reference(S, q_chunk):
    """Chunked causal prefill attention (ragged last chunks too) and
    one-token decode attention, f32, within rtol 1e-5."""
    from repro.models.attention import causal_attention as j_causal
    from repro.models.attention import decode_attention as j_decode
    from repro_torch.models.attention import (causal_attention,
                                              decode_attention)
    rng = np.random.RandomState(S)
    q = rng.randn(2, S, 8, 16).astype(np.float32)
    k = rng.randn(2, S, 2, 16).astype(np.float32)
    v = rng.randn(2, S, 2, 16).astype(np.float32)
    want = np.asarray(j_causal(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_chunk=S))
    got = causal_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    kd, vd = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    live = S - 5
    want = np.asarray(j_decode(jnp.asarray(q[:, 0]), jnp.asarray(kd),
                               jnp.asarray(vd), jnp.arange(S) < live))
    got = decode_attention(torch.tensor(q[:, 0]),
                           torch.tensor(kd[:, :, :live].copy()),
                           torch.tensor(vd[:, :, :live].copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_prefill_into_cache_matches_stepped_reference(ref, port_params):
    """The port's chunked prefill against the reference's stepped
    one: logits after the prompt and the cached keys and values."""
    _prefill_agrees(ref, port_params)


def _chunked_reference(ref):
    """The reference's chunked forward over the prompt (its
    ``forward_prefill``): the logits after the prompt and every layer's
    keys and values in the cache's layout (L, B, Hkv, S, dh)."""
    from repro.models import attention as jattn
    from repro.models import transformer as jtf
    from repro.models.layers import rmsnorm as jrmsnorm
    from repro.models.model import embed_tokens, forward_prefill
    cfg, params = ref["cfg"], ref["params"]
    tokens = jnp.asarray(ref["prompt"])
    h = embed_tokens(cfg, params, tokens)
    kv = {"k": [], "v": []}
    for i in range(cfg.n_layers):
        p = jax.tree.map(lambda a: a[i], params["stack"])
        _, k, v = jattn.gqa_project(
            p["attn"], jrmsnorm(p["ln1"], h), cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, jnp.arange(PROMPT)[None, :], cfg.rope_theta,
            cfg.qk_norm)
        kv["k"].append(np.asarray(k.transpose(0, 2, 1, 3), np.float32))
        kv["v"].append(np.asarray(v.transpose(0, 2, 1, 3), np.float32))
        h, _ = jtf.decoder_layer_fwd(cfg, p, h)
    logits = forward_prefill(cfg, params, {"tokens": tokens})
    return np.asarray(logits), {f: np.stack(a) for f, a in kv.items()}


def _prefill_agrees(ref, port_params):
    """The port's chunked prefill against the reference's stepped one. In
    the MoE family each position's tokens are routed as the reference's
    decode step routes them, so no pair is dropped where the steps keep
    it."""
    cfg = get_smoke_config(ref["arch"])
    cache = init_cache(cfg, B, S_TOTAL, clustered=False, device="cpu")
    logits, cache = serve.prefill_into_cache(cfg, port_params, cache,
                                             torch.tensor(ref["prompt"]))
    _close(logits, ref["logits"], what="logits")
    want = _np_tree(ref["cache"])["stack"]
    for f in ("k", "v"):
        _close(cache["stack"][f][:, :, :, :PROMPT],
               want[f][:, :, :, :PROMPT].astype(np.float32), what=f)
        assert (cache["stack"][f][:, :, :, PROMPT:] == 0).all()


def test_serve_step_flat_matches_reference(ref, port_params):
    """Full-attention decode steps from the same prefilled cache,
    teacher-forced with the reference's greedy tokens."""
    _flat_steps_agree(ref, port_params)


def _flat_steps_agree(ref, port_params):
    cfg = get_smoke_config(ref["arch"])
    cache = cache_from_reference(_np_tree(ref["cache"]), device="cpu")
    jcache, step = ref["cache"], _jax_step(ref)
    tok = ref["prompt"][:, -1:]
    for i in range(4):
        want, jcache = step(ref["params"], jcache, jnp.asarray(tok),
                            jnp.int32(PROMPT + i))
        got, cache = serve_step(cfg, port_params, cache, torch.tensor(tok),
                                PROMPT + i)
        _close(got, np.asarray(want), what=f"logits step {i}")
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    want_c = _np_tree(jcache)["stack"]
    for f in ("k", "v"):
        _close(cache["stack"][f], want_c[f].astype(np.float32), what=f)


def _clustered(ref):
    return jax_attach_clusters(ref["cfg"], dict(ref["cache"]), length=PROMPT)


@pytest.fixture(scope="module")
def clustered(ref):
    return _clustered(ref)


def test_attach_clusters_matches_reference(ref, clustered):
    _attach_agrees(ref, clustered)


def _attach_agrees(ref, clustered):
    cfg = get_smoke_config(ref["arch"])
    flat = cache_from_reference(_np_tree(ref["cache"]), device="cpu")
    got = serve.attach_clusters(cfg, flat, length=PROMPT)["stack"]
    want = _np_tree(clustered)["stack"]
    assert set(got) == set(want)
    for f in ("kt", "vt", "sizes", "ring_k", "ring_v", "ring_fill"):
        g = got[f].float().numpy() if got[f].dtype == torch.bfloat16 \
            else got[f].numpy()
        np.testing.assert_array_equal(g, want[f].astype(g.dtype),
                                      err_msg=f)
    np.testing.assert_allclose(got["cent"].float().numpy(),
                               want["cent"].astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_serve_step_cluster_major_matches_reference(ref, port_params,
                                                    clustered):
    """k²-attention decode steps from the same cluster-major cache,
    teacher-forced with the reference's greedy tokens; then one fold of
    the ring, and a step after it."""
    _cluster_major_steps_agree(ref, port_params, clustered)


class _Selections:
    """Both packages' top-p cluster selections, layer by layer, of the
    step being run: the reference's through ``jax.debug.callback`` in its
    jitted step, the port's around ``select_clusters``."""

    def __init__(self, monkeypatch):
        import repro.models.attention as jattn
        from repro_torch.models import attention as tattn
        self.ref, self.port = [], []
        j_sel, t_sel = jattn._select_top_clusters, tattn.select_clusters

        def j_spy(qr, cent, p):
            sel = j_sel(qr, cent, p)
            jax.debug.callback(lambda v: self.ref.append(np.asarray(v)),
                               sel)
            return sel

        def t_spy(q, cent, p):
            sel = t_sel(q, cent, p)
            qf, cf = q.float(), cent.float()
            self.port.append((sel.numpy() % cent.shape[2], qf, cf))
            return sel
        monkeypatch.setattr(jattn, "_select_top_clusters", j_spy)
        monkeypatch.setattr(tattn, "select_clusters", t_spy)

    def clear(self):
        self.ref.clear()
        self.port.clear()

    def parted_at_near_ties(self) -> set:
        """The batch rows where some query row selected other clusters
        than the reference's; every such query row must be a near tie:
        the two selections' worst f32 distances within 2^-6 of the row's
        magnitudes (bf16 keeps 8 bits, and both packages compute the
        distances in bf16 at other rounding places)."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port)
        parted = set()
        for want, (got, q, cent) in zip(self.ref, self.port):
            B, Hkv, g, p = want.shape
            got = got.reshape(B, Hkv, g, p)
            qr = q.reshape(B, Hkv, g, -1)
            d2 = ((qr * qr).sum(-1)[..., None]
                  - 2.0 * torch.einsum("bhgd,bhkd->bhgk", qr, cent)
                  + (cent * cent).sum(-1)[:, :, None, :]).numpy()
            mag = ((qr * qr).sum(-1)[..., None]
                   + (cent * cent).sum(-1)[:, :, None, :]).numpy()
            for idx in zip(*np.nonzero((np.sort(want, -1)
                                        != np.sort(got, -1)).any(-1))):
                parted.add(int(idx[0]))
                worst = [d2[idx][s].max() for s in (want[idx], got[idx])]
                assert abs(worst[0] - worst[1]) <= 2 ** -6 * \
                    mag[idx].max(), (idx, worst)
        return parted


def _agreeing_rows_close(got, want, sel, what, rel=BF16_REL):
    """The logits of the batch rows whose cluster selections all agreed
    with the reference's (every row without ``sel``), within ``rel``.
    Returns the rows that parted."""
    rows = sel.parted_at_near_ties() if sel is not None else set()
    keep = [b for b in range(want.shape[0]) if b not in rows]
    if keep:
        _close(got[keep], np.asarray(want)[keep], rel=rel, what=what)
    return rows


def _cluster_major_steps_agree(ref, port_params, clustered, sel=None,
                               rel=BF16_REL):
    """Teacher-forced k²-attention steps, a fold and a step after it, the
    logits within ``rel`` and the rings within ``BF16_REL`` (they are
    bf16 in both packages' clustered caches). With ``sel``
    (:class:`_Selections`), a batch row whose query rows picked other
    clusters at a bf16 near tie is not held to the logits' tolerance at
    that step (ROADMAP §3 entry 20), the other rows are; at most one of
    the six steps may part."""
    cfg = get_smoke_config(ref["arch"])
    cache = cache_from_reference(_np_tree(clustered), device="cpu")
    jcache, step = clustered, _jax_step(ref)
    tok = ref["prompt"][:, -1:]
    _build.reset_launches()
    parted = []
    for i in range(5):
        if sel is not None:
            sel.clear()
        want, jcache = step(ref["params"], jcache, jnp.asarray(tok),
                            jnp.int32(PROMPT + i))
        got, cache = serve_step(cfg, port_params, cache, torch.tensor(tok),
                                PROMPT + i)
        if _agreeing_rows_close(got, want, sel, f"logits step {i}", rel):
            parted.append(i)
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    assert _build.launches()["cluster_attend"] == 0   # CPU: plain version
    want_c = _np_tree(jcache)["stack"]
    np.testing.assert_array_equal(cache["stack"]["ring_fill"].numpy(),
                                  want_c["ring_fill"])
    for f in ("ring_k", "ring_v"):
        _close(cache["stack"][f], want_c[f].astype(np.float32), what=f)
    # the fold: from the reference's state, so both fold the same rows
    counts = jnp.asarray(want_c["sizes"], jnp.float32)
    jcache, jcounts, jfolded = jax_fold_ring(jcache, counts)
    cache = cache_from_reference({"stack": want_c}, device="cpu")
    cache, pcounts, folded = serve.fold_ring(
        cache, torch.tensor(np.asarray(counts)))
    assert folded == jfolded == 5 * cfg.n_layers
    want_f = _np_tree(jcache)["stack"]
    for f in ("kt", "vt", "sizes", "ring_k", "ring_v", "ring_fill"):
        g = cache["stack"][f]
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(g, want_f[f].astype(g.dtype),
                                      err_msg=f)
    np.testing.assert_array_equal(pcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(cache["stack"]["cent"].float().numpy(),
                               want_f["cent"].astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)
    if sel is not None:
        sel.clear()
    want, _ = step(ref["params"], jcache, jnp.asarray(tok),
                   jnp.int32(PROMPT + 5))
    got, _ = serve_step(cfg, port_params, cache, torch.tensor(tok),
                        PROMPT + 5)
    if _agreeing_rows_close(got, want, sel, "logits after the fold", rel):
        parted.append(5)
    assert len(parted) <= 1, parted
    return parted


@pytest.fixture(scope="module", params=["qwen3-14b", "arctic-480b"])
def other(request):
    """The module's chain for the other ported configs: qwen3-14b (dense
    GQA with qk-norm at other widths) and Arctic (the MoE family: 8
    experts, top-2, a dense residual)."""
    r = _reference(request.param)
    return dict(r, port=_port_params(r), clustered=_clustered(r))


def test_other_configs_params_match_reference(other):
    """The reference's params cross with their paths and types (an MoE
    layer's f32 router, its bf16 experts (L, E, d, f) and Arctic's dense
    residual among them), and the port's own init lays out the same tree
    from its stacked leaves."""
    cfg = get_smoke_config(other["arch"])
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            other["params"])[0]:
        for tree in (other["port"], own):
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    if cfg.moe:
        assert own["stack"]["mlp"]["router"]["w"].dtype == torch.float32
        assert own["stack"]["mlp"]["wi"].shape == (
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
        assert set(own["stack"]) == {"ln1", "attn", "ln2", "mlp",
                                     "dense_mlp"}
        # every layer and expert drew its own numbers
        wi = own["stack"]["mlp"]["wi"]
        assert not torch.equal(wi[0, 0], wi[0, 1])
        assert not torch.equal(wi[0], wi[1])


def test_other_configs_prefill_matches_reference(other):
    _prefill_agrees(other, other["port"])


def test_other_configs_forward_prefill_matches_reference(other):
    """The port's chunked ``forward_prefill`` (one router call over the
    B·S tokens, at its capacity) against the reference's: the logits
    after the prompt and every layer's keys and values. In Arctic that
    capacity drops pairs the stepped prefill keeps, and the two
    reference prefills part by more than the tolerance."""
    from repro_torch.models.model import forward_prefill
    cfg = get_smoke_config(other["arch"])
    kv = {"k": [], "v": []}

    def sink(i, fields):
        for f in ("k", "v"):
            kv[f].append(fields[f].transpose(1, 2))
    logits = forward_prefill(cfg, other["port"],
                             torch.tensor(other["prompt"]), kv_sink=sink)
    want_logits, want = _chunked_reference(other)
    _close(logits, want_logits, what="logits")
    for f in ("k", "v"):
        _close(torch.stack(kv[f]), want[f], what=f)
    parted = np.abs(want_logits - other["logits"]).max() > \
        BF16_REL * np.abs(want_logits).max()
    assert parted == cfg.moe


def test_other_configs_flat_steps_match_reference(other):
    _flat_steps_agree(other, other["port"])


def test_other_configs_attach_clusters_matches_reference(other):
    _attach_agrees(other, other["clustered"])


def test_other_configs_cluster_major_steps_match_reference(other,
                                                           monkeypatch):
    """As the module's chain; at a step whose selection parted at a bf16
    near tie, the batch rows that parted are counted, not compared."""
    _cluster_major_steps_agree(other, other["port"], other["clustered"],
                               sel=_Selections(monkeypatch))


@pytest.mark.parametrize("arch", ["granite-8b", "minitron-4b",
                                  "arctic-480b"])
def test_family_without_qk_norm_matches_reference(arch, monkeypatch):
    """The families without qk-norm (dense, and Arctic's MoE): the
    port's prefill logits against the reference's chunked
    ``forward_prefill`` (Arctic's against its stepped serve prefill,
    whose router keeps every pair the chunked one may drop), then two decode
    steps (flat, then cluster-major after ``attach_clusters``) from the
    port's cache carried back to the reference (copied: the port's
    step then writes its cache in place while the reference may still
    be reading); bf16 tolerance. At Arctic's cluster-major step a batch
    row whose selection parted at a bf16 near tie is not compared
    (ROADMAP §3 entry 20), and one row at least is."""
    from repro.models.model import forward_prefill as jax_forward_prefill
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    params = jax_init_params(jcfg, jax.random.PRNGKey(1))
    pp = params_from_reference(_np_tree(params), cfg, device="cpu")
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, (B, PROMPT))
    if cfg.moe:     # the reference's serve prefill: steps of its decode
        want, _ = jax_prefill(jcfg, params, jax_init_cache(
            jcfg, B, S_TOTAL, clustered=False, enc_len=8),
            jnp.asarray(prompt, jnp.int32))
    else:
        want = jax_forward_prefill(
            jcfg, params, {"tokens": jnp.asarray(prompt, jnp.int32)})
    cache = init_cache(cfg, B, S_TOTAL, clustered=False, device="cpu")
    got, cache = serve.prefill_into_cache(cfg, pp, cache,
                                          torch.tensor(prompt))
    _close(got, np.asarray(want), what="prefill logits")
    step = jax.jit(lambda p, c, t, i: jax_serve_step(jcfg, p, c, t, i))
    tok = prompt[:, -1:].astype(np.int32)
    sel = _Selections(monkeypatch) if cfg.moe else None
    for clustered in (False, True):
        if clustered:
            cache = serve.attach_clusters(cfg, cache, length=PROMPT)
        jcache = jax.tree.map(
            lambda t: jnp.asarray(np.array(t.float().numpy())).astype(
                jnp.bfloat16) if t.dtype == torch.bfloat16
            else jnp.asarray(np.array(t.numpy())), cache)
        if sel is not None:
            sel.clear()
        want, _ = step(params, jcache, jnp.asarray(tok), jnp.int32(PROMPT))
        got, _ = serve_step(cfg, pp, cache, torch.tensor(tok), PROMPT)
        assert len(_agreeing_rows_close(got, want, sel,
                                        f"clustered={clustered}")) < B


def test_serve_main_smoke_on_cpu(capsys):
    """``launch.serve.main``'s smoke run on the CPU: 48-token prompts, 16 decode
    steps, a fold every 8; the reference's printed lines, the serving
    executor's queue and fault counters among them."""
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--prompt-len", str(PROMPT), "--decode", str(DECODE),
                "--fold-every", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 5, out
    assert re.fullmatch(r"decoded 16 tokens: full=\d+\.\d\ds "
                        r"clustered=\d+\.\d\ds  token agreement=\d\.\d\d",
                        out[0]), out[0]
    m = re.fullmatch(r"partial_fit folds: 32 ring slots \(16 tokens x 2 "
                     r"layers\) absorbed into the cluster tables \((\d+) "
                     r"member rows, 384 -> (\d+)\), fold every 8 steps",
                     out[1])
    assert m, out[1]
    assert int(m.group(1)) == int(m.group(2)) - 384 <= 32 * B * 2
    assert out[2] == ("attention reads/token: full=65 clustered=40 "
                      "(1.6x fewer)")
    # the executor envelope's lines: 16 decode steps and 2 + 1 folds went
    # through the queue, nothing retried, healed or shed
    assert out[3] == "serve queue: admitted=19 rejected=0 max_depth=1/8"
    assert out[4] == (
        "ft counters: retries=0 (budget 3/call) repairs={'bound_reset': 0, "
        "'regroup': 0, 'split': 0, 'restore': 0} degraded_folds=0 "
        "evicted_rows=0 sanitized_rows=0 sheds=0")


@pytest.mark.parametrize("arch", ["qwen3-14b", "arctic-480b"])
def test_serve_main_runs_the_other_configs_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu`` runs to its end for qwen3-14b and Arctic: the same five lines,
    16 decode steps and their folds through the executor."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--prompt-len", str(PROMPT), "--decode", str(DECODE),
                "--fold-every", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 5, out
    assert out[0].startswith("decoded 16 tokens: full=")
    assert out[1].startswith("partial_fit folds: 32 ring slots (16 tokens "
                             "x 2 layers)")
    assert out[3] == "serve queue: admitted=19 rejected=0 max_depth=1/8"


def test_serve_run_reports_the_clustered_decode():
    cfg = get_smoke_config(ARCH)
    _build.reset_launches()
    r = serve.run(cfg, batch=B, prompt_len=PROMPT, decode_len=DECODE,
                  fold_every=8, device="cpu", echo=lambda s: None)
    assert len(r["full_toks"]) == len(r["clus_toks"]) == DECODE
    for f in ("prefill_logits", "full_logits", "clus_logits"):
        assert r[f].shape == (B, cfg.vocab) and torch.isfinite(r[f]).all()
    assert r["folded"] == DECODE * cfg.n_layers
    assert r["dropped"] == PROMPT * B * cfg.n_kv_heads * cfg.n_layers \
        - r["sizes0"] >= 0
    assert r["sizes0"] <= r["sizes1"] <= r["sizes0"] + r["folded"] * B \
        * cfg.n_kv_heads
    # the counts carried across folds keep growing past full tables
    assert float(r["counts"].sum()) == r["sizes0"] + r["folded"] * B \
        * cfg.n_kv_heads
    assert r["launches"]["cluster_attend"] == 0          # CPU tensors
    assert int(r["cache"]["stack"]["ring_fill"].sum()) == 0


def test_decode_through_the_executor_equals_direct_calls():
    """The clustered decode and its folds through the serving executor
    (``ex.call``) give the direct calls' tokens and tables, and a
    scheduled transient failure of a decode step is retried and counted,
    not surfaced."""
    from repro_torch.ft import FaultInjector
    cfg = get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(4)
    params = init_params(cfg, gen, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                           dtype=torch.int32)
    out = []
    for via in (False, True):
        cache = init_cache(cfg, B, S_TOTAL, clustered=False, device="cpu")
        _, cache = serve.prefill_into_cache(cfg, params, cache, prompt)
        cache = serve.attach_clusters(cfg, cache, length=PROMPT)
        counts = cache["stack"]["sizes"].float()
        ex = serve.serve_executor(cfg, params) if via else None
        with FaultInjector(seed=0, fail_calls={"decode_step": (3,)}):
            toks, logits, cache, counts, folded = serve.decode(
                cfg, params, cache, prompt[:, -1:], PROMPT, 10,
                fold_every=4, counts=counts, executor=ex)
        out.append((toks, logits, cache, folded, ex))
    (t0, l0, c0, f0, _), (t1, l1, c1, f1, ex) = out
    assert all((a == b).all() for a, b in zip(t0, t1)) and f0 == f1 == 2 * \
        cfg.n_layers * 4
    assert torch.equal(l0, l1)
    for name in ("kt", "vt", "cent", "sizes", "ring_fill"):
        assert torch.equal(c0["stack"][name], c1["stack"][name]), name
    assert ex.counter.retries == 1
    assert ex.stats()["admitted"] == 10 + 2 and ex.queue.max_depth == 1


def test_serve_entry_points_do_not_fall_back_to_cpu(port_params):
    """Without a card the entry points raise unless asked for the CPU:
    ``launch.serve``, which makes its own data, and the functions given host
    arrays. (Tensors are used where they lie: a CPU tensor is the
    caller's choice of the CPU.)"""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.kernels.cluster_attend import cluster_attend
    from repro_torch.models.kv_cluster import build_kv_clusters
    cfg = get_smoke_config(ARCH)
    rng = np.random.RandomState(0)
    keys = rng.randn(1, 2, 24, 16).astype(np.float32)
    q = rng.randn(4, 16).astype(np.float32)
    tab = rng.randn(6, 8, 16).astype(np.float32)
    valid = np.ones((6, 8), np.int32)
    sel = np.array([[0, 1], [2, 3], [4, 5], [0, 5]], np.int32)
    tok = np.zeros((B, 1), np.int32)
    cache = init_cache(cfg, B, S_TOTAL, clustered=False, device="cpu")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_kv_clusters(keys, 4, 8, **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            cluster_attend(q, tab, tab, valid, sel, **kw)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_step(cfg, port_params, cache, tok, 0, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, B, S_TOTAL, clustered=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(cfg)
    # asked for the CPU, each runs there
    assert build_kv_clusters(keys, 4, 8, device="cpu")[0].device.type == \
        "cpu"
    assert cluster_attend(q, tab, tab, valid, sel,
                          device="cpu").shape == (4, 16)
    logits, _ = serve_step(cfg, port_params, cache, tok, 0, device="cpu")
    assert logits.shape == (B, cfg.vocab)


def test_init_params_rejects_a_generator_on_another_device():
    """The params land on the device asked for, which must be the
    generator's: a CPU generator cannot fill tensors elsewhere."""
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="generator on cpu"):
        init_params(cfg, torch.Generator(), device="meta")
    own = init_params(cfg, torch.Generator(), device="cpu")
    assert own["embed"].device.type == "cpu"
