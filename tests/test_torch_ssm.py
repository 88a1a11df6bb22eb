"""The SSM families of the port (``repro_torch.models.ssm``, RWKV6 and
Mamba2), the ``rwkv6-3b`` and ``zamba2-7b`` chains and Zamba2's shared
attention block against the JAX reference, on the CPU.

The mixers run at small widths from the reference's inits; the chains
run the reference's smoke configs (RWKV6: 2 layers, d_model 64, 4 heads
of 16; Zamba2: 4 Mamba2 layers, d_model 64, 4 heads, N 8, the shared
block at layers 0 and 2). Params come from ``PRNGKey(0)`` and are carried
across with ``convert.params_from_reference``, caches with
``convert.cache_from_reference``; prompts are 2 x 48 tokens from
``RandomState(0)`` (``test_torch_lm._reference``). On the CPU the scans
are the plain versions (``kernels.ref``), the reference's ``scan``
bodies step by step; no kernel launches.

Tolerances, and why:
- the plain scans against the reference's ``lax.scan`` bodies: rtol 1e-5
  (f32 sums in other orders);
- a mixer in f32: within 1e-5 of the largest output (f32 sums in other
  orders); in bf16 within ``BF16_REL`` (2e-2) of the largest magnitude
  (the two frameworks round bf16 at other places, ``test_torch_lm``'s
  module doc); the final states and ``xprev`` likewise;
- the chains (``forward_prefill``, 8 decode steps) in f32: within 1e-4 of
  the largest logit (f32 sums in other orders through the layers). In
  bf16 the reference's forward parts from its own f32 forward by 1.4e-2
  (RWKV6) and 2.2e-2 (Zamba2) of the largest logit and the port's by
  1.2e-2 and 1.7e-2, so the port's bf16 ``forward_prefill`` is held
  within ``BF16_REL`` of the f32 reference and within max(``BF16_REL``,
  1.5 x the reference's gap) of the bf16 reference (2.6e-2 apart for
  Zamba2), and the decode chains are held in f32 (ROADMAP §3, the note
  after entry 25);
- the port's serve prefill (one chunked forward) against the reference's
  stepped prefill: the reference's own two prefills part by 7.0e-3 of the
  largest logit (RWKV6) and 0.0 (Zamba2), and its bf16 forward from its
  f32 one by the gaps above, so the logits are held within
  max(``BF16_REL``, 1.5 x the larger gap), and within ``BF16_REL`` of the
  f32 reference; every cache field within ``BF16_REL``;
- cluster structures built from the same cache: ints bit-equal, bf16
  centroids within one bf16 ulp (``test_torch_lm._attach_agrees``); the
  cluster-major decode as ``test_torch_lm``'s (a batch row whose top-p
  selection parts at a bf16 near tie is not compared at that step,
  ROADMAP §3 entry 20).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.kernels import _build, ref as kref
from repro_torch.launch import serve
from repro_torch.models import ssm as tssm
from repro_torch.models.model import (cache_shapes, forward_prefill,
                                     init_cache, init_params, n_shared_apps,
                                     serve_step)
from test_torch_lm import (B, BF16_REL, PROMPT, S_TOTAL, _close, _jax_step,
                           _np_tree, _port_params, _reference, _Selections)

ARCHS = ["rwkv6-3b", "zamba2-7b"]
# the reference's own gap between its stepped prefill and its chunked
# forward, as a share of the largest logit (smoke configs, PRNGKey(0),
# RandomState(0))
PREFILL_GAP = {"rwkv6-3b": 7.0e-3, "zamba2-7b": 0.0}


@pytest.fixture(scope="module", params=ARCHS)
def chain(request):
    """The reference's smoke chain for an SSM config (params, prompt, the
    cache of its stepped prefill and the logits after it) and the port's
    params."""
    r = _reference(request.param)
    return dict(r, port=_port_params(r))


def _tree_to(tree, dtype):
    """numpy-array leaves of a reference tree as port tensors in
    ``dtype`` (floating leaves) on the CPU."""
    return {k: _tree_to(v, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32)).to(dtype)
            for k, v in tree.items()}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _check(got, want, dtype, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    rel = 1e-5 if dtype == "float32" else BF16_REL
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


# --------------------------------------------------------------------------
# the plain scans against the reference's scan bodies
# --------------------------------------------------------------------------

def _captured_scan(monkeypatch, call):
    """The reference's ``lax.scan`` body and its carry, captured from
    ``call()``; returns (step, the real ``lax.scan``)."""
    real = jax.lax.scan
    seen = {}

    def spy(step, init, xs, *a, **kw):
        seen["step"] = step
        return real(step, init, xs, *a, **kw)
    monkeypatch.setattr(jax.lax, "scan", spy)
    call()
    monkeypatch.setattr(jax.lax, "scan", real)
    return seen["step"], real


def test_wkv6_plain_scan_matches_reference_body(monkeypatch):
    """``ref.wkv6_scan_ref`` against the reference's RWKV6 ``scan`` body
    (captured from ``rwkv6_apply``, with its ``u``) run by ``lax.scan`` on
    the same random r, k, v, w and a random initial state: the outputs
    and the final state, rtol 1e-5."""
    Bq, S, H, dh = 2, 37, 3, 8
    p = jssm.rwkv6_init(jax.random.PRNGKey(0), H * dh, H, dtype=jnp.float32)
    step, scan = _captured_scan(monkeypatch, lambda: jssm.rwkv6_apply(
        p, jnp.zeros((1, 2, H * dh)), n_heads=H))
    rs = np.random.RandomState(1)
    r, k, v = (rs.randn(Bq, S, H, dh).astype(np.float32) for _ in range(3))
    w = rs.uniform(0.5, 1.0, (Bq, S, H, dh)).astype(np.float32)
    s0 = rs.randn(Bq, H, dh, dh).astype(np.float32)
    xs = tuple(jnp.asarray(np.moveaxis(a, 1, 0)) for a in (r, k, v, w))
    want_s, want = scan(step, jnp.asarray(s0), xs)
    state = torch.tensor(s0)
    got = kref.wkv6_scan_ref(*(torch.tensor(a) for a in (r, k, v, w)),
                             torch.tensor(np.asarray(p["u"])), state)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want),
                                                        0, 1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


def test_ssd_plain_scan_matches_reference_body(monkeypatch):
    """``ref.ssd_scan_ref`` against the reference's Mamba2 ``scan`` body
    (captured from ``mamba2_apply``) run by ``lax.scan`` on the same
    random inputs and a random initial state, with the reference's D skip
    added after: the outputs and the final state, rtol 1e-5."""
    Bq, S, H, P, N = 2, 41, 3, 6, 5
    p = jssm.mamba2_init(jax.random.PRNGKey(0), 3 * P, H, N, 1,
                         dtype=jnp.float32)
    step, scan = _captured_scan(monkeypatch, lambda: jssm.mamba2_apply(
        p, jnp.zeros((1, 2, 3 * P)), n_heads=H))
    rs = np.random.RandomState(2)
    x = rs.randn(Bq, S, H, P).astype(np.float32)
    Bm, Cm = (rs.randn(Bq, S, N).astype(np.float32) for _ in range(2))
    decay = rs.uniform(0.3, 1.0, (Bq, S, H)).astype(np.float32)
    dt = rs.uniform(0.0, 1.5, (Bq, S, H)).astype(np.float32)
    D = rs.randn(H).astype(np.float32)
    s0 = rs.randn(Bq, H, P, N).astype(np.float32)
    xs = tuple(jnp.asarray(np.moveaxis(a, 1, 0))
               for a in (x, Bm, Cm, decay, dt))
    want_s, want = scan(step, jnp.asarray(s0), xs)
    want = np.moveaxis(np.asarray(want), 0, 1) + D[None, None, :, None] * x
    state = torch.tensor(s0)
    got = kref.ssd_scan_ref(*(torch.tensor(a) for a in (x, Bm, Cm, decay,
                                                        dt, D)), state)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# the mixers
# --------------------------------------------------------------------------

def _mixer_case(kind, dtype, S=20, seed=0):
    """A small mixer from the reference's init (d 48, 4 heads; Mamba2 N 8,
    expand 2) and x (2, S, 48), both in ``dtype``."""
    jd = getattr(jnp, dtype)
    key = jax.random.PRNGKey(seed)
    if kind == "rwkv6":
        p = jssm.rwkv6_init(key, 48, 4, dtype=jd)
    else:
        p = jssm.mamba2_init(key, 48, 4, 8, 2, dtype=jd)
        # non-trivial decays, skips and dt biases (the init's are 0, 1, 0)
        rs = np.random.RandomState(seed + 7)
        p = dict(p, A_log=jnp.asarray(rs.randn(4).astype(np.float32) * 0.5),
                 D=jnp.asarray(rs.randn(4).astype(np.float32)),
                 dt_bias=jnp.asarray(rs.randn(4).astype(np.float32) * 0.5))
    x = np.random.RandomState(seed).randn(2, S, 48).astype(np.float32)
    tp = _tree_to(_np_tree(p), getattr(torch, dtype))
    for f in ("w0", "u", "A_log", "D", "dt_bias"):       # f32 in both
        if f in tp:
            tp[f] = torch.tensor(np.asarray(p[f]))
    return p, jnp.asarray(x).astype(jd), tp, torch.tensor(x).to(
        getattr(torch, dtype))


def _stepped_rwkv6(p, x):
    """The reference's final RWKV6 state after x, from its decode step
    over each position (the scan's body), and the last input."""
    Bq, S, d = x.shape
    dh = d // 4
    state = jnp.zeros((Bq, 4, dh, dh), jnp.float32)
    prev = jnp.zeros((Bq, 1, d), x.dtype)
    step = jax.jit(lambda xt, xp, st: jssm.rwkv6_decode(p, xt, xp, st,
                                                        n_heads=4))
    for t in range(S):
        _, state, prev = step(x[:, t:t + 1], prev, state)
    return state, prev


def _stepped_mamba2(p, x):
    """The reference's final Mamba2 state after x, from its decode step
    over each position."""
    Bq, S, _ = x.shape
    state = jnp.zeros((Bq, 4, 96 // 4, 8), jnp.float32)
    step = jax.jit(lambda xt, st: jssm.mamba2_decode(p, xt, st, n_heads=4))
    for t in range(S):
        _, state = step(x[:, t:t + 1], state)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_apply_matches_reference(dtype):
    """The prefill RWKV6 (token shift, data-dependent decay, the scan, the
    gated norm): its output against ``rwkv6_apply``'s, its final state and
    last input against the reference's decode stepped over the sequence;
    f32 within 1e-5, bf16 within ``BF16_REL``."""
    jp, jx, tp, tx = _mixer_case("rwkv6", dtype)
    want = jssm.rwkv6_apply(jp, jx, n_heads=4)
    got, state, xprev = tssm.rwkv6_apply(tp, tx, n_heads=4)
    assert got.dtype == tx.dtype and state.dtype == torch.float32
    _check(got, want, dtype, "out")
    want_s, want_prev = _stepped_rwkv6(jp, jx)
    _check(state, want_s, dtype, "state")
    assert torch.equal(xprev, tx[:, -1:])
    _check(xprev, want_prev, dtype, "xprev")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_decode_matches_reference(dtype):
    """One decode step from a random state and x_prev: the output, the
    state (updated in place) and the next x_prev; f32 within 1e-5, bf16
    within ``BF16_REL``."""
    jp, jx, tp, tx = _mixer_case("rwkv6", dtype, S=2, seed=1)
    s0 = np.random.RandomState(3).randn(2, 4, 12, 12).astype(np.float32)
    want, want_s, want_prev = jssm.rwkv6_decode(
        jp, jx[:, 1:], jx[:, :1], jnp.asarray(s0), n_heads=4)
    state = torch.tensor(s0)
    got, out_s, prev = tssm.rwkv6_decode(tp, tx[:, 1:], tx[:, :1], state,
                                         n_heads=4)
    assert out_s is state
    _check(got, want, dtype, "out")
    _check(state, want_s, dtype, "state")
    _check(prev, want_prev, dtype, "xprev")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_matches_reference(dtype):
    """The prefill Mamba2 (in-projection, softplus dt, the SSD scan with
    its D skip, the gated norm): its output against ``mamba2_apply``'s and
    its final state against the reference's decode stepped over the
    sequence; f32 within 1e-5, bf16 within ``BF16_REL``."""
    jp, jx, tp, tx = _mixer_case("mamba2", dtype)
    want = jssm.mamba2_apply(jp, jx, n_heads=4)
    got, state = tssm.mamba2_apply(tp, tx, n_heads=4)
    assert got.dtype == tx.dtype and state.shape == (2, 4, 24, 8)
    _check(got, want, dtype, "out")
    _check(state, _stepped_mamba2(jp, jx), dtype, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(dtype):
    """One decode step from a random state: the output and the state
    (updated in place); f32 within 1e-5, bf16 within ``BF16_REL``."""
    jp, jx, tp, tx = _mixer_case("mamba2", dtype, S=1, seed=1)
    s0 = np.random.RandomState(4).randn(2, 4, 24, 8).astype(np.float32)
    want, want_s = jssm.mamba2_decode(jp, jx, jnp.asarray(s0), n_heads=4)
    state = torch.tensor(s0)
    got, out_s = tssm.mamba2_decode(tp, tx, state, n_heads=4)
    assert out_s is state
    _check(got, want, dtype, "out")
    _check(state, want_s, dtype, "state")


# --------------------------------------------------------------------------
# the smoke chains
# --------------------------------------------------------------------------

def test_configs_params_and_caches_match_reference(chain):
    """Both configs' params cross with their paths and types (the f32
    ``w0``, ``u``, ``A_log``, ``D``, ``dt_bias``; Zamba2's ``shared``
    block), the port's own init lays out the same tree, and the cache
    shapes match the reference's, flat and clustered (the SSM state
    whatever ``clustered`` says; the shared block's cache over its
    applications)."""
    from repro.models import cache_shapes as jax_cache_shapes
    cfg = get_smoke_config(chain["arch"])
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want_top = {"embed", "out_norm", "stack", "embed_f32"} \
        | ({"shared"} if cfg.attn_every else set())
    assert set(own) == set(chain["port"]) == want_top
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            chain["params"])[0]:
        for tree in (chain["port"], own):
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    mix = own["stack"]["mix"]
    for f in ("mu", "u") if cfg.ssm == "rwkv6" else ("A_log", "D"):
        assert not torch.equal(mix[f][0], mix[f][-1]) or f in ("A_log", "D")
    for clustered in (False, True):
        want = jax_cache_shapes(chain["cfg"], B, S_TOTAL,
                                clustered=clustered, enc_len=8)
        got = cache_shapes(cfg, B, S_TOTAL, clustered=clustered)
        assert set(got) == set(want)
        for part in got:
            assert set(got[part]) == set(want[part]), part
            for f, (shape, dtype) in got[part].items():
                assert shape == want[part][f].shape, (part, f)
                assert str(dtype).split(".")[-1] == \
                    str(want[part][f].dtype), (part, f)
    assert cache_shapes(cfg, B, 1 << 20)["stack"] == \
        cache_shapes(cfg, B, 1 << 20, clustered=False)["stack"]
    cache = cache_from_reference(_np_tree(chain["cache"]), device="cpu")
    for part in cache:
        for f, t in cache[part].items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                np.asarray(chain["cache"][part][f], np.float32))


def _sinks():
    """A kv_sink and a shared_sink that keep what they are given."""
    got = {"fields": [], "shared": []}
    return (got, lambda i, f: got["fields"].append((i, f)),
            lambda app, k, v: got["shared"].append((app, k, v)))


def test_forward_prefill_matches_reference(chain):
    """The port's chunked ``forward_prefill`` against the reference's: in
    f32 (both packages' params in f32) the logits after the prompt within
    1e-4 of their largest magnitude. In bf16 the reference's logits part
    from its own f32 ones by 1.4e-2 (RWKV6) and 2.2e-2 (Zamba2), which
    the test measures; the port's bf16 logits are held within
    ``BF16_REL`` of the f32 reference's and within max(``BF16_REL``, 1.5 x
    that gap) of the bf16 reference's (the two bf16 chains round at other
    places, each ~2% off the f32 result). The sinks get every layer's
    state (and RWKV6's last input) and, in Zamba2, the shared block's
    keys and values at layers 0 and 2, as applications 0 and 1."""
    from repro.models.model import forward_prefill as jax_forward_prefill
    cfg = get_smoke_config(chain["arch"])
    tokens = jnp.asarray(chain["prompt"])
    out = {}
    for name, params in (("f32", _f32(chain["params"])),
                         ("bf16", _np_tree(chain["params"]))):
        got, kv_sink, shared_sink = _sinks()
        logits = forward_prefill(
            cfg, params_from_reference(params, cfg, device="cpu"),
            torch.tensor(chain["prompt"]), kv_sink=kv_sink,
            shared_sink=shared_sink)
        want = np.asarray(jax_forward_prefill(
            chain["cfg"], jax.tree.map(jnp.asarray, params),
            {"tokens": tokens}))
        assert logits.dtype == torch.float32
        out[name] = (logits, want)
        assert [i for i, _ in got["fields"]] == list(range(cfg.n_layers))
        want_f = {"state", "xprev"} if cfg.ssm == "rwkv6" else {"state"}
        assert all(set(f) == want_f for _, f in got["fields"])
        apps = [a for a, _, _ in got["shared"]]
        assert apps == (list(range(n_shared_apps(cfg))) if cfg.attn_every
                        else [])
    (got32, want32), (got16, want16) = out["f32"], out["bf16"]
    _close(got32, want32, rel=1e-4, what="f32 logits")
    gap = np.abs(want16 - want32).max() / np.abs(want32).max()
    assert 1.2e-2 <= gap <= 2.4e-2, gap
    _close(got16, want32, what="bf16 logits against the f32 reference")
    _close(got16, want16, rel=max(BF16_REL, 1.5 * gap),
           what="bf16 logits")


def test_serve_prefill_matches_stepped_reference(chain):
    """The port's serve prefill (one chunked forward, its sinks writing
    the cache) against the reference's stepped ``prefill_into_cache``.
    In bf16: the logits within ``BF16_REL`` of the reference's f32
    chunked forward, and within max(``BF16_REL``, 1.5 x the larger of
    the reference's own two gaps, its stepped prefill against its chunked
    forward and its bf16 forward against its f32 one) of the stepped
    reference's, both gaps measured first; layer 0's cache fields (and
    the shared block's first application's keys and values) within
    ``BF16_REL`` of their largest magnitude, every field within that
    max. In f32 (params and caches in f32 in both packages): the logits
    and every cache field (the states, RWKV6's ``xprev``, Zamba2's shared
    keys and values, zeros past the prompt) within 1e-4."""
    from repro.launch.serve import prefill_into_cache as jax_prefill
    from repro.models import init_cache as jax_init_cache
    from repro.models.model import forward_prefill as jax_forward_prefill
    cfg = get_smoke_config(chain["arch"])
    tokens = {"tokens": jnp.asarray(chain["prompt"])}
    chunked = np.asarray(jax_forward_prefill(chain["cfg"], chain["params"],
                                             tokens))
    p32 = _f32(chain["params"])
    chunked32 = np.asarray(jax_forward_prefill(
        chain["cfg"], jax.tree.map(jnp.asarray, p32), tokens))
    gap = np.abs(chunked - chain["logits"]).max() / \
        np.abs(chain["logits"]).max()
    assert abs(gap - PREFILL_GAP[chain["arch"]]) <= 1e-3, gap
    gap32 = np.abs(chunked - chunked32).max() / np.abs(chunked32).max()
    loose = max(BF16_REL, 1.5 * gap, 1.5 * gap32)
    cache = init_cache(cfg, B, S_TOTAL, clustered=False, device="cpu")
    _build.reset_launches()
    logits, cache = serve.prefill_into_cache(cfg, chain["port"], cache,
                                             torch.tensor(chain["prompt"]))
    assert not any(_build.launches().values())          # CPU: plain scans
    _close(logits, chunked32, what="logits against the f32 reference")
    _close(logits, chain["logits"], rel=loose, what="logits")
    want = _np_tree(chain["cache"])
    assert set(cache) == set(want)
    for part in cache:
        assert set(cache[part]) == set(want[part])
        for f, t in cache[part].items():
            w = want[part][f].astype(np.float32)
            _close(t[0], w[0], what=f"{part} {f} [0]")
            _close(t, w, rel=loose, what=f"{part} {f}")
    # in f32: the reference's stepped prefill on an f32 cache
    c32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                       if jnp.issubdtype(a.dtype, jnp.floating) else a,
                       jax_init_cache(chain["cfg"], B, S_TOTAL,
                                      clustered=False, enc_len=8))
    want_l, want_c = jax_prefill(chain["cfg"], jax.tree.map(jnp.asarray, p32),
                                 c32, jnp.asarray(chain["prompt"]))
    cache = {part: {f: t.float() for f, t in fields.items()}
             for part, fields in init_cache(cfg, B, S_TOTAL, clustered=False,
                                            device="cpu").items()}
    logits, cache = serve.prefill_into_cache(
        cfg, params_from_reference(p32, cfg, device="cpu"), cache,
        torch.tensor(chain["prompt"]))
    _close(logits, np.asarray(want_l), rel=1e-4, what="f32 logits")
    want_c = _np_tree(want_c)
    for part in cache:
        for f, t in cache[part].items():
            _close(t, want_c[part][f], rel=1e-4, what=f"f32 {part} {f}")
    if cfg.attn_every:
        assert (cache["shared"]["k"][..., PROMPT:, :] == 0).all()


def test_serve_steps_match_reference(chain):
    """8 decode steps (the recurrent states in place; Zamba2's shared
    block over its flat per-application cache) from the reference's
    stepped-prefill cache carried across, teacher-forced with the
    reference's greedy tokens, params and caches in f32 in both packages:
    the logits at every step and every cache field after within 1e-4 of
    their largest magnitude."""
    cfg = get_smoke_config(chain["arch"])
    p32 = _f32(chain["params"])
    params = params_from_reference(p32, cfg, device="cpu")
    jparams = jax.tree.map(jnp.asarray, p32)
    c32 = _f32(chain["cache"])
    cache = cache_from_reference(c32, device="cpu")
    jcache, step = jax.tree.map(jnp.asarray, c32), _jax_step(chain)
    tok = chain["prompt"][:, -1:]
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
    for part in cache:
        for f, t in cache[part].items():
            assert t.dtype == torch.float32
            _close(t, want_c[part][f], rel=1e-4, what=f"{part} {f}")


# --------------------------------------------------------------------------
# Zamba2's shared block over the cluster-major cache
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    """Zamba2's smoke chain and the reference's clustered cache: its
    stepped-prefill stack (the Mamba2 states) and, for each application
    of the shared block, ``build_cluster_major`` over the prompt's keys
    and values, with an empty ring, in ``init_cache(clustered=True)``'s
    layout."""
    from repro.models.kv_cluster import build_cluster_major
    r = _reference("zamba2-7b")
    cfg = r["cfg"]
    sc = r["cache"]["shared"]
    parts = [build_cluster_major(sc["k"][a][:, :, :PROMPT],
                                 sc["v"][a][:, :, :PROMPT], cfg.kv_clusters,
                                 cfg.cluster_cap)
             for a in range(sc["k"].shape[0])]
    napps, hkv, dh = sc["k"].shape[0], cfg.n_kv_heads, cfg.d_head
    ring = (napps, B, hkv, cfg.cluster_ring, dh)
    shared = {f: jnp.stack([p[j] for p in parts])
              for j, f in enumerate(("kt", "vt", "cent", "sizes"))}
    shared.update(ring_k=jnp.zeros(ring, jnp.bfloat16),
                  ring_v=jnp.zeros(ring, jnp.bfloat16),
                  ring_fill=jnp.zeros((napps,), jnp.int32))
    clustered = {"stack": r["cache"]["stack"], "shared": shared}
    return dict(r, port=_port_params(r), clustered=clustered)


def test_attach_clusters_repacks_shared_as_reference(zamba):
    """The port's ``attach_clusters`` over Zamba2's flat cache repacks the
    shared block's cache, one application at a time, into the tables the
    reference's ``build_cluster_major`` builds: ints and tables equal,
    centroids within one bf16 ulp, an empty ring, the stack untouched."""
    cfg = get_smoke_config("zamba2-7b")
    flat = cache_from_reference(_np_tree(zamba["cache"]), device="cpu")
    got = serve.attach_clusters(cfg, flat, length=PROMPT)
    assert got["stack"] is flat["stack"]
    want = _np_tree(zamba["clustered"])["shared"]
    assert set(got["shared"]) == set(want)
    for f in ("kt", "vt", "sizes", "ring_k", "ring_v", "ring_fill"):
        g = got["shared"][f]
        g = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(g, want[f].astype(g.dtype), err_msg=f)
    np.testing.assert_allclose(got["shared"]["cent"].float().numpy(),
                               want["cent"].astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_cluster_major_shared_steps_match_reference(zamba, monkeypatch):
    """6 teacher-forced k²-attention steps over the reference's
    cluster-major shared cache carried across (the tables read-only, the
    ring written in place at its application), against the reference's
    ``serve_step`` on the same cache (``gqa_decode_cluster_major`` over
    the per-application tables), params and cache in f32 in both packages
    (Zamba2's bf16 chain parts from itself by 2.2e-2, ROADMAP §3's note
    after entry 25): the logits within 1e-4 of their largest magnitude
    (a batch row whose selection parted at a near tie not compared at
    that step, at most one step of six parting), the ring, its fills and
    the Mamba2 states after."""
    cfg = get_smoke_config("zamba2-7b")
    sel = _Selections(monkeypatch)
    c32 = jax.tree.map(lambda a: np.asarray(a, np.float32)
                       if jnp.issubdtype(a.dtype, jnp.floating)
                       else np.asarray(a), zamba["clustered"])
    p32 = _f32(zamba["params"])
    params = params_from_reference(p32, cfg, device="cpu")
    cache = cache_from_reference(c32, device="cpu")
    tables = {f: cache["shared"][f].clone() for f in ("kt", "vt", "cent",
                                                      "sizes")}
    jparams, jcache = (jax.tree.map(jnp.asarray, t) for t in (p32, c32))
    step = _jax_step(zamba)
    tok = zamba["prompt"][:, -1:]
    parted = []
    for i in range(6):
        sel.clear()
        want, jcache = step(jparams, jcache, jnp.asarray(tok),
                            jnp.int32(PROMPT + i))
        got, cache = serve_step(cfg, params, cache, torch.tensor(tok),
                                PROMPT + i)
        rows = sel.parted_at_near_ties()
        keep = [b for b in range(B) if b not in rows]
        if keep:
            _close(got[keep], np.asarray(want)[keep], rel=1e-4,
                   what=f"logits step {i}")
        if rows:
            parted.append(i)
        tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
    assert len(parted) <= 1, parted
    want_c = _np_tree(jcache)
    for f, t in tables.items():
        assert torch.equal(cache["shared"][f], t), f
    np.testing.assert_array_equal(cache["shared"]["ring_fill"].numpy(),
                                  want_c["shared"]["ring_fill"])
    assert (cache["shared"]["ring_fill"] == 6).all()
    for f in ("ring_k", "ring_v"):
        _close(cache["shared"][f], want_c["shared"][f], rel=1e-4, what=f)
    _close(cache["stack"]["state"], want_c["stack"]["state"], rel=1e-4,
           what="state")


# --------------------------------------------------------------------------
# run and the reference's serve
# --------------------------------------------------------------------------

def test_run_rwkv6_prints_the_reference_lines(capsys):
    """``python -m repro_torch.launch.serve --arch rwkv6-3b --smoke
    --device cpu``: the reference's two lines (attention-free, then the
    recurrent decode), and ``run``'s clustered fields ``None``;
    ``attach_clusters`` on its cache (no keys) raises."""
    serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                "--prompt-len", str(PROMPT), "--decode", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == ("rwkv6-smoke: attention-free — k²-attention "
                      "inapplicable (native O(1) state); running plain "
                      "decode"), out
    assert re.fullmatch(r"decoded 16 tokens in \d+\.\d\ds \(recurrent\)",
                        out[1]), out
    assert len(out) == 2
    r = serve.run(get_smoke_config("rwkv6-3b"), batch=B, prompt_len=PROMPT,
                  decode_len=4, device="cpu", echo=lambda line: None)
    assert r["cache"] is None and r["clus_logits"] is None \
        and r["executor"] is None and len(r["full_toks"]) == 4
    for f in ("prefill_logits", "full_logits"):
        assert r[f].shape == (B, 512) and torch.isfinite(r[f]).all()
    with pytest.raises(ValueError, match="no flat keys"):
        serve.attach_clusters(get_smoke_config("rwkv6-3b"), r["flat_cache"])


def test_run_zamba_clusters_the_shared_block(capsys):
    """``--arch zamba2-7b --smoke --device cpu``: the full and clustered
    decode (no folds, K6's plain version on the CPU), the clustered cache's
    shared block cluster-major with one ring slot a decoded token; a
    decode longer than the ring, or a fold asked for, raises."""
    serve.main(["--arch", "zamba2-7b", "--smoke", "--device", "cpu",
                "--prompt-len", str(PROMPT), "--decode", "4"])
    out = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"decoded 4 tokens: full=\d+\.\d\ds "
                        r"clustered=\d+\.\d\ds  token agreement=\d\.\d\d",
                        out[0]), out
    assert out[1].startswith("no folds: the 4 decoded tokens stay in the "
                             "ring of each of the 2 shared-block "
                             "applications"), out
    cfg = get_smoke_config("zamba2-7b")
    r = serve.run(cfg, batch=B, prompt_len=PROMPT, decode_len=3,
                  device="cpu", echo=lambda line: None)
    sc = r["cache"]["shared"]
    assert "k" not in sc and sc["kt"].shape[:2] == (2, B)
    assert (sc["ring_fill"] == 3).all() and r["folded"] == 0
    assert r["sizes1"] == r["sizes0"] and r["dropped"] >= 0
    assert set(r["cache"]["stack"]) == {"state"}
    for kw in (dict(decode_len=cfg.cluster_ring + 1),
               dict(decode_len=4, fold_every=2)):
        with pytest.raises(ValueError, match="ring is not folded"):
            serve.run(cfg, batch=B, prompt_len=PROMPT, device="cpu", **kw)


def test_reference_serve_raises_on_zamba():
    """ROADMAP §3 entry 25: the reference's serve decodes Zamba2 with full
    attention and then dies in ``attach_clusters`` with ``KeyError: 'k'``
    (a hybrid keeps Mamba2 states in the stack and the shared block's keys
    in ``cache["shared"]``), while its model decodes a clustered hybrid
    cache (the cluster-major test above)."""
    from repro.launch import serve as jserve
    r = _reference("zamba2-7b")
    with pytest.raises(KeyError, match="'k'"):
        jserve.attach_clusters(r["cfg"], dict(r["cache"]), length=PROMPT)


def test_ssm_configs_match_reference():
    """Both SSM configs, full and smoke, field for field, the SSM fields
    among them."""
    from repro.configs.base import get_config as jax_get_config
    from repro_torch.configs.base import get_config
    for arch in ARCHS:
        for port, jx in ((get_config(arch), jax_get_config(arch)),
                         (get_smoke_config(arch), jax_smoke_config(arch))):
            assert port == type(port)(**{
                f: getattr(jx, f) for f in port.__dataclass_fields__})
