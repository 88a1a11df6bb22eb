"""The VLM family of the port (InternVL2: a dense GQA LLM whose first
``n_patches`` positions take patch embeddings) against the JAX
reference, on the CPU.

The chain runs the reference's ``internvl2-76b`` smoke config (2 layers,
d_model 128, 8 q-heads over 2 kv-heads of 16, 8 patch positions, kc 8,
cap 16, top-p 2). Params come from ``PRNGKey(0)`` and are carried across
with ``convert.params_from_reference``, caches with
``convert.cache_from_reference``; the prompt (2 x 48 tokens), then the
patches (2 x 8 x d_model), are drawn from one ``RandomState(0)``.

The reference's serve ignores patches (its ``serve_step`` embeds tokens
only), so a patched prefill has no stepped oracle in it but a
composition: its ``run_stack_decode`` stepped over the prompt with the
patch rows in place of the first 8 embeddings (ROADMAP §3 entry 26's
note). The port's ``serve_step(patches=)`` steps the same way.

Tolerances, and why:
- ``embed_tokens(patches=)``: bit for bit (a gather and a cast);
- ``forward_prefill`` with patches: within 1e-4 of the largest logit in
  f32 (sums in other orders through the layers), within ``BF16_REL``
  (2e-2) in bf16 (the two frameworks round bf16 at other places,
  ``test_torch_lm``'s module doc);
- the chains in f32: within 1e-4 of the largest logit and of every cache
  field's largest entry; the reference's own chunked forward and its
  stepped composition part by 7.4e-7 in f32;
- the cluster-major decode in f32, within 1e-4 (a batch row whose top-p
  selection parts at a near tie is not compared at that step, ROADMAP §3
  entry 20). In bf16 a near tie at one step changes the ring keys that
  the deeper layer keeps, so a row whose selection parted stays apart at
  the next steps too (up to 0.38 of the largest logit on this chain),
  and a bf16 chain would pass or fail by luck.
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
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import transformer as jtf
from repro.models.layers import rmsnorm as jrmsnorm
from repro.models.model import embed_tokens as jax_embed_tokens
from repro.models.model import forward_prefill as jax_forward_prefill
from repro.models.model import unembed as jax_unembed
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import cache_from_reference, params_from_reference
from repro_torch.launch import serve
from repro_torch.models.model import (cache_shapes, embed_tokens,
                                     forward_prefill, init_cache,
                                     init_params, serve_step)
from test_torch_lm import (B, BF16_REL, PROMPT, S_TOTAL, _close, _jax_step,
                           _np_tree, _Selections, _attach_agrees,
                           _cluster_major_steps_agree)
from test_torch_ssm import _f32

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "internvl2-76b"


def _inputs(cfg):
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, cfg.vocab, (B, PROMPT)).astype(np.int32)
    patches = rs.randn(B, cfg.n_patches, cfg.d_model).astype(np.float32)
    return prompt, patches


def _ref_stepped(cfg, params, cache, prompt, patches):
    """The reference's stepped composition of a patched prefill: its
    ``run_stack_decode`` over each position, the patch row in place of
    the token's embedding below ``n_patches``; the logits after the
    prompt and the cache."""
    @jax.jit
    def step(params, cache, h, pos):
        h, nc, _ = jtf.run_stack_decode(cfg, params["stack"], cache["stack"],
                                        h, pos)
        return jax_unembed(cfg, params, jrmsnorm(params["out_norm"], h))[
            :, 0], {"stack": nc}
    dt = params["embed"].dtype
    logits = None
    for i in range(prompt.shape[1]):
        if i < cfg.n_patches:
            h = jnp.asarray(patches[:, i:i + 1]).astype(dt)
        else:
            h = jnp.take(params["embed"], jnp.asarray(prompt[:, i:i + 1]),
                         axis=0)
        logits, cache = step(params, cache, h, jnp.int32(i))
    return np.asarray(logits), cache


@pytest.fixture(scope="module")
def jparams():
    return jax_init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def chain(jparams):
    """The reference's f32 and bf16 chains: params, prompt, patches, the
    stepped composition's cache and logits, and the port's params."""
    cfg = jax_smoke_config(ARCH)
    prompt, patches = _inputs(cfg)
    out = {}
    for dtype in ("float32", "bfloat16"):
        params = jparams if dtype == "bfloat16" else \
            jax.tree.map(jnp.asarray, _f32(jparams))
        cache = jax_init_cache(cfg, B, S_TOTAL, clustered=False, enc_len=8)
        if dtype == "float32":
            cache = jax.tree.map(lambda a: a.astype(jnp.float32), cache)
        logits, cache = _ref_stepped(cfg, params, cache, prompt, patches)
        out[dtype] = dict(
            arch=ARCH, cfg=cfg, params=params, prompt=prompt,
            patches=patches, cache=cache, logits=logits,
            port=params_from_reference(_np_tree(params),
                                       get_smoke_config(ARCH), device="cpu"))
    return out


def test_params_and_cache_shapes_match_reference(jparams):
    """The reference's params cross path for path and type for type, the
    port's own init lays out the same tree, and the caches (flat and
    cluster-major) have the reference's fields, shapes and types."""
    from repro.configs.base import get_config as jax_get_config
    from repro.models import cache_shapes as jax_cache_shapes
    from repro_torch.configs.base import get_config
    cfg = get_smoke_config(ARCH)
    port = params_from_reference(_np_tree(jparams), cfg, device="cpu")
    own = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        for tree in (port, own):
            node = tree
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    for clustered in (False, True):
        want = jax_cache_shapes(jax_smoke_config(ARCH), B, S_TOTAL,
                                clustered=clustered, enc_len=8)
        got = cache_shapes(cfg, B, S_TOTAL, clustered=clustered)
        assert set(got) == set(want) == {"stack"}
        for f, (shape, dt) in got["stack"].items():
            assert shape == want["stack"][f].shape, f
            assert str(dt).split(".")[-1] == str(want["stack"][f].dtype)
    assert get_config(ARCH).params_estimate() == \
        jax_get_config(ARCH).params_estimate()


@pytest.mark.parametrize("S,start", [(48, 0), (8, 0), (5, 0), (1, 3),
                                     (1, 8), (6, 4)])
def test_embed_tokens_with_patches_bit_for_bit(jparams, S, start):
    """``embed_tokens(patches=)`` against the reference's, bit for bit (the
    patch rows cast to the embedding's bf16): the whole prompt, a prompt
    of exactly ``n_patches`` positions; and at other positions (``start``,
    the stepped path's) against the reference's rows there. The
    reference's own ``embed_tokens`` needs S >= n_patches."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    prompt, patches = _inputs(jcfg)
    port = params_from_reference(_np_tree(jparams), cfg, device="cpu")
    full = np.asarray(jax_embed_tokens(jcfg, jparams, jnp.asarray(prompt),
                                       jnp.asarray(patches)).astype(
        jnp.float32))
    got = embed_tokens(cfg, port, torch.tensor(prompt[:, start:start + S]),
                       torch.tensor(patches), start=start)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  full[:, start:start + S])
    plain = embed_tokens(cfg, port, torch.tensor(prompt))
    assert not torch.equal(plain[:, :8], torch.tensor(full[:, :8]).to(
        torch.bfloat16))
    np.testing.assert_array_equal(plain[:, 8:].float().numpy(), full[:, 8:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_with_patches_matches_reference(chain, dtype):
    """The port's chunked ``forward_prefill`` with patches against the
    reference's: f32 within 1e-4, bf16 within ``BF16_REL``; the patches
    move the logits."""
    r = chain[dtype]
    cfg = get_smoke_config(ARCH)
    want = np.asarray(jax_forward_prefill(
        r["cfg"], r["params"], {"tokens": jnp.asarray(r["prompt"]),
                                "patches": jnp.asarray(r["patches"])}))
    got = forward_prefill(cfg, r["port"], torch.tensor(r["prompt"]),
                          patches=torch.tensor(r["patches"]), q_chunk=16)
    _close(got, want, rel=1e-4 if dtype == "float32" else BF16_REL,
           what=f"{dtype} logits")
    plain = forward_prefill(cfg, r["port"], torch.tensor(r["prompt"]))
    assert (plain - got).abs().max() > 1e-3 * got.abs().max()


def test_patched_serve_prefill_matches_stepped_composition(chain):
    """In f32 (params and caches): the port's patched serve prefill (one
    chunked forward) and its ``serve_step(patches=)`` stepped over the
    prompt, each against the reference's stepped composition: the logits
    and every cache field within 1e-4, zeros past the prompt. The
    reference's own chunked forward is 7.4e-7 from that composition."""
    r = chain["float32"]
    cfg = get_smoke_config(ARCH)
    chunked = np.asarray(jax_forward_prefill(
        r["cfg"], r["params"], {"tokens": jnp.asarray(r["prompt"]),
                                "patches": jnp.asarray(r["patches"])}))
    gap = np.abs(chunked - r["logits"]).max() / np.abs(r["logits"]).max()
    assert gap <= 1e-5, gap
    want = _np_tree(r["cache"])["stack"]
    patches = torch.tensor(r["patches"])
    for how in ("chunked", "stepped"):
        cache = {"stack": {f: t.float() for f, t in init_cache(
            cfg, B, S_TOTAL, clustered=False, device="cpu")["stack"].items()}}
        if how == "chunked":
            logits, cache = serve.prefill_into_cache(
                cfg, r["port"], cache, torch.tensor(r["prompt"]),
                patches=patches)
        else:
            for i in range(PROMPT):
                logits, cache = serve_step(
                    cfg, r["port"], cache,
                    torch.tensor(r["prompt"][:, i:i + 1]), i,
                    patches=patches)
        _close(logits, r["logits"], rel=1e-4, what=f"{how} logits")
        for f, t in cache["stack"].items():
            _close(t, want[f], rel=1e-4, what=f"{how} {f}")
            assert (t[:, :, :, PROMPT:] == 0).all()


def test_serve_steps_flat_after_patched_prefill(chain):
    """8 flat decode steps in f32 from the reference's patched stepped
    cache carried across, teacher-forced with the reference's greedy
    tokens: every step's logits and the cache after within 1e-4."""
    r = chain["float32"]
    cfg = get_smoke_config(ARCH)
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
    return {dtype: jax_attach_clusters(r["cfg"], dict(r["cache"]),
                                       length=PROMPT)
            for dtype, r in chain.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attach_clusters_after_patched_prefill(chain, clustered, dtype):
    _attach_agrees(chain[dtype], clustered[dtype])


def test_serve_steps_cluster_major_after_patched_prefill(chain, clustered,
                                                         monkeypatch):
    """Five k²-attention steps from the f32 patched prefill's clustered
    cache (the reference's ``attach_clusters`` makes its ring bf16), a
    ``fold_ring`` against the reference's and a step after it, as
    ``test_torch_lm``'s chain, the logits within 1e-4 (a row whose top-p
    selection parted at a near tie is counted, not compared; at most one
    step parts)."""
    r = chain["float32"]
    _cluster_major_steps_agree(r, r["port"], clustered["float32"],
                               sel=_Selections(monkeypatch), rel=1e-4)


def test_serve_main_runs_internvl_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch internvl2-76b --smoke
    --device cpu`` prints the reference serve's five lines (the patch
    rows drawn from the run's generator), with 16 decode steps and a fold
    every 8 through the executor; in a fresh interpreter it imports
    neither JAX nor the reference."""
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
    code = ("import sys\n"
            "from repro_torch.launch import serve\n"
            "serve.main(['--arch', 'internvl2-76b', '--smoke', '--device', "
            "'cpu', '--decode', '4'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert run.returncode == 0, run.stderr
    assert run.stdout.startswith("decoded 4 tokens: full=")


def test_serve_run_draws_patches():
    """``serve.run`` on the smoke config: patch rows (B, n_patches, d) in
    bf16 at an embedding's scale; the prefill's logits are the patched
    forward's."""
    cfg = get_smoke_config(ARCH)
    r = serve.run(cfg, batch=B, prompt_len=PROMPT, decode_len=4,
                  device="cpu", echo=lambda s: None)
    p = r["patches"]
    assert p.shape == (B, cfg.n_patches, cfg.d_model)
    assert p.dtype == torch.bfloat16 and r["frames"] is None
    assert 0.5 < float(p.float().std() * cfg.d_model ** 0.5) < 2.0
    want = forward_prefill(cfg, r["params"], r["prompt"], patches=p)
    assert torch.equal(r["prefill_logits"], want)
    for f in ("full_logits", "clus_logits"):
        assert torch.isfinite(r[f]).all()
