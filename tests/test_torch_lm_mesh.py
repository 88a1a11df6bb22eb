"""The LM's executed placement against the JAX reference and one device,
on the CPU: the sharded k²-attention decode
(``attention.cluster_major_decode_attention(mesh=)``, ``serve_step(mesh=)``
over a cache packed by ``serve.attach_clusters(mesh=)``), the ZeRO-1
train step (``launch.train.make_train_step(mesh=)``) and the mesh's
collectives.

The port runs in one ``launch.mesh.run_local`` world of four gloo ranks
(``torch_lm_mesh_cases.lm_world``). The reference's ``shard_map`` branch
of ``cluster_major_decode_attention`` runs at the same time in one
subprocess on four host devices (``--xla_force_host_platform_device_count
=4`` inside ``with jax.make_mesh((4,), ("data",))``); it spells
``check_vma``, so it needs no shim. Inputs are drawn with numpy
(``RandomState(0)``): B=2, H=8, Hkv=2, kc=16 (4 clusters a rank), cap=8,
dh=32, top-p 4, a ring of 8 with 3 live rows and the token being
decoded; some (rank, head) pairs select no cluster the rank holds.

Tolerances, and why:
- the sharded attention against the reference's branch and the port's
  one device: f32, within 1e-5 of the output's largest magnitude (the
  merge's sums in another order); the same bits on every rank and in two
  runs (the gather carries every rank's state and each rank adds them in
  shard order);
- the model-level decode of qwen3-8b's smoke config (kc 8, 2 clusters a
  rank) in f32, teacher-forced with one device's tokens: logits within
  1e-5 of their largest magnitude of one device's;
- the ZeRO step (the smoke config with a 16,384-token vocab, whose tied
  embedding reaches the FSDP threshold and is reduce-scattered, every
  other leaf summed whole), f32, 3 steps on 4 ranks x 1 x 16 tokens
  against one
  device on the four shards' batches concatenated in shard order: the
  losses rel 1e-5 and the params within 1e-4 of each leaf's largest
  magnitude (the gradients summed by rank, then divided by 4; the norm
  and the loss in other orders); with int8 compression before the
  reduction the one device compresses the whole batch's gradient where
  each rank compresses its own: a value may take the neighbouring code
  (ROADMAP §3 entry 28), within the same bounds; two runs bit-identical;
- the bytes a rank sends: equal to the dry run's figures.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_lm_mesh_cases as cases
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import ShardedBatcher
from repro_torch.kernels.ref import cluster_attend_ref
from repro_torch.launch import train
from repro_torch.launch.dryrun import decode_merge_bytes, zero_step_bytes
from repro_torch.launch.mesh import make_mesh, run_local
from repro_torch.models.attention import cluster_major_decode_attention
from repro_torch.models.model import serve_step
from repro_torch.optim import tree_leaves, tree_map

P_RANKS = 4

_REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.models.attention import cluster_major_decode_attention

a = np.load(sys.argv[1])
J = jnp.asarray
args = (J(a["q"]), J(a["kt"]), J(a["vt"]), J(a["cent"]), J(a["sizes"]),
        int(a["top_p"]))
kw = dict(self_kv=(J(a["k_new"]), J(a["v_new"])),
          ring=(J(a["ring_k"]), J(a["ring_v"]), J(a["fill"])))
one = cluster_major_decode_attention(*args, **kw)
with jax.make_mesh((4,), ("data",)):
    shard = cluster_major_decode_attention(*args, **kw)
np.savez(sys.argv[2], one=np.asarray(one), shard=np.asarray(shard),
         devices=len(jax.devices()))
"""


def _attn_inputs():
    rs = np.random.RandomState(0)
    B, H, Hkv, kc, cap, dh, R = 2, 8, 2, 16, 8, 32, 8
    f = lambda *s: rs.standard_normal(s).astype(np.float32)  # noqa: E731
    sizes = rs.randint(0, cap + 1, (B, Hkv, kc)).astype(np.int32)
    sizes[0, 0, :3] = 0                        # empty clusters too
    kt, vt = f(B, Hkv, kc, cap, dh), f(B, Hkv, kc, cap, dh)
    live = np.arange(cap)[None, None, None, :, None] < sizes[..., None, None]
    return {"q": f(B, H, dh), "kt": kt * live, "vt": vt * live,
            "cent": f(B, Hkv, kc, dh), "sizes": sizes,
            "top_p": np.array(4, np.int32),
            "k_new": f(B, Hkv, dh), "v_new": f(B, Hkv, dh),
            "ring_k": f(B, Hkv, R, dh), "ring_v": f(B, Hkv, R, dh),
            "fill": np.array(3, np.int32)}


def _one_device_decode(cfg):
    """One device's greedy decode over the f32 cache, from the prompt's
    last token at slot PROMPT (as ``serve.decode`` starts): the tokens
    fed at each step and the logits."""
    params, prompt = cases.f32_model(cfg)
    cache = cases.f32_cache(cfg, params, prompt)
    tok = prompt[:, -1].numpy()
    toks, logits = [], []
    for i in range(cases.DECODE):
        toks.append(tok)
        lg, cache = serve_step(cfg, params, cache,
                               torch.as_tensor(tok)[:, None],
                               cases.PROMPT + i, device="cpu")
        logits.append(lg.numpy())
        tok = logits[-1].argmax(-1).astype(np.int32)
    return np.stack(toks), logits


def _one_device_train(cfg, compress):
    """One device's steps over the four shards' batches concatenated in
    shard order, from the same f32 params."""
    params, opt = train.init_state(cfg, seed=0, device="cpu")
    state = (tree_map(lambda t: t.float(), params), opt)
    shards = [ShardedBatcher(cases.TRAIN_BATCH, cases.TRAIN_SEQ, cfg.vocab,
                             num_shards=P_RANKS, shard_id=s)
              for s in range(P_RANKS)]
    step = train.make_train_step(cfg, q_chunk=cases.TRAIN_SEQ,
                                 compress=compress)
    hist = []
    for s in range(cases.TRAIN_STEPS):
        parts = [b.batch_at(s) for b in shards]
        batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        state, m = step(state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return {"hist": hist,
            "params": [t.float().numpy() for t in tree_leaves(state[0])]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess beside the port's four-rank world and
    the one-device runs."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    a = _attn_inputs()
    np.savez(tmp / "in.npz", **a)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp / "in.npz"),
         str(tmp / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = get_smoke_config(cases.ARCH)
        toks, one_logits = _one_device_decode(cfg)
        four = run_local(cases.lm_world, P_RANKS, dict(a, tokens=toks),
                         device="cpu", timeout=300)
        one_train = {c: _one_device_train(cases.zero_config(), c)
                     for c in (False, True)}
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp / "out.npz"))
    assert int(ref["devices"]) == 4
    return {"a": a, "ref": ref, "four": four, "cfg": cfg,
            "one_logits": one_logits, "one_train": one_train}


def _within(got, want, rel, what=""):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    lim = rel * float(np.abs(np.asarray(want)).max())
    assert err <= lim, (what, err, lim)


def _one_attention(a):
    T = torch.from_numpy
    return cluster_major_decode_attention(
        T(a["q"]), T(a["kt"]), T(a["vt"]), T(a["cent"]), T(a["sizes"]),
        int(a["top_p"]), self_kv=(T(a["k_new"]), T(a["v_new"])),
        ring=(T(a["ring_k"]), T(a["ring_v"]), T(a["fill"]))).numpy()


def test_sharded_attention_matches_reference_shard_map(runs):
    """Every rank's sharded output against the reference's shard_map
    branch and its one-device path, f32 within 1e-5."""
    ref = runs["ref"]
    _within(ref["shard"], ref["one"], 1e-5, "reference: shard vs one")
    for r in runs["four"]:
        _within(r["attn"][0], ref["shard"], 1e-5, f"rank {r['index']}")
        _within(r["attn"][0], ref["one"], 1e-5, f"rank {r['index']}")


def test_sharded_attention_matches_one_device_and_repeats(runs):
    """The sharded output against the port's one device (f32, 1e-5); the
    same bits on every rank and in a second run."""
    one = _one_attention(runs["a"])
    first = runs["four"][0]["attn"][0]
    _within(first, one, 1e-5, "port: sharded vs one device")
    for r in runs["four"]:
        for o in r["attn"]:
            np.testing.assert_array_equal(o, first)


def test_merge_sends_the_dry_runs_bytes(runs):
    """One gather of (m, l, acc) f32 a layer: B·H·(dh + 2)·4 bytes a
    rank, the dry run's figure for one layer (the attention call) and
    for the smoke model's layers a decoded token."""
    a, cfg = runs["a"], runs["cfg"]
    B, H, dh = a["q"].shape
    for r in runs["four"]:
        assert r["attn_sent"] == B * H * (dh + 2) * 4
        assert r["decode_sent"] == decode_merge_bytes(cfg, cases.B, P_RANKS)


def test_sharded_serve_step_matches_one_device(runs):
    """qwen3-8b's smoke config in f32: each rank holds kc / 4 clusters'
    tables (the centroids all kc), and every rank's teacher-forced
    logits agree with one device's within 1e-5 of their largest."""
    cfg = runs["cfg"]
    kc_loc = cfg.kv_clusters // P_RANKS
    for r in runs["four"]:
        assert r["kt_shape"][3] == kc_loc
        for got, want in zip(r["decode"], runs["one_logits"]):
            _within(got, want, 1e-5, f"rank {r['index']}")
        for got, want in zip(r["decode"], runs["four"][0]["decode"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compress", [False, True])
def test_zero_step_matches_one_device(runs, compress):
    """The ZeRO step's losses (rel 1e-5) and params (1e-4 of each leaf's
    largest) against one device on the concatenated batch, with and
    without int8 compression before the reduction; every rank the same
    params and metrics."""
    one = runs["one_train"][compress]
    for r in runs["four"]:
        got = r["zero_c"] if compress else r["zero"][0]
        for (lg, ng), (lw, nw) in zip(got["hist"], one["hist"]):
            assert abs(lg - lw) <= 1e-5 * abs(lw), (lg, lw)
        for g, w in zip(got["params"], one["params"]):
            _within(g, w, 1e-4)
        lead = runs["four"][0]["zero_c"] if compress \
            else runs["four"][0]["zero"][0]
        assert got["hist"] == lead["hist"]
        for g, w in zip(got["params"], lead["params"]):
            np.testing.assert_array_equal(g, w)


def test_zero_step_repeats_and_sends_the_dry_runs_bytes(runs):
    """Two runs bit-identical; each rank's bytes a step equal to
    ``dryrun.zero_step_bytes``; each rank holds a quarter of every split
    moment."""
    cfg = cases.zero_config()
    f32 = tree_map(lambda t: t.float(), train.state_shapes(cfg)[0])
    want = zero_step_bytes(cfg, P_RANKS, f32)
    for r in runs["four"]:
        a, b = r["zero"]
        assert a["hist"] == b["hist"]
        for x, y in zip(a["params"] + a["m"], b["params"] + b["m"]):
            np.testing.assert_array_equal(x, y)
        assert a["sent"] == [want] * cases.TRAIN_STEPS
    one = train.init_state(cfg, seed=0, device="cpu")[1]["m"]
    sizes = [t.numel() for t in tree_leaves(one)]
    got = [m.size for m in runs["four"][0]["zero"][0]["m"]]
    assert sum(got) < sum(sizes) / 2 and all(
        g in (s, s // P_RANKS) for g, s in zip(got, sizes))


def test_collectives_in_shard_order(runs):
    """reduce_scatter (along dims 0 and 1, f32 and bf16), max,
    gather_blocks and Sharded.place/gather on four ranks."""
    t = np.arange(32, dtype=np.float32).reshape(4, 8)
    tot = t * (1 + 2 + 3 + 4)
    for r in runs["four"]:
        i, c = r["index"], r["coll"]
        np.testing.assert_array_equal(c["rs0"], tot[i:i + 1])
        np.testing.assert_array_equal(c["rs1"], tot[:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(c["rs_bf16"], tot[:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(c["max"], [3.0, 0.0])
        np.testing.assert_array_equal(
            c["blocks"], np.repeat(np.arange(4.0), 3)[None].repeat(2, 0))
        x = np.arange(16.0).reshape(2, 8)
        np.testing.assert_array_equal(c["placed"], x[:, 2 * i:2 * i + 2])
        np.testing.assert_array_equal(c["joined"], x)


def test_wholly_remote_selection_selects_nothing():
    """K6's plain version: a row whose selected ids all lie outside the
    table gives (-inf, 0, 0); a row with some gives the state over the
    others alone, as the reference's ``_cm_partial`` gives it for a
    shard's local tables."""
    import jax.numpy as jnp
    from repro.models.attention import _cm_partial
    a = _attn_inputs()
    B, Hkv, kc, cap, dh = a["kt"].shape
    g = a["q"].shape[1] // Hkv
    sel_g = np.random.RandomState(1).randint(0, kc, (B, Hkv, g, 4))
    lo, n = 8, 4                              # shard 2 of 4
    loc = sel_g - lo
    here = (loc >= 0) & (loc < n)
    here[0, 0, 0] = False                     # one row wholly remote
    loc = np.where(here, loc, -1)
    rows = (np.arange(B * Hkv).reshape(B, Hkv, 1, 1) * n + loc)
    rows = np.where(here, rows, -1).reshape(B * Hkv * g, 4).astype(np.int32)
    kt, vt = a["kt"][:, :, lo:lo + n], a["vt"][:, :, lo:lo + n]
    sizes = a["sizes"][:, :, lo:lo + n]
    T = torch.from_numpy
    m, l, acc = cluster_attend_ref(
        T(a["q"].reshape(-1, dh)),
        T(np.ascontiguousarray(kt).reshape(-1, cap, dh)),
        T(np.ascontiguousarray(vt).reshape(-1, cap, dh)), T(rows),
        sizes=T(np.ascontiguousarray(sizes).reshape(-1)))
    assert m[0].item() == -np.inf and l[0].item() == 0.0
    assert not acc[0].any()
    sel_ref = np.where(here, sel_g, -10 ** 6)
    jm, jl, jacc = _cm_partial(
        jnp.asarray(a["q"].reshape(B, Hkv, g, dh)), jnp.asarray(kt),
        jnp.asarray(vt), jnp.asarray(sizes), jnp.asarray(sel_ref), lo, dh)
    np.testing.assert_array_equal(np.isfinite(m.numpy()),
                                  np.isfinite(np.asarray(jm).reshape(-1)))
    fin = np.isfinite(m.numpy())
    np.testing.assert_allclose(m.numpy()[fin],
                               np.asarray(jm).reshape(-1)[fin], rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl).reshape(-1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc).reshape(
        B * Hkv * g, dh), rtol=1e-5, atol=1e-5)


def test_executable_mesh_refuses_a_model_axis():
    """A "model" axis of size > 1 raises NotImplementedError naming
    ROADMAP §1 item 16 (tensor-parallel execution), before any process
    group is needed; other axes and orders raise ValueError."""
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 16"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="expected axes"):
        make_mesh((2, 2), ("model", "data"), device="cpu")
    with pytest.raises(ValueError, match="expected axes"):
        make_mesh((2,), ("expert",), device="cpu")
