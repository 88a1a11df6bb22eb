"""The training step's parts in the port against the JAX reference, on
the CPU: AdamW, its schedule, global-norm clipping and int8 gradient
compression (``repro_torch.optim``), the token batcher
(``repro_torch.data.pipeline``), the plain scans' gradients, three
``launch.train.make_train_step`` steps and a resumed
``FaultTolerantLoop``. Inputs are drawn with numpy (or are the
reference's params and draws) and handed to both.

Tolerances, and why:
- AdamW, the schedule: within 1 ulp of the reference's (the same ops in
  the same order, each rounded to the tensor's type; XLA's ``pow`` and
  ``cos`` may differ from torch's in the last bit);
- the global norm: rel 1e-6 (a sum over leaves and elements in another
  order); the int8 round trip: bit-equal (a max, a division and a
  rounding, each exact or correctly rounded);
- the plain scans' gradients against ``jax.grad`` of the reference's
  ``lax.scan`` bodies: within 1e-5 of each gradient's largest magnitude
  (f32 sums in other orders);
- three train steps: the losses and gradient norms rel 1e-5, params
  within 1e-5 of each leaf's largest magnitude and ``m``, ``v`` within
  1e-4 of theirs (the update's ops in the same order, the gradients'
  sums in others); ``step`` equal. With int8 compression, a gradient
  value within its sums' error of a rounding midpoint of its block's
  codes takes the neighbouring code in one package: it moves by one
  code, 1/127 of its block's largest magnitude, and ``m`` and ``v`` are
  held within 1/127 of theirs;
- the resumed loop: bit-equal to the uninterrupted one (the same ops on
  the same inputs, the state restored exactly).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data import ShardedBatcher as JaxBatcher
from repro.data import token_batches as jax_token_batches
from repro.optim import (adamw_update as jax_adamw_update,
                         clip_by_global_norm as jax_clip,
                         compress_int8 as jax_compress_int8,
                         compressed_grads as jax_compressed_grads,
                         cosine_schedule as jax_cosine_schedule,
                         decompress_int8 as jax_decompress_int8)
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data import ShardedBatcher, token_batches
from repro_torch.ft import FaultTolerantLoop
from repro_torch.kernels import ref as kref
from repro_torch.launch import train
from repro_torch.models.model import param_shapes
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_int8, compressed_grads,
                               cosine_schedule, decompress_int8,
                               init_opt_shapes)
from test_torch_train import (B, Q_CHUNK, S, _get, _jax_init, _leaves,
                              _np_tree, _to_f32, compiled)


def _ulps(got: torch.Tensor, want) -> int:
    """The largest distance in ulps of ``got`` from ``want`` (numpy, same
    type; f32 or bf16 read as f32), by their bits."""
    want_t = torch.tensor(np.asarray(want, np.float32)).to(got.dtype)
    it = torch.int32 if got.dtype == torch.float32 else torch.int16
    a, b = got.view(it).long(), want_t.view(it).long()
    assert bool(((a < 0) == (b < 0)).all())          # no sign flips
    return int((a - b).abs().max()) if a.numel() else 0


def _torch(tree):
    """A tree of numpy arrays (bf16 read through its bits) as tensors."""
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree_np(rs, dtype):
    return {"w": rs.randn(7, 33).astype(np.float32).astype(dtype),
            "blk": {"b": rs.randn(300).astype(np.float32).astype(dtype),
                    "g": (1 + 0.1 * rs.randn(5)).astype(np.float32)}}


def test_cosine_schedule_matches_reference():
    """The learning rate over warmup, the cosine and past its end, within
    1 ulp; on a step tensor it stays a tensor (no host read)."""
    steps = np.array([0, 1, 7, 100, 199, 200, 201, 4321, 9999, 10000,
                      12000], np.int32)
    want = np.asarray(jax_cosine_schedule(jnp.asarray(steps)))
    got = cosine_schedule(torch.tensor(steps))
    assert _ulps(got, want) <= 1
    got = cosine_schedule(torch.tensor(5), base_lr=1e-3, warmup=3,
                          total=50, min_frac=0.2)
    want = jax_cosine_schedule(jnp.int32(5), base_lr=1e-3, warmup=3,
                               total=50, min_frac=0.2)
    assert isinstance(got, torch.Tensor) and _ulps(got, want) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Four AdamW updates from step 197 (across the warmup's end) of a
    tree of params in ``dtype`` with f32 moments: params, ``m``, ``v``
    within 1 ulp of the reference's, ``step`` equal."""
    import ml_dtypes
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rs = np.random.RandomState(4)
    params = _tree_np(rs, np_dtype)
    opt = {"m": jax.tree.map(lambda a: (0.01 * rs.randn(*a.shape)).astype(
        np.float32), params),
        "v": jax.tree.map(lambda a: (1e-4 * rs.rand(*a.shape)).astype(
            np.float32), params), "step": np.int32(197)}
    jp, jo = jax.tree.map(jnp.asarray, (params, opt))
    tp = _torch(params)
    to = opt_state_from_reference(opt, device="cpu")
    for _ in range(4):
        g = _tree_np(rs, np_dtype)
        jp, jo = jax_adamw_update(jax.tree.map(jnp.asarray, g), jo, jp)
        tp, to = adamw_update(_torch(g), to, tp)
        for path, want in _leaves(_np_tree(jp)):
            assert _ulps(_get(tp, path), want) <= 1, path
        for part in ("m", "v"):
            for path, want in _leaves(_np_tree(jo[part])):
                assert _ulps(_get(to[part], path), want) <= 1, (part, path)
        assert int(to["step"]) == int(jo["step"])


def test_clip_by_global_norm_matches_reference():
    """The global norm rel 1e-6 and the clipped leaves rel 1e-6, for a
    norm above 1 (clipped) and below (left as it is)."""
    rs = np.random.RandomState(5)
    for scale in (10.0, 1e-3):
        g = jax.tree.map(lambda a: a * np.float32(scale),
                         _tree_np(rs, np.float32))
        jg, jn = jax_clip(jax.tree.map(jnp.asarray, g))
        tg, tn = clip_by_global_norm(jax.tree.map(torch.tensor, g))
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for path, want in _leaves(_np_tree(jg)):
            np.testing.assert_allclose(_get(tg, path).numpy(), want,
                                       rtol=1e-6, atol=0)


def test_int8_round_trip_matches_reference():
    """``compress_int8`` codes and scales, ``decompress_int8`` and
    ``compressed_grads`` (f32 and bf16 leaves, a size that needs padding)
    bit-equal to the reference's; the error at most half a block's
    scale."""
    import ml_dtypes
    rs = np.random.RandomState(6)
    x = (rs.randn(1000) * 5).astype(np.float32)
    x[300:556] = 0.0                              # an all-zero block
    q, s, shp = compress_int8(torch.tensor(x))
    jq, js, jshp = jax_compress_int8(jnp.asarray(x))
    assert torch.equal(q, torch.tensor(np.asarray(jq)))
    assert torch.equal(s, torch.tensor(np.asarray(js)))
    assert tuple(shp) == tuple(jshp)
    back = decompress_int8(q, s, shp)
    assert torch.equal(back, torch.tensor(np.asarray(
        jax_decompress_int8(jq, js, jshp))))
    err = (back - torch.tensor(x)).abs().reshape(-1)
    bound = torch.repeat_interleave(s[:, 0], 256)[:1000] / 2
    assert bool((err <= bound * (1 + 1e-6)).all())
    tree = {"a": rs.randn(17, 19).astype(np.float32),
            "b": rs.randn(513).astype(ml_dtypes.bfloat16)}
    want = _np_tree(jax_compressed_grads(jax.tree.map(jnp.asarray, tree)))
    got = compressed_grads(_torch(tree))
    for k in ("a", "b"):
        assert _ulps(got[k], want[k]) == 0, k


def test_sharded_batcher_replays_and_takes_reference_draws():
    """``batch_at(step)`` replays exactly, differs across steps and
    shards, has int32 tokens in [0, vocab) and labels rolled one place
    left; with ``draws=`` the reference's batcher's tokens come back with
    the reference's labels, for every shard; ``token_batches`` likewise."""
    b = ShardedBatcher(8, 32, 97, num_shards=2, shard_id=1, seed=7)
    one, again = b.batch_at(5), b.batch_at(5)
    assert one["tokens"].dtype == torch.int32
    assert tuple(one["tokens"].shape) == (4, 32)
    assert torch.equal(one["tokens"], again["tokens"])
    assert not torch.equal(one["tokens"], b.batch_at(6)["tokens"])
    other = ShardedBatcher(8, 32, 97, num_shards=2, shard_id=0, seed=7)
    assert not torch.equal(one["tokens"], other.batch_at(5)["tokens"])
    assert int(one["tokens"].min()) >= 0 and int(one["tokens"].max()) < 97
    assert torch.equal(one["labels"], torch.roll(one["tokens"], -1, 1))
    with pytest.raises(ValueError, match="not a multiple"):
        ShardedBatcher(7, 4, 9, num_shards=2).local_batch
    for shard in (0, 1):
        ref = JaxBatcher(8, 16, 50, num_shards=2, shard_id=shard, seed=3)
        port = ShardedBatcher(8, 16, 50, num_shards=2, shard_id=shard,
                              seed=3, draws=lambda s, sh: np.asarray(
                                  JaxBatcher(8, 16, 50, num_shards=2,
                                             shard_id=sh, seed=3).batch_at(
                                      s)["tokens"]))
        for step in (0, 3):
            want, got = ref.batch_at(step), port.batch_at(step)
            for k in ("tokens", "labels"):
                assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    want = [np.asarray(x["labels"]) for x in jax_token_batches(2, 8, 11, 3)]
    got = [x["labels"].numpy() for x in token_batches(
        2, 8, 11, 3, draws=lambda s, _: np.asarray(
            JaxBatcher(2, 8, 11).batch_at(s)["tokens"]))]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _scan_of(monkeypatch, apply, init, xs):
    """Run ``apply()`` with ``lax.scan`` made to scan the body it is
    given over ``init`` and ``xs`` (time leading) in place of its own
    arguments; returns that scan's (final carry, outputs)."""
    real = jax.lax.scan
    got = {}

    def spy(step, _init, _xs, *a, **kw):
        got["out"] = real(step, init, xs, *a, **kw)
        return got["out"]
    monkeypatch.setattr(jax.lax, "scan", spy)
    try:
        apply()
    finally:
        monkeypatch.setattr(jax.lax, "scan", real)
    return got["out"]


def _scan_grads_agree(names, ts, want):
    for name, t, w in zip(names, ts, want):
        w = np.asarray(w)
        err = np.abs(t.grad.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err)


def test_wkv6_plain_scan_gradients_match_reference_body(monkeypatch):
    """Autograd through ``ref.wkv6_scan_states_ref`` against ``jax.grad``
    of the reference's RWKV6 ``scan`` body (``rwkv6_apply``'s, run over
    these inputs, ``u`` its param) with random inputs, initial state and
    cotangents of the outputs and the final state: the gradients of r,
    k, v, w, u and the initial state."""
    from repro.models import ssm as jssm
    Bq, T, H, dh = 2, 23, 3, 8
    p = jssm.rwkv6_init(jax.random.PRNGKey(0), H * dh, H, dtype=jnp.float32)
    rs = np.random.RandomState(8)
    r, k, v = (rs.randn(Bq, T, H, dh).astype(np.float32) for _ in range(3))
    w = rs.uniform(0.5, 1.0, (Bq, T, H, dh)).astype(np.float32)
    u = rs.randn(H, dh).astype(np.float32)
    s0 = rs.randn(Bq, H, dh, dh).astype(np.float32)
    c_out = rs.randn(Bq, T, H, dh).astype(np.float32)
    c_s = rs.randn(Bq, H, dh, dh).astype(np.float32)

    def loss(r, k, v, w, u, s0):
        fs, outs = _scan_of(
            monkeypatch, lambda: jssm.rwkv6_apply(
                dict(p, u=u), jnp.zeros((Bq, T, H * dh)), n_heads=H), s0,
            tuple(jnp.moveaxis(a, 1, 0) for a in (r, k, v, w)))
        return jnp.sum(jnp.moveaxis(outs, 0, 1) * c_out) + jnp.sum(fs * c_s)
    want = jax.grad(loss, argnums=tuple(range(6)))(r, k, v, w, u, s0)
    ts = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u, s0)]
    out, final = kref.wkv6_scan_states_ref(*ts)
    (torch.sum(out * torch.tensor(c_out))
     + torch.sum(final * torch.tensor(c_s))).backward()
    _scan_grads_agree(("r", "k", "v", "w", "u", "s0"), ts, want)


def test_ssd_plain_scan_gradients_match_reference_body(monkeypatch):
    """Autograd through ``ref.ssd_scan_states_ref`` against ``jax.grad``
    of the reference's Mamba2 ``scan`` body (``mamba2_apply``'s, over
    these inputs) with its D skip added after, as the reference adds it:
    the gradients of x, B, C, decay, dt, D and the initial state."""
    from repro.models import ssm as jssm
    Bq, T, H, P, N = 2, 29, 3, 6, 5
    p = jssm.mamba2_init(jax.random.PRNGKey(0), 3 * P, H, N, 1,
                         dtype=jnp.float32)
    rs = np.random.RandomState(9)
    x = rs.randn(Bq, T, H, P).astype(np.float32)
    Bm, Cm = (rs.randn(Bq, T, N).astype(np.float32) for _ in range(2))
    decay = rs.uniform(0.3, 1.0, (Bq, T, H)).astype(np.float32)
    dt = rs.uniform(0.0, 1.5, (Bq, T, H)).astype(np.float32)
    D = rs.randn(H).astype(np.float32)
    s0 = rs.randn(Bq, H, P, N).astype(np.float32)
    c_y = rs.randn(Bq, T, H, P).astype(np.float32)
    c_s = rs.randn(Bq, H, P, N).astype(np.float32)

    def loss(x, Bm, Cm, decay, dt, D, s0):
        fs, ys = _scan_of(
            monkeypatch, lambda: jssm.mamba2_apply(
                p, jnp.zeros((Bq, T, 3 * P)), n_heads=H), s0,
            tuple(jnp.moveaxis(a, 1, 0) for a in (x, Bm, Cm, decay, dt)))
        y = jnp.moveaxis(ys, 0, 1) + D[None, None, :, None] * x
        return jnp.sum(y * c_y) + jnp.sum(fs * c_s)
    want = jax.grad(loss, argnums=tuple(range(7)))(x, Bm, Cm, decay, dt, D,
                                                   s0)
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, Bm, Cm, decay, dt, D, s0)]
    y, final = kref.ssd_scan_states_ref(*ts)
    (torch.sum(y * torch.tensor(c_y))
     + torch.sum(final * torch.tensor(c_s))).backward()
    _scan_grads_agree(("x", "Bm", "Cm", "decay", "dt", "D", "s0"), ts, want)


@functools.lru_cache(maxsize=None)
def _reference_steps(compress):
    """Three steps of the reference's ``make_train_step`` on qwen3-8b's
    smoke config (f32 params) over the reference's batcher."""
    from repro.data import ShardedBatcher as JaxBatcher
    from repro.launch.train import make_train_step as jax_make_train_step
    from repro.optim import adamw_init as jax_adamw_init
    cfg = jax_smoke_config("qwen3-8b")
    params = _to_f32(_jax_init(cfg))
    state = (params, jax_adamw_init(params))
    batcher = JaxBatcher(B, S, cfg.vocab, seed=0)
    step = compiled(jax_make_train_step(cfg, q_chunk=Q_CHUNK,
                                        compress=compress), state,
                    batcher.batch_at(0))
    start = (_np_tree(params), _np_tree(state[1]))
    tokens, metrics = [], []
    for s in range(3):
        b = batcher.batch_at(s)
        tokens.append(np.asarray(b["tokens"]))
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return start, tokens, metrics, _np_tree(state)


@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain", "compress"])
def test_three_train_steps_match_reference(compress):
    """Three ``make_train_step`` steps (autograd, optional int8
    compression, clipping, AdamW) from the reference's params and AdamW
    state, on the reference's token draws (``draws=``): the losses and
    gradient norms, then params, ``m``, ``v`` and ``step``."""
    (params_np, opt_np), tokens, metrics_ref, (p_ref, o_ref) = \
        _reference_steps(compress)
    cfg = get_smoke_config("qwen3-8b")
    state = (params_from_reference(params_np, cfg, device="cpu",
                                   unembed_table=False),
             opt_state_from_reference(opt_np, device="cpu"))
    batcher = train.batcher_for(cfg, B, S, draws=lambda s, _: tokens[s])
    step = train.make_train_step(cfg, q_chunk=Q_CHUNK, compress=compress)
    for s in range(3):
        state, m = step(state, batcher.batch_at(s))
        for k in ("loss", "grad_norm"):
            want = metrics_ref[s][k]
            assert abs(float(m[k]) - want) <= 1e-5 * abs(want), (s, k)
    params, opt = state
    assert int(opt["step"]) == int(o_ref["step"]) == 3
    rel_mv = 1 / 127 if compress else 1e-4
    for tree, want_tree, rel in ((params, p_ref, 1e-5),
                                 (opt["m"], o_ref["m"], rel_mv),
                                 (opt["v"], o_ref["v"], rel_mv)):
        for path, want in _leaves(want_tree):
            got = _get(tree, path).float().numpy()
            err = float(np.abs(got - want).max())
            assert err <= rel * float(np.abs(want).max()), (path, err)


def test_resumed_loop_ends_on_the_uninterrupted_params(tmp_path):
    """``FaultTolerantLoop`` over ``make_train_step``: 6 steps straight,
    against a run preempted at step 4 (checkpoints every 2 steps) and
    resumed from its newest checkpoint, on the CPU: the same params and
    optimizer state, bit for bit, and the same metrics on the replayed
    steps."""
    cfg = get_smoke_config("qwen3-8b")
    batcher = train.batcher_for(cfg, B, S, seed=3)

    def run(ckpt_dir, start, n, state=None, fail_at=None):
        state = state or train.init_state(cfg, seed=1, device="cpu")
        step = train.MetricsStep(train.make_train_step(cfg, q_chunk=Q_CHUNK))
        ckpt = AsyncCheckpointer(str(ckpt_dir))
        loop = FaultTolerantLoop(step, batcher, ckpt, ckpt_every=2,
                                 fail_at_step=fail_at)
        try:
            state, _ = loop.run(state, start, n)
        finally:
            ckpt.wait()
        return state, step.history
    want, hist = run(tmp_path / "a", 0, 6)
    with pytest.raises(RuntimeError, match="preemption at step 4"):
        run(tmp_path / "b", 0, 6, fail_at=4)
    last = latest_step(str(tmp_path / "b"))
    assert last == 4
    like = (param_shapes(cfg), init_opt_shapes(param_shapes(cfg)))
    state = restore_checkpoint(str(tmp_path / "b"), last, like,
                               device="cpu")
    got, hist_b = run(tmp_path / "b", last, 6 - last, state=state)
    assert hist_b == hist[last:]
    for (path, g), (_, w) in zip(_leaves({"p": got[0], "o": got[1]}),
                                 _leaves({"p": want[0], "o": want[1]})):
        assert g.dtype == w.dtype and torch.equal(g, w), path


