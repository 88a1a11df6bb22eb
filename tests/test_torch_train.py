"""LM training in the port (``repro_torch.models.model.forward_train``,
``repro_torch.launch.train``) against the JAX reference, on the CPU.

Params come from the reference's ``init_params(cfg, PRNGKey(0))`` at each
arch's smoke config, cast to f32 (the gradients' point is the algorithm,
not bf16 rounding), and are carried across with
``convert.params_from_reference``; tokens, frames and patches are drawn
with numpy and handed to both. B x S = 2 x 16 with ``q_chunk`` 8 (two
query chunks).

The audio config: the reference casts the frames to bf16 and its
encoder's ``lax.scan`` carry must keep that type, so its
``forward_train`` fails to trace with f32 encoder weights (ROADMAP §3
entry 27). Its gradients are held against ``jax.value_and_grad`` of the
reference's own layers composed as its ``forward_train`` composes them
(``_jax_audio_loss``: the frames cast to bf16, the first encoder layer
outside the scan, whose carry is f32 from then on, as the port's loop
carries it), in f32; its ``forward_train`` with the encoder in bf16 is
held in the loss.

Tolerances, and why:
- the loss: rel 1e-5 (f32 sums in other orders through the layers); the
  audio ``forward_train`` with its bf16 encoder, rel 1e-3 (measured
  3e-5: the two frameworks round bf16 at other places);
- every gradient leaf: within 1e-4 of that leaf's largest magnitude in
  the reference (the same sums, then the backward's, in other orders);
- the remat policies: bit-equal (the same ops on the same inputs).

The train steps, the resumed loop and the optimizer are in
``test_torch_optim.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models.model import forward_train as jax_forward_train
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import train
from repro_torch.models.model import forward_train, param_shapes
from repro_torch.models.transformer import REMAT_POLICIES
from repro_torch.optim import adamw_init, init_opt_shapes

B, S, Q_CHUNK = 2, 16, 8
LOSS_REL_BF16 = 1e-3    # the audio forward_train's bf16 encoder


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _to_f32(params):
    return jax.tree.map(lambda a: a.astype(jnp.float32), params)


def _jax_audio_loss(cfg, params, batch):
    """The reference's audio ``forward_train`` with f32 params: its
    layers, composed as it composes them, with the first encoder layer
    taking the bf16 frames outside the scan."""
    from repro.models import transformer as jtf
    from repro.models.layers import rmsnorm, softmax_xent
    from repro.models.model import embed_tokens, unembed
    layer = lambda tree, i: jax.tree.map(lambda a: a[i], tree)  # noqa
    h = jtf.encoder_layer_fwd(cfg, layer(params["enc"], 0),
                              batch["frames"].astype(jnp.bfloat16),
                              q_chunk=Q_CHUNK)
    rest = jax.tree.map(lambda a: a[1:], params["enc"])
    h, _ = jax.lax.scan(lambda h, p: (jtf.encoder_layer_fwd(
        cfg, p, h, q_chunk=Q_CHUNK), None), h, rest)
    enc_out = rmsnorm(params["enc_norm"], h)
    h = embed_tokens(cfg, params, batch["tokens"])
    h, _ = jax.lax.scan(lambda h, p: (jtf.cross_layer_fwd(
        cfg, p, h, enc_out, q_chunk=Q_CHUNK), None), h, params["stack"])
    logits = unembed(cfg, params, rmsnorm(params["out_norm"], h))
    loss = softmax_xent(logits, batch["labels"])
    return loss, {"loss": loss, "aux": jnp.float32(0.0)}


def _batch_np(cfg, seed=0):
    rs = np.random.RandomState(seed)
    tok = rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    if cfg.family == "audio":
        b["frames"] = rs.randn(B, S, cfg.d_model).astype(np.float32)
    if cfg.n_patches:
        b["patches"] = rs.randn(B, cfg.n_patches,
                                cfg.d_model).astype(np.float32)
    return b


def compiled(fn, *args):
    """``jax.jit(fn)`` for ``args``, compiled at XLA's backend
    optimization level 0: the same computation, compiled in about half
    the time (its f32 results may differ from the default level's in the
    last bits, far inside every tolerance here)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_init(cfg):
    """The reference's ``init_params(cfg, PRNGKey(0))``, jitted (the same
    draws; eager, an MoE config's init takes seconds)."""
    return jax.jit(lambda k: jax_init_params(cfg, k))(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's f32 params, batch, loss, metrics and gradients
    (numpy), computed once per arch."""
    cfg = jax_smoke_config(arch)
    params = _to_f32(_jax_init(cfg))
    batch = _batch_np(cfg)
    loss_fn = functools.partial(_jax_audio_loss, cfg) \
        if cfg.family == "audio" else (lambda p, b: jax_forward_train(
            cfg, p, b, q_chunk=Q_CHUNK))
    batch_j = jax.tree.map(jnp.asarray, batch)
    fn = compiled(jax.value_and_grad(loss_fn, has_aux=True), params, batch_j)
    (loss, metrics), grads = fn(params, batch_j)
    return (_np_tree(params), batch, float(loss), _np_tree(metrics),
            _np_tree(grads))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _port_loss_grads(arch, remat="dots", params_np=None):
    cfg = get_smoke_config(arch)
    ref_params, batch_np, *_ = _reference(arch)
    params = params_from_reference(
        ref_params if params_np is None else params_np, cfg, device="cpu",
        unembed_table=False)
    paths, leaves = zip(*_leaves(params))
    for t in leaves:
        t.requires_grad_()
    batch = {k: torch.tensor(v) for k, v in batch_np.items()}
    total, metrics = forward_train(cfg, params, batch, remat=remat,
                                   q_chunk=Q_CHUNK)
    grads = torch.autograd.grad(total, leaves)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(paths, grads)))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_loss_and_grads_match_reference(arch):
    """``forward_train``'s loss, aux and the gradient of every param leaf
    against ``jax.value_and_grad`` of the reference's, per arch: the
    dense, MoE (Arctic's dense residual; DeepSeek's MLA, shared experts
    and dense prefix), SSM, hybrid (Zamba2's shared block), VLM (patches)
    and audio (encoder, cross attention) families."""
    _, _, loss_ref, metrics_ref, grads_ref = _reference(arch)
    total, metrics, grads = _port_loss_grads(arch)
    for got, want in ((total, loss_ref), (metrics["loss"],
                                          metrics_ref["loss"])):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert abs(float(metrics["aux"]) - float(metrics_ref["aux"])) \
        <= 1e-5 * abs(float(metrics_ref["aux"]))
    ref_paths = [p for p, _ in _leaves(grads_ref)]
    assert sorted(ref_paths) == sorted(grads)
    for path in ref_paths:
        want = np.asarray(_get(grads_ref, path), np.float32)
        got = grads[path].float().numpy()
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (path, err)
    if get_smoke_config(arch).family == "audio":
        jcfg = jax_smoke_config(arch)
        params = _to_f32(_jax_init(jcfg))
        params["enc"] = _jax_init(jcfg)["enc"]          # bf16
        batch = _batch_np(jcfg)
        want, _ = compiled(lambda p, b: jax_forward_train(
            jcfg, p, b, q_chunk=Q_CHUNK), params, batch)(params, batch)
        got, _, _ = _port_loss_grads(arch, params_np=_np_tree(params))
        assert abs(float(got) - float(want)) <= LOSS_REL_BF16 * float(want)


@functools.lru_cache(maxsize=None)
def _no_remat(arch):
    return _port_loss_grads(arch, "none")


@pytest.mark.parametrize("remat", sorted(REMAT_POLICIES))
def test_remat_policies_give_the_same_numbers(remat):
    """Each remat policy gives the loss and every gradient of "none", bit
    for bit, on a dense, an MoE and a hybrid config."""
    for arch in ("qwen3-8b", "arctic-480b", "zamba2-7b"):
        total0, _, grads0 = _no_remat(arch)
        total, _, grads = _port_loss_grads(arch, remat)
        assert torch.equal(total, total0), arch
        for path, g in grads.items():
            assert torch.equal(g, grads0[path]), (arch, path)


def test_param_shapes_are_the_references():
    """``param_shapes`` (meta tensors) and ``init_opt_shapes`` against
    the reference's ``param_shapes`` for every arch: the same paths,
    shapes and types, no storage."""
    from repro.models import param_shapes as jax_param_shapes
    for arch in ARCH_IDS:
        want = dict(_leaves(jax_param_shapes(jax_smoke_config(arch))))
        got = dict(_leaves(param_shapes(get_smoke_config(arch))))
        assert sorted(got) == sorted(want), arch
        for path, t in got.items():
            assert t.is_meta and tuple(t.shape) == want[path].shape, path
            assert str(t.dtype).split(".")[-1] == str(want[path].dtype)
        opt = init_opt_shapes(param_shapes(get_smoke_config(arch)))
        assert all(t.is_meta and t.dtype == torch.float32
                   for _, t in _leaves(opt["m"]))
        assert opt["step"].dtype == torch.int32


def test_train_cli_and_card_default():
    """``main()`` trains a smoke config on the CPU when asked; without a
    card the entry points raise rather than fall back."""
    import io
    import contextlib
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "8",
                        "--ckpt-dir", d])
        assert "trained steps [0, 2)" in out.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.init_state(get_smoke_config("qwen3-8b"))
    state = adamw_init({"w": torch.zeros(3)})
    assert int(state["step"]) == 0
