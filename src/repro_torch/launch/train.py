"""End-to-end training entry point (port of ``repro.launch.train``).

CPU-scale demo:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --smoke --steps 20 --device cpu
On a card (the default device) the same step runs any config; ``chip
_smoke.py`` trains Qwen3-8B at full width cut to 4 layers. The step is
the reference's: the loss and its gradients (``torch.autograd`` through
``models.model.forward_train``), optionally int8-compressed
(``optim.compressed_grads``), clipped to global norm 1, then one AdamW
update. It makes no host read; the loop (:class:`MetricsStep`) reads the
step's loss and gradient norm once a step, as one copy. The loop is
``ft.FaultTolerantLoop``: deterministic replay from the step index,
async checkpoints of (params, optimizer state), a straggler policy and
simulated preemption (``--fail-at``); ``--resume`` restarts from the
newest complete checkpoint.

The batches come from ``data.ShardedBatcher`` (CPU generator per step);
an audio config's frames and a VLM's patches are drawn per step from a
generator seeded by (99, step), as the reference draws them from
``fold_in(PRNGKey(99), step)`` (other numbers, the same shapes).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs.base import get_config, get_smoke_config
from ..data import ShardedBatcher, generator_at
from ..device import resolve
from ..ft import FaultTolerantLoop, StragglerPolicy
from ..models.model import forward_train, init_params
from ..optim import (adamw_init, adamw_update, clip_by_global_norm,
                     compressed_grads, tree_leaves, tree_map)


def init_state(cfg, *, seed: int = 0, device=None):
    """(params, AdamW state) for training: random params from a generator
    seeded with ``seed`` on ``device`` (the card by default), without the
    serving copy ``embed_f32``."""
    dev = resolve(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev, unembed_table=False)
    return params, adamw_init(params)


def batcher_for(cfg, batch: int, seq: int, *, seed: int = 0, draws=None):
    """The reference's training batcher: ``ShardedBatcher`` tokens, plus
    ``frames`` (batch, seq, d) on an audio config and ``patches`` (batch,
    n_patches, d) on a VLM one, standard normal f32 drawn per step."""
    b = ShardedBatcher(batch, seq, cfg.vocab, seed=seed, draws=draws)
    if cfg.family != "audio" and not cfg.n_patches:
        return b
    base = b.batch_at

    def batch_at(step):
        out = dict(base(step))
        gen = generator_at(99, step)
        if cfg.family == "audio":
            out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=gen)
        if cfg.n_patches:
            out["patches"] = torch.randn((batch, cfg.n_patches,
                                          cfg.d_model), generator=gen)
        return out
    b.batch_at = batch_at
    return b


def make_train_step(cfg, *, remat: str = "dots", q_chunk: int = 512,
                    compress: bool = False):
    """``step((params, opt), batch) -> ((params, opt), {"loss",
    "grad_norm"})``, the metrics 0-d tensors on the params' device. The
    batch's tensors move to that device; nothing is read back."""
    def step(state, batch):
        params, opt = state
        dev = params["embed"].device
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        tracked = tree_map(lambda t: t.detach().requires_grad_(), params)
        live = list(tree_leaves(tracked))
        total, metrics = forward_train(cfg, tracked, batch, remat=remat,
                                       q_chunk=q_chunk)
        got = dict(zip(map(id, live), torch.autograd.grad(
            total, live, allow_unused=True)))
        del total, live
        # a leaf the loss does not reach gets a zero gradient, as jax.grad
        grads = tree_map(lambda t: torch.zeros_like(t) if got[id(t)] is None
                         else got[id(t)], tracked)
        del got, tracked
        if compress:
            grads = compressed_grads(grads)
        grads, gn = clip_by_global_norm(grads)
        with torch.no_grad():
            params, opt = adamw_update(grads, opt, params)
        return (params, opt), {"loss": metrics["loss"].detach(),
                               "grad_norm": gn}
    return step


class MetricsStep:
    """A train step for ``FaultTolerantLoop``: runs ``step`` and reads its
    loss and gradient norm to the host once, as one copy. ``last`` holds
    the last step's floats and ``history`` every step's (step index from
    the batch order)."""

    def __init__(self, step):
        self.step = step
        self.last: dict = {}
        self.history: list[dict] = []

    def __call__(self, state, batch):
        state, metrics = self.step(state, batch)
        loss, gn = torch.stack([metrics["loss"].float(),
                                metrics["grad_norm"].float()]).tolist()
        self.last = {"loss": loss, "grad_norm": gn}
        self.history.append(self.last)
        return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join("build", "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression before the update")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="simulate preemption at this step (FT demo)")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    state = init_state(cfg, device=dev)
    batcher = batcher_for(cfg, args.batch, args.seq)

    start = 0
    if args.resume:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(args.ckpt_dir, last, state,
                                       device=dev)
            start = last
            print(f"restored checkpoint at step {last}")

    step = MetricsStep(make_train_step(cfg, remat=args.remat, q_chunk=64,
                                       compress=args.compress))
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    loop = FaultTolerantLoop(step, batcher, ckpt, ckpt_every=args.ckpt_every,
                             policy=StragglerPolicy(),
                             fail_at_step=args.fail_at)
    t0 = time.time()
    box = [state]       # the loop holds the state's only reference, so
    del state           # each step frees the one before
    try:
        state, end = loop.run(box.pop(), start, args.steps - start)
    finally:
        ckpt.wait()
    dt = time.time() - t0
    m = step.last
    print(f"trained steps [{start}, {args.steps}) in {dt:.1f}s  "
          f"final loss={m.get('loss', float('nan')):.4f} "
          f"grad_norm={m.get('grad_norm', float('nan')):.3f} "
          f"ft_events={loop.events}")


if __name__ == "__main__":
    main()
