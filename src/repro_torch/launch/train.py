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

Under a mesh (``make_train_step(mesh=)``, ``--mesh data=4`` under
``torch.distributed.run``: one rank a card, NCCL) the step is
data-parallel with ZeRO-1, the placement the reference's dry run gives
its train step: the batch by ``launch.sharding.batch_specs`` (each rank
draws its shard, ``ShardedBatcher(num_shards=P, shard_id=mesh.index)``),
the params replicated, ``m`` and ``v`` by ``opt_specs``. Each rank's
gradients (int8-compressed first with ``compress``, as the reference's
"compression before reduction") are reduced in shard order to the block
that ``opt_specs`` gives the rank, along the dimension it shards over
the data axes (``Mesh.reduce_scatter``), or summed whole (``Mesh.sum``)
for a leaf the spec keeps whole, and divided by P. The global norm adds
each leaf's blocks' sums of squares in shard order, then the leaves in
the trees' key order; the loss is the shard-order mean of the ranks'.
AdamW updates the rank's blocks of the params, ``m`` and ``v``, and the
updated param blocks are gathered back whole (``Mesh.gather_blocks``).
The step still reads nothing to the host. Checkpoints under a mesh hold
each rank's state (the params whole, its ``m`` and ``v`` blocks) in a
directory of its own with the mesh's shape, and resume onto the same
mesh; restoring onto another mesh is ROADMAP §1 item 16.

The batches come from ``data.ShardedBatcher`` (CPU generator per step);
an audio config's frames and a VLM's patches are drawn per step from a
generator seeded by (99, step), as the reference draws them from
``fold_in(PRNGKey(99), step)`` (other numbers, the same shapes).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..configs.base import get_config, get_smoke_config
from ..data import ShardedBatcher, generator_at
from ..device import resolve
from ..ft import FaultTolerantLoop, StragglerPolicy
from ..kernels.ref import sqrt_rn
from ..models.model import forward_train, init_params, param_shapes
from ..optim import (adamw_init, adamw_update, clip_by_global_norm,
                     compressed_grads, tree_leaves, tree_map)
from .mesh import mesh_from_env
from .sharding import local_shape, opt_specs, to_placements


def zero_placements(cfg, mesh):
    """The params' tree of :class:`launch.sharding.Sharded` placements of
    ``m`` and ``v`` under ``opt_specs`` (ZeRO-1) over ``mesh``."""
    return to_placements(opt_specs(cfg, param_shapes(cfg), mesh)["m"], mesh)


def init_state(cfg, *, seed: int = 0, device=None, mesh=None):
    """(params, AdamW state) for training: random params from a generator
    seeded with ``seed`` on ``device`` (the card by default; the mesh's
    device under ``mesh``), without the serving copy ``embed_f32``.
    Under ``mesh`` every rank holds the params whole and its blocks of
    ``m`` and ``v`` (:func:`zero_placements`)."""
    dev = resolve(device) if mesh is None else mesh.device
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev, unembed_table=False)
    if mesh is None:
        return params, adamw_init(params)
    return params, tree_map(lambda t: torch.zeros(
        t.shape, dtype=t.dtype, device=dev), state_shapes(cfg, mesh)[1])


def state_shapes(cfg, mesh=None):
    """(params, AdamW state) of meta tensors, a checkpoint restore's like
    tree: this rank's blocks of ``m`` and ``v`` under ``mesh``."""
    ps = param_shapes(cfg)
    if mesh is None:
        return ps, adamw_init(ps)
    blocks = tree_map(lambda pl, t: torch.empty(
        local_shape(t.shape, pl.spec, mesh), device="meta"),
        zero_placements(cfg, mesh), ps)
    return ps, adamw_init(blocks)


def batcher_for(cfg, batch: int, seq: int, *, seed: int = 0, draws=None,
                mesh=None):
    """The reference's training batcher: ``ShardedBatcher`` tokens, plus
    ``frames`` (batch, seq, d) on an audio config and ``patches`` (batch,
    n_patches, d) on a VLM one, standard normal f32 drawn per step.
    ``batch`` is the global batch; under ``mesh`` each rank draws its
    shard (``batch_specs``: the batch axis over the data axes), the
    frames and patches as the rows of the global draw."""
    P = mesh.size if mesh is not None else 1
    shard = mesh.index if mesh is not None else 0
    b = ShardedBatcher(batch, seq, cfg.vocab, num_shards=P, shard_id=shard,
                       seed=seed, draws=draws)
    if cfg.family != "audio" and not cfg.n_patches:
        return b
    base = b.batch_at
    rows = slice(shard * b.local_batch, (shard + 1) * b.local_batch)

    def batch_at(step):
        out = dict(base(step))
        gen = generator_at(99, step)
        if cfg.family == "audio":
            out["frames"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=gen)[rows]
        if cfg.n_patches:
            out["patches"] = torch.randn((batch, cfg.n_patches,
                                          cfg.d_model), generator=gen)[rows]
        return out
    b.batch_at = batch_at
    return b


def loss_and_grads(cfg, params, batch, *, remat: str = "dots",
                   q_chunk: int = 512):
    """(``forward_train``'s metrics, the gradient tree) of ``batch`` on
    the params' device; a leaf the loss does not reach gets a zero
    gradient."""
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
    return metrics, grads


def _rebuild(tree, values):
    """``tree``'s structure with its leaves, in ``tree_leaves`` order,
    replaced by ``values``."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def _zero_reduce(grads, places, mesh):
    """Each leaf's gradient summed over the shards in shard order and
    divided by P: this rank's block of it where ``places`` splits the
    leaf (a reduce-scatter), else whole (one ``Mesh.sum`` for all such
    leaves). Takes the gradients' only reference (``grads`` is emptied)
    and frees each whole gradient once reduced."""
    n = mesh.size
    flat_g, flat_p = list(tree_leaves(grads)), list(tree_leaves(places))
    grads.clear()
    whole = [i for i, pl in enumerate(flat_p) if pl.split_dim() is None]
    out = [None] * len(flat_g)
    for i, pl in enumerate(flat_p):
        if i not in whole:
            out[i] = mesh.reduce_scatter(flat_g[i], pl.split_dim()) / n
            flat_g[i] = None
    if whole:
        sums = mesh.sum(*(flat_g[i] for i in whole))
        for i, s in zip(whole, sums if len(whole) > 1 else (sums,)):
            out[i] = s / n
    return _rebuild(places, out)


def _zero_norm_and_loss(blocks, places, loss, mesh):
    """(the global gradient norm, the shard-order mean loss) from one
    gather of each leaf's block sum of squares and the rank's loss: each
    split leaf's blocks added in shard order, a whole leaf's taken once,
    then the leaves added in the trees' key order."""
    flat_b, flat_p = list(tree_leaves(blocks)), list(tree_leaves(places))
    vec = torch.stack([torch.sum(torch.square(b.float())) for b in flat_b]
                      + [loss.float()])
    g = mesh.gather(vec)
    acc = g[0]
    for j in range(1, g.shape[0]):
        acc = acc + g[j]
    total = None
    for i, pl in enumerate(flat_p):
        sq = acc[i] if pl.split_dim() is not None else g[0, i]
        total = sq if total is None else total + sq
    return sqrt_rn(total), acc[-1] / g.shape[0]


def make_train_step(cfg, *, remat: str = "dots", q_chunk: int = 512,
                    compress: bool = False, mesh=None):
    """``step((params, opt), batch) -> ((params, opt), {"loss",
    "grad_norm"})``, the metrics 0-d tensors on the params' device. The
    batch's tensors move to that device; nothing is read back. Under
    ``mesh`` the step is data-parallel ZeRO-1 (the module's docstring):
    ``batch`` is this rank's shard and ``opt`` holds its blocks of ``m``
    and ``v`` (:func:`init_state`); every rank returns the same params
    and metrics."""
    places = zero_placements(cfg, mesh) if mesh is not None else None

    def step(state, batch):
        params, opt = state
        metrics, grads = loss_and_grads(cfg, params, batch, remat=remat,
                                        q_chunk=q_chunk)
        if compress:
            grads = compressed_grads(grads)
        if mesh is None:
            grads, gn = clip_by_global_norm(grads)
            with torch.no_grad():
                params, opt = adamw_update(grads, opt, params)
            return (params, opt), {"loss": metrics["loss"].detach(),
                                   "grad_norm": gn}
        with torch.no_grad():
            blocks = _zero_reduce(grads, places, mesh)
            del grads
            gn, loss = _zero_norm_and_loss(blocks, places,
                                           metrics["loss"].detach(), mesh)
            scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
            blocks = tree_map(lambda g: g * scale.to(g.dtype), blocks)
            mine = tree_map(lambda pl, p: pl.place(p), places, params)
            mine, opt = adamw_update(blocks, opt, mine)
            del blocks
            params = tree_map(lambda pl, p: pl.gather(p), places, mine)
        return (params, opt), {"loss": loss, "grad_norm": gn}
    return step


def shard_ckpt_dir(ckpt_dir: str, mesh) -> str:
    """This rank's checkpoint directory under ``mesh`` (its placement in
    ``placement.json`` beside the steps); ``ckpt_dir`` off a mesh.
    Raises when the directory was written under another mesh (restoring
    onto another mesh is ROADMAP §1 item 16)."""
    if mesh is None:
        return ckpt_dir
    path = os.path.join(ckpt_dir, f"shard-{mesh.index}-of-{mesh.size}")
    meta = {"mesh": mesh.shape, "index": mesh.index}
    where = os.path.join(path, "placement.json")
    if os.path.exists(where):
        with open(where) as f:
            old = json.load(f)
        if old != meta:
            raise ValueError(f"{path} was written under {old}, not {meta}: "
                             f"restoring onto another mesh is ROADMAP §1 "
                             f"item 16")
    else:
        os.makedirs(path, exist_ok=True)
        with open(where, "w") as f:
            json.dump(meta, f)
    return path


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
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=4: ZeRO-1 data parallel under "
                         "torch.distributed.run, one rank a card (NCCL; "
                         "gloo with --device cpu); --batch is the global "
                         "batch")
    args = ap.parse_args(argv)

    mesh = mesh_from_env(args.mesh, device=args.device) if args.mesh \
        else None
    try:
        _train(args, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _train(args, mesh) -> None:
    dev = resolve(args.device) if mesh is None else mesh.device
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    state = init_state(cfg, device=dev, mesh=mesh)
    batcher = batcher_for(cfg, args.batch, args.seq, mesh=mesh)
    ckpt_dir = shard_ckpt_dir(args.ckpt_dir, mesh)

    start = 0
    if args.resume:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last, state, device=dev)
            start = last
            if mesh is None or mesh.index == 0:
                print(f"restored checkpoint at step {last}")

    step = MetricsStep(make_train_step(cfg, remat=args.remat, q_chunk=64,
                                       compress=args.compress, mesh=mesh))
    ckpt = AsyncCheckpointer(ckpt_dir)
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
    if mesh is None or mesh.index == 0:
        print(f"trained steps [{start}, {args.steps}) in {dt:.1f}s  "
              f"final loss={m.get('loss', float('nan')):.4f} "
              f"grad_norm={m.get('grad_norm', float('nan')):.3f} "
              f"ft_events={loop.events}"
              + (f"  mesh {mesh.shape}, this rank sent "
                 f"{mesh.sent_bytes} bytes" if mesh is not None else ""))


if __name__ == "__main__":
    main()
