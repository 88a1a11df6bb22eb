#!/usr/bin/env python3
"""Qwen3-8B over the cards of one host: the sharded k²-attention decode
and ZeRO-1 training, one NCCL rank a card.

Run from the root of the repository:

    python3 -m torch.distributed.run --nproc_per_node 4 \
        scripts/probe_lm_mesh.py

Every rank works on ``cuda:<local rank>`` over a ``"data"`` mesh of the
world, with random weights from seed 0 and ``ShardedBatcher`` tokens:

(c) Qwen3-8B at full width cut to ``--cut-layers`` (4) layers, where one
    card holds it: rank 0 alone first trains ``--steps`` steps on the
    ranks' batches (1 x ``--cut-seq`` tokens each) concatenated in shard
    order, then every rank trains the same steps under ZeRO-1; the losses
    side by side, ms a step;
(b) Qwen3-8B whole (36 layers) trained under ZeRO-1 at 1 x
    ``--train-seq`` tokens a rank (4096; on running out of memory, once
    more at half the tokens, and the line says so), ``--steps`` steps:
    ms a step (host clock ended by a synchronize, steps 1..), tokens/s,
    each card's peak memory, the bytes each rank sends a step against
    ``dryrun.zero_step_bytes``;
(a) Qwen3-8B whole decoded at B = 1 x ``--prompt`` (65,536) tokens with
    the clusters of the config's kc 2048 sharded over the cards
    (``serve.run(mesh=)``: prefill, ``--decode`` full tokens, the
    clustering, as many clustered tokens, no folds); then the clustered
    decode again teacher-forced over its tokens: ms a token, each card's
    peak memory, and the merge's share of a step (its gather and sums
    timed alone, a layer a token, at the step's shapes).

Neither whole model fits one card. Rank 0 prints the cards (``nvidia-smi``
name and power limit), one line a measurement, and last one JSON object,
also written to ``chiprun_out/probe_lm_mesh.json``.

Rehearse on the CPU with gloo at the smoke config:

    torchrun --nproc_per_node 4 scripts/probe_lm_mesh.py --device cpu \
        --smoke --prompt 40 --decode 4 --train-seq 16 --cut-seq 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(torch, dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _all(torch, mesh, value: float) -> list:
    """Every rank's ``value``, in shard order (one gather)."""
    return mesh.gather(torch.tensor([float(value)], dtype=torch.float64,
                                    device=mesh.device))[:, 0].tolist()


def _zero_steps(torch, cfg, mesh, seq: int, steps: int) -> dict:
    """``steps`` ZeRO-1 steps at 1 x ``seq`` tokens a rank: losses, ms a
    step, bytes sent a step, this rank's peak memory."""
    from repro_torch.launch import train
    dev = mesh.device
    _reset_peak(torch, dev)
    state = train.init_state(cfg, seed=0, device=dev, mesh=mesh)
    batcher = train.batcher_for(cfg, mesh.size, seq, mesh=mesh)
    step = train.MetricsStep(train.make_train_step(cfg, remat="dots",
                                                   mesh=mesh))
    times, sent = [], []
    for s in range(steps):
        b0 = mesh.sent_bytes
        _sync(torch, dev)
        t0 = time.perf_counter()
        state = step(state, batcher.batch_at(s))    # reads loss and norm
        times.append(time.perf_counter() - t0)
        sent.append(mesh.sent_bytes - b0)
    del state
    return {"losses": [h["loss"] for h in step.history], "times": times,
            "sent": sent, "peak": _peak(torch, dev)}


def _one_card_steps(torch, cfg, P: int, seq: int, steps: int, dev) -> list:
    """One card's losses over the P shards' batches concatenated."""
    from repro_torch.data import ShardedBatcher
    from repro_torch.launch import train
    state = train.init_state(cfg, seed=0, device=dev)
    shards = [ShardedBatcher(P, seq, cfg.vocab, num_shards=P, shard_id=s)
              for s in range(P)]
    step = train.make_train_step(cfg, remat="dots")
    losses = []
    for s in range(steps):
        parts = [b.batch_at(s) for b in shards]
        state, m = step(state, {k: torch.cat([p[k] for p in parts])
                                for k in parts[0]})
        losses.append(float(m["loss"]))
    del state
    return losses


def _decode(torch, cfg, mesh, prompt: int, n: int, say) -> dict:
    """(a): ``serve.run(mesh=)`` at B = 1, then the clustered decode
    teacher-forced over its tokens, and the merge alone."""
    from repro_torch.launch import serve
    from repro_torch.models.attention import _merge_shards
    from repro_torch.models.model import serve_step
    dev = mesh.device
    _reset_peak(torch, dev)
    r = serve.run(cfg, batch=1, prompt_len=prompt, decode_len=n, device=dev,
                  mesh=mesh, echo=say)
    params, cache = r["params"], r["cache"]
    toks = [r["prompt"][:, -1:]] + [torch.as_tensor(t, device=dev)[:, None]
                                     for t in r["clus_toks"][:-1]]
    out = {k: r[k] for k in ("t_init", "t_prefill", "t_attach", "t_full",
                             "t_clus", "agreement", "dropped")}
    out["launches"] = r["launches"]["cluster_attend"]
    del r
    st = cache["stack"]
    for f in ("ring_k", "ring_v", "ring_fill"):
        st[f].zero_()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for i, t in enumerate(toks):
        logits, cache = serve_step(cfg, params, cache, t, prompt + i,
                                   mesh=mesh)
        torch.argmax(logits, -1).cpu()              # the step's host read
    out["ms_token"] = (time.perf_counter() - t0) / len(toks) * 1e3
    BH, dh = cfg.n_heads, cfg.d_head
    m = torch.randn((BH,), device=dev)
    l, acc = torch.rand((BH,), device=dev), torch.randn((BH, dh), device=dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(len(toks) * cfg.n_layers):
        _merge_shards(mesh, m, l, acc)
    _sync(torch, dev)
    out["ms_merge_token"] = (time.perf_counter() - t0) / len(toks) * 1e3
    out["peak"] = _peak(torch, dev)
    del params, cache
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (a CPU rehearsal)")
    ap.add_argument("--prompt", type=int, default=65536)
    ap.add_argument("--decode", type=int, default=32)
    ap.add_argument("--train-seq", type=int, default=4096)
    ap.add_argument("--cut-layers", type=int, default=4)
    ap.add_argument("--cut-seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "probe_lm_mesh.json"))
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.launch.dryrun import decode_merge_bytes, zero_step_bytes
    from repro_torch.launch.mesh import mesh_from_env

    mesh = mesh_from_env(f"data={os.environ.get('WORLD_SIZE', '1')}",
                         device=args.device, timeout=300)
    dev, P, lead = mesh.device, mesh.size, mesh.index == 0
    say = print if lead else (lambda *a: None)
    full = (get_smoke_config if args.smoke else get_config)("qwen3-8b")
    out = {"cards": P, "device": str(dev)}
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        out["smi"] = smi.stdout.strip().splitlines()
        say("\n".join(out["smi"]))
    try:
        # (c) the cut model: four cards against one
        cut = dataclasses.replace(full, n_layers=args.cut_layers)
        one = None
        if lead:
            _reset_peak(torch, dev)
            one = _one_card_steps(torch, cut, P, args.cut_seq, args.steps,
                                  dev)
            out["c_one_peak"] = _peak(torch, dev)
        mesh.max(torch.zeros((1,), device=dev))     # the others wait
        c = _zero_steps(torch, cut, mesh, args.cut_seq, args.steps)
        rel = [abs(a - b) / abs(b) for a, b in zip(c["losses"], one or [])]
        out["c"] = dict(c, one_losses=one, rel=rel,
                        peaks=_all(torch, mesh, c["peak"]))
        say(f"(c) {cut.name} cut to {cut.n_layers} layers, {P} x 1 x "
            f"{args.cut_seq} tokens: ZeRO-1 losses {c['losses']}, one card "
            f"on the concatenated batch {one} (rel {rel}); ms a step "
            f"{[round(t * 1e3, 1) for t in c['times']]}; peaks "
            f"{[round(p / 2 ** 30, 2) for p in out['c']['peaks']]} GiB (one "
            f"card {out.get('c_one_peak', 0) / 2 ** 30:.2f})")

        # (b) the whole model trained under ZeRO-1
        seq, b = args.train_seq, None
        for attempt in range(2):
            try:
                b = _zero_steps(torch, full, mesh, seq, args.steps)
                failed = 0.0
            except torch.OutOfMemoryError:
                failed = 1.0
            if max(_all(torch, mesh, failed)) == 0.0:
                break
            b = None
            say(f"(b) out of memory at 1 x {seq} tokens a rank")
            out["b_oom_at"] = seq
            seq //= 2
        if b is not None:
            steady = b["times"][1:] or b["times"]
            ms = sum(steady) / len(steady) * 1e3
            want = zero_step_bytes(full, P)
            out["b"] = dict(b, seq=seq, ms_step=ms,
                            tokens_s=P * seq / ms * 1e3, dryrun_bytes=want,
                            peaks=_all(torch, mesh, b["peak"]))
            say(f"(b) {full.name} whole ({full.n_layers} layers) under "
                f"ZeRO-1, {P} x 1 x {seq} tokens: {ms:.1f} ms a step over "
                f"steps 1.. ({[round(t * 1e3, 1) for t in b['times']]}), "
                f"{out['b']['tokens_s']:.0f} tokens/s, losses {b['losses']};"
                f" bytes a rank a step {b['sent']} (the dry run's {want}); "
                f"peaks {[round(p / 2 ** 30, 2) for p in out['b']['peaks']]}"
                f" GiB")
        _reset_peak(torch, dev)

        # (a) the whole model decoded with the clusters sharded
        try:
            a = _decode(torch, full, mesh, args.prompt, args.decode, say)
            failed = 0.0
        except torch.OutOfMemoryError:
            failed = 1.0
        if max(_all(torch, mesh, failed)) > 0.0:
            say(f"(a) out of memory at B = 1 x {args.prompt} tokens")
            out["a_oom"] = True
            a = None
        else:
            a["peaks"] = _all(torch, mesh, a["peak"])
    finally:
        dist.destroy_process_group()
    if a is not None:
        merge = decode_merge_bytes(full, 1, P)
        out["a"] = dict(a, merge_bytes=merge,
                        merge_share=a["ms_merge_token"] / a["ms_token"])
        say(f"(a) {full.name} whole, B = 1 x {args.prompt} tokens, kc "
            f"{full.kv_clusters} over {P} cards: prefill "
            f"{a['t_prefill']:.2f} s, attach {a['t_attach']:.2f} s, "
            f"{args.decode} tokens full {a['t_full']:.2f} s, clustered "
            f"{a['t_clus']:.2f} s through the executor; teacher-forced "
            f"{a['ms_token']:.2f} ms a token, the merge alone "
            f"{a['ms_merge_token']:.2f} ms a token "
            f"({out['a']['merge_share']:.1%}), {merge} bytes a rank a token;"
            f" K6 launches {a['launches']}; peaks "
            f"{[round(p / 2 ** 30, 2) for p in out['a']['peaks']]} GiB")
    if lead:
        print(json.dumps(out))
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
