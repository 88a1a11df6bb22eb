"""Fault-tolerance runtime (port of ``repro.ft.runtime``): heartbeats,
straggler mitigation, elastic remesh planning, the transient-retry
envelope, mid-fit checkpoints, and a restart-safe step loop.

On a multi-host deployment the heartbeat transport is the cluster
orchestrator's liveness check and ``torch.distributed``'s store; here the
mechanism is host-local but the *policy* layer — what to do when a step
is slow or a host vanishes — is the production logic and is what the
tests exercise.
"""
from __future__ import annotations

import dataclasses
import math
import os
import statistics
import time
from typing import Callable

import numpy as np
import torch

from .chaos import TransientError


def _host(t, dtype) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t, dtype)


@dataclasses.dataclass
class StragglerPolicy:
    """Detect slow steps (stragglers) from the step-time stream.

    slack: a step slower than slack * rolling-median is flagged.
    window: median window.  patience: consecutive flags before escalation
    (production: trigger checkpoint + cordon the slow host; here: callback).
    """
    slack: float = 2.0
    window: int = 20
    patience: int = 3

    def __post_init__(self):
        self.times: list[float] = []
        self.flags = 0
        self.escalations = 0

    def observe(self, step_time: float) -> str:
        self.times.append(step_time)
        hist = self.times[-self.window:]
        if len(hist) < 5:
            return "ok"
        med = statistics.median(hist[:-1])
        if step_time > self.slack * med:
            self.flags += 1
            if self.flags >= self.patience:
                self.flags = 0
                self.escalations += 1
                return "escalate"
            return "straggler"
        self.flags = 0
        return "ok"


class HeartbeatMonitor:
    """Per-host liveness from step-completion timestamps. A host missing
    for timeout seconds is declared dead -> the loop checkpoints and the
    remesh planner computes the survivor topology."""

    def __init__(self, hosts: list[str], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last = {h: self.clock() for h in hosts}

    def beat(self, host: str):
        self.last[host] = self.clock()

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]


def plan_remesh(n_alive_chips: int, *, model_parallel: int = 16):
    """Elastic remesh: largest (data, model) grid that fits the survivors.

    Keeps the TP degree fixed (weights are sharded that way) and shrinks
    the data axis to the largest power of two that fits — the batch is
    re-sharded, the global batch size is preserved by raising the
    per-host accumulation factor."""
    if n_alive_chips < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{n_alive_chips} chips: checkpoint and relaunch smaller")
    data = n_alive_chips // model_parallel
    data = 2 ** int(math.log2(data))
    return {"data": data, "model": model_parallel,
            "chips": data * model_parallel,
            "accum_factor_vs": lambda old_data: max(1, old_data // data)}


def retry_transient(fn: Callable, *, retries: int = 3,
                    base_delay: float = 0.05, counter=None):
    """Call ``fn()``; absorb :class:`ft.chaos.TransientError` with
    exponential backoff (base_delay * 2^attempt between tries). Every
    absorbed failure lands on ``counter.retries`` so recovery is never
    silent; the last failure propagates when the budget runs out.
    Non-transient exceptions propagate immediately."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except TransientError:
            if attempt >= retries:
                raise
            if counter is not None:
                counter.count_retry()
            time.sleep(base_delay * (2 ** attempt))


class FitCheckpointer:
    """Periodic atomic checkpoints of the *minimal* fit state, on
    ``checkpoint.save_checkpoint``, in the reference's format (each
    package resumes from the other's).

    The payload is mesh-independent on purpose — centers (k, d), the
    point-order unpadded assignment (n,), and the completed iteration —
    so a checkpoint taken single-device restores onto any mesh (and vice
    versa). On the rebuild engines the Hamerly bound state rides along
    (point-order ``u``/``lo`` plus the replicated center-graph ``nb``):
    restoring it resumes the *gated* trajectory bit-for-bit. Without it
    (resident arenas, legacy) bounds are rebuilt as the stale-zero safe
    loose state with ``first=True`` — still exact per-row, but the full
    recompute may take kn-restricted moves the gated run never evaluated,
    so the resumed trajectory is equivalent-quality rather than
    bit-identical (DESIGN.md §11.3).
    """

    def __init__(self, ckpt_dir: str, *, every: int = 0, keep: int = 3,
                 extra: dict | None = None):
        self.ckpt_dir = ckpt_dir
        self.every = int(every)
        self.keep = keep
        self.extra = dict(extra or {})
        self.saved: list[int] = []

    def due(self, it: int) -> bool:
        return self.every > 0 and it > 0 and it % self.every == 0

    def save(self, it: int, c, a, u=None, lo=None, nb=None) -> str:
        """Atomic write of {c, a} (+ optional bound state {u, lo, nb})
        at iteration ``it`` (rides ``checkpoint.save_checkpoint``: temp
        dir + fsync + rename)."""
        import shutil
        from ..checkpoint import save_checkpoint
        payload = {"c": _host(c, np.float32), "a": _host(a, np.int32)}
        fit_meta = dict(self.extra, it=it)
        if u is not None:
            payload["u"] = _host(u, np.float32)
            payload["lo"] = _host(lo, np.float32)
            payload["nb"] = _host(nb, np.int32)
            fit_meta["kn_nb"] = int(payload["nb"].shape[1])
        path = save_checkpoint(self.ckpt_dir, it, payload,
                               extra_meta={"fit": fit_meta})
        self.saved.append(it)
        for s in self.saved[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step-{s:09d}"),
                          ignore_errors=True)
        self.saved = self.saved[-self.keep:] if self.keep else self.saved
        return path

    def latest(self, n: int, k: int, d: int):
        """Newest complete checkpoint as ``(it, c, a, bounds)`` numpy
        arrays — ``bounds`` is a ``{u, lo, nb}`` dict when the
        checkpoint carried the Hamerly state, else None — or None when
        the directory holds no restorable checkpoint (truncated ones are
        skipped by ``checkpoint.latest_step``)."""
        from ..checkpoint import latest_step, load_meta, restore_checkpoint
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        fit_meta = load_meta(self.ckpt_dir, step).get("extra", {}) \
            .get("fit", {})
        like = {"c": np.zeros((k, d), np.float32),
                "a": np.zeros((n,), np.int32)}
        kn_nb = fit_meta.get("kn_nb")
        if kn_nb:
            like["u"] = np.zeros((n,), np.float32)
            like["lo"] = np.zeros((n,), np.float32)
            like["nb"] = np.zeros((k, kn_nb), np.int32)
        tree = restore_checkpoint(self.ckpt_dir, step, like, device="cpu")
        bounds = None
        if kn_nb:
            bounds = {"u": _host(tree["u"], np.float32),
                      "lo": _host(tree["lo"], np.float32),
                      "nb": _host(tree["nb"], np.int32)}
        return (step, _host(tree["c"], np.float32),
                _host(tree["a"], np.int32), bounds)


class FaultTolerantLoop:
    """Restart-safe step loop: deterministic data replay from the step
    index (any batcher with ``batch_at(step)``), periodic async
    checkpoints, straggler monitoring, and simulated preemption for tests
    (fail_at_step). A step's time is taken after the device has finished
    it (a synchronize when the state's first tensor lies on a card)."""

    def __init__(self, step_fn, batcher, checkpointer, *,
                 ckpt_every: int = 50, policy: StragglerPolicy | None = None,
                 fail_at_step: int | None = None):
        self.step_fn = step_fn
        self.batcher = batcher
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.policy = policy or StragglerPolicy()
        self.fail_at_step = fail_at_step
        self.events: list[tuple[int, str]] = []

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        for step in range(start_step, start_step + num_steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"simulated preemption at step {step}")
            t0 = time.perf_counter()
            batch = self.batcher.batch_at(step)
            state = self.step_fn(state, batch)
            _block_until_ready(state)
            verdict = self.policy.observe(time.perf_counter() - t0)
            if verdict != "ok":
                self.events.append((step, verdict))
            if (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, state)
        return state, step + 1


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _block_until_ready(state) -> None:
    t = _first_tensor(state)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
