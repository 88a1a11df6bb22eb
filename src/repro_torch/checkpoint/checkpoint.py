"""Checkpoint/restart over numpy ``.npz`` (port of
``repro.checkpoint.checkpoint``, with no JAX).

- atomic: arrays and meta are written (and fsync'd) into
  ``<dir>/tmp-<step>``, the directory is renamed into place and the
  parent directory fsync'd, so a writer crashing at any point never
  corrupts the latest complete checkpoint;
- validated: :func:`latest_step` skips truncated or partly written
  checkpoints with a warning naming the defect, and
  :func:`restore_checkpoint` raises :class:`CheckpointCorruptError`
  naming it;
- async: :class:`AsyncCheckpointer` copies the tensors to the host and
  writes them on a worker thread.

Both packages write one format: a tree is flattened as
``jax.tree_util.tree_flatten`` flattens it (NamedTuple fields in
declaration order, dict keys sorted, list and tuple items in order,
``None`` contributing no leaf) and leaf i is stored as ``leaf_i``, so
either package restores the other's checkpoints. A leaf is a tensor, a
numpy array or a Python scalar; bf16 leaves are stored as f32 (npz has
no bf16) and restored to the like-tree's type. A restore places every
leaf on the device the caller names, the card by default
(``device.resolve``).

:func:`reshard_restore` is the elastic restore onto a mesh
(``launch.mesh``): each leaf comes back as this rank's block of rows or
whole, as its placement (``launch.sharding.Rows`` / ``Replicated``)
says, in place of the reference's ``NamedSharding``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import warnings

import numpy as np
import torch

from ..device import resolve


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists but cannot be restored (truncated
    arrays, unparseable meta, missing files); the message names why."""


def _flatten(tree):
    """``(leaves, treedef)``: the leaves in ``jax.tree_util`` order and a
    nested description of the containers to rebuild them with."""
    leaves = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return ("namedtuple", type(t), [walk(v) for v in t])
        if isinstance(t, (list, tuple)):
            return ("seq", type(t), [walk(v) for v in t])
        leaves.append(t)
        return ("leaf",)
    return leaves, walk(tree)


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        kids = [build(c) for c in node[-1]]
        if kind == "dict":
            return dict(zip(node[1], kids))
        if kind == "namedtuple":
            return node[1](*kids)
        return node[1](kids)
    return build(treedef)


def _describe(node) -> str:
    """A readable form of a treedef for meta.json (informational only)."""
    kind = node[0]
    if kind in ("none", "leaf"):
        return "None" if kind == "none" else "*"
    kids = [_describe(c) for c in node[-1]]
    if kind == "dict":
        return "{" + ", ".join(f"'{k}': {v}" for k, v in zip(node[1], kids)) \
            + "}"
    return f"{node[1].__name__}(" + ", ".join(kids) + ")"


def _to_numpy(x) -> np.ndarray:
    """A leaf as a host array; bf16 leaves as f32 (npz has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    a = np.asarray(x)
    if str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
    return a


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:                       # platforms without dir-open
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step-{step:09d}")


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra_meta: dict | None = None) -> str:
    """Atomic checkpoint write: temp dir + fsync'd files + ``os.rename``
    + parent-dir fsync. ``extra_meta`` (JSON-serializable) rides along in
    meta.json, e.g. the static config a restorer needs to rebuild the
    like-tree (:func:`load_meta`). Returns the step's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _flatten(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    arrays_path = os.path.join(tmp, "arrays.npz")
    np.savez(arrays_path, **arrays)
    _fsync_file(arrays_path)
    meta = {"step": step, "n_leaves": len(leaves),
            "treedef": _describe(treedef)}
    if extra_meta is not None:
        meta["extra"] = extra_meta
    meta_path = os.path.join(tmp, "meta.json")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(ckpt_dir)
    return final


def _meta_reason(path: str) -> str | None:
    """Why the step directory ``path`` or its meta.json cannot be used,
    or None."""
    if not os.path.isdir(path):
        return "missing checkpoint directory"
    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return "missing meta.json"
    except (json.JSONDecodeError, OSError) as e:
        return f"unreadable meta.json ({e})"
    if not isinstance(meta.get("n_leaves"), int):
        return "meta.json missing n_leaves"
    return None


def verify_checkpoint(ckpt_dir: str, step: int) -> str | None:
    """None when the checkpoint at ``step`` is complete, else a readable
    reason (missing, truncated, unparseable). Reads every array."""
    path = _step_dir(ckpt_dir, step)
    reason = _meta_reason(path)
    if reason is not None:
        return reason
    with open(os.path.join(path, "meta.json")) as f:
        n_leaves = json.load(f)["n_leaves"]
    try:
        with np.load(os.path.join(path, "arrays.npz")) as data:
            names = set(data.files)
            missing = [i for i in range(n_leaves)
                       if f"leaf_{i}" not in names]
            if missing:
                return f"arrays.npz missing leaves {missing[:4]}"
            for i in range(n_leaves):
                data[f"leaf_{i}"]          # forces the zip member read
    except FileNotFoundError:
        return "missing arrays.npz"
    except Exception as e:                 # zipfile/np errors: truncation
        return f"truncated or corrupt arrays.npz ({e})"
    return None


def load_meta(ckpt_dir: str, step: int) -> dict:
    """A checkpoint's meta.json (including any ``extra_meta``)."""
    path = os.path.join(_step_dir(ckpt_dir, step), "meta.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint step {step} in {ckpt_dir}: unreadable meta.json "
            f"({e})") from e


def all_steps(ckpt_dir: str) -> list[int]:
    """Every step directory present (complete or not), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("-")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step-"))


def latest_step(ckpt_dir: str) -> int | None:
    """Newest complete checkpoint step (None when there is none).
    Truncated or partly written ones are skipped with a warning naming
    the reason."""
    best = None
    for step in all_steps(ckpt_dir):
        reason = verify_checkpoint(ckpt_dir, step)
        if reason is None:
            best = step
        else:
            warnings.warn(f"skipping checkpoint step {step} in {ckpt_dir}: "
                          f"{reason}", stacklevel=2)
    return best


def _dtype_of(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    a = np.asarray(leaf)
    return torch.from_numpy(np.zeros((), a.dtype)).dtype


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, *, device=None):
    """Restore into the structure of ``like_tree``, each leaf a tensor of
    its like-leaf's shape and type on ``device`` (default ``cuda``; the
    like-leaves may sit on the ``meta`` device, since only their shapes
    and types are read). Raises :class:`CheckpointCorruptError` naming
    the defect on a truncated or partly written checkpoint. Reads each
    array once (the reference reads them all to verify, then again)."""
    dev = resolve(device)
    where = f"checkpoint step {step} in {ckpt_dir}"
    path = _step_dir(ckpt_dir, step)
    reason = _meta_reason(path)
    if reason is not None:
        raise CheckpointCorruptError(f"{where}: {reason}")
    leaves, treedef = _flatten(like_tree)
    restored = []
    try:        # one pass: each leaf is checked as it is read
        with np.load(os.path.join(path, "arrays.npz")) as data:
            names = set(data.files)
            for i, want in enumerate(leaves):
                if f"leaf_{i}" not in names:
                    raise CheckpointCorruptError(
                        f"{where}: leaf_{i} absent (saved tree had fewer "
                        f"leaves than like_tree)")
                got = data[f"leaf_{i}"]
                shape = tuple(np.shape(want))
                if got.shape != shape:
                    raise CheckpointCorruptError(
                        f"{where}: leaf_{i} shape {got.shape} != expected "
                        f"{shape}")
                restored.append(torch.from_numpy(got).to(
                    device=dev, dtype=_dtype_of(want)))
    except CheckpointCorruptError:
        raise
    except FileNotFoundError as e:
        raise CheckpointCorruptError(f"{where}: missing arrays.npz") from e
    except Exception as e:                 # zipfile/np errors: truncation
        raise CheckpointCorruptError(
            f"{where}: truncated or corrupt arrays.npz ({e})") from e
    return _unflatten(treedef, restored)


def reshard_restore(ckpt_dir: str, step: int, like_tree, shardings):
    """Elastic restore onto a mesh: ``like_tree`` holds the global shapes
    and types (as saved, whatever mesh saved them), ``shardings`` the same
    tree with a placement per leaf (``launch.sharding.Rows(mesh)``: this
    rank's block of the leaf's rows; ``Replicated(mesh)``: the whole
    leaf), each on the mesh's device."""
    host = restore_checkpoint(ckpt_dir, step, like_tree, device="cpu")
    leaves, treedef = _flatten(host)
    places, _ = _flatten(shardings)
    if len(places) != len(leaves):
        raise ValueError(f"{len(places)} placements for {len(leaves)} "
                         "leaves")
    return _unflatten(treedef, [p.place(t) for t, p in zip(leaves, places)])


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a worker thread, keeping the
    newest ``keep`` steps."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err = None
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree = item
            try:
                save_checkpoint(self.ckpt_dir, step, tree)
                self._gc()
            except Exception as e:              # surfaced on next save/wait
                self._err = e

    def _gc(self):
        for s in all_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(_step_dir(self.ckpt_dir, s), ignore_errors=True)

    def save(self, step: int, tree):
        """Copy ``tree``'s leaves to the host now; write them later."""
        if self._err:
            raise self._err
        leaves, treedef = _flatten(tree)
        self._q.put((step, _unflatten(treedef,
                                      [_to_numpy(x) for x in leaves])))

    def wait(self):
        """Drain the queue and stop the worker; raises any deferred error."""
        self._q.put(None)
        self._t.join()
        if self._err:
            raise self._err
