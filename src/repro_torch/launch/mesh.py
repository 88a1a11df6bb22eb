"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

One process per card: a :class:`Mesh` names the ranks of the initialised
process group that hold the data's row shards, in shard order, with a
``"data"`` axis, an optional leading ``"pod"`` axis and an optional
trailing ``"model"`` (tensor-parallel) axis, which an executable mesh
carries only of size 1: tensor-parallel execution is ROADMAP §1 item 16,
and a larger ``"model"`` axis raises rather than run as data parallel.
:func:`make_production_mesh` and :func:`make_debug_mesh` give the
reference's LM meshes as :class:`MeshShape` stand-ins (shape and axis
names, no ranks), which is all the spec functions of
``launch.sharding`` and the dry run read. Each data axis has its
subgroup (the ranks of this rank's pod along ``"data"``, the ranks with
this rank's data index along ``"pod"``). Centers and the k_n-NN graph are
replicated; what the shards computed is combined by :meth:`Mesh.sum`, the
counterpart of the reference's ``for ax in reversed(axes): psum(., ax)``.

:meth:`Mesh.sum` adds the shards' partials in shard order (within the
pod first, then across pods) from an ``all_gather``, never through
``all_reduce``, whose order is the collective library's choice. The
result is then the same on every rank, in every run, on gloo and on
NCCL, and on the card and the CPU alike: f32 additions in one fixed order
give one result. The gather carries every partial's bits, so a ``-0.0``
partial stays ``-0.0`` (an ``all_reduce`` over zero-filled slots would
turn it into ``+0.0``).

The LM's placement adds :meth:`Mesh.max` (exact in any order),
:meth:`Mesh.reduce_scatter` (each shard's block of the shards' sum, the
blocks exchanged by one ``all_to_all`` and added in shard order, never
through the library's ``reduce_scatter``, whose order is its own) and
:meth:`Mesh.gather_blocks` (the shards' blocks joined along an axis).
Each counts the bytes this rank hands to the collective
(``gathered_bytes``, ``scattered_bytes``; ``sent_bytes`` both).

gloo runs its collectives on host tensors: a CUDA payload is staged
through the host and its result taken back on the card. Payloads travel
as bytes, so every type goes through either backend.

Every collective is bounded in time. :func:`init_process_group` starts
the process group with a timeout, and each mesh carries it to the
subgroups it makes (its axes', a failover's survivors'), so a deadlocked
collective fails instead of hanging.

:func:`run_local` is the counterpart of ``make_debug_cluster_mesh``: it
runs a function on P ranks of one host (one spawned process each, a
``FileStore`` in a temporary directory, every rank on
``cuda:<rank % device_count>`` unless the caller asks for the CPU) and
returns each rank's result. The TPU v5e constants of the reference
module are not carried over.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve

DATA_AXES = ("pod", "data")
TP_AXIS = "model"
AXES = DATA_AXES + (TP_AXIS,)
# the bound on every collective of the process group this process started
# (init_process_group), carried by every mesh to the subgroups it makes
_TIMEOUT: datetime.timedelta | None = None


class Mesh:
    """The ranks holding the row shards, in shard order (sorted global
    ranks), their process group and each axis's subgroup. ``shape`` maps
    each axis, major to minor, to its size; ``index`` is this rank's
    shard index (None when this rank is not in the mesh); ``device`` is
    where this rank's shard lives; ``timeout`` bounds every collective of
    the groups the mesh makes."""

    def __init__(self, shape: dict, ranks, group, device, subgroups=None, *,
                 timeout: datetime.timedelta):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.ranks = tuple(ranks)
        if list(self.ranks) != sorted(self.ranks) \
                or math.prod(self.shape.values()) != len(self.ranks):
            raise ValueError(f"mesh {self.shape} over ranks {self.ranks}: "
                             "needs sorted ranks, one per shard")
        self.group = group
        self.device = torch.device(device)
        self.timeout = timeout
        self.subgroups = dict(subgroups or {a: group
                                            for a in self.axis_names})
        me = dist.get_rank()
        self.index = self.ranks.index(me) if me in self.ranks else None
        # this rank's share of the traffic: collectives run, bytes it
        # handed to them (a gather's buffer, a reduce-scatter's input)
        self.gathers = 0
        self.gathered_bytes = 0
        self.scatters = 0
        self.scattered_bytes = 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def sent_bytes(self) -> int:
        return self.gathered_bytes + self.scattered_bytes

    def coords(self) -> dict:
        """This rank's index along each axis (row-major over ``shape``)."""
        out, rest = {}, self.index
        for a in reversed(self.axis_names):
            out[a] = rest % self.shape[a]
            rest //= self.shape[a]
        return out

    def _gather(self, buf: torch.Tensor, group, n: int) -> torch.Tensor:
        """(n, *buf.shape): every rank's ``buf`` in group-rank order."""
        if n == 1:
            return buf[None]
        self.gathers += 1
        self.gathered_bytes += buf.numel() * buf.element_size()
        stage = buf.is_cuda and dist.get_backend(group) == "gloo"
        src = (buf.cpu() if stage else buf).contiguous().reshape(-1)
        out = torch.empty((n * src.numel(),), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        out = out.reshape(n, *buf.shape)
        return out.to(buf.device) if stage else out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(P, *t.shape): every shard's ``t``, in shard order."""
        return self._gather(t, self.group, self.size)

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The shards' ``t`` elementwise largest (one gather): the same
        in any order, so the same on every rank."""
        return torch.amax(self.gather(t), dim=0)

    def gather_blocks(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The shards' blocks ``t`` joined along ``dim`` in shard order
        (every shard's ``t`` must have the same shape)."""
        g = self.gather(t).movedim(0, dim)
        shape = list(t.shape)
        shape[dim] *= self.size
        return g.reshape(shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's block of the shards' ``t`` summed: ``t`` is split
        along ``dim`` into ``size`` equal blocks in shard order, shard r
        receives block r of every shard's ``t`` through one
        ``all_to_all`` and adds them in shard order, in ``t``'s type. The
        result is contiguous, the same bits on every backend and in every
        run."""
        n = self.size
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)}"
                             f" does not split over {n} shards")
        moved = t.movedim(dim, 0)
        blocks = moved.reshape(n, -1)
        self.scatters += 1
        self.scattered_bytes += blocks.numel() * blocks.element_size()
        stage = blocks.is_cuda and dist.get_backend(self.group) == "gloo"
        raw = (blocks.cpu() if stage else blocks).contiguous().view(
            torch.uint8).reshape(-1)
        out = torch.empty_like(raw)
        dist.all_to_all_single(out, raw, group=self.group)
        got = out.view(blocks.dtype).reshape(blocks.shape)
        got = got.to(blocks.device) if stage else got
        acc = got[0]
        for j in range(1, n):
            acc = acc + got[j]
        shape = (moved.shape[0] // n,) + tuple(moved.shape[1:])
        return acc.reshape(shape).movedim(0, dim).contiguous()

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The shards' row blocks concatenated in shard order (every
        shard's ``t`` must have the same shape)."""
        return self.gather_blocks(t, 0)

    def sum(self, *ts: torch.Tensor, axes=None):
        """Every shard's partials summed in shard order over ``axes``
        (default: the data axes), innermost axis first; one gather per
        axis carries all of ``ts`` as bytes. Returns the summed tensor,
        or a tuple of them for several inputs. Every rank of the mesh
        gets the same bits."""
        axes = tuple(axes) if axes is not None else dp_axes(self)
        flat = [t.reshape(-1) for t in ts]
        for ax in reversed(axes):
            n = self.shape[ax]
            if n == 1:
                continue
            raw = [f.contiguous().view(torch.uint8) for f in flat]
            g = self._gather(torch.cat(raw), self.subgroups[ax], n)
            out, at = [], 0
            for f, r in zip(flat, raw):
                parts = g[:, at:at + r.numel()].contiguous().view(f.dtype)
                at += r.numel()
                acc = parts[0]
                for j in range(1, n):
                    acc = acc + parts[j]
                out.append(acc)
            flat = out
        res = tuple(f.reshape(t.shape) for f, t in zip(flat, ts))
        return res[0] if len(res) == 1 else res

    def broadcast_object(self, obj, src: int | None = None):
        """Global rank ``src``'s ``obj`` (default: the mesh's first
        rank's), on every rank of the mesh."""
        box = [obj]
        dist.broadcast_object_list(
            box, src=self.ranks[0] if src is None else src,
            group=self.group,
            device=self.device if self.device.type == "cuda" else None)
        return box[0]

    def submesh(self, ranks) -> "Mesh":
        """A 1-D ``"data"`` mesh over ``ranks`` (a subset of this mesh's),
        its group bounded by this mesh's timeout: every rank of the
        process group must call it, members or not (``dist.new_group``),
        and this mesh must span the whole group."""
        if self.size != dist.get_world_size():
            raise ValueError("a submesh needs a mesh over every rank of "
                             "the process group")
        ranks = sorted(ranks)
        group = dist.new_group(ranks, timeout=self.timeout)
        return Mesh({"data": len(ranks)}, ranks, group, self.device,
                    timeout=self.timeout)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks}, on {self.device})"


def init_process_group(backend: str, *, timeout: float, **kw) -> None:
    """``dist.init_process_group(backend, **kw)`` with every collective
    bounded by ``timeout`` seconds; the meshes made over the group carry
    the same bound to their subgroups."""
    global _TIMEOUT
    _TIMEOUT = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, timeout=_TIMEOUT, **kw)


class MeshShape:
    """A stand-in mesh: the shape and axis names of a mesh that no process
    group backs (the reference's production meshes), all that the spec
    functions and the dry run read. ``shape`` maps each axis, major to
    minor, to its size."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh as a stand-in: 16 x 16 ("data",
    "model"), or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def make_debug_mesh(data: int = 2, model: int = 2) -> MeshShape:
    """The reference's debug mesh (data, model) as a stand-in."""
    return MeshShape({"data": data, "model": model})


def _check_axes(shape: tuple, axis_names: tuple) -> None:
    """Axes among ("pod", "data", "model"), each once, in that order;
    ``"model"`` of size 1 (raises NotImplementedError for a larger one)."""
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(
            axis_names) or any(a not in AXES for a in axis_names) \
            or list(axis_names) != sorted(axis_names, key=AXES.index):
        raise ValueError(f"mesh axes {axis_names} of shape {shape}: "
                         f"expected axes among {AXES}, in that order")
    size = dict(zip(axis_names, shape))
    if size.get(TP_AXIS, 1) != 1:
        raise NotImplementedError(
            f"mesh {size}: a {TP_AXIS!r} axis of size {size[TP_AXIS]}: "
            f"tensor-parallel execution is ROADMAP §1 item 16; an "
            f"executable mesh carries a {TP_AXIS!r} axis of size 1 (the "
            f"spec functions and the dry run take any on a MeshShape)")


def make_mesh(shape=None, axis_names=("data",), *, device=None) -> Mesh:
    """A mesh over every rank of the process group that
    :func:`init_process_group` started (the counterpart of
    ``jax.make_mesh``): ``shape`` defaults to one ``"data"`` axis over
    the world; with ``("pod", "data")`` axes each data axis gets its
    subgroup (every rank must call this, as ``dist.new_group``
    demands); a trailing ``"model"`` axis must have size 1 (tensor
    parallel execution, ROADMAP §1 item 16, raises NotImplementedError).
    ``device``: this rank's device, by default its card,
    ``cuda:<rank % device_count>`` (raises without one, on either
    backend)."""
    axis_names = tuple(axis_names)
    if shape is not None:
        _check_axes(tuple(shape), axis_names)
    if _TIMEOUT is None or not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group started by "
                           "launch.mesh.init_process_group (its timeout "
                           "bounds every collective of the mesh)")
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,)
    _check_axes(shape, axis_names)
    if device is None:
        resolve(None)                   # raises without a card
        device = f"cuda:{dist.get_rank() % torch.cuda.device_count()}"
    ranks = list(range(world))
    group = dist.group.WORLD
    sub = {a: group for a in axis_names}
    size = dict(zip(axis_names, shape))
    if "pod" in size and "data" in size:
        pods, per = size["pod"], size["data"]
        sub["data"], _ = dist.new_subgroups_by_enumeration(
            [ranks[p * per:(p + 1) * per] for p in range(pods)],
            timeout=_TIMEOUT)
        sub["pod"], _ = dist.new_subgroups_by_enumeration(
            [ranks[j::per] for j in range(per)], timeout=_TIMEOUT)
    return Mesh(dict(zip(axis_names, shape)), ranks, group, device, sub,
                timeout=_TIMEOUT)


def dp_axes(mesh: Mesh) -> tuple:
    """The data-parallel axes of a mesh ('pod' included when present)."""
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def dp_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


def make_debug_cluster_mesh(device=None) -> Mesh:
    """1-D ``"data"`` mesh over every rank of the process group (each on
    its card unless ``device`` says otherwise)."""
    return make_mesh(device=device)


def _rank_main(fn, rank, world, store_path, backend, device, timeout,
               results, args):
    """One rank of :func:`run_local`: join the group, run ``fn(mesh,
    *args)``, post (rank, ok, result or traceback)."""
    try:
        dev = resolve(device)           # raises without a card
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            # P ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        init_process_group(backend, timeout=timeout,
                           store=dist.FileStore(store_path, world),
                           rank=rank, world_size=world)
        try:
            out = fn(make_debug_cluster_mesh(dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:    # the boundary of a rank: report, never hang
        results.put((rank, False, traceback.format_exc()))


def run_local(fn, nprocs: int, *args, backend: str = "gloo",
              device=None, timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks of this host, one
    spawned process each, and return the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    result picklable. ``device``: None or ``"cuda"`` puts rank r on
    ``cuda:<r % device_count>`` (and raises without a card), ``"cuda:i"``
    every rank on card i, ``"cpu"`` every rank on the host; the kernels
    are built before ranks on a card start. Every collective and the
    whole run are bounded by ``timeout`` seconds: a rank that fails or a
    run that outlasts it stops every rank and raises."""
    if resolve(device).type == "cuda":
        from ..kernels import _build
        _build.build_all()
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, nprocs, os.path.join(tmp, "store"),
                                   backend, device, timeout, results, args))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        out, done = [None] * nprocs, set()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_local: {nprocs} ranks did not "
                                       f"finish within {timeout} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_local: rank {dead[0]} "
                                           f"exited with code "
                                           f"{procs[dead[0]].exitcode}")
                    continue
                if not ok:
                    raise RuntimeError(f"run_local: rank {rank} failed:\n"
                                       f"{val}")
                out[rank] = val
                done.add(rank)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
        return out


def parse_mesh(text: str) -> tuple[tuple, tuple]:
    """``"data=4"`` or ``"pod=2,data=2"`` -> (shape, axis_names), the
    launchers' ``--mesh`` flag."""
    axes = [kv.split("=") for kv in text.split(",") if kv]
    if not axes or any(len(kv) != 2 for kv in axes):
        raise ValueError(f"--mesh {text!r}: expected axis=size[,...]")
    return (tuple(int(n) for _, n in axes), tuple(a for a, _ in axes))


def mesh_from_env(text: str, *, device=None, timeout: float = 600.0) -> Mesh:
    """The mesh of a ``torch.distributed.run`` launch (its ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``): NCCL with each
    rank on its card, gloo on the CPU (``device="cpu"``)."""
    shape, names = parse_mesh(text)
    dev = resolve(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    init_process_group("nccl" if dev.type == "cuda" else "gloo",
                       timeout=timeout)
    return make_mesh(shape, names, device=dev)


__all__ = ["AXES", "DATA_AXES", "Mesh", "MeshShape", "TP_AXIS", "dp_axes",
           "dp_size", "init_process_group", "make_debug_cluster_mesh",
           "make_debug_mesh", "make_mesh", "make_production_mesh",
           "mesh_from_env", "parse_mesh", "run_local"]
