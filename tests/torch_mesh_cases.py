"""Rank programs of the port's mesh tests (``test_torch_mesh*.py``,
``test_torch_cuda.py``): each runs on every rank of a
``launch.mesh.run_local`` world, imports only the port, and returns
numpy arrays and plain values."""
import os

import numpy as np
import torch

from repro_torch.checkpoint import reshard_restore, save_checkpoint
from repro_torch.core import OpCounter, fit, init_state
from repro_torch.core.distributed import (fit_distributed_k2means,
                                          make_distributed_lloyd_step)
from repro_torch.core.engine import K2Step
from repro_torch.ft import FaultInjector, Preemption, StragglerPolicy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import Replicated, Rows, pad_rows, shard_rows

K, KN = 16, 6


def _np(t):
    return t.detach().cpu().numpy()


def _fit_out(r, cnt=None):
    out = {"a": _np(r.assignment), "c": _np(r.centers), "energy": r.energy,
           "iterations": r.iterations, "history": r.history}
    if cnt is not None:
        out["profile"] = cnt.profile()
    return out


def steps(mesh, x, init, a0, *, residency, iters, **kw):
    """The sharded engine step from (init, a0), iteration by iteration:
    the gathered assignment, the centers and the summed statistics."""
    dev = mesh.device
    xp, w = pad_rows(torch.from_numpy(x).to(dev), mesh.size)
    ap = pad_rows(torch.from_numpy(a0).to(dev), mesh.size)[0]
    n_pad, d = xp.shape
    sb = K2Step(k=K, kn=KN, backend="kernels", mesh=mesh, bn=8, bkn=8,
                residency=residency, **kw)
    step = sb.build(n_pad, d)
    xl, wl, al = (shard_rows(t, mesh) for t in (xp, w, ap))
    c = torch.from_numpy(init).to(dev)
    state = sb.init_resident(xl, wl, c, al) if residency == "resident" \
        else init_state(c, al, KN)
    out = []
    for _ in range(iters):
        state, stats = step(xl, wl, state)
        a = sb.final_assignment(state, n_pad) if residency == "resident" \
            else mesh.gather_rows(state.a)
        out.append({"a": _np(a)[:x.shape[0]], "c": _np(state.c),
                    "stats": [float(s) for s in stats]})
    return out


def lloyd_steps(mesh, x, init, iters=4):
    """The sharded Lloyd step from ``init``: per step the gathered
    assignment, the centers and the energy."""
    dev = mesh.device
    xp, w = pad_rows(torch.from_numpy(x).to(dev), mesh.size)
    xl, wl = shard_rows(xp, mesh), shard_rows(w, mesh)
    step = make_distributed_lloyd_step(mesh, init.shape[0])
    c, out = torch.from_numpy(init).to(dev), []
    for _ in range(iters):
        c, a, e = step(xl, wl, c)
        out.append({"a": _np(mesh.gather_rows(a))[:x.shape[0]],
                    "c": _np(c), "energy": float(e)})
    return out


def dist_fit(mesh, x, k=K, kn=KN, key=0, **kw):
    cnt = OpCounter()
    r = fit_distributed_k2means(x, k, kn, mesh, key, counter=cnt, **kw)
    return _fit_out(r, cnt)


def engine_world(mesh, d):
    """The engine and the sharded fit at test_engine_distributed's fixtures."""
    x, init, a0 = d["x"], d["init"], d["a0"]
    out = {"index": mesh.index,
           "step": steps(mesh, x, init, a0, residency="rebuild", iters=6),
           "resident_step": steps(mesh, x, init, a0, residency="resident",
                                  iters=8, regroup_every=4, move_cap=128)}
    for backend in ("kernels", "xla", "legacy"):
        out[backend] = dist_fit(mesh, x, max_iters=25, init_centers=init,
                                backend=backend)
    out["kernels_again"] = dist_fit(mesh, x, max_iters=25,
                                    init_centers=init, backend="kernels")
    out["kernels_rebuild"] = dist_fit(mesh, x, max_iters=25,
                                      init_centers=init, backend="kernels",
                                      residency="rebuild")
    out["uneven"] = dist_fit(mesh, d["xu"], max_iters=20,
                             init_centers=d["initu"], backend="kernels")
    out["lloyd"] = lloyd_steps(mesh, d["xu"], d["initu"])
    out["monitor4"] = dist_fit(mesh, x, max_iters=25, init_centers=init,
                               backend="xla", monitor_every=4)
    cnt = OpCounter()
    out["api"] = _fit_out(fit(x, K, mesh=mesh, kn=KN, max_iters=10,
                              init="random", counter=cnt, backend="xla"),
                          cnt)
    # the sharded seed: the reference's draws, then the port's own
    xg = d["xg"]
    out["seed_ref_draws"] = dist_fit(mesh, xg, max_iters=0, init="gdi",
                                     gdi_draws=d["draws"][mesh.index])
    out["seed"] = dist_fit(mesh, xg, key=3, max_iters=0, init="gdi")
    out["seed_replicated"] = dist_fit(mesh, xg, key=3, max_iters=0,
                                      init="gdi_replicated")
    out["seed_k12"] = dist_fit(mesh, xg, k=12, key=3, max_iters=5,
                               init="gdi")
    out["replicated_fit"] = dist_fit(mesh, xg, key=3, max_iters=3,
                                     init="gdi_replicated")
    out.update(pod_cases(mesh, d))
    out.update(group_cases(mesh))
    out.update(reshard_cases(mesh, d))
    return out


def pod_cases(mesh, d):
    """A ("pod", "data") = (2, 2) mesh: the sum's order (within the pod,
    then across pods) and a fit on it."""
    pod = make_mesh((2, 2), ("pod", "data"), device=mesh.device)
    r = pod.index
    vals = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    t = torch.tensor([vals[r], -0.0], dtype=torch.float32)
    s = pod.sum(t)
    return {"pod_sum": _np(s), "pod_sum_flat": _np(pod.sum(t, axes=("data",))),
            "pod_fit": dist_fit(pod, d["x"], max_iters=25,
                                init_centers=d["init"], backend="xla")}


def _group_timeout(group, dev):
    """The timeout the process group was made with, in seconds."""
    return group._get_backend(dev).options._timeout.total_seconds()


def group_cases(mesh):
    """Every group a mesh makes (its pod axes', a survivors' submesh) is
    bounded by the timeout the world was started with; a mesh made with
    no device names the rank's card (raising on a host without one)."""
    dev = torch.device(mesh.device)
    pod = make_mesh((2, 2), ("pod", "data"), device=dev)
    sub = mesh.submesh([0, 2, 3])
    bounds = [mesh.timeout.total_seconds(), pod.timeout.total_seconds(),
              sub.timeout.total_seconds()]
    bounds += [_group_timeout(g, dev) for g in (
        mesh.group, pod.subgroups["data"], pod.subgroups["pod"])]
    if sub.index is not None:
        bounds.append(_group_timeout(sub.group, dev))
        sub.sum(torch.ones((1,)))       # the survivors' group works
    try:
        default = str(make_mesh().device)
    except RuntimeError as e:
        default = f"raised: {e}"
    return {"group_timeouts": bounds, "default_device": default}


def reshard_cases(mesh, d):
    """Checkpoints across mesh sizes: a whole tree saved by one rank comes
    back as each rank's rows (``Rows``) or whole (``Replicated``); each
    rank's rows gathered and saved are what a one-rank mesh restores."""
    ckdir = d["ckpt_dir"]
    x, init = d["x"], d["init"]
    tree = {"rows": x, "centers": init}
    if mesh.index == 0:
        save_checkpoint(os.path.join(ckdir, "whole"), 1, tree)
    mesh.sum(torch.zeros((1,)))            # the save precedes every read
    got = reshard_restore(os.path.join(ckdir, "whole"), 1, tree,
                          {"rows": Rows(mesh), "centers": Replicated(mesh)})
    rows = mesh.gather_rows(got["rows"])
    # this rank's rows of a sharded state, gathered and saved
    local = shard_rows(torch.from_numpy(x), mesh) * 2.0
    if mesh.size > 1:
        whole = mesh.gather_rows(local)
        if mesh.index == 0:
            save_checkpoint(os.path.join(ckdir, "sharded"), 2,
                            {"rows": whole, "centers": got["centers"]})
    return {"reshard_rows": _np(rows), "reshard_centers": _np(got["centers"]),
            "reshard_local_shape": list(got["rows"].shape)}


def one_rank_world(mesh, d):
    """One rank: the sharded fit in each configuration, ``api.fit(mesh=)``,
    and the four-rank world's checkpoint restored whole."""
    x, init = d["x"], d["init"]
    out = {}
    for name, kw in (("kernels", {"backend": "kernels"}),
                     ("kernels_rebuild", {"backend": "kernels",
                                          "residency": "rebuild"}),
                     ("xla", {"backend": "xla"})):
        out[name] = dist_fit(mesh, x, max_iters=25, init_centers=init, **kw)
    out["lloyd"] = lloyd_steps(mesh, d["xu"], d["initu"])
    cnt = OpCounter()
    out["api"] = _fit_out(fit(x, K, mesh=mesh, kn=KN, max_iters=10,
                              init="random", counter=cnt, backend="xla"),
                          cnt)
    got = reshard_restore(os.path.join(d["ckpt_dir"], "sharded"), 2,
                          {"rows": x, "centers": init},
                          {"rows": Rows(mesh), "centers": Replicated(mesh)})
    out["restored_rows"] = _np(got["rows"])
    return out


# --- fault tolerance on the mesh (test_torch_mesh_ft.py) ------------------


def ft_world(mesh, d):
    """test_ft_selfheal's mesh schedule (n=2048, k=32, kn=8, xla rebuild,
    the reference's random init centers): the fault-free fit, a kill at 6
    resumed from the step-4 checkpoint, a host drop at 5, a straggler
    cordoned; then a guarded chaos fit on the resident mesh."""
    x, c0 = d["x"], d["init"]
    kw = dict(max_iters=10, init_centers=c0, backend="xla",
              residency="rebuild")
    out = {"index": mesh.index, "base": dist_fit(mesh, x, 32, 8, **kw)}
    # shard 0 writes the checkpoints, every rank reads them
    ckdir = os.path.join(d["ckpt_dir"], "fit")
    preempted = False
    try:
        with FaultInjector(seed=0, preempt_at=6):
            dist_fit(mesh, x, 32, 8, ckpt_dir=ckdir, ckpt_every=2, **kw)
    except Preemption:
        preempted = True
    mesh.sum(torch.zeros((1,)))         # every rank has stopped
    out["preempted"] = preempted
    out["resumed"] = dist_fit(mesh, x, 32, 8, ckpt_dir=ckdir, ckpt_every=2,
                              resume=True, **kw)
    with FaultInjector(seed=0, drop_host={5: 1}) as inj:
        out["dropped"] = dist_fit(mesh, x, 32, 8, **kw)
    out["drop_events"] = inj.events
    # slow for exactly `patience` steps, and far slower than any step of a
    # loaded host: cordoned once, whatever the load does to the others
    pol = StragglerPolicy(slack=2.0, window=20, patience=3)
    stall = {it: 1.0 for it in range(6, 6 + pol.patience)}
    with FaultInjector(seed=0, stall=stall) as inj:
        out["straggler"] = dist_fit(mesh, x, 32, 8,
                                    straggler_policy=pol, **kw)
    # a guarded chaos fit over the resident mesh
    sched = dict(nan_rows={2: 8}, poison_centers={4: 2},
                 poison_slots={6: 5}, poison_bounds={8: 7})
    with FaultInjector(seed=5, **sched) as inj:
        out["chaos"] = dist_fit(mesh, x, 32, 8, key=1, max_iters=20,
                                init_centers=c0, backend="kernels",
                                guards=True)
    out["chaos_events"] = inj.events
    return out


# --- the card (test_torch_cuda.py) -----------------------------------------


def sum_world(mesh, vals):
    """Each rank's row of ``vals`` summed across the mesh, as bits."""
    t = torch.from_numpy(vals[mesh.index]).to(mesh.device)
    return _np(mesh.sum(t)).view(np.uint32)


def small_fit_world(mesh, d):
    return dist_fit(mesh, d["x"], 48, 8, max_iters=20,
                    init_centers=d["init"], backend="kernels")


def random_start_world(mesh, d):
    """ROADMAP §3 entry 19's case: the sharded xla fit from random rows,
    long enough for the shard-order sums to move the trajectory."""
    return dist_fit(mesh, d["x"], d["init"].shape[0], d["kn"],
                    max_iters=200, init_centers=d["init"], backend="xla")
