"""The port's sharded k²-means (``launch.mesh``, ``core.distributed``,
``K2Step(mesh=...)``) against the JAX reference, on the CPU.

The port runs in ``launch.mesh.run_local`` worlds of gloo ranks
(``torch_mesh_cases``: one four-rank world and one one-rank world,
each running many cases). The reference's sharded fit runs at the
same time in a subprocess on four host devices
(``--xla_force_host_platform_device_count=4``); jax 0.9 spells
``shard_map``'s ``check_rep`` as ``check_vma``, so the subprocess
installs a shim that renames the keyword on the module attributes the
reference calls (``repro.compat``, ``repro.core.distributed``,
``repro.core.engine``); nothing in ``src/repro`` changes.

Fixtures are ``test_engine_distributed.py``'s: ``gmm_blobs(PRNGKey(0),
1024, 16, true_k=10)``, k = 16, k_n = 6 from the reference's random
init. Tolerances: assignments, iteration counts, the changed counts and
the ``OpCounter`` lanes exactly equal; centers within rtol 1e-5 of the
single-device reference (the sharded sums add per shard, then across
shards: the reference's own standard); a one-rank mesh equals the
single-device port bit for bit; the sharded seed's energy within 1.35x
of the replicated GDI's (the reference's bound).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro.core import assign_nearest as jax_assign_nearest
from repro.core.distributed import _gdi_merge as jax_gdi_merge
from repro.core.gdi import frontier_round_bound as jax_round_bound
from repro.core.gdi import gdi_fixed_rounds as jax_fixed_rounds
from repro.data import gmm_blobs
from repro_torch.core import OpCounter, fit, fit_k2means, lloyd_step
from repro_torch.core.distributed import _gdi_merge
from repro_torch.core.gdi import frontier_round_bound, gdi_fixed_rounds
from repro_torch.kernels.ops import grouped_capacity
from repro_torch.launch.mesh import run_local
from test_torch_fit import COUNTED

K, KN = cases.K, cases.KN
SEED_K, SEED_ROUNDS = 16, jax_round_bound(16, 0.125) + 2

_SHIM = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro.compat
import repro.core.distributed
import repro.core.engine
_shard_map = repro.compat.shard_map


def shard_map(f, *args, check_rep=None, **kw):
    if check_rep is not None:
        kw["check_vma"] = check_rep
    return _shard_map(f, *args, **kw)


for _m in (repro.compat, repro.core.distributed, repro.core.engine):
    _m.shard_map = shard_map
"""

_REF_SCRIPT = _SHIM + r"""
import json
import jax, jax.numpy as jnp
import numpy as np
from repro.core import (OpCounter, assign_nearest, fit_k2means, K2State,
                        init_state)
from repro.core.distributed import fit_distributed_k2means
from repro.core.k2means import k2means_pallas_step
from repro.data import gmm_blobs
from repro.launch.mesh import make_debug_cluster_mesh

COUNTED = %(counted)r
mesh = make_debug_cluster_mesh()
key = jax.random.PRNGKey(0)
k, kn, bn, bkn = 16, 6, 8, 8
x = gmm_blobs(key, 1024, 16, true_k=10)
init = x[jax.random.choice(key, 1024, shape=(k,), replace=False)]
a0 = assign_nearest(x, init).astype(jnp.int32)
out = {"devices": len(jax.devices())}


def lanes(cnt):
    p = cnt.profile()
    return {name: p[name] for name in COUNTED}


def listed(r):
    return {"a": np.asarray(r.assignment).tolist(),
            "iterations": r.iterations, "energy": r.energy}


# the single-device pallas step, iteration by iteration
ss = init_state(init, a0, kn)
out["step"] = []
for it in range(8):
    c, a, u, lo, nb, stats = k2means_pallas_step(
        x, ss.c, ss.a, ss.u, ss.lo, ss.prev_nb, ss.first, kn, bn, bkn, True)
    ss = K2State(c, a, u, lo, nb, jnp.array(False))
    out["step"].append({"a": np.asarray(a).tolist(),
                        "c": np.asarray(c).tolist(),
                        "changed": int(stats[1])})
out["fit_pallas"] = listed(fit_k2means(x, init, a0, kn=kn, max_iters=25,
                                       backend="pallas"))
out["fit_xla"] = listed(fit_k2means(x, init, a0, kn=kn, max_iters=25))
xu = gmm_blobs(jax.random.PRNGKey(5), 1000, 16, true_k=10)
initu = xu[jax.random.choice(jax.random.PRNGKey(6), 1000, shape=(k,),
                             replace=False)]
out["fit_uneven"] = listed(fit_k2means(xu, initu, assign_nearest(xu, initu),
                                       kn=kn, max_iters=20, backend="pallas"))
# the reference's own sharded fit
for name, xx, cc, iters, kw in (
        ("pallas", x, init, 25, {"backend": "pallas"}),
        ("pallas_rebuild", x, init, 25, {"backend": "pallas",
                                          "residency": "rebuild"}),
        ("xla", x, init, 25, {"backend": "xla"}),
        ("legacy", x, init, 25, {"backend": "legacy"}),
        ("uneven", xu, initu, 20, {"backend": "pallas"})):
    cnt = OpCounter()
    r = fit_distributed_k2means(xx, k, kn, mesh, key, max_iters=iters,
                                init_centers=cc, counter=cnt, **kw)
    out["dist_" + name] = dict(listed(r), lanes=lanes(cnt))
print("RESULT " + json.dumps(out))
"""


def _inputs(ckpt_dir):
    key = jax.random.PRNGKey(0)
    x = gmm_blobs(key, 1024, 16, true_k=10)
    init = x[jax.random.choice(key, 1024, shape=(K,), replace=False)]
    xu = gmm_blobs(jax.random.PRNGKey(5), 1000, 16, true_k=10)
    initu = xu[jax.random.choice(jax.random.PRNGKey(6), 1000, shape=(K,),
                                 replace=False)]
    xg = np.array(gmm_blobs(jax.random.PRNGKey(1), 4096, 16, true_k=32))
    return {"x": np.array(x), "init": np.array(init),
            "a0": np.asarray(jax_assign_nearest(x, init)).astype(np.int32),
            "xu": np.array(xu), "initu": np.array(initu), "xg": xg,
            "draws": [_shard_draws(s, 1024) for s in range(4)],
            "ckpt_dir": str(ckpt_dir)}


def _shard_key(s):
    return jax.random.fold_in(jax.random.PRNGKey(3), s)


def _shard_draws(s, n_loc):
    """The uniform draws of the reference's per-shard seed rounds
    (``gdi_fixed_rounds`` under ``fold_in(key, shard)``), in order."""
    out = []
    for sub in jax.random.split(_shard_key(s), SEED_ROUNDS):
        k1, k2 = jax.random.split(sub)
        out.append((np.array(jax.random.uniform(k1, (n_loc,))),
                    np.array(jax.random.uniform(k2, (n_loc,)))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess beside the port's two worlds."""
    data = _inputs(tmp_path_factory.mktemp("mesh"))
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT % {"counted": COUNTED}],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        four = run_local(cases.engine_world, 4, data, device="cpu",
                         timeout=400)
        one = run_local(cases.one_rank_world, 1, data, device="cpu",
                        timeout=200)
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    ref = json.loads(line[0][len("RESULT "):])
    assert ref["devices"] == 4
    return {"data": data, "four": four, "one": one[0], "ref": ref}


def _lanes(profile):
    return {name: profile[name] for name in COUNTED}


def test_every_rank_returns_the_same_result(runs):
    """Every rank of the four-rank world holds the same centers and the
    same full assignment, bit for bit."""
    four = runs["four"]
    assert [r["index"] for r in four] == [0, 1, 2, 3]
    for name in ("kernels", "xla", "legacy", "uneven", "seed"):
        for r in four[1:]:
            np.testing.assert_array_equal(r[name]["a"], four[0][name]["a"])
            np.testing.assert_array_equal(r[name]["c"], four[0][name]["c"])
            assert r[name]["energy"] == four[0][name]["energy"]


def test_engine_step_matches_single_device_per_iteration(runs):
    """The sharded kernels step against the reference's single-device
    pallas step, iteration by iteration: identical assignments, equal
    changed counts, centers within rtol 1e-5."""
    for got, want in zip(runs["four"][0]["step"], runs["ref"]["step"]):
        np.testing.assert_array_equal(got["a"], want["a"])
        assert int(got["stats"][1]) == want["changed"]
        np.testing.assert_allclose(got["c"], np.float32(want["c"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["kernels", "xla", "legacy"])
def test_fit_distributed_matches_reference(runs, backend):
    """``fit_distributed_k2means`` on four ranks: the reference's
    single-device fit's assignments and iterations, and the reference's
    own sharded fit's assignments, iterations and counted lanes."""
    got = runs["four"][0][backend]
    ref = runs["ref"]
    single = ref["fit_xla" if backend != "kernels" else "fit_pallas"]
    dist = ref["dist_" + ("pallas" if backend == "kernels" else backend)]
    np.testing.assert_array_equal(got["a"], single["a"])
    assert got["iterations"] == single["iterations"]
    np.testing.assert_array_equal(got["a"], dist["a"])
    assert got["iterations"] == dist["iterations"]
    assert _lanes(got["profile"]) == dist["lanes"]
    assert abs(got["energy"] - dist["energy"]) <= 1e-5 * dist["energy"]


def test_bounded_engine_counts_fewer_distances_than_legacy(runs):
    four = runs["four"][0]
    legacy = four["legacy"]["profile"]["distances"]
    assert four["kernels"]["profile"]["distances"] < legacy
    assert four["xla"]["profile"]["distances"] < legacy


def test_uneven_shards(runs):
    """n=1000 over four ranks (duplicate head rows at weight 0): the
    single-device reference's assignment, its sharded fit's lanes."""
    got, ref = runs["four"][0]["uneven"], runs["ref"]
    assert got["a"].shape == (1000,)
    np.testing.assert_array_equal(got["a"], ref["fit_uneven"]["a"])
    assert abs(got["energy"] - ref["fit_uneven"]["energy"]) \
        < 1e-6 * ref["fit_uneven"]["energy"]
    assert _lanes(got["profile"]) == ref["dist_uneven"]["lanes"]


def test_distributed_lloyd_step(runs):
    """The sharded Lloyd step on the uneven n=1000 against the
    single-device step: one rank bit for bit; four ranks with identical
    assignments, centers and energy within rtol 1e-5."""
    data = runs["data"]
    c = torch.from_numpy(data["initu"])
    x = torch.from_numpy(data["xu"])
    for it in range(4):
        c_next, a, e = lloyd_step(x, c)
        one, four = runs["one"]["lloyd"][it], runs["four"][0]["lloyd"][it]
        np.testing.assert_array_equal(one["a"], a.numpy())
        np.testing.assert_array_equal(one["c"], c_next.numpy())
        assert one["energy"] == float(e)
        np.testing.assert_array_equal(four["a"], a.numpy())
        np.testing.assert_allclose(four["c"], c_next.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert abs(four["energy"] - float(e)) <= 1e-5 * float(e)
        c = c_next


def test_monitor_every_leaves_the_fit_unchanged(runs):
    four = runs["four"][0]
    np.testing.assert_array_equal(four["monitor4"]["a"], four["xla"]["a"])
    assert four["monitor4"]["iterations"] == four["xla"]["iterations"]


def test_resident_mesh_through_repairs_and_resorts(runs):
    """The resident step on four ranks (re-sort every 4, move cap 128)
    against the reference's single-device rebuild step, iteration by
    iteration; sparse repairs happened and moved fewer rows than the
    arena; the resident fit equals the single-device pallas fit and
    the reference's sharded resident fit (lanes included), and moves
    fewer bytes than the rebuild residency."""
    four, ref = runs["four"][0], runs["ref"]
    repaired = []
    for got, want in zip(four["resident_step"], ref["step"]):
        np.testing.assert_array_equal(got["a"], want["a"])
        assert int(got["stats"][1]) == want["changed"]
        if got["stats"][4] == 0:
            repaired.append(got["stats"][3])
    assert repaired and max(repaired) < 1024
    np.testing.assert_array_equal(four["kernels"]["a"],
                                  ref["fit_pallas"]["a"])
    rebuild = four["kernels_rebuild"]
    assert _lanes(rebuild["profile"]) == ref["dist_pallas_rebuild"]["lanes"]
    assert 0 < four["kernels"]["profile"]["bytes_moved"] \
        < rebuild["profile"]["bytes_moved"]


def test_api_fit_with_mesh(runs):
    """``api.fit(mesh=)``: shapes and charges on four ranks; on one rank
    it equals the single-device ``api.fit`` bit for bit."""
    four, one, data = runs["four"][0], runs["one"], runs["data"]
    assert four["api"]["c"].shape == (K, 16)
    assert four["api"]["a"].shape == (1024,)
    assert four["api"]["profile"]["total_ops"] > 0
    cnt = OpCounter()
    r = fit(data["x"], K, kn=KN, max_iters=10, init="random", counter=cnt,
            backend="xla", device="cpu")
    np.testing.assert_array_equal(one["api"]["a"], r.assignment.numpy())
    np.testing.assert_array_equal(one["api"]["c"], r.centers.numpy())
    assert one["api"]["energy"] == r.energy
    assert one["api"]["profile"]["total_ops"] == cnt.total


@pytest.mark.parametrize("name,kw", [
    ("kernels", {"backend": "kernels"}),
    ("kernels_rebuild", {"backend": "kernels", "residency": "rebuild"}),
    ("xla", {"backend": "xla"})])
def test_one_rank_equals_the_single_device_port(runs, name, kw):
    """A one-rank mesh is the single-device fit bit for bit: centers,
    assignment, energy, iterations and every counted lane (the sharded fit's
    own initial assignment charges n*k distances more)."""
    data, got = runs["data"], runs["one"][name]
    cnt = OpCounter()
    cnt.add_distances(1024 * K)
    r = fit_k2means(data["x"], data["init"], data["a0"], kn=KN,
                    max_iters=25, counter=cnt, device="cpu", **kw)
    np.testing.assert_array_equal(got["a"], r.assignment.numpy())
    np.testing.assert_array_equal(got["c"], r.centers.numpy())
    assert got["energy"] == r.energy and got["iterations"] == r.iterations
    assert _lanes(got["profile"]) == _lanes(cnt.profile())


def test_two_four_rank_runs_are_bit_identical(runs):
    four = runs["four"][0]
    np.testing.assert_array_equal(four["kernels_again"]["a"],
                                  four["kernels"]["a"])
    np.testing.assert_array_equal(four["kernels_again"]["c"],
                                  four["kernels"]["c"])
    assert four["kernels_again"]["history"] == four["kernels"]["history"]


def test_gdi_fixed_rounds_matches_reference_per_shard(runs):
    """Each shard's fixed frontier rounds on that shard's rows with the
    reference's draws: identical leaf ids, sizes and leaf count, centers
    within rtol 1e-5."""
    data = runs["data"]
    assert frontier_round_bound(SEED_K, 0.125) + 2 == SEED_ROUNDS
    for s in range(4):
        xs = data["xg"][s * 1024:(s + 1) * 1024]
        aj, cj, _, zj, nj = jax_fixed_rounds(
            jnp.asarray(xs), SEED_K, _shard_key(s), rounds=SEED_ROUNDS,
            bn=8, impl="xla", frontier=0.125)
        at, ct, _, zt, nt = gdi_fixed_rounds(
            torch.from_numpy(xs), SEED_K, rounds=SEED_ROUNDS, bn=8,
            frontier=0.125, draws=data["draws"][s])
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
        assert int(nt) == int(nj)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                                   atol=1e-5)


def _ref_leaves(data):
    cs, ws, ids = [], [], []
    for s in range(4):
        xs = data["xg"][s * 1024:(s + 1) * 1024]
        a, c, _, z, nl = jax_fixed_rounds(
            jnp.asarray(xs), SEED_K, _shard_key(s), rounds=SEED_ROUNDS,
            bn=8, impl="xla", frontier=0.125)
        live = np.arange(SEED_K) < int(nl)
        cs.append(np.asarray(c))
        ws.append(np.where(live, np.asarray(z), 0).astype(np.float32))
        ids.append(np.asarray(a) + s * SEED_K)
    return np.concatenate(cs), np.concatenate(ws), np.concatenate(ids)


def test_gdi_merge_matches_reference(runs):
    """The weighted Lloyd merge on the reference's P·k leaves: identical
    leaf-to-meta map, meta-centers within rtol 1e-5."""
    cg, wg, _ = _ref_leaves(runs["data"])
    mj, lj = jax_gdi_merge(jnp.asarray(cg), jnp.asarray(wg), k=SEED_K)
    mt, lt = _gdi_merge(torch.from_numpy(cg), torch.from_numpy(wg), SEED_K)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-5)


def test_sharded_seed_matches_reference(runs):
    """``fit(init="gdi")`` on four ranks with the reference's per-shard
    draws, stopped after the seed: the reference's merged meta-centers
    (rtol 1e-5) and every row's meta-cluster through its leaf; the
    rounds and the merge charged as the reference charges them."""
    cg, wg, ids = _ref_leaves(runs["data"])
    mj, lj = jax_gdi_merge(jnp.asarray(cg), jnp.asarray(wg), k=SEED_K)
    got = runs["four"][0]["seed_ref_draws"]
    np.testing.assert_array_equal(got["a"], np.asarray(lj)[ids])
    np.testing.assert_allclose(got["c"], np.asarray(mj), rtol=1e-5,
                               atol=1e-5)
    p = got["profile"]
    r_loc = grouped_capacity(1024, SEED_K, 8) * 8
    assert p["inner_products"] == 4 * SEED_ROUNDS * 2 * r_loc
    assert p["distances"] == 8 * 4 * SEED_K * SEED_K


def test_sharded_seed_energy(runs):
    """The port's own sharded seed lands within 1.35x of the replicated
    device GDI's energy; k = 12 (not a multiple of the shard count) still
    gives 12 clusters; the replicated seed's fit stays finite."""
    four = runs["four"][0]
    ratio = four["seed"]["energy"] / four["seed_replicated"]["energy"]
    assert ratio < 1.35, ratio
    assert four["seed"]["profile"]["sort_equivalents"] > 0
    assert 0 <= four["seed"]["a"].min() and four["seed"]["a"].max() < 16
    k12 = four["seed_k12"]
    assert k12["c"].shape == (12, 16)
    assert 0 <= k12["a"].min() and k12["a"].max() < 12
    assert np.isfinite(k12["energy"])
    assert np.isfinite(four["replicated_fit"]["energy"])


def test_pod_mesh_sums_within_the_pod_first(runs):
    """On a (pod, data) = (2, 2) mesh the sum adds within each pod, then
    across pods ((1e8 + 1) + (-1e8 + 1) in f32 is 0, where the shard-order
    chain gives 1), keeps a -0.0 partial, and a fit on it equals the
    single-device reference's assignment."""
    four = runs["four"]
    for r in four:
        np.testing.assert_array_equal(r["pod_sum"], np.float32([0.0, -0.0]))
        assert np.signbit(r["pod_sum"][1])
    assert [float(r["pod_sum_flat"][0]) for r in four] == [1e8, 1e8, -1e8,
                                                            -1e8]
    np.testing.assert_array_equal(four[0]["pod_fit"]["a"],
                                  runs["ref"]["fit_xla"]["a"])


def test_reshard_restore_round_trips(runs):
    """A tree saved whole comes back on four ranks as each rank's rows
    and the whole centers; four ranks' rows gathered and saved come back
    whole on one rank."""
    data, four, one = runs["data"], runs["four"], runs["one"]
    for r in four:
        assert r["reshard_local_shape"] == [256, 16]
        np.testing.assert_array_equal(r["reshard_rows"], data["x"])
        np.testing.assert_array_equal(r["reshard_centers"], data["init"])
    np.testing.assert_array_equal(one["restored_rows"], data["x"] * 2.0)


def test_every_group_of_the_mesh_is_bounded(runs):
    """The world's timeout (400 s) bounds the mesh's group, the pod
    mesh's two subgroups and a survivors' submesh, as torch holds them;
    a mesh made with no device takes the rank's card, and raises on a
    host without one (never the CPU by default)."""
    for r in runs["four"]:
        want = 7 if r["index"] != 1 else 6       # rank 1 is not a survivor
        assert r["group_timeouts"] == [400.0] * want
        if torch.cuda.is_available():
            assert r["default_device"] == \
                f"cuda:{r['index'] % torch.cuda.device_count()}"
        else:
            assert r["default_device"].startswith("raised: ")
            assert "CUDA device" in r["default_device"]


@pytest.mark.parametrize("call", ["run_local", "make_mesh"])
def test_launch_defaults_to_the_card(monkeypatch, call):
    """With no device named, ``run_local`` and ``make_mesh`` put each rank
    on its card: on a host with no card they raise before any rank
    starts, never falling back to the CPU; ``make_mesh`` also refuses a
    process group not started with a timeout."""
    import repro_torch.launch.mesh as mesh_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if call == "run_local":
        with pytest.raises(RuntimeError, match="CUDA device"):
            run_local(cases.sum_world, 2, np.zeros((2, 4), np.float32),
                      timeout=60)
    else:
        monkeypatch.setattr(mesh_mod, "_TIMEOUT", None)
        with pytest.raises(RuntimeError, match="init_process_group"):
            mesh_mod.make_mesh()


def test_mesh_placement_checks_its_arguments():
    """As the reference's ``fit``: the mesh places k²-means only, and
    ``gdi_replicated`` is an init of the mesh placement alone."""
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    with pytest.raises(ValueError, match="k2means"):
        fit(x, 2, method="lloyd", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown init"):
        fit(x, 2, init="gdi_replicated", device="cpu")


_ENTRY19_SCRIPT = _SHIM + r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.core import assign_nearest, fit_k2means
from repro.core.distributed import fit_distributed_k2means
from repro.launch.mesh import make_debug_cluster_mesh
d = np.load(sys.argv[1])
x, init, kn = jnp.asarray(d["x"]), jnp.asarray(d["init"]), int(d["kn"])
a0 = assign_nearest(x, init).astype(jnp.int32)
one = fit_k2means(x, init, a0, kn=kn, max_iters=200, backend="xla")
four = fit_distributed_k2means(x, init.shape[0], kn,
                               make_debug_cluster_mesh(),
                               jax.random.PRNGKey(0), max_iters=200,
                               init_centers=init, backend="xla")
print("RESULT " + json.dumps({
    name: {"a": np.asarray(r.assignment).tolist(),
           "iterations": r.iterations,
           "history": [float(e) for _, e in r.history]}
    for name, r in (("one", one), ("four", four))}))
"""


def test_sharded_fits_part_from_one_device_in_both_packages(tmp_path):
    """ROADMAP §3 entry 19: from one random start (n=12000, d=64, k=256,
    k_n=12, 128 blobs) the sharded xla fit parts from the single-device
    fit in the reference as in the port. Each package's two energy
    histories agree through iteration 1 and part from iteration 2 on
    (the shard-order f32 sums move the centers by ulps, and 25 or more
    iterations from a random start let that change assignments); the
    port's single-device fit is the reference's (assignments, iterations
    and history), and its four-rank fit parts from it as the
    reference's four-device fit parts from the reference's. A property
    of sharding, not a fault of the port."""
    key = jax.random.PRNGKey(0)
    x = np.array(gmm_blobs(key, 12000, 64, true_k=128))
    init = x[np.random.RandomState(1).choice(12000, 256, replace=False)]
    kn = 12
    np.savez(tmp_path / "in.npz", x=x, init=init, kn=kn)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _ENTRY19_SCRIPT, str(tmp_path / "in.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        four = run_local(cases.random_start_world, 4,
                         {"x": x, "init": init, "kn": kn}, device="cpu",
                         timeout=400)[0]
        a0 = torch.from_numpy(np.asarray(jax_assign_nearest(
            jnp.asarray(x), jnp.asarray(init)), np.int32))
        one = fit_k2means(torch.from_numpy(x), torch.from_numpy(init), a0,
                          kn=kn, max_iters=200, backend="xla",
                          device="cpu")
        out, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads([ln for ln in out.splitlines()
                      if ln.startswith("RESULT ")][0][len("RESULT "):])
    port = {"one": {"a": one.assignment.numpy(),
                    "iterations": one.iterations,
                    "history": [e for _, e in one.history]},
            "four": {"a": four["a"], "iterations": four["iterations"],
                     "history": [e for _, e in four["history"]]}}
    np.testing.assert_array_equal(port["one"]["a"], ref["one"]["a"])
    assert port["one"]["iterations"] == ref["one"]["iterations"]
    np.testing.assert_allclose(port["one"]["history"],
                               ref["one"]["history"], rtol=1e-6)
    for name, fits in (("reference", ref), ("port", port)):
        h1, h4 = fits["one"]["history"], fits["four"]["history"]
        first = next(i for i, (e1, e4) in enumerate(zip(h1, h4))
                     if e1 != e4)
        differ = int((np.asarray(fits["one"]["a"])
                      != np.asarray(fits["four"]["a"])).sum())
        print(f"{name}: one device {fits['one']['iterations']} iterations, "
              f"four {fits['four']['iterations']}; histories part at "
              f"iteration {first}; {differ} of 12000 assignments differ")
        assert first >= 2 and differ > 0, (name, first, differ)
