"""Fault tolerance of the port's sharded fit on a four-rank gloo world
(``torch_mesh_cases.ft_world``), on the CPU.

The schedule is ``test_ft_selfheal.py``'s mesh test: n = 2048, k = 32,
k_n = 8, the xla backend with the rebuild residency, 10 iterations from
the reference's random init centers (``jax.random`` draws cannot be
made with a ``torch.Generator``, so the centers are carried over). A
kill before iteration 6 resumed from the step-4 checkpoint, a host lost
at iteration 5 and a straggler cordoned after three slow iterations all
keep the fault-free assignment, each with one ``restore`` repair; the
fault-free fit equals the reference's single-device fit (identical
assignments and iterations). A guarded chaos fit on the resident mesh
(NaN rows, poisoned centers, slots and bounds) heals and ends finite,
the same on every rank.
"""
import jax
import numpy as np
import pytest

import torch_mesh_cases as cases
from repro.core import assign_nearest as jax_assign_nearest
from repro.core import fit_k2means as jax_fit_k2means
from repro.data import gmm_blobs
from repro_torch.launch.mesh import run_local

pytestmark = pytest.mark.faults

_N, _K, _KN = 2048, 32, 8


@pytest.fixture(scope="module")
def ft(tmp_path_factory):
    x = gmm_blobs(jax.random.PRNGKey(0), _N, 16, true_k=20)
    c0 = x[jax.random.choice(jax.random.PRNGKey(3), _N, shape=(_K,),
                             replace=False)]
    ref = jax_fit_k2means(x, c0, jax_assign_nearest(x, c0), kn=_KN,
                          max_iters=10, backend="xla", residency="rebuild")
    data = {"x": np.array(x), "init": np.array(c0),
            "ckpt_dir": str(tmp_path_factory.mktemp("mesh_ft"))}
    return {"ref": ref, "ranks": run_local(cases.ft_world, 4, data,
                                           device="cpu", timeout=400)}


def test_fault_free_fit_matches_reference(ft):
    base = ft["ranks"][0]["base"]
    np.testing.assert_array_equal(base["a"], np.asarray(ft["ref"].assignment))
    assert base["iterations"] == ft["ref"].iterations


def test_kill_and_resume_on_the_mesh(ft):
    r = ft["ranks"][0]
    assert r["preempted"]
    np.testing.assert_array_equal(r["resumed"]["a"], r["base"]["a"])
    assert r["resumed"]["profile"]["repairs"]["restore"] == 1


def test_host_drop_fails_over_to_the_survivors(ft):
    """Rank 1 lost at iteration 5: the survivors (two of three, as
    ``plan_remesh`` rounds down) finish the fit, and every rank, the
    dropped and the idle one included, returns the fault-free result."""
    for r in ft["ranks"]:
        assert (5, "drop_host", 1) in r["drop_events"]
        np.testing.assert_array_equal(r["dropped"]["a"],
                                      ft["ranks"][0]["base"]["a"])
        assert r["dropped"]["profile"]["repairs"]["restore"] == 1
        assert r["dropped"]["iterations"] == ft["ranks"][0]["base"][
            "iterations"]


def test_straggler_is_cordoned(ft):
    for r in ft["ranks"]:
        np.testing.assert_array_equal(r["straggler"]["a"],
                                      ft["ranks"][0]["base"]["a"])
        assert r["straggler"]["profile"]["repairs"]["restore"] == 1


def test_guarded_chaos_fit_heals_on_the_mesh(ft):
    """Guards sum their lanes across the shards, so every rank takes the
    same rungs: the NaN rows are quarantined, the poisoned centers split
    back, the slots regrouped, the bounds reset; the fit ends finite and
    every rank holds the same result."""
    first = ft["ranks"][0]
    rep = first["chaos"]["profile"]["repairs"]
    assert rep["regroup"] >= 1 and rep["split"] >= 1
    assert first["chaos"]["profile"]["sanitized_rows"] == 8
    assert np.isfinite(first["chaos"]["energy"])
    assert np.isfinite(first["chaos"]["c"]).all()
    for r in ft["ranks"][1:]:
        assert r["chaos_events"] == first["chaos_events"]
        np.testing.assert_array_equal(r["chaos"]["a"], first["chaos"]["a"])
        np.testing.assert_array_equal(r["chaos"]["c"], first["chaos"]["c"])
