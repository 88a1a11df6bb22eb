"""The port's fit path against the JAX reference, on the CPU.

Every case starts both packages from one numpy input and one init (the
reference's state carried over by ``convert.from_reference``) and
demands what the reference demands of its own two backends: identical
assignments, equal iteration counts, energies within rel 1e-5 and equal
``OpCounter`` charges. The divisive init is compared with the
reference's ``jax.random`` draws fed to the port's round step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import assign_nearest as jax_assign_nearest
from repro.core import fit as jax_fit
from repro.core import fit_k2means as jax_fit_k2means
from repro.core import gdi_device_init as jax_gdi_device_init
from repro.core.engine import K2Step as JaxK2Step
from repro.core.gdi import _device_state as jax_device_state
from repro.core.gdi import gdi_round_step as jax_round_step
from repro.core.gdi import segmented_split_sweep as jax_sweep
from repro_torch.convert import from_reference
from repro_torch.core import (K2Step, OpCounter, fit, fit_k2means,
                              gdi_device_init, gdi_round_step,
                              segmented_split_sweep)
from repro_torch.core.gdi import _device_state

COUNTED = ("distances", "inner_products", "additions", "sort_equivalents",
           "bytes_gathered", "bytes_scattered", "bytes_sorted",
           "bytes_scanned", "rows_moved", "resorts")


def blobs(seed, n, d, true_k, spread=4.0, equal=False):
    """GMM stand-in drawn with numpy (power-law weights unless equal)."""
    rng = np.random.RandomState(seed)
    mus = rng.randn(true_k, d) * spread
    w = np.ones(true_k) if equal else 1.0 / np.arange(1, true_k + 1)
    comp = rng.choice(true_k, n, p=w / w.sum())
    return (mus[comp] + rng.randn(n, d)).astype(np.float32)


def reference_init(x, k, seed):
    init = x[np.random.RandomState(seed).choice(x.shape[0], k,
                                                replace=False)]
    a0 = np.asarray(jax_assign_nearest(jnp.asarray(x), jnp.asarray(init)))
    return init, a0


def jax_draws(key, n, rounds):
    """The uniform draws of ``gdi_device_init``'s rounds, in order."""
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append((np.array(jax.random.uniform(k1, (n,))),
                    np.array(jax.random.uniform(k2, (n,)))))
    return out


def assert_same_charges(cj, ct):
    pj, pt = cj.profile(), ct.profile()
    for key in COUNTED:
        assert pt[key] == pj[key], key
    assert ct.total == cj.total


@pytest.mark.parametrize("kw", [{}, {"residency": "rebuild"},
                                {"monitor_every": 4}],
                         ids=["resident", "rebuild", "monitor4"])
def test_fit_k2means_matches_reference(kw):
    """The configuration of test_k2_pallas_backend's convergence test
    (n=1500, d=24, k=50, k_n=8), run to the fixed point."""
    x = blobs(0, 1500, 24, 15)
    init, a0 = reference_init(x, 50, 7)
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit_k2means(jnp.asarray(x), jnp.asarray(init),
                         jnp.asarray(a0), kn=8, max_iters=40,
                         backend="pallas", counter=cj, **kw)
    c0, a0_t = from_reference(init, a0, device="cpu")
    rt = fit_k2means(torch.tensor(x), c0, a0_t, kn=8, max_iters=40,
                     counter=ct, device="cpu", **kw)
    assert (rt.assignment.numpy() == np.asarray(rj.assignment)).all()
    assert rt.iterations == rj.iterations
    assert len(rt.history) == len(rj.history)
    for (_, et), (_, ej) in zip(rt.history, rj.history):
        assert et == pytest.approx(ej, rel=1e-5)
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               rtol=1e-5, atol=1e-4)
    assert_same_charges(cj, ct)


def test_resident_step_matches_reference_per_iteration():
    """The configuration of test_resident_layout's parity test (n=1536,
    d=16, k=24, k_n=8, re-sort every 5, move buffer 128): after every
    iteration the arena (pid, b2c, fill, openb) is bit-equal to the
    reference's, and the step statistics agree."""
    n, d, k, kn = 1536, 16, 24, 8
    x = blobs(1, n, d, 16)
    init, a0 = reference_init(x, k, 2)
    kw = dict(k=k, kn=kn, residency="resident", regroup_every=5,
              move_cap=128)
    sj = JaxK2Step(backend="pallas", **kw)
    st = K2Step(**kw)
    step_j, step_t = sj.build(n, d), st.build(n, d)
    xj, wj = jnp.asarray(x), jnp.ones((n,), jnp.float32)
    xt, wt = torch.tensor(x), torch.ones(n)
    c0, a0_t = from_reference(init, a0, device="cpu")
    state_j = sj.init_resident(xj, wj, jnp.asarray(init), jnp.asarray(a0))
    state_t = st.init_resident(xt, wt, c0, a0_t)
    resorts = repairs = 0
    for it in range(12):
        state_j, stats_j = step_j(xj, wj, state_j)
        state_t, stats_t = step_t(xt, wt, state_t)
        for name in ("pid", "b2c", "fill", "openb"):
            assert (getattr(state_t, name).numpy()
                    == np.asarray(getattr(state_j, name))).all(), (it, name)
        for name in ("n_need", "changed", "moved", "resorted"):
            assert int(getattr(stats_t, name)) \
                == int(getattr(stats_j, name)), (it, name)
        assert float(stats_t.energy) == pytest.approx(
            float(stats_j.energy), rel=1e-5)
        np.testing.assert_allclose(state_t.c.numpy(), np.asarray(state_j.c),
                                   rtol=1e-5, atol=1e-4)
        resorts += int(stats_t.resorted)
        repairs += int(stats_t.resorted) == 0 and int(stats_t.changed) > 0
    assert resorts >= 2 and repairs >= 1      # both branches ran
    assert (st.final_assignment(state_t, n).numpy()
            == np.asarray(sj.final_assignment(state_j, n))).all()


def test_gdi_round_step_matches_reference():
    """Three rounds from one leaf with the reference's draws injected:
    identical leaf assignments, sizes and leaf counts every round."""
    n, d, k, bn = 2048, 16, 16, 8
    x = blobs(2, n, d, 24)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    sj, s_t = jax_device_state(xj, k), _device_state(xt, k)
    for r in range(3):
        key = jax.random.PRNGKey(r)
        k1, k2 = jax.random.split(key)
        draws = (np.array(jax.random.uniform(k1, (n,))),
                 np.array(jax.random.uniform(k2, (n,))))
        sj = jax_round_step(xj, *sj, key, k=k, bn=bn, split_iters=2,
                            impl="xla", interpret=True)
        s_t = gdi_round_step(xt, *s_t, k=k, bn=bn, split_iters=2,
                             draws=draws)
        for i in (0, 3, 4):
            assert (np.asarray(s_t[i]) == np.asarray(sj[i])).all(), (r, i)
        np.testing.assert_allclose(s_t[1].numpy(), np.asarray(sj[1]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(s_t[2].numpy(), np.asarray(sj[2]),
                                   rtol=1e-4)


@pytest.mark.parametrize("bn", [8, 16])
def test_segmented_split_sweep_matches_reference(bn):
    n, d, k = 2048, 16, 8
    x = blobs(3, n, d, 24)
    rng = np.random.RandomState(6)
    a = rng.randint(0, k, n).astype(np.int32)
    c_a = rng.randn(k, d).astype(np.float32)
    c_b = rng.randn(k, d).astype(np.float32)
    want = jax_sweep(jnp.asarray(x), jnp.asarray(a), jnp.asarray(c_a),
                     jnp.asarray(c_b), k=k, bn=bn, impl="xla")
    got = segmented_split_sweep(torch.tensor(x), torch.tensor(a),
                                torch.tensor(c_a), torch.tensor(c_b),
                                k=k, bn=bn)
    assert (got[0].numpy() == np.asarray(want[0])).all()     # found
    assert (got[1].numpy() == np.asarray(want[1])).all()     # cnt_a
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-3)


def test_gdi_device_init_matches_reference():
    """n=600, d=16, k=20 at bn=8: identical leaf assignment and equal
    charges with the reference's draws injected."""
    n, d, k = 600, 16, 20
    x = blobs(4, n, d, 8)
    key = jax.random.PRNGKey(4)
    cj, ct = JaxCounter(), OpCounter()
    c1, a1 = jax_gdi_device_init(jnp.asarray(x), k, key, counter=cj, bn=8,
                                 impl="xla")
    c2, a2 = gdi_device_init(torch.tensor(x), k, counter=ct, bn=8,
                             draws=jax_draws(key, n, 256), device="cpu")
    assert (a2.numpy() == np.asarray(a1)).all()
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), rtol=1e-5,
                               atol=1e-4)
    assert_same_charges(cj, ct)


def test_fit_api_energy_within_one_percent():
    """fit(init="gdi") end to end through api.fit: with its own draws the
    port's seed-mean energy lands within 1% of the reference
    fit(backend="pallas")'s (BENCH_init's criterion for device GDI)."""
    x = blobs(0, 2000, 16, 24)
    ej = [jax_fit(jnp.asarray(x), 48, method="k2means", init="gdi",
                  key=jax.random.PRNGKey(s), kn=6, max_iters=20,
                  backend="pallas").energy for s in range(4)]
    rt = [fit(x, 48, method="k2means", init="gdi", kn=6, max_iters=20,
              seed=s, device="cpu", profile=True) for s in range(4)]
    for r in rt:
        assert r.centers.shape == (48, 16)
        assert np.isfinite(r.energy)
        assert r.profile["total_ops"] == pytest.approx(r.ops)
    assert abs(np.mean([r.energy for r in rt]) / np.mean(ej) - 1.0) <= 0.01


def test_fit_max_iters_zero_evaluates_init():
    x = blobs(6, 200, 8, 5)
    init, a0 = reference_init(x, 6, 1)
    rj = jax_fit_k2means(jnp.asarray(x), jnp.asarray(init), jnp.asarray(a0),
                         kn=3, max_iters=0, backend="pallas")
    c0, a0_t = from_reference(init, a0, device="cpu")
    rt = fit_k2means(torch.tensor(x), c0, a0_t, kn=3, max_iters=0,
                     device="cpu")
    assert rt.iterations == rj.iterations == 0
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)
