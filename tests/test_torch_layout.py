"""The port's grouped-layout operations against the JAX reference's:
``perm``, ``b2c``, ``fill``, ``openb`` and the sparse-repair plan must be
bit-equal on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops


def _np(*vs):
    return [np.asarray(v) for v in vs]


@pytest.mark.parametrize("n,k,d", [(60000, 1000, 784), (2414, 64, 32256),
                                   (100, 7, 5), (4096, 256, 32),
                                   (1500, 50, 24), (10, 40, None)])
def test_choose_group_bn_matches(n, k, d):
    assert ops.choose_group_bn(n, k, d) == jops.choose_group_bn(n, k, d)


@pytest.mark.parametrize("n,k,bn,seed", [(300, 7, 8, 0), (500, 64, 32, 1),
                                         (64, 64, 8, 2), (1000, 5, 16, 3)])
def test_group_by_cluster_device_bit_equal(n, k, bn, seed):
    a = np.random.RandomState(seed).randint(0, k, n).astype(np.int32)
    if seed == 1:
        a[a == 3] = 4                               # an empty cluster
    want = _np(*jops.group_by_cluster_device(jnp.asarray(a), k, bn))
    got = ops.group_by_cluster_device(torch.tensor(a), k, bn)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert (g.numpy() == w).all()
    vals = np.random.RandomState(seed).randn(want[0].shape[0]) \
        .astype(np.float32)
    prev = np.full(n, -3.0, np.float32)
    ws = np.asarray(jops.scatter_from_grouped(
        jnp.asarray(want[0]), jnp.asarray(vals), jnp.asarray(prev)))
    gs = ops.scatter_from_grouped(got[0], torch.tensor(vals),
                                  torch.tensor(prev))
    assert (gs.numpy() == ws).all()


@pytest.mark.parametrize("n,k,bn,spare,seed", [(300, 7, 8, 0, 0),
                                               (256, 5, 8, 3, 1),
                                               (1536, 24, 32, 0, 2)])
def test_resident_regroup_bit_equal(n, k, bn, spare, seed):
    a = np.random.RandomState(seed).randint(0, k, n).astype(np.int32)
    nbt = ops.resident_capacity(n, k, bn, spare)
    assert nbt == jops.resident_capacity(n, k, bn, spare)
    want = _np(*jops.resident_regroup(jnp.asarray(a), k, bn, nbt))
    got = ops.resident_regroup(torch.tensor(a), k, bn, nbt)
    for g, w in zip(got, want):
        assert (g.numpy() == w).all()


def _plan_case(n, k, bn, moves, seed, move_cap):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, k, n).astype(np.int32)
    nbt = ops.resident_capacity(n, k, bn)
    perm, b2c, fill, openb = _np(*jops.resident_regroup(jnp.asarray(a), k,
                                                        bn, nbt))
    owned = np.flatnonzero(perm >= 0)
    slots = rng.choice(owned, size=min(moves, owned.size), replace=False)
    mask = np.zeros(perm.shape[0], bool)
    mask[slots] = True
    dst_all = rng.randint(0, k, perm.shape[0]).astype(np.int32)
    return b2c, fill, openb, mask, dst_all, move_cap


@pytest.mark.parametrize("n,k,bn,moves,seed,move_cap", [
    (300, 7, 8, 0, 0, 32),        # no moves: identity
    (300, 7, 8, 20, 1, 32),
    (64, 8, 8, 40, 2, 64),        # exhausts the free pool
    (1536, 24, 32, 150, 3, 128),  # overflows the move buffer
    (2000, 50, 16, 60, 4, 64),
])
def test_plan_layout_repair_bit_equal(n, k, bn, moves, seed, move_cap):
    b2c, fill, openb, mask, dst_all, cap = _plan_case(n, k, bn, moves, seed,
                                                      move_cap)
    s_total = mask.shape[0]
    mv = np.asarray(jnp.nonzero(jnp.asarray(mask), size=cap,
                                fill_value=s_total)[0])
    mv_t = ops.compact(torch.tensor(mask), cap, s_total)
    assert (mv_t.numpy() == mv).all()
    active = mv < s_total
    dst = dst_all[np.minimum(mv, s_total - 1)]
    want = _np(*jops.plan_layout_repair(
        jnp.asarray(b2c), jnp.asarray(fill), jnp.asarray(openb),
        jnp.asarray(active), jnp.asarray(dst), bn=bn))
    got = ops.plan_layout_repair(
        torch.tensor(b2c), torch.tensor(fill), torch.tensor(openb),
        torch.tensor(active), torch.tensor(dst), bn=bn)
    total_new, n_free = int(want[4]), int(want[5])
    assert int(got[4]) == total_new and int(got[5]) == n_free
    if total_new <= n_free:         # the plan is only valid then
        for g, w in zip(got[:4], want[:4]):
            assert (g.numpy() == w).all()
