"""The port's baselines — K5 distance_argmin, K7 candidate_assign_rowwise,
Lloyd, Elkan and k-means++ — against the JAX reference, on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages; the
reference runs its Pallas kernels with ``interpret=True``. The port's
distances round |x|^2, |c|^2 and x.c once from f64 and the reference
sums in f32, so squared distances agree within rtol 1e-5 with atol
1e-5 max|c|^2 (the f32 expansion cancels where a point sits near a
center: the reference's own error there is an ulp of |x|^2 + |c|^2, the
tolerance of tests/test_torch_kernels.py), and
assignments are identical except on rows whose best and second-best
squared distance differ by less than 1e-6 relative in the reference's
own values (a float tie: either answer is right); such rows are listed
when they differ. The fits start both packages from one init and demand
what the reference demands of its own backends: identical assignments,
equal iteration counts, energies within rel 1e-5 and equal ``OpCounter``
charges. k-means++ draws differ between ``jax.random`` and
``torch.Generator``, so its centers are compared with the reference's
draws fed to the port's draw helper, and its quality by seed means.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OpCounter as JaxCounter
from repro.core import fit as jax_fit
from repro.core import kmeanspp_init as jax_kmeanspp_init
from repro.core.api import initialize as jax_initialize
from repro.core.elkan import elkan_step as jax_elkan_step
from repro.core.elkan import fit_elkan as jax_fit_elkan
from repro.core.lloyd import fit_lloyd as jax_fit_lloyd
from repro.kernels.candidate_assign import \
    candidate_assign_rowwise as jax_rowwise
from repro.kernels.candidate_assign import \
    rowwise_grid_steps as jax_rowwise_steps
from repro.kernels.candidate_assign import tiled_grid_steps as jax_tiled_steps
from repro.kernels.distance_argmin import distance_argmin as jax_dargmin
from repro.kernels.ops import assign_nearest_pallas
from repro_torch.core import (OpCounter, elkan_step, fit, fit_elkan,
                              fit_lloyd, kmeanspp_init)
from repro_torch.core import kmeanspp as port_kmeanspp
from repro_torch.kernels import _build
from repro_torch.kernels.candidate_assign import (candidate_assign_rowwise,
                                                  rowwise_grid_steps,
                                                  tiled_grid_steps)
from repro_torch.kernels.distance_argmin import distance_argmin
from repro_torch.kernels.ops import assign_nearest_kernel

COUNTED = ("distances", "inner_products", "additions", "sort_equivalents")


def blobs(seed, n, d, true_k, spread=4.0):
    """GMM stand-in drawn with numpy, power-law component weights."""
    rng = np.random.RandomState(seed)
    mus = rng.randn(true_k, d) * spread
    w = 1.0 / np.arange(1, true_k + 1)
    comp = rng.choice(true_k, n, p=w / w.sum())
    return (mus[comp] + rng.randn(n, d)).astype(np.float32)


def near_ties(x, c, cand=None, tol=1e-6):
    """Rows whose best and second-best squared distance (over all centers,
    or over the row's candidate list ``cand`` (n, kn)) differ by less
    than ``tol`` relative, in the reference's f32 formula."""
    xs = jnp.sum(jnp.asarray(x) ** 2, -1)
    cs = jnp.sum(jnp.asarray(c) ** 2, -1)
    sq = np.asarray(jnp.maximum(xs[:, None] - 2.0 * (jnp.asarray(x)
                                                     @ jnp.asarray(c).T)
                                + cs, 0.0))
    if cand is not None:
        sq = np.take_along_axis(sq, cand, axis=1)
        # an id the list names twice is one candidate, not a tie
        first = ((cand[:, :, None] == cand[:, None, :]).argmax(2)
                 == np.arange(cand.shape[1]))
        sq = np.where(first, sq, np.inf)
    top2 = np.sort(sq, axis=1)[:, :2]
    return top2[:, 1] - top2[:, 0] < tol * top2[:, 0]


def assert_assign_close(got_a, got_d, want_a, want_d, ties, c):
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.sum(c * c, 1))))
    differ = got_a != want_a
    assert ties[differ].all(), np.flatnonzero(differ & ~ties)


def assert_same_charges(cj, ct):
    for key in COUNTED:
        assert getattr(ct, key) == getattr(cj, key), key
    assert ct.total == cj.total


@pytest.mark.parametrize("n,k,d,bn,bk", [
    (256, 128, 32, 64, 64),
    (512, 128, 96, 128, 128),
    (128, 256, 17, 32, 128),     # non-aligned d
    (1024, 64, 256, 256, 64),
])
def test_distance_argmin_matches_pallas(n, k, d, bn, bk):
    """test_kernels.py's sweep shapes."""
    rng = np.random.RandomState(n + k + d)
    x = rng.randn(n, d).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    wa, wd = (np.asarray(v) for v in jax_dargmin(
        jnp.asarray(x), jnp.asarray(c), bn=bn, bk=bk, interpret=True))
    before = _build.launches()["distance_argmin"]
    ga, gd = distance_argmin(torch.tensor(x), torch.tensor(c))
    assert _build.launches()["distance_argmin"] == before   # plain path
    assert ga.dtype == torch.int32 and gd.dtype == torch.float32
    assert_assign_close(ga.numpy(), gd.numpy(), wa, wd, near_ties(x, c), c)


@pytest.mark.parametrize("n,k,d", [(333, 45, 16), (1000, 7, 3),
                                   (77, 130, 200)])
def test_assign_nearest_kernel_ragged(n, k, d):
    """Odd n and k, which the reference pads and the port does not
    (test_assign_nearest_pallas_padding's 333 x 45 first)."""
    rng = np.random.RandomState(n * k)
    x = rng.randn(n, d).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    wa, wd = (np.asarray(v) for v in assign_nearest_pallas(
        jnp.asarray(x), jnp.asarray(c), interpret=True))
    ga, gd = assign_nearest_kernel(torch.tensor(x), torch.tensor(c))
    assert ga.shape == (n,) and gd.shape == (n,)
    assert_assign_close(ga.numpy(), gd.numpy(), wa, wd, near_ties(x, c), c)


def test_distance_argmin_chunks_agree_and_ties_go_first():
    """The plain version's row chunks change nothing, and duplicated
    centers resolve to the first copy."""
    from repro_torch.kernels.ref import distance_argmin_ref
    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(301, 9).astype(np.float32))
    c = torch.tensor(rng.randn(20, 9).astype(np.float32))
    c = torch.cat([c, c])                          # ids 20.. copy 0..
    a1, d1 = distance_argmin_ref(x, c)
    a2, d2 = distance_argmin_ref(x, c, chunk_elems=7 * 40)
    assert torch.equal(a1, a2) and torch.equal(d1, d2)
    assert int(a1.max()) < 20


@pytest.mark.parametrize("n,k,d,kn,bn", [
    (256, 64, 48, 8, 64),
    (512, 128, 16, 16, 128),
    (128, 32, 200, 4, 32),
    (512, 30, 48, 33, 256),         # the reference's default bn; kn > k,
    (768, 32, 20, 33, 256),         # so every list names ids twice
])
def test_candidate_assign_rowwise_matches_pallas(n, k, d, kn, bn):
    """test_kernels.py's rowwise sweep shapes, with skipped blocks, and
    the reference's default bn with lists that name ids twice."""
    rng = np.random.RandomState(n * k)
    nb = n // bn
    x = rng.randn(n, d).astype(np.float32)
    c = rng.randn(k, d).astype(np.float32)
    cand = rng.randint(0, k, (nb, kn)).astype(np.int32)
    skip = (rng.rand(nb) < 0.3).astype(np.int32)
    skip[0], skip[-1] = 0, 1
    prev_a = rng.randint(0, k, n).astype(np.int32)
    prev_d = np.full(n, 7.0, np.float32)
    wa, wd = (np.asarray(v) for v in jax_rowwise(
        jnp.asarray(x), jnp.asarray(c), jnp.asarray(cand), jnp.asarray(skip),
        jnp.asarray(prev_a), jnp.asarray(prev_d), bn=bn, interpret=True))
    ga, gd = candidate_assign_rowwise(
        torch.tensor(x), torch.tensor(c), torch.tensor(cand),
        torch.tensor(skip), torch.tensor(prev_a), torch.tensor(prev_d),
        bn=bn)
    ties = near_ties(x, c, np.repeat(cand, bn, axis=0))
    assert_assign_close(ga.numpy(), gd.numpy(), wa, wd, ties, c)
    skipped = np.repeat(skip != 0, bn)
    assert (ga.numpy()[skipped] == prev_a[skipped]).all()
    assert (gd.numpy()[skipped] == 7.0).all()


def test_rowwise_equals_tiled_on_the_same_lists():
    """K7's plain version picks K1's center from the same lists (the check
    assign_bench makes), bit for bit in the distance."""
    from repro_torch.kernels.candidate_assign import (candidate_assign_tiled,
                                                      candidate_tables,
                                                      pad_candidates)
    rng = np.random.RandomState(5)
    n, k, d, kn, bn = 256, 60, 40, 11, 32
    nb = n // bn
    x = torch.tensor(rng.randn(n, d).astype(np.float32))
    c = torch.tensor(rng.randn(k, d).astype(np.float32))
    table = torch.tensor(rng.randint(0, k, (5, kn)).astype(np.int32))
    rowsel = torch.tensor(rng.randint(0, 5, nb).astype(np.int32))
    skip = torch.zeros(nb, dtype=torch.int32)
    zi, zf = torch.zeros(n, dtype=torch.int32), torch.zeros(n)
    cidx = pad_candidates(table, 8).contiguous()
    ta, td, _ = candidate_assign_tiled(x, *candidate_tables(c, cidx), cidx,
                                       rowsel, skip, zi, zf, zf, bn=bn, bkn=8)
    ra, rd = candidate_assign_rowwise(x, c, table[rowsel.long()], skip, zi,
                                      zf, bn=bn)
    assert torch.equal(ta, ra) and torch.equal(td, rd)


@pytest.mark.parametrize("n,kn,bn,bkn", [(4096, 32, 128, 8),
                                         (1000, 30, 8, 16), (64, 5, 32, 8)])
def test_grid_step_counts_match_reference(n, kn, bn, bkn):
    assert tiled_grid_steps(n, kn, bn, bkn) == jax_tiled_steps(n, kn, bn, bkn)
    assert rowwise_grid_steps(n, kn, bn) == jax_rowwise_steps(n, kn, bn)


def _reference_init(x, k, seed):
    return x[np.random.RandomState(seed).choice(x.shape[0], k,
                                                replace=False)]


@pytest.mark.parametrize("n,d,k,true_k,seed", [(1500, 24, 50, 15, 7),
                                               (800, 8, 12, 6, 1),
                                               (1200, 3, 33, 10, 4)])
def test_fit_lloyd_matches_reference(n, d, k, true_k, seed):
    x = blobs(seed, n, d, true_k)
    init = _reference_init(x, k, seed)
    seen_j, seen_t = [], []
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit_lloyd(jnp.asarray(x), jnp.asarray(init), max_iters=60,
                       counter=cj,
                       callback=lambda it, c, a, e: seen_j.append(
                           np.asarray(a)))
    rt = fit_lloyd(x, init, max_iters=60, counter=ct, device="cpu",
                   callback=lambda it, c, a, e: seen_t.append(a.numpy()))
    assert rt.iterations == rj.iterations == len(seen_t) == len(seen_j)
    for it, (aj, at) in enumerate(zip(seen_j, seen_t)):
        np.testing.assert_array_equal(at, aj, err_msg=f"iteration {it + 1}")
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)
    np.testing.assert_allclose(rt.centers.numpy(), np.asarray(rj.centers),
                               rtol=1e-5, atol=1e-5)
    assert_same_charges(cj, ct)
    assert rt.ops == rj.ops
    assert [h[0] for h in rt.history] == [h[0] for h in rj.history]
    np.testing.assert_allclose([h[1] for h in rt.history],
                               [h[1] for h in rj.history], rtol=1e-5)


def test_fit_lloyd_reads_the_host_once_per_iteration(monkeypatch):
    """The convergence flag and the energy come back in one read: no
    ``.item()``, ``bool()`` or ``int()`` of a tensor inside the loop."""
    x = blobs(2, 600, 6, 5)
    init = _reference_init(x, 9, 2)
    reads = []
    real = torch.Tensor.tolist

    def counting(t):
        reads.append(tuple(t.shape))
        return real(t)
    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    monkeypatch.setattr(torch.Tensor, "item", None)
    monkeypatch.setattr(torch.Tensor, "__bool__", None)
    r = fit_lloyd(x, init, max_iters=40, device="cpu")
    assert reads == [(2,)] * r.iterations


@pytest.mark.parametrize("n,d,k,true_k,seed", [(1500, 24, 50, 15, 7),
                                               (800, 8, 12, 6, 1)])
def test_fit_elkan_matches_reference_and_lloyd(n, d, k, true_k, seed):
    x = blobs(seed, n, d, true_k)
    init = _reference_init(x, k, seed)
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit_elkan(jnp.asarray(x), jnp.asarray(init), max_iters=60,
                       counter=cj)
    rt = fit_elkan(x, init, max_iters=60, counter=ct, device="cpu")
    assert rt.iterations == rj.iterations
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)
    assert_same_charges(cj, ct)
    assert [h[0] for h in rt.history] == [h[0] for h in rj.history]
    np.testing.assert_allclose([h[1] for h in rt.history],
                               [h[1] for h in rj.history], rtol=1e-5)
    # Elkan is an exact acceleration: the port's Lloyd, same assignments
    rl = fit_lloyd(x, init, max_iters=60, device="cpu")
    assert torch.equal(rl.assignment, rt.assignment)
    assert rt.energy == pytest.approx(rl.energy, rel=1e-6)
    assert rt.ops < rl.ops


def test_elkan_step_matches_reference_from_one_state():
    """One Elkan step from the reference's state after two steps, carried
    across: the assignment, the counts and the stale flags are equal, the
    centers and bounds within the tolerances of the module doc."""
    x = blobs(11, 900, 10, 8)
    init = _reference_init(x, 16, 11)
    xj = jnp.asarray(x)
    dist = jnp.sqrt(jnp.maximum(jnp.sum(xj * xj, 1)[:, None]
                                - 2.0 * xj @ jnp.asarray(init).T
                                + jnp.sum(jnp.asarray(init) ** 2, 1), 0.0))
    state = (jnp.asarray(init), jnp.argmin(dist, 1).astype(jnp.int32),
             jnp.min(dist, 1), dist, jnp.ones((900,), bool))
    for _ in range(2):
        *state, _ = jax_elkan_step(xj, *state)
    c, a, u, lb, stale = (np.asarray(v) for v in state)
    want = jax_elkan_step(xj, *state)
    got = elkan_step(torch.tensor(x), torch.tensor(c), torch.tensor(a),
                     torch.tensor(u), torch.tensor(lb), torch.tensor(stale))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(got[5]) == int(want[5][0])
    assert int(got[6]) == int(want[5][1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    # bounds are distances: held in the squared domain, at the squared
    # distances' tolerance (module doc)
    atol = 1e-5 * float(np.max(np.sum(c * c, 1)))
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        np.testing.assert_allclose(g.numpy() ** 2, np.asarray(w) ** 2,
                                   rtol=1e-5, atol=atol)


def _reference_draws(x, centers):
    """The row of ``x`` each reference center was drawn from."""
    eq = (np.asarray(centers)[:, None, :] == x[None, :, :]).all(-1)
    assert (eq.sum(1) == 1).all()
    return eq.argmax(1)


def _inject_draws(monkeypatch, x, idx):
    """Make the port's draw helper return ``idx`` in order, checking at
    each call that the weights it gets are the D^2 weights of the centers
    drawn so far (uniform for the first draw)."""
    calls = []
    xd = x.astype(np.float64)

    def draw(w, generator):
        j = len(calls)
        calls.append(j)
        w = w.double().numpy()
        if j == 0:
            np.testing.assert_array_equal(w, np.ones(x.shape[0]))
        else:
            chosen = xd[idx[:j]]
            want = ((xd[:, None, :] - chosen[None]) ** 2).sum(-1).min(1)
            scale = float((xd ** 2).sum(1).max())
            np.testing.assert_allclose(w, want, rtol=1e-5,
                                       atol=1e-5 * scale)
            assert (w[idx[:j]] <= 1e-5 * scale).all()
        return torch.tensor([int(idx[j])])
    monkeypatch.setattr(port_kmeanspp, "_draw", draw)
    return calls


@pytest.mark.parametrize("n,d,k,seed", [(500, 6, 12, 0), (900, 17, 40, 3)])
def test_kmeanspp_with_reference_draws(monkeypatch, n, d, k, seed):
    x = blobs(seed, n, d, 8)
    cj, ct = JaxCounter(), OpCounter()
    cref = np.asarray(jax_kmeanspp_init(jnp.asarray(x), k,
                                        jax.random.PRNGKey(seed), cj))
    calls = _inject_draws(monkeypatch, x, _reference_draws(x, cref))
    got = kmeanspp_init(torch.tensor(x), k, torch.Generator(), ct)
    assert len(calls) == k
    np.testing.assert_array_equal(got.numpy(), cref)
    assert ct.distances == cj.distances == n * k
    assert ct.total == cj.total


def test_kmeanspp_draws_follow_the_weights():
    """The inverse-CDF draw never picks a zero-weight index, and its
    frequencies follow the weights."""
    g = torch.Generator().manual_seed(0)
    w = torch.tensor([0.0, 1.0, 0.0, 3.0, 0.0])
    got = torch.cat([port_kmeanspp._draw(w, g) for _ in range(4000)])
    counts = torch.bincount(got, minlength=5).numpy()
    assert counts[[0, 2, 4]].sum() == 0
    assert counts[3] / 4000 == pytest.approx(0.75, abs=0.03)
    # duplicated points: every center picked once, then zero weights
    x = torch.tensor([[0.0, 0.0]] * 3 + [[5.0, 5.0]] * 3)
    c = kmeanspp_init(x, 4, torch.Generator().manual_seed(1))
    assert {tuple(r) for r in c.tolist()} == {(0.0, 0.0), (5.0, 5.0)}


def test_lloyd_plus_plus_energy_within_one_percent_of_reference():
    """BENCH_init's criterion: seed-mean energy over 4 seeds, each
    package with its own draws."""
    x = blobs(9, 2000, 16, 24)
    ej, et = [], []
    for s in range(4):
        cj = jax_kmeanspp_init(jnp.asarray(x), 48, jax.random.PRNGKey(s))
        ej.append(jax_fit_lloyd(jnp.asarray(x), cj, max_iters=50).energy)
        ct = kmeanspp_init(torch.tensor(x), 48,
                           torch.Generator().manual_seed(s))
        et.append(fit_lloyd(x, ct, max_iters=50, device="cpu").energy)
    assert abs(np.mean(et) / np.mean(ej) - 1.0) <= 0.01


@pytest.mark.parametrize("method,init", [("lloyd", "random"),
                                         ("lloyd", "kmeanspp"),
                                         ("elkan", "kmeanspp")])
def test_fit_api_matches_reference(monkeypatch, method, init):
    """``fit(method=, init=)`` end to end, with the reference's init draws
    fed to the port (its random init's sample, its k-means++ indices)."""
    x = blobs(4, 1000, 12, 10)
    k, seed = 20, 5
    k_init, _ = jax.random.split(jax.random.PRNGKey(seed))
    c0, _ = jax_initialize(jnp.asarray(x), k, init, k_init, JaxCounter())
    c0 = np.asarray(c0)
    if init == "random":
        monkeypatch.setattr("repro_torch.core.api.random_init",
                            lambda x_, k_, g: torch.tensor(c0))
    else:
        _inject_draws(monkeypatch, x, _reference_draws(x, c0))
    cj, ct = JaxCounter(), OpCounter()
    rj = jax_fit(jnp.asarray(x), k, method=method, init=init,
                 key=jax.random.PRNGKey(seed), max_iters=50, counter=cj)
    rt = fit(x, k, method=method, init=init, max_iters=50, counter=ct,
             device="cpu", profile=True)
    assert rt.iterations == rj.iterations
    np.testing.assert_array_equal(rt.assignment.numpy(),
                                  np.asarray(rj.assignment))
    assert rt.energy == pytest.approx(rj.energy, rel=1e-5)
    assert_same_charges(cj, ct)
    assert rt.profile["total_ops"] == rt.ops == rj.ops


@pytest.mark.parametrize("method", ["lloyd", "elkan"])
def test_fit_return_model_after_baseline(method):
    """``return_model=True`` serves the baseline's fit, as the
    reference's ``done()`` does."""
    x = blobs(8, 600, 8, 6)
    res, model = fit(x, 10, method=method, init="kmeanspp", kn=4,
                     max_iters=30, device="cpu", return_model=True)
    assert torch.equal(model.centers, res.centers)
    a = model.predict(torch.tensor(x[:64]))
    assert a.shape == (64,) and int(a.min()) >= 0 and int(a.max()) < 10
