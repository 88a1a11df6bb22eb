"""One correctly rounded value per (point, center) pair, and sums in a
fixed order (ROADMAP §3 entries 7 and 8), on the CPU.

``ref.exact_cross`` and ``ref.exact_sqnorm`` return RN_f32 of the exact
sum of the exact f32 products (ties to even, a zero as +0), held here
against an independent ``fractions.Fraction`` oracle on inputs whose f64
sums round wrongly or depend on their order: the example of the issue,
exact midpoints, wide exponent spreads (a hypothesis property) and the
rounding fixture; the value must not change under any permutation of d.
The plain versions of K1, K5 and K7 then agree with each other on those
inputs. K3's forward fold is modelled on the tiles its kernel walks: the
prefix a tile publishes is the same whatever predecessor its look-back
stops at, and it is the plain version's. The ordered block sums give the
CPU's row-order scatter-add.
"""
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.data import rounding_fixture
from repro_torch.kernels import exact_round, ref
from repro_torch.kernels.ops import group_by_cluster_device, segment_sum
from repro_torch.kernels.segment_sum import segment_sum_blocks

F32_MAX = Fraction(np.finfo(np.float32).max.item())
HALF_ULP_MAX = Fraction(2) ** 103          # half an ulp at the top binade


def _rn_f32(v: Fraction) -> float:
    """The f32 nearest the rational v, ties to the even significand: the
    candidates around a first guess, compared exactly."""
    if v == 0:
        return 0.0
    if abs(v) >= F32_MAX + HALF_ULP_MAX:
        return math.copysign(math.inf, v)
    guess = np.float32(float(v))
    with np.errstate(over="ignore"):
        cands = {guess, np.nextafter(guess, np.float32(np.inf)),
                 np.nextafter(guess, np.float32(-np.inf))}
    cands = [c for c in cands if np.isfinite(c)]
    best = min(abs(Fraction(c.item()) - v) for c in cands)
    near = [c for c in cands if abs(Fraction(c.item()) - v) == best]
    if len(near) > 1:
        near = [c for c in near if int(c.view(np.uint32)) % 2 == 0]
    out = near[0].item()
    return out if out != 0 else 0.0


def _oracle_dot(a, b) -> float:
    return _rn_f32(sum((Fraction(float(u)) * Fraction(float(v))
                        for u, v in zip(a, b)), Fraction(0)))


def _f32(*v) -> torch.Tensor:
    return torch.tensor(np.array(v, dtype=np.float32))


def test_the_example_rounds_up():
    """(1, 2^-24, 2^-80) . (1, 1, 1): every f64 order loses 2^-80 and
    lands on the midpoint above 1, which ties down to 1; the exact sum is
    just above it, so the value is 1 + 2^-23."""
    x = _f32(1.0, 2.0 ** -24, 2.0 ** -80)[None]
    c = torch.ones(3, 1)
    assert float((x.double() @ c.double()).float()) == 1.0
    for perm in ([0, 1, 2], [2, 1, 0], [1, 2, 0]):
        got = ref.exact_cross(x[:, perm], c[perm])
        assert float(got) == 1.0 + 2.0 ** -23
    sq = ref.exact_sqnorm(_f32(1.0, 2.0 ** -12, 2.0 ** -40)[None])
    assert float(sq) == 1.0 + 2.0 ** -23


@pytest.mark.parametrize("terms,want", [
    ((1.0, 2.0 ** -24), 1.0),                              # tie to even: down
    ((1.0 + 2.0 ** -23, 2.0 ** -24), 1.0 + 2.0 ** -22),    # tie to even: up
    ((-1.0, -(2.0 ** -24)), -1.0),
    ((3.0, -3.0), 0.0)])                                   # a zero is +0
def test_exact_midpoints_tie_to_even(terms, want):
    x = _f32(*terms)[None]
    got = float(ref.exact_cross(x, torch.ones(len(terms), 1)))
    assert got == want and math.copysign(1.0, got) == math.copysign(1.0,
                                                                     want)


@pytest.mark.parametrize("x,c,want", [
    ((2.0 ** -75,), (2.0 ** -75,), 0.0),           # half the least subnormal
    ((2.0 ** -75, 2.0 ** -75), (2.0 ** -75, 2.0 ** -76), 2.0 ** -149),
    ((3 * 2.0 ** -76,), (2.0 ** -74,), 2.0 ** -148)])  # 1.5 quanta: to even
def test_subnormal_results_round_to_the_quantum(x, c, want):
    got = float(ref.exact_cross(_f32(*x)[None], _f32(*c)[:, None]))
    assert got == want and math.copysign(1.0, got) == 1.0


def test_rn_f32_of_int_subnormals_and_overflow():
    """The integer rounding behind the fallback, against the oracle."""
    cases = [(1, -150), (3, -151), (1, -151), (5, -152), (2 ** 24 - 1, 104),
             (2 ** 25 - 1, 103), (-(2 ** 24 + 1), -30), (2 ** 24 + 3, -30),
             (7, -200), (2 ** 60 + 1, -100)]
    for v, e in cases:
        want = _rn_f32(Fraction(v) * Fraction(2) ** e)
        assert ref.rn_f32_of_int(v, e) == want, (v, e)


def _wide(rng, *shape, lo=-60, hi=40):
    return (rng.choice([-1.0, 1.0], shape) * (1.0 + rng.rand(*shape))
            * 2.0 ** rng.randint(lo, hi, shape)).astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_exact_cross_and_sqnorm_match_the_oracle(seed):
    """Rows over eighty binades and with cancellation: every element is
    RN_f32 of its exact sum."""
    rng = np.random.RandomState(seed)
    a = _wide(rng, 6, 33)
    b = _wide(rng, 33, 5)
    b[:, 0] = -a[0]                       # column 0 cancels row 0 exactly
    got = ref.exact_cross(torch.tensor(a), torch.tensor(b)).numpy()
    for i in range(6):
        for j in range(5):
            assert got[i, j] == _oracle_dot(a[i], b[:, j]), (i, j)
    sq = ref.exact_sqnorm(torch.tensor(a)).numpy()
    for i in range(6):
        assert sq[i] == _oracle_dot(a[i], a[i])


@pytest.mark.parametrize("seed", range(3))
def test_exact_rowdot_matches_the_oracle(seed):
    """GDI's projections: row i against row idx[i] of another table, over
    eighty binades and with cancellation; every element is the oracle's,
    ``exact_cross``'s and the same under a permutation of d."""
    rng = np.random.RandomState(seed)
    x = _wide(rng, 9, 21)
    y = _wide(rng, 4, 21)
    idx = rng.randint(0, 4, 9)
    x[0] = -y[idx[0]]                         # row 0 cancels to -|y|^2
    got = ref.exact_rowdot(torch.tensor(x), torch.tensor(y),
                           torch.tensor(idx)).numpy()
    for i in range(9):
        assert got[i] == _oracle_dot(x[i], y[idx[i]]), i
    cross = ref.exact_cross(torch.tensor(x), torch.tensor(y).T).numpy()
    np.testing.assert_array_equal(got, cross[np.arange(9), idx])
    perm = rng.permutation(21)
    np.testing.assert_array_equal(
        ref.exact_rowdot(torch.tensor(x[:, perm]), torch.tensor(y[:, perm]),
                         torch.tensor(idx)).numpy(), got)
    np.testing.assert_array_equal(
        exact_round.exact_rowdot(torch.tensor(x), torch.tensor(y),
                                 torch.tensor(idx)).numpy(), got)


hypothesis = pytest.importorskip("hypothesis")
st = hypothesis.strategies


@hypothesis.settings(max_examples=60, deadline=None)
@hypothesis.given(
    st.lists(st.tuples(st.integers(-2 ** 24 + 1, 2 ** 24 - 1),
                       st.integers(-120, 100),
                       st.integers(-2 ** 24 + 1, 2 ** 24 - 1),
                       st.integers(-120, 100)), min_size=1, max_size=24))
def test_exact_cross_property_wide_exponent_spreads(terms):
    """Any f32 vectors with exponents spread over 220 binades: the value
    is the oracle's, under any order of the terms."""
    a = np.array([np.float32(m * 2.0 ** e) for m, e, _, _ in terms])
    b = np.array([np.float32(m * 2.0 ** e) for _, _, m, e in terms])
    want = _oracle_dot(a, b)
    for perm in (np.arange(len(a)), np.arange(len(a))[::-1],
                 np.random.RandomState(len(a)).permutation(len(a))):
        got = float(ref.exact_cross(torch.tensor(a[perm])[None],
                                    torch.tensor(b[perm])[:, None]))
        assert got == want or (math.isnan(got) and math.isnan(want))


@pytest.mark.parametrize("d", [16, 40, 200])
def test_rounding_fixture_and_permutations(d):
    """The fixture's own-center products are the midpoint above m plus 1.5
    f64 ulps: the value is the oracle's, and no permutation of d changes
    any element of ``exact_cross`` or ``exact_sqnorm``."""
    x, c, a = rounding_fixture(48, 12, d, seed=d, device="cpu")
    cross = ref.exact_cross(x, c.T)
    sq = ref.exact_sqnorm(x)
    own = cross[torch.arange(48), a.long()]
    for i in range(48):
        assert float(own[i]) == _oracle_dot(x[i].numpy(),
                                            c[a[i]].numpy())
    # the f64 sum in index order rounds some of them the other way
    seq = torch.cumsum(x.double() * c[a.long()].double(), dim=1)[:, -1]
    assert not torch.equal(seq.float(), own)
    for seed in range(3):
        perm = torch.tensor(np.random.RandomState(seed).permutation(d))
        assert torch.equal(ref.exact_cross(x[:, perm], c[:, perm].T), cross)
        assert torch.equal(ref.exact_sqnorm(x[:, perm]), sq)
    assert torch.equal(exact_round.exact_cross(x, c.T), cross)
    assert torch.equal(exact_round.exact_sqnorm(x), sq)


@pytest.mark.parametrize("source", ["fixture", "wide"])
def test_plain_versions_of_k1_k5_k7_agree(source):
    """K5's, K7's and K1's plain versions, given every center as the
    candidate list, pick the same center at the same distance on rows
    where f64 sums in different orders would round apart."""
    if source == "fixture":
        x, c, _ = rounding_fixture(64, 16, 96, seed=3, device="cpu")
    else:
        rng = np.random.RandomState(5)
        x = torch.tensor(_wide(rng, 64, 48, lo=-8, hi=8))
        c = torch.tensor(_wide(rng, 16, 48, lo=-8, hi=8))
    n, k = x.shape[0], c.shape[0]
    bn = 8
    a5, d5 = ref.distance_argmin_ref(x, c)
    cand = torch.arange(k, dtype=torch.int32).repeat(n // bn, 1)
    skip = torch.zeros(n // bn, dtype=torch.int32)
    prev_a = torch.zeros(n, dtype=torch.int32)
    prev_d = torch.zeros(n)
    a7, d7 = ref.candidate_assign_ref(x, c, cand, skip, prev_a, prev_d, bn)
    from repro_torch.kernels.candidate_assign import candidate_tables
    cidx = torch.arange(k, dtype=torch.int32)[None]
    ctab, csqtab = candidate_tables(c, cidx)
    rowsel = torch.zeros(n // bn, dtype=torch.int32)
    a1, d1, _ = ref.candidate_assign_tiled_ref(x, ctab, csqtab, cidx, rowsel,
                                               skip, prev_a, prev_d, prev_d,
                                               bn)
    assert torch.equal(a5, a7) and torch.equal(a5, a1)
    assert torch.equal(d5, d7) and torch.equal(d5, d1)


def _k3_forward_fold(lanes, b2s, bn, tr, stops):
    """K3's arithmetic, tile by tile, in numpy: f64 running sums down each
    tile of TR rows (the aggregate records are their totals), f64
    inclusive prefixes published as a left fold from the nearest prefix
    the look-back met (``stops[t]`` tiles back, clipped at the segment's
    first tile), and each row's value the tile's exclusive prefix plus
    its running sum, rounded once to f32."""
    r, d = lanes.shape
    nt = r // tr
    agg = np.zeros((nt, d), np.float64)
    for t in range(nt):
        acc = np.zeros(d, np.float64)
        for row in range(t * tr, (t + 1) * tr):
            acc = acc + lanes[row]
        agg[t] = acc
    first = np.zeros(nt, np.int64)
    for t in range(nt):
        blk = t * tr // bn
        starts = t * tr % bn == 0 and (blk == 0 or b2s[blk] != b2s[blk - 1])
        first[t] = t if starts else first[t - 1]
    prefix = np.zeros((nt, d), np.float64)
    out = np.zeros((r, d), np.float32)
    for t in range(nt):
        excl = np.zeros(d, np.float64)
        if first[t] != t:
            j = max(first[t], t - 1 - stops[t])          # the prefix met
            excl = prefix[j].copy()
            for u in range(j + 1, t):
                excl = excl + agg[u]
        prefix[t] = excl + agg[t]
        run = np.zeros(d, np.float64)
        for row in range(t * tr, (t + 1) * tr):
            run = run + lanes[row]
            out[row] = (excl + run).astype(np.float32)
    return out


def test_k3_forward_fold_is_the_same_wherever_the_walk_stops():
    """Look-backs that stop at different predecessors publish the same
    prefixes bit for bit (a walk that adds the aggregates nearest first
    does not), and every one gives K3's plain version bit for bit: the
    card's K3 and the CPU's plain version share one arithmetic."""
    rng = np.random.RandomState(0)
    n, d, k, bn = 600, 5, 3, 8
    x = torch.tensor((rng.randn(n, d) * 10.0 ** rng.randint(-3, 4, (n, 1)))
                     .astype(np.float32))
    a = torch.tensor(rng.randint(0, k, n).astype(np.int32))
    perm, b2s = group_by_cluster_device(a, k, bn)
    xg = x[perm.clamp(min=0).long()]
    w = (perm >= 0).float()
    tr = ref.scan_tile_rows(bn, d)
    assert tr == 8
    lanes = torch.cat([xg * w[:, None], (w * ref.exact_sqnorm(xg))[:, None],
                       w[:, None]], dim=1).double().numpy()
    nt = xg.shape[0] // tr
    runs = [_k3_forward_fold(lanes, b2s.numpy(), bn, tr, stops)
            for stops in (np.zeros(nt, np.int64), np.full(nt, 10 ** 6),
                          rng.randint(0, 7, nt))]
    for other in runs[1:]:
        np.testing.assert_array_equal(runs[0], other)
    want = ref.segmented_scan_ref(xg, w, b2s, bn)
    np.testing.assert_array_equal(runs[0][:, :d], want[0].numpy())
    np.testing.assert_array_equal(runs[0][:, d], want[1].numpy())
    np.testing.assert_array_equal(runs[0][:, d + 1], want[2].numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_sum_blocks_is_the_row_order_scatter_add(weighted):
    """Over a cluster-grouped layout, the ordered block sums equal the
    point-order ``segment_sum`` bit for bit (each cluster's rows are listed
    in row order), the count lane included."""
    rng = np.random.RandomState(2)
    n, d, k, bn = 700, 9, 11, 8
    x = torch.tensor((rng.randn(n, d) * 10.0 ** rng.randint(-4, 5, (n, 1)))
                     .astype(np.float32))
    a = torch.tensor(rng.randint(0, k, n).astype(np.int32))
    perm, b2s = group_by_cluster_device(a, k, bn)
    if weighted:
        wp = torch.tensor(rng.rand(n).astype(np.float32))
        w = torch.where(perm >= 0, wp[perm.clamp(min=0).long()], 0.0)
        xs, cs = x * wp[:, None], wp
    else:
        w, xs, cs = None, x, torch.ones(n)
    sums, cnt = segment_sum_blocks(x, b2s, k, bn, w=w, perm=perm)
    assert torch.equal(sums, segment_sum(xs, a, k))
    assert torch.equal(cnt, segment_sum(cs, a, k))
