"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``), on the CPU.

Params come from the reference's ``moe_init`` (or its whole LM's
``init_params``) and cross through ``convert``; tokens are drawn with
numpy from a seed. Tolerances, and why:
- f32: outputs within rtol 1e-5 (atol 1e-5): the same products and sums
  in other orders; expert ids and the tokens each expert keeps equal.
- bf16: outputs within 2e-2 of their largest magnitude: the two
  frameworks round bf16 products and sums at other places
  (``test_torch_lm.py``'s module doc); expert ids equal (the router
  runs in f32 on the same bf16 tokens).
- the load-balance ``aux`` within 1e-6 (f32 means in other orders).
- the GDI router from the reference's draws: within rtol 1e-5 (GDI's
  centers are means summed in other orders, ``test_torch_methods.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import layers as jlayers
from repro_torch.convert import _tree
from repro_torch.models import moe
from repro_torch.models.layers import swiglu

from test_torch_fit import blobs, jax_draws

D, F, E, K = 32, 24, 8, 2
BF16_REL = 2e-2


def _params(n_shared, dtype, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), D, F, E, n_shared,
                      dtype=dtype)
    return p, _tree(jax.tree.map(np.asarray, p), "cpu")


def _tokens(dtype, B=2, S=40, seed=1):
    x = np.random.RandomState(seed).randn(B, S, D).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.tensor(x).to(
        getattr(torch, jnp.dtype(dtype).name))


def _reference_eidx(p, x, k=K):
    xf = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(xf @ p["router"]["w"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


def _both(jp, tp, jx, tx, *, dense=None, **kw):
    """Both packages' (y, aux); ``dense``: a dense residual SwiGLU's
    reference params, carried across."""
    jfn = tfn = None
    if dense is not None:
        td = _tree(jax.tree.map(np.asarray, dense), "cpu")
        jfn = lambda xf: jlayers.swiglu(dense, xf)          # noqa: E731
        tfn = lambda xf: swiglu(td, xf)                     # noqa: E731
    jy, jaux = jmoe.moe_apply(jp, jx, top_k=K, dense_residual_fn=jfn, **kw)
    ty, taux = moe.moe_apply(tp, tx, top_k=K, dense_residual_fn=tfn, **kw)
    return (np.asarray(jy, np.float32), float(jaux),
            ty.float().numpy(), float(taux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shared,residual", [(0, False), (1, False),
                                               (0, True), (1, True)],
                         ids=["experts", "shared", "residual",
                              "shared+residual"])
def test_moe_apply_matches_reference(dtype, n_shared, residual):
    """Top-2 of 8 experts with the reference's capacity, alone, with a
    shared expert, with a dense residual and with both."""
    jd = getattr(jnp, dtype)
    jp, tp = _params(n_shared, jd)
    jx, tx = _tokens(jd)
    dense = jlayers.swiglu_init(jax.random.PRNGKey(9), D, 16, jd) \
        if residual else None
    jy, jaux, ty, taux = _both(jp, tp, jx, tx, dense=dense)
    assert ty.shape == jy.shape == (2, 40, D)
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(ty - jy).max() <= BF16_REL * np.abs(jy).max()
    assert abs(taux - jaux) <= 1e-6
    r = moe.route(tp["router"]["w"], tx.reshape(-1, D), top_k=K)
    np.testing.assert_array_equal(r["eidx"].numpy(), _reference_eidx(jp, jx))


def test_capacity_overflow_drops_the_reference_pairs():
    """A router skewed to expert 0 at capacity factor 0.5: C = 8 slots an
    expert for 80 (token, k) pairs, so expert 0 overflows. The stable
    sort keeps its lowest token ids; the reference drops the same pairs:
    outputs equal (f32), and the tokens left with no expert at all are
    the rows both packages return as zeros."""
    jp, tp = _params(0, jnp.float32)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 0] += 0.6                      # most tokens rank expert 0 first
    jp["router"]["w"] = jnp.asarray(w)
    tp["router"]["w"] = torch.tensor(w)
    jx, tx = _tokens(jnp.float32, S=20, seed=3)
    tx = tx + 1.0                      # every token's sum is positive
    jx = jx + 1.0
    jy, _, ty, _ = _both(jp, tp, jx, tx, capacity_factor=0.5)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    r = moe.route(tp["router"]["w"], tx.reshape(-1, D), top_k=K,
                  capacity_factor=0.5)
    assert r["C"] == 8
    dropped = int((~r["kept"]).sum())
    assert dropped > 0
    assert int((r["slot_tok"][0] < 40).sum()) == 8   # expert 0 is full
    # expert 0 keeps its 8 lowest token ids among those that chose it
    chose0 = sorted(set(np.nonzero(r["eidx"].numpy() == 0)[0].tolist()))
    assert len(chose0) > 8
    assert r["slot_tok"][0].tolist() == chose0[:8]
    none = (r["pair_slot"] == E * r["C"]).all(1).numpy()
    zero_ref = (np.abs(jy.reshape(-1, D)) == 0).all(1)
    np.testing.assert_array_equal(none, zero_ref)
    assert none.any()


def _stepped_reference(jp, jx, dense=None, **kw):
    """The reference's ``moe_apply`` called once for each position's B
    tokens, as its serve prefill steps its decode: (y (B, S, d), the
    calls' aux)."""
    fn = (lambda xf: jlayers.swiglu(dense, xf)) if dense is not None \
        else None
    outs = [jmoe.moe_apply(jp, jx[:, s:s + 1], top_k=K,
                           dense_residual_fn=fn, **kw)
            for s in range(jx.shape[1])]
    return (np.concatenate([np.asarray(y, np.float32) for y, _ in outs],
                           axis=1), [float(a) for _, a in outs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_shared,residual", [(0, False), (1, True)],
                         ids=["experts", "shared+residual"])
def test_moe_apply_stepped_matches_the_reference_steps(dtype, n_shared,
                                                       residual):
    """``moe_apply_stepped`` over (2, 40) tokens against 40 calls of the
    reference's ``moe_apply`` on each position's 2 tokens (C = 8 a call,
    so nothing is dropped): outputs at the module's tolerances, ``aux``
    the mean of the calls' within 1e-6."""
    jd = getattr(jnp, dtype)
    jp, tp = _params(n_shared, jd)
    jx, tx = _tokens(jd)
    dense = jlayers.swiglu_init(jax.random.PRNGKey(9), D, 16, jd) \
        if residual else None
    jy, jaux = _stepped_reference(jp, jx, dense)
    tfn = None
    if dense is not None:
        td = _tree(jax.tree.map(np.asarray, dense), "cpu")
        tfn = lambda xf: swiglu(td, xf)                     # noqa: E731
    ty, taux = moe.moe_apply_stepped(tp, tx, top_k=K, dense_residual_fn=tfn)
    ty = ty.float().numpy()
    assert ty.shape == jy.shape == (2, 40, D)
    if dtype == "float32":
        np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(ty - jy).max() <= BF16_REL * np.abs(jy).max()
    assert abs(float(taux) - np.mean(jaux)) <= 1e-6


def test_moe_apply_stepped_drops_what_each_step_drops():
    """24 tokens a position at capacity factor 0.5: C = 8 a step for 48
    pairs, and a router skewed to expert 0, so each position's call
    drops pairs. The stepped pass keeps each position's 8 lowest batch
    rows to an expert, as the reference's calls do (f32, rtol 1e-5); the
    one chunked call over all the tokens would give another result."""
    jp, tp = _params(0, jnp.float32)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 0] += 0.6
    jp["router"]["w"] = jnp.asarray(w)
    tp["router"]["w"] = torch.tensor(w)
    jx, tx = _tokens(jnp.float32, B=24, S=3, seed=3)
    jx, tx = jx + 1.0, tx + 1.0
    jy, _ = _stepped_reference(jp, jx, capacity_factor=0.5)
    ty, _ = moe.moe_apply_stepped(tp, tx, top_k=K, capacity_factor=0.5)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-5, atol=1e-5)
    assert moe.capacity(24, E, K, 0.5) == 8
    eidx = _reference_eidx(jp, jx).reshape(24, 3, K)
    assert ((eidx == 0).any(-1).sum(0) > 8).all()   # every step overflows
    chunked, _ = moe.moe_apply(tp, tx, top_k=K, capacity_factor=0.5)
    assert np.abs(chunked.numpy() - jy).max() > 1e-3


def test_top_k_tie_goes_to_the_lower_expert():
    """Two equal router columns that every token ranks first and second:
    both packages list the lower id first, and agree."""
    jp, tp = _params(0, jnp.float32)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 3] = w[:, 6] = 3.0
    jp["router"]["w"] = jnp.asarray(w)
    tp["router"]["w"] = torch.tensor(w)
    jx, tx = _tokens(jnp.float32, seed=4)
    jx, tx = jnp.abs(jx), tx.abs()
    r = moe.route(tp["router"]["w"], tx.reshape(-1, D), top_k=K)
    assert (r["eidx"][:, 0] == 3).all() and (r["eidx"][:, 1] == 6).all()
    np.testing.assert_array_equal(r["eidx"].numpy(), _reference_eidx(jp, jx))
    jy, jaux, ty, taux = _both(jp, tp, jx, tx)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    assert abs(taux - jaux) <= 1e-6


def test_combine_adds_in_ascending_expert_id():
    """Top-3 in bf16: each token's kept outputs are gathered for the
    combine in ascending expert id (the reference's scatter order),
    whatever order top-k ranked them in, each slot holding its token and
    gate; the layer agrees with the reference's top-3."""
    jp, tp = _params(0, jnp.bfloat16)
    jx, tx = _tokens(jnp.bfloat16, seed=5)
    r = moe.route(tp["router"]["w"], tx.reshape(-1, D), top_k=3,
                  capacity_factor=4.0)
    C, ids, slots = r["C"], r["eidx"], r["pair_slot"]
    assert (slots < E * C).all()                       # nothing dropped
    assert (ids[:, 0] > ids[:, 1]).any()               # ranks not by id
    assert torch.equal(slots // C, torch.sort(ids, 1).values)
    tok = torch.arange(ids.shape[0])[:, None].expand(-1, 3)
    assert torch.equal(r["slot_tok"].reshape(-1)[slots], tok)
    assert torch.equal(r["slot_gate"].reshape(-1)[slots],
                       torch.gather(r["gates"], 1, torch.argsort(ids, 1)))
    jy, _ = jmoe.moe_apply(jp, jx, top_k=3, capacity_factor=4.0)
    ty, _ = moe.moe_apply(tp, tx, top_k=3, capacity_factor=4.0)
    jy = np.asarray(jy, np.float32)
    assert np.abs(ty.float().numpy() - jy).max() <= BF16_REL * np.abs(
        jy).max()


def test_gdi_router_init_with_reference_draws():
    """The GDI router from the reference's round draws: (d, E) with unit
    columns, within rtol 1e-5 of the reference's."""
    n, d, E_ = 1024, 16, 8
    x = blobs(7, n, d, 12)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jmoe.gdi_router_init(jnp.asarray(x), E_, key))
    got = moe.gdi_router_init(torch.tensor(x), E_, device="cpu",
                              draws=jax_draws(key, n, 3))
    assert tuple(got.shape) == (d, E_) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(got.double(), dim=0),
                               1.0, rtol=1e-6)


def test_moe_entry_points_default_to_the_card():
    """Without a card the GDI router raises unless asked for the CPU;
    ``moe_apply`` runs where its tensors lie."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x = torch.tensor(blobs(2, 64, 8, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.gdi_router_init(x, 4)
    assert moe.gdi_router_init(x, 4, device="cpu").shape == (8, 4)


@pytest.mark.parametrize("T,E_,k,cf,want", [(40, 8, 2, 1.25, 16),
                                            (2, 128, 2, 1.25, 8),
                                            (65536, 128, 2, 1.25, 1280),
                                            (100, 8, 3, 1.0, 40)])
def test_capacity_is_the_reference_expression(T, E_, k, cf, want):
    C = int(cf * k * T / E_ + 0.5)
    assert moe.capacity(T, E_, k, cf) == max(8, -(-C // 8) * 8) == want
