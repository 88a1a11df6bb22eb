"""The port's checkpoints (``repro_torch.checkpoint`` and
``KMeansModel.save``/``restore``) against the JAX reference's, on the CPU.

The checkpointer tests are ``tests/test_checkpoint_ft.py``'s run against
the port's module (trees of tensors), the model tests its int8 round
trip, torn file and scale mismatch, and ``test_model_predict``'s and
``test_streaming``'s round trips. Both packages write one format, so a
checkpoint written by either is restored by the other: every leaf equal
(the same shapes, types and bits), and the two models then take the same
``partial_fit`` batches with equal assignments and bit-equal arenas,
statistics and clocks, the tolerances of ``tests/test_torch_stream.py``
(``fold_both``) applying to the router and the charges. The restore
places the tensors on the device it is given; the card is the default,
and without one the restore raises instead of falling back.

Tolerances: none beyond ``fold_both``'s; leaves and restored states are
compared with ``==``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.core import assign_nearest, fit_k2means
from repro.core import fit as jax_fit
from repro.core.model import KMeansModel as JaxModel
from repro.data import gmm_blobs
from repro_torch.checkpoint import (AsyncCheckpointer, CheckpointCorruptError,
                                    all_steps, latest_step, load_meta,
                                    restore_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.convert import model_from_reference
from repro_torch.core import KMeansModel

from test_resident_layout import check_layout
from test_torch_stream import _batches, _windowed_model, fold_both

KEY = jax.random.PRNGKey(0)


def _state():
    return {"w": torch.arange(6.0).reshape(2, 3),
            "n": torch.tensor(3, dtype=torch.int32)}


# -- the checkpointer (test_checkpoint_ft.py's) ---------------------------------

def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, _state())
    assert latest_step(d) == 7 and all_steps(d) == [7]
    got = restore_checkpoint(d, 7, _state(), device="cpu")
    assert torch.equal(got["w"], _state()["w"])
    assert got["n"].dtype == torch.int32 and int(got["n"]) == 3


def test_checkpoint_atomic_overwrite(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 5, _state())
    save_checkpoint(d, 5, {"w": torch.ones((2, 3)) * 9,
                           "n": torch.tensor(9, dtype=torch.int32)})
    got = restore_checkpoint(d, 5, _state(), device="cpu")
    assert float(got["w"][0, 0]) == 9.0
    assert sorted(os.listdir(d)) == ["step-%09d" % 5]


def test_async_checkpointer_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = AsyncCheckpointer(d, keep=2)
    for s in (10, 20, 30, 40):
        ck.save(s, _state())
    ck.wait()
    assert all_steps(d) == [30, 40]
    got = restore_checkpoint(d, 40, _state(), device="cpu")
    assert torch.equal(got["w"], _state()["w"])


def test_latest_step_skips_truncated(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 4, _state())
    save_checkpoint(d, 8, _state())
    npz = os.path.join(d, "step-%09d" % 8, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.warns(UserWarning, match="skipping checkpoint step 8"):
        assert latest_step(d) == 4
    reason = verify_checkpoint(d, 8)
    assert reason is not None and "arrays.npz" in reason
    with pytest.raises(CheckpointCorruptError, match="step 8"):
        restore_checkpoint(d, 8, _state(), device="cpu")


def test_latest_step_skips_missing_meta(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 3, _state())
    os.remove(os.path.join(d, "step-%09d" % 3, "meta.json"))
    with pytest.warns(UserWarning, match="missing meta.json"):
        assert latest_step(d) is None
    with pytest.raises(CheckpointCorruptError, match="meta.json"):
        load_meta(d, 3)


def test_flatten_order_is_jax_tree_util_order():
    """NamedTuple fields in order, dict keys sorted, None no leaf, bf16
    stored as f32 and restored as bf16; shapes checked on restore."""
    from repro_torch.core.engine import K2State
    tree = {"b": [torch.zeros(1), None, (torch.ones(2), 3)],
            "a": K2State(*(torch.full((1,), float(i)) for i in range(5)),
                         None),
            "c": torch.tensor([1.5], dtype=torch.bfloat16)}
    leaves, _ = _flatten(tree)
    jleaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, {
            "b": [np.zeros(1), None, (np.ones(2), 3)],
            "a": tuple(np.full((1,), float(i)) for i in range(5)) + (None,),
            "c": np.array([1.5], np.float32)}))
    assert len(leaves) == len(jleaves) == 9
    for got, want in zip(leaves, jleaves):
        assert np.array_equal(np.asarray(got.float() if isinstance(
            got, torch.Tensor) else got), want)


def test_bf16_leaf_and_shape_mismatch(tmp_path):
    d = str(tmp_path / "ckpt")
    t = {"x": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    save_checkpoint(d, 1, t)
    with np.load(os.path.join(d, "step-%09d" % 1, "arrays.npz")) as z:
        assert z["leaf_0"].dtype == np.float32
    got = restore_checkpoint(d, 1, t, device="cpu")
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], t["x"])
    with pytest.raises(CheckpointCorruptError, match="shape"):
        restore_checkpoint(d, 1, {"x": torch.zeros(3)}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    """``device=None`` means ``cuda``: with no card the restore raises
    rather than land on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _state())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(d, 1, _state())
    jm, pm = _windowed_model()
    pm.save(str(tmp_path / "m"), step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeansModel.restore(str(tmp_path / "m"))


# -- the model ------------------------------------------------------------

def _int8_model():
    x = gmm_blobs(jax.random.PRNGKey(2), 256, 8, true_k=8)
    init = x[:8]
    a0 = assign_nearest(x, init).astype(jnp.int32)
    res = fit_k2means(x, init, a0, kn=4, max_iters=6)
    jm = JaxModel.from_result(res, kn=4, precision="int8")
    return jm, model_from_reference(jm, device="cpu"), np.asarray(x)


def test_int8_model_checkpoint_roundtrip(tmp_path):
    """Precision and scales ride the checkpoint; the restored int8 model
    predicts as the saved one, and the reference restores it too."""
    _, pm, x = _int8_model()
    d = str(tmp_path / "ckpt")
    pm.save(d, step=3)
    got = KMeansModel.restore(d, device="cpu")
    assert got.precision == "int8"
    assert torch.equal(got.predict(x[:64]), pm.predict(x[:64]))
    jm = JaxModel.restore(d)
    assert jm.precision == "int8"
    assert (np.asarray(jm.predict(jnp.asarray(x[:64])))
            == pm.predict(x[:64]).numpy()).all()


def test_int8_model_checkpoint_torn_file(tmp_path):
    _, pm, _ = _int8_model()
    d = str(tmp_path / "ckpt")
    pm.save(d, step=3)
    npz = os.path.join(d, "step-%09d" % 3, "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointCorruptError, match="step 3"):
        KMeansModel.restore(d, 3, device="cpu")


def test_int8_model_checkpoint_scale_mismatch(tmp_path):
    _, pm, _ = _int8_model()
    d = str(tmp_path / "ckpt")
    tree = pm._tree()
    tree["qscale"]["c"] = tree["qscale"]["c"] * 1.5
    save_checkpoint(d, 4, tree, extra_meta={"kmeans_model": pm._config()})
    with pytest.raises(CheckpointCorruptError, match="quantization scales"):
        KMeansModel.restore(d, 4, device="cpu")


def _leaves_np(tree):
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for v in _flatten(tree)[0]]


def _assert_same_leaves(a, b):
    la, lb = _leaves_np(a), _leaves_np(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert (x == y).all(), i


def _reference_tree(jm):
    return jax.tree_util.tree_map(np.asarray, jm._tree())


def test_leaf_order_and_count_match_the_reference():
    """f32: 25 leaves, int8: 27, leaf i the same array in both."""
    jm, pm = _windowed_model(drift_guard=True, half_life=4.0)
    for xb in _batches(5, 6, 32, pm.d):
        jm.partial_fit(jnp.asarray(xb))
        pm.partial_fit(xb)
    jleaves = jax.tree_util.tree_leaves(_reference_tree(jm))
    pleaves = _leaves_np(pm._tree())
    assert len(pleaves) == len(jleaves) == 25
    for i, (x, y) in enumerate(zip(pleaves, jleaves)):
        assert x.shape == np.shape(y) and x.dtype == np.asarray(y).dtype, i
    c_j = {k: v for k, v in jm._config().items() if k != "backend"}
    c_t = {k: v for k, v in pm._config().items() if k != "backend"}
    assert c_j == c_t and pm._config()["backend"] == "pallas"
    _, pm8, _ = _int8_model()
    assert len(_leaves_np(pm8._tree())) == 27


def test_model_checkpoint_roundtrip(tmp_path):
    """test_model_predict's: every array, the config and the stream
    position survive; the restored model predicts and folds as the saved
    one."""
    allx = gmm_blobs(KEY, 2048 + 512, 16, true_k=24)
    x, q = np.asarray(allx[:2048]), np.asarray(allx[2048:])
    _, jm = jax_fit(jnp.asarray(x), 24, kn=8, max_iters=15, key=KEY,
                    return_model=True)
    pm = model_from_reference(dataclasses.replace(jm, backend="pallas",
                                                  interpret=True),
                              device="cpu")
    d = str(tmp_path / "model_ckpt")
    pm.save(d, step=5)
    m2 = KMeansModel.restore(d, device="cpu")
    assert (m2.n_rows, m2.batches_seen, m2.kn, m2.bn) == \
        (pm.n_rows, pm.batches_seen, pm.kn, pm.bn)
    _assert_same_leaves(m2._tree(), pm._tree())
    assert torch.equal(m2.predict(q), pm.predict(q))
    a1 = pm.partial_fit(q[:64])
    a2 = m2.partial_fit(q[:64])
    assert torch.equal(a1, a2)
    _assert_same_leaves(m2._tree(), pm._tree())
    check_layout(m2.state.pid, m2.state.b2c, m2.state.fill,
                 m2.state.openb, m2.a_pts, m2.bn)


def test_checkpoint_roundtrip_stream_state(tmp_path):
    """test_streaming's: the stream config, the epoch and motion clocks
    and the counters survive, and the restored model's trajectory is the
    saved one's, bit for bit."""
    jm, pm = _windowed_model(half_life=4.0, count_floor=0.1,
                             drift_guard=True)
    for xb in _batches(5, 6, 32, pm.d):
        pm.partial_fit(xb)
    pm.save(str(tmp_path), step=3)
    r = KMeansModel.restore(str(tmp_path), device="cpu")
    assert (r.window, r.half_life, r.count_floor, r.drift_guard) == \
        (pm.window, pm.half_life, pm.count_floor, pm.drift_guard)
    assert (r.rows_streamed, r.evicted_rows) == (pm.rows_streamed,
                                                 pm.evicted_rows)
    assert torch.equal(r.e_pts, pm.e_pts)
    assert torch.equal(r.c_motion, pm.c_motion)
    for xb in _batches(6, 4, 32, pm.d):
        assert torch.equal(pm.partial_fit(xb), r.partial_fit(xb))
    assert torch.equal(r.counts, pm.counts) and torch.equal(r.sums, pm.sums)
    assert r.evicted_rows == pm.evicted_rows


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint written by one package, restored by the other: every
    leaf equal to the writer's, and the two models then fold the same
    batches alike (``fold_both``)."""
    jm, pm = _windowed_model(half_life=4.0, count_floor=0.1,
                             drift_guard=True, cap=640)
    for i, xb in enumerate(_batches(5, 6, 32, pm.d)):
        fold_both(jm, pm, xb, stats_close=True, context=f"warm {i}")
    d = str(tmp_path / "ckpt")
    if writer == "reference":
        jm.save(d, step=6)
        meta = json.load(open(os.path.join(d, "step-%09d" % 6,
                                           "meta.json")))
        assert meta["extra"]["kmeans_model"]["backend"] == "pallas"
        pm2 = KMeansModel.restore(d, device="cpu")
        _assert_same_leaves(pm2._tree(), _reference_tree(jm))
        jm2 = jm
    else:
        pm.save(d, step=6)
        jm2 = JaxModel.restore(d)
        jm2 = dataclasses.replace(jm2, interpret=True)
        _assert_same_leaves(_reference_tree(jm2), pm._tree())
        pm2 = pm
    # the runtime caches (drift-guard bands, stream bounds) are not
    # checkpointed: both sides start them afresh
    jm2._dg = None
    pm2._dg = None
    for i, xb in enumerate(_batches(6, 6, 32, pm.d)):
        fold_both(jm2, pm2, xb, stats_close=True, context=f"{writer} {i}")


def test_reference_tree_restores_through_the_port_checkpointer(tmp_path):
    """The low-level formats agree: a tree the reference saves restores
    through the port's ``restore_checkpoint`` and back."""
    d = str(tmp_path / "ckpt")
    tree = {"w": jnp.arange(6.0).reshape(2, 3), "n": jnp.int32(3),
            "f": jnp.array(True)}
    jax_save(d, 2, tree)
    like = {"w": torch.zeros(2, 3), "n": torch.tensor(0, dtype=torch.int32),
            "f": torch.tensor(False)}
    got = restore_checkpoint(d, 2, like, device="cpu")
    assert got["w"].tolist() == np.asarray(tree["w"]).tolist()
    assert int(got["n"]) == 3 and bool(got["f"]) is True
    save_checkpoint(d, 3, got)
    back = jax_restore(d, 3, tree)
    assert all(np.array_equal(np.asarray(back[k]), np.asarray(tree[k]))
               for k in tree)
