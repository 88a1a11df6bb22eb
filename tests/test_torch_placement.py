"""The port's placement rules (``launch.sharding``), stand-in meshes
(``launch.mesh``) and dry run (``launch.dryrun``) against the JAX
reference's, on the CPU with no devices.

The reference's spec functions read only ``mesh.shape`` and
``mesh.axis_names``, so a ``SimpleNamespace`` of the production shapes
is an oracle that needs no devices. Every spec is compared exactly
(entry for entry, an axis name or a tuple of names), over all ten arch
ids' full configs on the meshes 1 x 1, 2 x 2, 4 x 1, 16 x 16 ("data",
"model") and 2 x 16 x 16 ("pod", "data", "model"), and at the smoke
configs. The dry run's input specs are held against the reference's
``ShapeDtypeStruct``s cell by cell (shape and dtype), and its per-device
bytes against those computed here from the reference's specs applied to
the reference's shapes. ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512
host devices when it is imported: jax's devices are fixed first (as
``tests/test_optim_data.py`` does) and the variable is restored.
"""
import math
import os
import types

import jax
import numpy as np
import pytest

from repro.configs.base import ARCH_IDS, SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import get_smoke_config as jget_smoke
from repro.launch import sharding as jshr
from repro.models import cache_shapes as jcache_shapes
from repro.models import param_shapes as jparam_shapes
from repro.optim import init_opt_shapes as jinit_opt_shapes
from repro_torch.configs.base import SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import (MeshShape, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models.model import cache_shapes, param_shapes
from repro_torch.optim import init_opt_shapes

MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "4x1": {"data": 4, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _jmesh(shape: dict):
    return types.SimpleNamespace(shape=dict(shape),
                                 axis_names=tuple(shape))


def _jflat(tree) -> dict:
    """path -> leaf of a reference tree (specs or shape structs)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(getattr(k, "key", getattr(k, "name", k)) for k in p): v
            for p, v in leaves}


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _same_specs(port, ref, what):
    p, r = _flat(port), _jflat(ref)
    assert set(p) == set(r), (what, set(p) ^ set(r))
    for k in r:
        assert tuple(p[k]) == tuple(r[k]), (what, k, p[k], r[k])


@pytest.fixture(scope="module")
def shapes():
    """Both packages' param shapes for every arch id's full config."""
    return {a: (param_shapes(get_config(a)), jparam_shapes(jget_config(a)))
            for a in ARCH_IDS}


def test_shapes_cells_match_reference():
    assert SHAPES == JSHAPES


def test_production_and_debug_meshes_are_the_reference_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512
    assert make_debug_mesh(4, 2).shape == {"data": 4, "model": 2}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_and_opt_specs_match_reference(shapes, mesh):
    """param_specs (FSDP on and off) and opt_specs, spec for spec, for
    all ten arch ids' full configs."""
    pm, jm = MeshShape(MESHES[mesh]), _jmesh(MESHES[mesh])
    for arch, (ps, jps) in shapes.items():
        cfg, jcfg = get_config(arch), jget_config(arch)
        for fsdp in (True, False):
            _same_specs(shr.param_specs(cfg, ps, pm, fsdp=fsdp),
                        jshr.param_specs(jcfg, jps, jm, fsdp=fsdp),
                        (arch, mesh, fsdp))
        _same_specs(shr.opt_specs(cfg, ps, pm), jshr.opt_specs(jcfg, jps, jm),
                    (arch, mesh, "opt"))
        for kind in ("train", "prefill"):
            _same_specs(shr.batch_specs(cfg, pm, kind),
                        jshr.batch_specs(jcfg, jm, kind), (arch, mesh, kind))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_cache_specs_match_reference(shape):
    """cache_specs over every arch id's decode cache, clustered as the
    dry run decides (from long_context_threshold, never for an SSM), on
    every mesh."""
    sh = SHAPES[shape]
    B, S = sh["global_batch"], sh["seq_len"]
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        clus = dryrun.clustered_decode(cfg, S)
        cs, jcs = cache_shapes(cfg, B, S, clustered=clus), jcache_shapes(
            jcfg, B, S, clustered=clus)
        assert {k: tuple(v[0]) for k, v in _flat(cs).items()} == {
            k: tuple(v.shape) for k, v in _jflat(jcs).items()}, arch
        for mesh, ms in MESHES.items():
            _same_specs(shr.cache_specs(cfg, cs, MeshShape(ms), B),
                        jshr.cache_specs(jcfg, jcs, _jmesh(ms), B),
                        (arch, shape, mesh))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_config_specs_match_reference(arch):
    """Every spec at the smoke config: params, the optimizer state, and
    the flat and cluster-major caches at B=2, S=64."""
    cfg, jcfg = get_smoke_config(arch), jget_smoke(arch)
    ps, jps = param_shapes(cfg), jparam_shapes(jcfg)
    for ms in MESHES.values():
        pm, jm = MeshShape(ms), _jmesh(ms)
        _same_specs(shr.opt_specs(cfg, ps, pm), jshr.opt_specs(jcfg, jps, jm),
                    (arch, ms))
        for clus in (False, True):
            _same_specs(
                shr.cache_specs(cfg, cache_shapes(cfg, 2, 64, clustered=clus),
                                pm, 2),
                jshr.cache_specs(jcfg, jcache_shapes(jcfg, 2, 64,
                                                     clustered=clus), jm, 2),
                (arch, ms, clus))


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module, its XLA_FLAGS undone."""
    import importlib
    jax.devices()         # fix the device count before its flags
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_input_specs_match_reference(jdryrun):
    """Every (arch x shape) cell's inputs: the same leaves, shapes and
    dtypes as the reference's ShapeDtypeStructs."""
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for shape in SHAPES:
            got = _flat(dryrun.input_specs(cfg, shape))
            want = _jflat(jdryrun.input_specs(jcfg, shape))
            assert set(got) == set(want), (arch, shape)
            for k, w in want.items():
                assert tuple(got[k].shape) == tuple(w.shape), (arch, shape, k)
                assert _dtype(got[k]) == _dtype(w), (arch, shape, k)
                assert got[k].is_meta


def _ref_bytes(tree, specs, mesh_shape) -> int:
    """One device's bytes of a reference tree under its specs: a
    dimension split n ways holds ⌈size / n⌉."""
    flat_t, flat_s = _jflat(tree), _jflat(specs)
    total = 0
    for k, t in flat_t.items():
        dims = list(t.shape)
        for i, e in enumerate(flat_s[k]):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            n = math.prod(mesh_shape[a] for a in axes)
            dims[i] = -(-dims[i] // n)
        total += math.prod(dims) * np.dtype(t.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_bytes_match_reference_specs(jdryrun, multi_pod):
    """run_cell's per-device bytes of params, optimizer state, cache and
    batch for every cell equal the reference's specs applied to the
    reference's shapes (FSDP by the reference's rule)."""
    ms = MESHES["2x16x16" if multi_pod else "16x16"]
    jm = _jmesh(ms)
    for arch in ARCH_IDS:
        jcfg = jget_config(arch)
        jps = jparam_shapes(jcfg)
        for shape, sh in JSHAPES.items():
            rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                  verbose=False)
            fits = jcfg.params_estimate() * 2 / ms["model"] < 12e9
            fsdp = not (sh["kind"] == "prefill" and fits)
            assert rec["fsdp"] == fsdp
            want = {"params": _ref_bytes(
                jps, jshr.param_specs(jcfg, jps, jm, fsdp=fsdp), ms),
                "opt": 0, "cache": 0, "batch": 0}
            inp = jdryrun.input_specs(jcfg, shape)
            if sh["kind"] == "decode":
                want["cache"] = _ref_bytes(inp["cache"], jshr.cache_specs(
                    jcfg, inp["cache"], jm, sh["global_batch"]), ms)
                want["batch"] = sh["global_batch"] * 4 + 4
            else:
                want["batch"] = _ref_bytes(inp, jshr.batch_specs(
                    jcfg, jm, sh["kind"]), ms)
            if sh["kind"] == "train":
                want["opt"] = _ref_bytes(jinit_opt_shapes(jps), jshr.opt_specs(
                    jcfg, jps, jm), ms)
            assert rec["bytes_per_device"] == want, (arch, shape)


def test_dryrun_flops_and_bytes_of_the_dense_train_step():
    """The dense GQA train step's operations product by product (the
    layers' projections and MLP and attention's value product in bf16,
    the scores and the unembedding in f32, times 3), and the ZeRO step's
    bytes from the leaves: split leaves' whole gradient and param block,
    whole leaves once, the norms and the loss."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3-8b"), n_layers=4)
    B, S, qc = 4, 2048, 512
    T = B * S
    d, H, Hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head, cfg.d_ff)
    proj = d * H * dh * 2 + d * Hkv * dh * 2 + 3 * d * f
    pairs = sum((min(S, lo + qc) - lo) * min(S, lo + qc)
                for lo in range(0, S, qc))
    att = 2 * B * H * pairs * dh
    fl = dryrun.train_flops(cfg, B, S, qc)
    assert fl["bf16"] == 3 * 4 * (2 * T * proj + att)
    assert fl["f32"] == 3 * (4 * att + 2 * T * d * cfg.vocab)
    ps = param_shapes(cfg)
    leaves = list(_flat(ps).items())
    specs = _flat(shr.opt_specs(cfg, ps, MeshShape({"data": 4}))["m"])
    want = 4 * (len(leaves) + 1)
    for k, t in leaves:
        nb = t.numel() * t.element_size()
        want += nb + (nb // 4 if "data" in specs[k] else 0)
    assert dryrun.zero_step_bytes(cfg, 4) == want
    assert dryrun.decode_merge_bytes(cfg, 2, 4) == 4 * 2 * H * (dh + 2) * 4


def test_dryrun_main_runs_every_cell(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch all --shape all``:
    every cell ok, one JSON line each, with no card."""
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "all", "--shape", "all", "--out",
                        str(out)]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == len(ARCH_IDS) * len(SHAPES)
    assert "dry-run cells: 40 ok, 0 failed" in capsys.readouterr().out


def test_opt_shapes_and_sharded_placement_rules():
    """init_opt_shapes mirrors the params in f32; local_shape divides each
    split dimension by its axes' product."""
    cfg = get_smoke_config("qwen3-8b")
    ps = param_shapes(cfg)
    opt = init_opt_shapes(ps)
    assert all(t.is_meta for t in _flat(opt).values())
    spec = shr.P(("pod", "data"), None, "model")
    m = MeshShape({"pod": 2, "data": 4, "model": 2})
    assert shr.local_shape((16, 3, 5), spec, m) == (2, 3, 3)
