"""The port's analyzer (``repro_torch.analysis``) on the CPU: its report
and opcount lint against the reference's on the same inputs, a seeded
fixture for every rule with a clean twin, the registry's rot guard, and
the CLI gate. The kernel pass reads real launch plans only on the card
(``tests/test_torch_cuda.py``); here its rules are held against seeded
plan records, as the reference's tests seed ``pallas_call`` records.
"""
import itertools
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from repro.analysis import opcount_lint as ref_lint
from repro.analysis import report as ref_report
from repro_torch.analysis import (cli, host_sync_audit, kernel_contracts,
                                  opcount_lint, report)
from repro_torch.analysis.kernel_contracts import LaunchPlan, check_record
from repro_torch.analysis.registry import (EntryPoint, KernelCase,
                                           KernelEntry, audit_entries,
                                           kernel_entries)
from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_FILES = sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "src" / "repro").rglob("*.py"))
HERE = str(pathlib.Path(__file__).resolve().parent)


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# report: the reference's schema, fingerprints and baselines
# ---------------------------------------------------------------------------


def _pair(**kw):
    base = dict(rule="K2L101", severity="error", file="src/x.py", line=3,
                entry="e", site="s", message="m")
    base.update(kw)
    return report.Finding(**base), ref_report.Finding(**base)


def test_report_fingerprints_and_reports_equal_the_reference(tmp_path):
    ours, theirs = zip(*[_pair(line=i, site=s, severity=sev)
                         for i, (s, sev) in enumerate(
                             [("s", "error"), ("s", "error"), ("t", "warn"),
                              ("u", "info")])])
    report.finalize_findings(list(ours))
    ref_report.finalize_findings(list(theirs))
    assert [f.fingerprint for f in ours] == [f.fingerprint for f in theirs]
    assert report.fingerprint("K2L201", "a", "b", "c") == \
        ref_report.fingerprint("K2L201", "a", "b", "c")
    base = {ours[0].fingerprint: {"justification": "audited"}}
    blk = report.apply_baseline(list(ours), base)
    rblk = ref_report.apply_baseline(list(theirs), base)
    passes = {"host_sync_audit": {"entries": 1}}
    a = report.make_report(list(ours), passes, blk)
    b = ref_report.make_report(list(theirs), passes, rblk)
    assert a == b
    report.validate_report(a)
    ref_report.validate_report(a)
    for mod, fs, name in ((report, ours, "a.json"),
                          (ref_report, theirs, "b.json")):
        mod.write_baseline(str(tmp_path / name), list(fs), "audited")
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    assert report.load_baseline(str(tmp_path / "b.json")) == \
        ref_report.load_baseline(str(tmp_path / "a.json"))


def test_baseline_without_justification_is_refused(tmp_path):
    f, _ = _pair()
    report.finalize_findings([f])
    path = tmp_path / "baseline.json"
    report.write_baseline(str(path), [f], "audited")
    raw = json.loads(path.read_text())
    raw["findings"][0]["justification"] = ""
    path.write_text(json.dumps(raw))
    for mod in (report, ref_report):
        with pytest.raises(ValueError, match="justification"):
            mod.load_baseline(str(path))
    with pytest.raises(ValueError):
        report.validate_report({"schema": "nope"})


# ---------------------------------------------------------------------------
# opcount lint: the reference's findings on the reference's sources
# ---------------------------------------------------------------------------

_UNCHARGED = """
import torch
from repro_torch.core.distance import pairwise_sqdist, sqnorm

def assign(x, c):
    d = pairwise_sqdist(x, c)
    return torch.argmin(d, dim=1)

def energy(x, c, a):
    return torch.sum(sqnorm(x - c[a]))
"""

_TORCH_IDIOMS = """
import torch

def d_mm(x, c, xn, cn):
    return xn + cn - 2.0 * torch.mm(x, c.T)

def d_bmm(x, c):
    return -2 * torch.bmm(x, c)

def d_cdist(x, c):
    return 2 * torch.cdist(x, c)

def resid(x, c):
    return torch.linalg.vector_norm(x - c, dim=1)

def exact(x, c):
    return exact_cross(x, c.T)
"""


def test_lint_equals_the_reference_on_its_seeded_sources():
    path = "src/repro/seeded.py"
    ref_src = _UNCHARGED.replace("repro_torch", "repro")
    for src, cmap in ((ref_src, {}), (ref_src, ref_lint.CHARGING_MAP),
                      (ref_src, {path + "::assign": "fit loop"}),
                      ("def d2(x, c, xn, cn):\n"
                       "    return xn + cn - 2.0 * (x @ c.T)\n", {}),
                      ("def broken(:\n", {})):
        ours = [f.to_dict() for f in opcount_lint.lint_source(src, path,
                                                              cmap)]
        theirs = [f.to_dict() for f in ref_lint.lint_source(src, path, cmap)]
        assert ours == theirs


@pytest.mark.parametrize("path", REF_FILES)
def test_lint_equals_the_reference_on_every_reference_file(path):
    src = (ROOT / path).read_text()
    for cmap in (ref_lint.CHARGING_MAP, {}):
        ours = [f.to_dict() for f in opcount_lint.lint_source(src, path,
                                                              cmap)]
        theirs = [f.to_dict() for f in ref_lint.lint_source(src, path, cmap)]
        assert ours == theirs


def test_seeded_uncharged_sites_are_k2l301_and_charged_twin_is_clean():
    path = "src/repro_torch/seeded.py"
    fs = opcount_lint.lint_source(_UNCHARGED, path, charging_map={})
    assert {f.site for f in fs} == {"assign:call:pairwise_sqdist",
                                    "energy:residual-norm:sqnorm"}
    assert _rules(fs) == {"K2L301"}
    charged = _UNCHARGED.replace(
        "    d = pairwise_sqdist(x, c)",
        "    counter.add_distances(x.shape[0] * c.shape[0])\n"
        "    d = pairwise_sqdist(x, c)").replace(
        "def energy(x, c, a):",
        "def energy(x, c, a):  # k2lint: charged-by(fit loop)")
    assert opcount_lint.lint_source(charged, path, charging_map={}) == []
    assert opcount_lint.lint_source(
        _UNCHARGED, path, charging_map={path + "::*": "fit loop"}) == []


def test_torch_idioms_are_distance_sites():
    fs = opcount_lint.lint_source(_TORCH_IDIOMS, "src/repro_torch/s.py",
                                  charging_map={})
    assert sorted(f.site for f in fs) == [
        "d_bmm:expansion:2*contraction", "d_cdist:expansion:2*contraction",
        "d_mm:expansion:2*contraction", "exact:call:exact_cross",
        "resid:residual-norm:vector_norm"]


def test_unparseable_module_is_k2l300_and_parseable_twin_is_clean():
    bad = opcount_lint.lint_source("def broken(:\n", "src/repro_torch/b.py")
    assert _rules(bad) == {"K2L300"}
    assert opcount_lint.lint_source("def fine():\n    return 1\n",
                                    "src/repro_torch/b.py") == []


def test_port_tree_lints_clean():
    fs, stats = opcount_lint.run(repo_root=str(ROOT))
    assert fs == [] and stats["files"] >= 70


# ---------------------------------------------------------------------------
# pass 1: seeded host-sync fixtures (attributed to this file)
# ---------------------------------------------------------------------------


@pytest.fixture
def seeded(monkeypatch):
    """Attribute events to frames of this file, as if it were the port."""
    monkeypatch.setattr(host_sync_audit, "PORT", HERE)


def _audit(entry):
    return host_sync_audit.audit_entry(entry, "cpu", str(ROOT))


def _entry(fn, make_args=lambda dev: (), **kw):
    return EntryPoint(name=kw.pop("name", "seeded/entry"),
                      file="tests/test_torch_analysis.py",
                      build=lambda dev: (fn, make_args(dev)), **kw)


def _x(dev):
    return (torch.arange(12, dtype=torch.float32, device=dev).reshape(4, 3),)


def _read(x):
    return x * float(x.sum())


def _stack_read(x):
    return torch.stack([x.sum(), x.max()]).tolist()


def _chained(x):
    return x.sum(0).cpu().numpy()


def _dynamic(x):
    return x[x > 3.0]


def _fixed(x):
    return torch.where(x > 3.0, x, 0.0)


def _f64(x):
    return x.double().sum()


def _dequant(x):
    q = torch.clamp(torch.round(x), -127, 127).to(torch.int8)
    return q.to(torch.float32) + q.float()


def _boom(x):
    raise RuntimeError("seeded failure")


def test_seeded_host_read_over_budget_is_k2l101(seeded):
    fs, counts = _audit(_entry(_read, _x))
    assert _rules(fs) == {"K2L101"} and counts["host_reads"] == 1
    f = fs[0]
    assert f.file == "tests/test_torch_analysis.py" and f.site == \
        "_read:host_read"
    fs, counts = _audit(_entry(_read, _x, host_reads=1))
    assert fs == []
    fs, counts = _audit(_entry(_stack_read, _x,
                                                    host_reads=1))
    assert fs == [] and counts["host_reads"] == 1
    # t.cpu().numpy() is one read, not two
    fs, counts = _audit(_entry(_chained, _x,
                                                    host_reads=1))
    assert fs == [] and counts["host_reads"] == 1


def test_seeded_f64_and_dequant_are_k2l102(seeded):
    fs, _ = _audit(_entry(_f64, _x))
    assert _rules(fs) == {"K2L102"} and fs[0].site == "f64:_f64"
    ok = {"tests/test_torch_analysis.py::_f64": "seeded: sanctioned"}
    assert _audit(_entry(_f64, _x, f64_ok=ok))[0] == []
    fs, counts = _audit(
        _entry(_dequant, _x, int8_region=True, sanctioned_dequants=1))
    assert counts["dequants"] == 2
    assert [f.site for f in fs] == ["dequant-budget"]
    assert _audit(
        _entry(_dequant, _x, int8_region=True, sanctioned_dequants=2))[0] \
        == []


def test_seeded_failure_is_k2l100_and_leaks_are_k2l103(seeded):
    fs, _ = _audit(_entry(_boom, _x))
    assert _rules(fs) == {"K2L100"}
    sizes = itertools.count(3)

    def leaky(dev):       # a Python-side value reaches the step's shapes
        return (torch.ones((next(sizes), 2), device=dev),)
    fs, _ = _audit(_entry(_fixed, leaky))
    assert [f.site for f in fs] == ["rerun"] and _rules(fs) == {"K2L103"}
    assert _audit(_entry(_fixed, _x))[0] == []

    def alt(dev):
        return _boom, _x(dev)
    fs, _ = _audit(_entry(_fixed, _x, build_alt=alt))
    assert [f.site for f in fs] == ["alt-shape"]


_WORKSPACE = {}


def _lazy(x):
    if "w" not in _WORKSPACE:          # made once, then reused
        _WORKSPACE["w"] = torch.zeros((3,))
    return x + _WORKSPACE["w"].sum()


def test_one_time_setup_is_k2l103_info(seeded):
    _WORKSPACE.clear()
    fs, _ = _audit(_entry(_lazy, _x))
    assert [(f.rule, f.severity, f.site) for f in fs] == [
        ("K2L103", "info", "first-run")]
    assert _audit(_entry(_lazy, _x))[0] == []


def test_seeded_collectives_are_k2l104():
    from repro_torch.analysis import registry
    free = [e for e in audit_entries() if e.name ==
            "step/kernels-rebuild-sharded"][0]
    fs, counts = _audit(
        EntryPoint(free.name, free.file, free.build, mesh=True))
    assert counts["collectives"] == 2
    assert [f.site for f in fs] == ["collective"]
    fs, _ = _audit(
        EntryPoint(free.name, free.file, free.build, mesh=True,
                   collective_free=False, collectives=3))
    assert [f.site for f in fs] == ["collective-count"]
    fs, _ = _audit(free)
    assert fs == []
    assert not registry._MESH


def test_seeded_dynamic_shape_op_is_k2l105(seeded):
    fs, counts = _audit(_entry(_dynamic, _x))
    assert _rules(fs) == {"K2L105"} and counts["dynamic_shape_ops"] == 1
    assert _audit(_entry(_fixed, _x))[0] == []
    assert _audit(
        _entry(_dynamic, _x, dynamic_shape_ops=1))[0] == []


def test_plain_versions_are_left_out_on_the_cpu():
    """kernels/ref.py's reads (its screen's nonzero and length check) are
    the kernels' plain versions: on the CPU they are not the entry's."""
    from repro_torch.kernels import ref

    def build(dev):
        x = torch.randn((40, 7), generator=torch.Generator().manual_seed(0))
        return ref.exact_cross, (x, x.T)
    fs, counts = _audit(
        EntryPoint("seeded/ref", "src/repro_torch/kernels/ref.py", build))
    assert fs == [] and counts["host_reads"] == 0 \
        and counts["dynamic_shape_ops"] == 0 and counts["f64_ops"] == 0


# ---------------------------------------------------------------------------
# pass 2: seeded launch plans
# ---------------------------------------------------------------------------

_KE = KernelEntry("seeded", "src/repro_torch/kernels/seeded.py",
                  "src/repro_torch/kernels/csrc/seeded.cu", "seeded",
                  "seeded_kernel", ())
_CASE = KernelCase("c", None, min_blocks_per_sm=2)


def _plan(**kw):
    base = dict(kernel="seeded", variant=1, variant_name="VEC4",
                grid=(8, 1, 1), launches=1, threads=256, smem=96 * 1024,
                vec=1, rows=512, row_extent=64, inner=128, inner_tile=32,
                attrs={"registers": 96, "local_bytes": 0,
                       "blocks_per_sm": 2},
                smem_optin=227 * 1024)
    base.update(kw)
    return LaunchPlan(**base)


def test_clean_seeded_plan_has_no_findings():
    assert check_record(_KE, _CASE, _plan()) == []


def test_seeded_indivisible_tile_is_k2l201_unless_guarded():
    rec = _plan(rows=500, grid=(8, 1, 1), inner=100)
    fs = check_record(_KE, _CASE, rec)
    assert {f.site for f in fs} == {"rows", "inner"}
    assert _rules(fs) == {"K2L201"}
    guarded = KernelEntry(*[getattr(_KE, f) for f in
                            ("name", "file", "source", "lib", "symbol",
                             "cases")], pad_ok=("rows", "inner"))
    assert check_record(guarded, _CASE, rec) == []


def test_seeded_scalar_fallback_is_k2l202_warn():
    fs = check_record(_KE, _CASE, _plan(vec=0, variant_name="VEC1"))
    assert [(f.rule, f.severity) for f in fs] == [("K2L202", "warn")]
    assert check_record(_KE, KernelCase("c", None, min_blocks_per_sm=2,
                                        scalar_ok=True),
                        _plan(vec=0)) == []
    assert check_record(_KE, _CASE, _plan(vec=-1)) == []


def test_seeded_smem_and_occupancy_are_k2l203():
    fs = check_record(_KE, _CASE, _plan(smem=240 * 1024))
    assert [f.site for f in fs] == ["smem"] and _rules(fs) == {"K2L203"}
    fs = check_record(_KE, _CASE, _plan(attrs={"blocks_per_sm": 1}))
    assert [f.site for f in fs] == ["occupancy"]


def test_seeded_coverage_is_k2l204():
    assert [f.site for f in check_record(_KE, _CASE, _plan(grid=(7, 1, 1)))
            ] == ["coverage"]
    assert [f.site for f in check_record(_KE, _CASE, _plan(grid=(9, 1, 1)))
            ] == ["excess"]
    # persistent: the stride must be the grid's reach
    pers = dict(grid=(4, 1, 1), stride=4, resident=4)
    assert check_record(_KE, _CASE, _plan(**pers)) == []
    assert [f.site for f in check_record(_KE, _CASE, _plan(
        **{**pers, "stride": 3}))] == ["stride"]
    # a batch over z, split across launches
    batch = dict(grid=(8, 2, 4), launches=3, batch=10, cols=256,
                 col_extent=128)
    assert check_record(_KE, _CASE, _plan(**batch)) == []
    assert [f.site for f in check_record(_KE, _CASE, _plan(
        **{**batch, "launches": 2}))] == ["coverage"]


def test_seeded_spill_is_k2l205_warn():
    fs = check_record(_KE, _CASE, _plan(spill=(24, 24, 24)))
    assert [(f.rule, f.severity) for f in fs] == [("K2L205", "warn")]
    # a stack frame without spills is no finding
    assert check_record(_KE, _CASE, _plan(spill=(160, 0, 0))) == []
    log = {"_Z13seeded_kernelILi16EEvPf": (0, 0, 0),
           "_Z13seeded_kernelILi64EEvPf": (96, 96, 96),
           "_Z12other_kernelv": (96, 8, 8)}
    assert kernel_contracts.ptxas_spill(_KE, log, 96) == (96, 96, 96)
    assert kernel_contracts.ptxas_spill(_KE, log, 0) == (0, 0, 0)
    assert kernel_contracts.ptxas_spill(_KE, log, 160) == (0, 0, 0)


def test_kernel_pass_on_the_cpu_reports_that_it_needs_the_card():
    fs, stats = kernel_contracts.run(device="cpu")
    assert fs == [] and "only on the card" in stats["skipped"]
    assert stats["kernels"] == len(_build.LAUNCHES)


def test_kernel_failure_is_k2l200():
    def build(dev):
        raise RuntimeError("seeded")
    entry = KernelEntry("exact_sqnorm", "f.py", "f.cu", "exact_round",
                        "k", (KernelCase("c", build),))
    fs, plans = kernel_contracts.check_kernel(entry, "cpu",
                                              limits={"smem_optin": 1})
    assert _rules(fs) == {"K2L200"} and plans == []

    def quiet(dev):                  # a CPU call launches nothing
        from repro_torch.kernels import exact_round
        return (exact_round.exact_sqnorm, (torch.ones((4, 3)),),
                lambda: {})
    fs, _ = kernel_contracts.check_kernel(
        KernelEntry("exact_sqnorm", "f.py", "f.cu", "exact_round", "k",
                    (KernelCase("c", quiet),)), "cpu",
        limits={"smem_optin": 1})
    assert "no-launch" in {f.site for f in fs}


# ---------------------------------------------------------------------------
# registry, budgets, and the gate
# ---------------------------------------------------------------------------


def test_registry_rot_guard():
    ents = audit_entries()
    names = [e.name for e in ents]
    assert len(ents) >= 20 and len(set(names)) == len(names)
    assert {"lm/decode-full", "lm/decode-k2attn", "lm/train-step"} <= \
        set(names)
    by = {e.name: e for e in ents}
    assert by["step/kernels-resident-f32"].host_reads == 1
    assert by["step/kernels-resident-sharded"].collectives == 3
    assert all(e.dynamic_shape_ops == 0 for e in ents)
    kes = kernel_entries()
    assert sorted(k.name for k in kes) == sorted(_build.LAUNCHES)
    for k in kes:
        assert k.lib in _build.SOURCES and k.cases
        assert (ROOT / k.source).exists() and (ROOT / k.file).exists()
        src = (ROOT / k.source).read_text()
        assert f"k2_plan_{k.name}" in src and k.symbol in src
        assert f"K2_DESCRIBE({k.name}," in src


# prologue kernels a launcher runs before the kernel it counts
_AUX = ("k2_exact_sqnorm_kernel<NT_NORM>", "norms_kernel", "segment_ranges")


@pytest.mark.parametrize("name", sorted(_build.LAUNCHES))
def test_every_launcher_takes_its_plan(name):
    """Each counted launch in the kernel's source takes its grid, block
    and shared memory from the plan, and its wrapper reads that plan."""
    import re
    ke = {k.name: k for k in kernel_entries()}[name]
    src = (ROOT / ke.source).read_text()
    assert f"def plan_{name}(" in (ROOT / ke.file).read_text()
    launches = re.findall(r"(\S+)\s*<<<([^>]*)>>>", src)
    counted = [cfg for fn, cfg in launches if not fn.startswith(_AUX)]
    assert counted and all(
        ("k2_grid(p" in cfg or "p[K2P_GRID_X]" in cfg)
        and "[K2P_THREADS]" in cfg and "[K2P_SMEM]" in cfg
        for cfg in counted), counted


def test_gate_exit_codes(tmp_path, seeded):
    out = str(tmp_path / "r.json")
    base = str(tmp_path / "baseline.json")

    def seeded_pass(repo_root="", device=None):
        return host_sync_audit.run([_entry(_read, _x)], str(ROOT), device)
    passes = (("host_sync_audit", seeded_pass),)
    assert cli.run(out=out, baseline=base, quiet=True, device="cpu",
                   passes=passes) == 1
    rep = json.loads(pathlib.Path(out).read_text())
    report.validate_report(rep)
    assert rep["ok"] is False and rep["counts"]["blocking"] == 1
    # a justified baseline entry is the only way to suppress it
    assert cli.run(out=out, baseline=base, quiet=True, device="cpu",
                   passes=passes, update_baseline=True) == 0
    raw = json.loads(pathlib.Path(base).read_text())
    raw["findings"][0]["justification"] = "seeded fixture, audited"
    pathlib.Path(base).write_text(json.dumps(raw))
    assert cli.run(out=out, baseline=base, quiet=True, device="cpu",
                   passes=passes) == 0

    def crash(repo_root="", device=None):
        raise RuntimeError("seeded analyzer crash")
    import repro_torch.analysis.cli as climod
    orig = climod.PASSES
    try:
        climod.PASSES = (("host_sync_audit", crash),)
        assert cli.main(["--device", "cpu", "--out", out, "--quiet"]) == 2
    finally:
        climod.PASSES = orig


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(out=str(tmp_path / "r.json"), quiet=True)
    assert cli.main(["--out", str(tmp_path / "r.json"), "--quiet"]) == 2


def test_clean_tree_on_the_cpu(tmp_path):
    out = tmp_path / "k2lint_torch_report.json"
    assert cli.main(["--device", "cpu", "--out", str(out), "--quiet"]) == 0
    rep = json.loads(out.read_text())
    report.validate_report(rep)
    assert rep["ok"] is True and rep["counts"]["blocking"] == 0
    audit = rep["passes"]["host_sync_audit"]
    assert audit["entries"] >= 20
    per = audit["per_entry"]
    assert per["step/kernels-resident-f32"]["host_reads"] == 1
    assert per["lm/decode-k2attn"]["host_reads"] == 1
    assert per["lm/train-step"]["host_reads"] == 1
    assert per["step/kernels-resident-sharded"]["collectives"] == 3
    assert "only on the card" in rep["passes"]["kernel_contracts"]["skipped"]
    assert rep["passes"]["opcount_lint"]["findings"] == 0
    assert json.loads(
        (ROOT / "src/repro_torch/analysis/baseline.json").read_text()) == \
        {"findings": []}
    assert not os.path.exists(ROOT / "k2lint_torch_report.json.tmp")
    assert np.isfinite(audit["entries"])


def test_ptxas_log_is_kept_under_the_librarys_hash(tmp_path, monkeypatch):
    """A build's log sits beside its library under the same hash, so the
    build of another hash (other sources or flags) never overwrites it and
    a cached library still reports its registers and spills."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    name = "candidate_assign"
    log = _build._log_path(name)
    assert log.parent == tmp_path and log.stem == _build._target(name).stem
    assert _build.build_log(name) == ""
    log.write_text(
        "ptxas info    : Function properties for _Z29candidate_assign_"
        "tiled_kernelILi1ELi1ELi4EEvPKfS1_\n"
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill "
        "loads\n")
    (tmp_path / f"{name}.log").write_text("another build's log\n")
    assert "spill stores" in _build.build_log(name)
    assert list(_build.spills(name).values()) == [(8, 4, 12)]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.build_log(name) == ""
