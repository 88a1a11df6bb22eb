"""Pass 1 — the hot-path auditor (DESIGN.md §15.3, rules K2L10x), the
port's counterpart of ``repro.analysis.jaxpr_audit``.

The port has no traced program to walk: each registered entry point
(``analysis.registry.audit_entries``) is *run* eagerly at the registry's
tiny shapes under a ``torch.overrides.TorchFunctionMode``, which sees the
Python-level reads of a tensor's value (``item``, ``__bool__``,
``__int__``, ``__float__``, ``__index__``, ``tolist``, ``numpy``,
``cpu``, ``to`` a CPU device from another device), and a
``torch.utils._python_dispatch.TorchDispatchMode``, which sees every
ATen op with its shapes and dtypes (``nonzero``, a boolean-mask
``index``, ``unique`` and the like, f64 values, int8 -> float
conversions). Each event is attributed to the innermost frame under
``src/repro_torch/`` outside ``analysis/``: that frame gives a finding its
file, line and site. On the CPU, events whose innermost frame is in
``kernels/ref.py`` are left out: those are the kernels' plain versions,
and on the card a kernel runs in their place. On the card every event
counts. A read of a tensor that an earlier counted read already brought
to the host (``t.cpu().numpy()``) is not a second read.

``K2L100``  the entry fails to run (a registry rot guard).
``K2L101``  host reads above the entry's ``host_reads`` budget — the §3
            deferred-host-read contract; every site of the entry's reads
            is listed.
``K2L102``  dtype discipline: an f64 value made outside the entry's
            ``f64_ok`` places, or, in ``int8_region`` entries, more
            int8 -> f32/bf16/f16 conversions than ``sanctioned_dequants``
            (an int8 -> f64 conversion is an exact integer product, the
            reference's int32 dot, and is held by the f64 rule).
``K2L103``  runs from identical builds issue different op sequences
            (name, shapes, dtypes), or the entry fails at ``build_alt``'s
            second shape: a Python-side value leaks into the step, which
            is what a CUDA graph capture of the step cannot survive. When
            only the first run differs (a workspace made once and cached)
            the finding is ``info``: set-up to do before a capture.
``K2L104``  collective placement: a ``launch.mesh.Mesh`` collective in a
            ``collective_free`` entry, or a sharded entry whose
            collectives a call differ from its declared count (counted
            through the ``Mesh`` methods, outermost call only: ``dist.*``
            calls pass through neither mode).
``K2L105``  dynamic-shape ops above the entry's ``dynamic_shape_ops``
            budget (ROADMAP's "no dynamic-shape op" ground rule; under
            ``jit`` the reference could not express them).
"""
from __future__ import annotations

import contextlib
import os
import sys

from .report import Finding
from .registry import EntryPoint, audit_entries

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYSIS = os.path.join(PORT, "analysis")
REF = os.path.join(PORT, "kernels", "ref.py")

HOST_READS = frozenset({"item", "__bool__", "__int__", "__float__",
                        "__index__", "__format__", "__array__", "tolist",
                        "numpy", "cpu", "to"})
# ATen ops whose output shape follows the data (or that sync to learn it)
DYNAMIC_OPS = frozenset({"nonzero", "_unique2", "unique_dim",
                         "unique_consecutive", "masked_select", "argwhere",
                         "bincount", "histc", "nonzero_numpy"})
MESH_COLLECTIVES = ("sum", "gather", "max", "gather_blocks", "gather_rows",
                    "reduce_scatter", "broadcast_object")


def _site(repo_root: str):
    """(repo-relative file, line, function, path) of the innermost frame
    under the port outside ``analysis/``, or None."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(PORT) and not fn.startswith(ANALYSIS):
            rel = os.path.relpath(fn, repo_root) if repo_root else fn
            return rel.replace(os.sep, "/"), f.f_lineno, f.f_code.co_name, fn
        f = f.f_back
    return None


class _Recorder:
    """What one run of an entry did: events (kind, file, line, function),
    the op sequence, and the Mesh collectives."""

    def __init__(self, device_type: str, repo_root: str):
        self.on_cpu = device_type == "cpu"
        self.repo_root = repo_root
        self.events: list[tuple] = []
        self.ops: list[tuple] = []
        self.collectives = 0
        self._host = set()        # ids of tensors a read brought to the host
        self._keep = []           # ... kept alive so their ids stay unique

    def event(self, kind: str, detail: str = "") -> None:
        where = _site(self.repo_root)
        if where is None:
            return
        rel, line, func, path = where
        if self.on_cpu and path == REF:
            return
        self.events.append((kind, rel, line, func, detail))

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e[0] == kind)


def _is_cpu_target(args, kwargs) -> bool:
    import torch
    for v in list(args[1:]) + list(kwargs.values()):
        if isinstance(v, torch.device) and v.type == "cpu":
            return True
        if isinstance(v, str) and v.split(":")[0] == "cpu":
            return True
    return False


def _modes(rec: _Recorder):
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Reads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = getattr(func, "__name__", "")
            if name in HOST_READS and args and isinstance(args[0],
                                                          torch.Tensor):
                src = args[0]
                if id(src) in rec._host:
                    return out
                if name == "to":
                    if not (_is_cpu_target(args, kwargs)
                            and src.device.type != "cpu"):
                        return out
                rec.event("host_read", name)
                if name in ("cpu", "to") and isinstance(out, torch.Tensor):
                    rec._host.add(id(out))
                    rec._keep.append(out)
            return out

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
            rec.ops.append((str(func), tuple(
                (tuple(t.shape), str(t.dtype)) for t in ins + outs)))
            dynamic = name in DYNAMIC_OPS or (
                name in ("index", "index_put", "index_put_") and any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in tree_flatten(args[1])[0]))
            if name == "repeat_interleave" and func._overloadname in (
                    "Tensor", "self_Tensor") \
                    and kwargs.get("output_size") is None:
                dynamic = True      # repeats given as a tensor
            if dynamic:
                rec.event("dynamic_shape", str(func))
            if any(o.dtype == torch.float64 for o in outs):
                rec.event("f64", str(func))
            if ins and ins[0].dtype == torch.int8 and any(
                    o.dtype in (torch.float32, torch.bfloat16, torch.float16)
                    for o in outs):
                rec.event("dequant", str(func))
            return out

    return Reads(), Ops()


@contextlib.contextmanager
def _count_collectives(rec: _Recorder):
    """Count the outermost calls of ``launch.mesh.Mesh``'s collectives."""
    from ..launch.mesh import Mesh
    saved = {n: getattr(Mesh, n) for n in MESH_COLLECTIVES}
    depth = [0]

    def wrap(fn):
        def counted(self, *a, **kw):
            if depth[0] == 0:
                rec.collectives += 1
            depth[0] += 1
            try:
                return fn(self, *a, **kw)
            finally:
                depth[0] -= 1
        return counted

    for n, fn in saved.items():
        setattr(Mesh, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(Mesh, n, fn)


def run_entry(entry: EntryPoint, device, repo_root: str = "",
              alt: bool = False) -> _Recorder:
    """One run of ``entry`` built fresh on ``device`` under both modes."""
    import torch
    dev = torch.device(device)
    fn, args = (entry.build_alt if alt else entry.build)(dev)
    return run_built(fn, args, dev, repo_root)


def run_built(fn, args, device, repo_root: str = "") -> _Recorder:
    """``fn(*args)`` once under both modes (the build left out, so that a
    profiler around this call sees the call alone)."""
    import torch
    dev = torch.device(device)
    rec = _Recorder(dev.type, repo_root)
    reads, ops = _modes(rec)
    with _count_collectives(rec), reads, ops:
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return rec


def _sites(rec: _Recorder, kind: str) -> list[tuple]:
    seen: dict[tuple, list] = {}
    for k, rel, line, func, detail in rec.events:
        if k == kind:
            seen.setdefault((rel, func), []).append((line, detail))
    return [(rel, func, hits) for (rel, func), hits in sorted(seen.items())]


def check_run(entry: EntryPoint, rec: _Recorder) -> list[Finding]:
    """The rules K2L101, K2L102, K2L104 and K2L105 over one run."""
    findings: list[Finding] = []

    def add(rule, site, message, file=None, line=0):
        findings.append(Finding(rule=rule, severity="error",
                                file=file or entry.file, line=line,
                                entry=entry.name, site=site,
                                message=message))

    for kind, rule, budget, what in (
            ("host_read", "K2L101", entry.host_reads,
             "host reads (§3: reads are deferred to the fit loop's "
             "monitor boundaries)"),
            ("dynamic_shape", "K2L105", entry.dynamic_shape_ops,
             "dynamic-shape ops (ROADMAP ground rules: none; "
             "ops.compact is the fixed-size form)")):
        total = rec.count(kind)
        if total > budget:
            for rel, func, hits in _sites(rec, kind):
                ops_ = sorted({d for _, d in hits})
                add(rule, f"{func}:{kind}",
                    f"{total} {what} a call against a budget of {budget}; "
                    f"{len(hits)} here ({', '.join(ops_)})",
                    file=rel, line=hits[0][0])
    for rel, func, hits in _sites(rec, "f64"):
        if f"{rel}::{func}" in entry.f64_ok:
            continue
        add("K2L102", f"f64:{func}",
            f"{len(hits)} ops make float64 values in '{func}' "
            f"({', '.join(sorted({d for _, d in hits}))}), not a place the "
            "entry's f64_ok names", file=rel, line=hits[0][0])
    if entry.int8_region:
        deq = rec.count("dequant")
        if deq > entry.sanctioned_dequants:
            where = ", ".join(f"{rel}::{func}"
                              for rel, func, _ in _sites(rec, "dequant"))
            add("K2L102", "dequant-budget",
                f"{deq} int8 -> float dequantizations a call, "
                f"{entry.sanctioned_dequants} sanctioned (§13: only the "
                f"residual-norm pass may dequantize before the exact "
                f"re-rank); at {where}")
    if entry.collective_free and rec.collectives:
        add("K2L104", "collective",
            f"{rec.collectives} Mesh collectives in a collective-free entry")
    elif not entry.collective_free and rec.collectives != entry.collectives:
        add("K2L104", "collective-count",
            f"{rec.collectives} Mesh collectives a call, "
            f"{entry.collectives} declared (§7.1)")
    return findings


def audit_entry(entry: EntryPoint, device="cpu",
                repo_root: str = "") -> tuple[list[Finding], dict]:
    """Run ``entry`` twice (and at ``build_alt``'s shape) and check it.
    Returns (findings, the first run's counts)."""
    from .registry import mesh1

    def fail(rule, site, what, e):
        return Finding(rule=rule, severity="error", file=entry.file,
                       line=0, entry=entry.name, site=site,
                       message=f"{what}: {type(e).__name__}: {e}")

    ctx = mesh1(device) if entry.mesh else contextlib.nullcontext()
    with ctx:
        try:
            rec = run_entry(entry, device, repo_root)
        except Exception as e:  # noqa: BLE001 — a failure is a finding
            return [fail("K2L100", "run", "entry failed to run", e)], {}
        findings = check_run(entry, rec)
        try:
            rec2 = run_entry(entry, device, repo_root)
            if rec2.ops != rec.ops:
                # a third run tells a first call's one-time set-up (a
                # workspace made and cached) from a step that drifts
                rec3 = run_entry(entry, device, repo_root)
                steady = rec3.ops == rec2.ops
                at = next((i for i, (a, b) in enumerate(zip(rec.ops,
                                                            rec2.ops))
                           if a != b), min(len(rec.ops), len(rec2.ops)))
                findings.append(Finding(
                    rule="K2L103", severity="info" if steady else "error",
                    file=entry.file, line=0, entry=entry.name,
                    site="first-run" if steady else "rerun",
                    message=(f"the first run issues {len(rec.ops)} ops, "
                             f"later runs {len(rec2.ops)} (first "
                             f"difference at op {at}): one-time set-up, "
                             f"to be done before a CUDA graph capture"
                             if steady else
                             f"runs from identical builds issue different "
                             f"op sequences ({len(rec.ops)}, "
                             f"{len(rec2.ops)} and {len(rec3.ops)} ops, "
                             f"first difference at op {at}): a Python-side "
                             f"value leaks into the step, which a CUDA "
                             f"graph capture cannot survive")))
        except Exception as e:  # noqa: BLE001
            findings.append(fail("K2L103", "rerun", "re-run failed", e))
        if entry.build_alt is not None:
            try:
                run_entry(entry, device, repo_root, alt=True)
            except Exception as e:  # noqa: BLE001
                findings.append(fail(
                    "K2L103", "alt-shape", "entry does not run at a second "
                    "shape (a dimension leaked as a Python value?)", e))
    counts = {"host_reads": rec.count("host_read"),
              "dynamic_shape_ops": rec.count("dynamic_shape"),
              "dequants": rec.count("dequant"), "f64_ops": rec.count("f64"),
              "collectives": rec.collectives, "ops": len(rec.ops)}
    return findings, counts


def run(entries: list[EntryPoint] | None = None, repo_root: str = "",
        device="cpu") -> tuple[list[Finding], dict]:
    entries = audit_entries() if entries is None else entries
    findings: list[Finding] = []
    per_entry = {}
    for entry in entries:
        fs, counts = audit_entry(entry, device, repo_root)
        findings.extend(fs)
        per_entry[entry.name] = counts
    stats = {"entries": len(entries), "findings": len(findings),
             "device": str(device), "per_entry": per_entry}
    return findings, stats
