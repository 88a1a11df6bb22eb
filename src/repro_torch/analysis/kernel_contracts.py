"""Pass 2 — the CUDA launch-plan checker (DESIGN.md §15.4, K2L20x), the
port's counterpart of ``repro.analysis.kernel_contracts``.

No launch configuration is re-declared here: every launcher in
``kernels/csrc/*.cu`` takes its grid, block, dynamic shared memory and
template variant from a host-only plan function that its library also
exports (``k2_plan_<kernel>``, ``csrc/common.cuh``), so the plan the
checker reads is the one the launcher launches — the counterpart of the
reference's interception of the real ``pl.pallas_call``. On the card
each registered case (``analysis.registry.kernel_entries``) launches its
kernel once through the wrapper, its plan is read at the same shapes,
and the instantiation it names is asked for its attributes
(``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
and its ptxas log. Each :class:`LaunchPlan` is then checked
declaratively; on the CPU the rules are held against seeded records.

``K2L200``  the case failed to run, the wrapper did not raise
            ``_build.LAUNCHES[name]``, or the plan symbol is missing.
``K2L201``  a block's extent or a walked tile does not divide its operand
            (rows, cols, inner), and the entry does not declare that the
            kernel guards that axis itself (``pad_ok``).
``K2L202``  (warn) the plan fell back from 16-byte ``cp.async`` pieces
            (``k2_aligned16``) to its scalar path, in a case that does not
            declare it exercises that path (``scalar_ok``).
``K2L203``  dynamic shared memory above the card's opt-in limit, or fewer
            resident blocks an SM than the design states
            (``min_blocks_per_sm``, e.g. K7's ``static_assert``).
``K2L204``  the grid does not cover the plan's units of work exactly once:
            a grid too small or a block with nothing to do, or, for a
            persistent kernel, a stride other than the grid's reach.
``K2L205``  (warn) spill stores or loads above 0 bytes: ptxas's log of
            the instantiation launched (matched by its stack frame, the
            runtime's ``localSizeBytes``); registers a thread and local
            bytes go in the pass's stats.
"""
from __future__ import annotations

import dataclasses

from .report import Finding
from .registry import KernelCase, KernelEntry, kernel_entries

CPU_NOTE = ("the kernel pass runs only on the card: no kernel is built or "
            "launched on the CPU, so no plan is read")


@dataclasses.dataclass
class LaunchPlan:
    """One launch as its plan function describes it (fields of
    ``k2_plan_fields``), with what the card says of the instantiation."""
    kernel: str
    variant: int
    variant_name: str
    grid: tuple
    launches: int
    threads: int
    smem: int
    vec: int
    rows: int
    row_extent: int
    cols: int = 1
    col_extent: int = 1
    batch: int = 1
    inner: int = 0
    inner_tile: int = 1
    per_block: int = 1
    stride: int = 0
    resident: int = 0
    attrs: dict | None = None       # _build.attrs of the instantiation
    smem_optin: int | None = None   # the card's opt-in limit a block
    spill: tuple = (0, 0, 0)        # ptxas: stack, spill stores, loads

    @classmethod
    def from_plan(cls, p: dict, **kw) -> "LaunchPlan":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(grid=(p["grid_x"], p["grid_y"], p["grid_z"]),
                   **{k: v for k, v in p.items() if k in names}, **kw)

    def summary(self) -> dict:
        a = self.attrs or {}
        return {"kernel": self.kernel, "variant": self.variant_name,
                "grid": list(self.grid), "launches": self.launches,
                "threads": self.threads, "smem": self.smem,
                "registers": a.get("registers"),
                "local_bytes": a.get("local_bytes"),
                "spill_bytes": self.spill[1] + self.spill[2],
                "blocks_per_sm": a.get("blocks_per_sm"), "vec": self.vec,
                "resident": self.resident}


def _cdiv(a: int, b: int) -> int:
    return -(-a // max(b, 1))


def check_record(entry: KernelEntry, case: KernelCase,
                 rec: LaunchPlan) -> list[Finding]:
    findings: list[Finding] = []

    def add(rule, site, message, severity="error"):
        findings.append(Finding(rule=rule, severity=severity,
                                file=entry.source, line=0,
                                entry=f"{entry.name}/{case.label}",
                                site=site, message=message))

    # --- K2L201 tile divisibility ---------------------------------------
    for axis, n, tile in (("rows", rec.rows, rec.row_extent),
                          ("cols", rec.cols, rec.col_extent),
                          ("inner", rec.inner, rec.inner_tile)):
        if tile < 1:
            add("K2L201", f"{axis}-tile", f"{axis}: tile {tile} < 1")
        elif n % tile and axis not in entry.pad_ok:
            add("K2L201", axis,
                f"{axis}: {n} does not divide by the plan's tile {tile} "
                "and the entry declares no guard of that axis (pad_ok)")

    # --- K2L202 the 16-byte copy path -----------------------------------
    if rec.vec == 0 and not case.scalar_ok:
        add("K2L202", "scalar-path",
            f"plan fell back to the scalar copy path ({rec.variant_name}): "
            "an operand is not 16-byte aligned or a row is not a multiple "
            "of 16 bytes", severity="warn")

    # --- K2L203 shared memory and residency -----------------------------
    if rec.smem_optin is not None and rec.smem > rec.smem_optin:
        add("K2L203", "smem",
            f"{rec.smem} B of dynamic shared memory a block, above the "
            f"card's opt-in limit of {rec.smem_optin} B")
    per_sm = (rec.attrs or {}).get("blocks_per_sm")
    if per_sm is not None and per_sm < case.min_blocks_per_sm:
        add("K2L203", "occupancy",
            f"{per_sm} resident blocks an SM at {rec.threads} threads and "
            f"{rec.smem} B, the design states {case.min_blocks_per_sm}")

    # --- K2L204 coverage -------------------------------------------------
    units = (_cdiv(rec.rows, rec.row_extent) * _cdiv(rec.cols,
                                                     rec.col_extent)
             * rec.batch)
    blocks = rec.grid[0] * rec.grid[1] * rec.grid[2]
    reach = blocks * rec.per_block
    if rec.stride:
        if rec.stride != reach:
            add("K2L204", "stride",
                f"persistent kernel strides {rec.stride} units a pass but "
                f"its {blocks} blocks reach {reach}: units are skipped or "
                "covered twice")
        elif units and blocks > _cdiv(units, rec.per_block):
            add("K2L204", "idle",
                f"{blocks} persistent blocks for {units} units")
    elif units:
        cover = reach * rec.launches
        if cover < units:
            add("K2L204", "coverage",
                f"{rec.launches} launches of {blocks} blocks cover {cover} "
                f"of {units} units of work")
        elif (rec.launches == 1 and reach - rec.per_block >= units) or (
                rec.launches > 1 and reach * (rec.launches - 1) >= units):
            add("K2L204", "excess",
                f"{rec.launches} launches of {blocks} blocks for {units} "
                "units: a block (or a launch) has nothing to cover")

    # --- K2L205 spills ----------------------------------------------------
    if rec.spill[1] or rec.spill[2]:
        add("K2L205", "spill",
            f"{rec.variant_name}: ptxas reports {rec.spill[1]} B of spill "
            f"stores and {rec.spill[2]} B of spill loads a thread "
            f"({rec.spill[0]} B stack frame)", severity="warn")
    return findings


def ptxas_spill(entry: KernelEntry, spills: dict, local_bytes: int) -> tuple:
    """(stack, spill stores, spill loads) that ptxas reports for the
    instantiation launched: among the log's functions of the entry's
    kernel, those whose stack frame is the runtime's ``localSizeBytes``
    for it (the largest when several match; (0, 0, 0) when none does)."""
    hits = [v for name, v in spills.items()
            if entry.symbol in name and v[0] == local_bytes]
    return tuple(max((h[i] for h in hits), default=0) for i in range(3))


def check_kernel(entry: KernelEntry, device="cuda",
                 limits: dict | None = None) -> tuple[list, list]:
    """Launch each case once on the card and check its plan. Returns
    (findings, [LaunchPlan.summary() + case label])."""
    import torch
    from ..kernels import _build
    findings: list[Finding] = []
    plans = []
    dev = torch.device(device)
    limits = limits or _build.device_limits()
    log = _build.spills(entry.lib)
    for case in entry.cases:
        def fail(site, msg):
            findings.append(Finding(
                rule="K2L200", severity="error", file=entry.file, line=0,
                entry=f"{entry.name}/{case.label}", site=site, message=msg))
        try:
            fn, args, plan = case.build(dev)
            before = _build.LAUNCHES[entry.name]
            fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            launched = _build.LAUNCHES[entry.name] != before
        except Exception as e:  # noqa: BLE001 — a failure is a finding
            fail("run", f"case failed to run: {type(e).__name__}: {e}")
            continue
        if not launched:
            fail("no-launch", f"the wrapper did not count a launch of "
                 f"'{entry.name}' (LAUNCHES did not move)")
            continue
        try:
            p = plan()
            attrs = _build.attrs(entry.lib, p["kernel"], p["variant"],
                                 p["threads"], p["smem"])
        except AttributeError as e:
            fail("plan-symbol", f"plan symbol missing: {e}")
            continue
        except Exception as e:  # noqa: BLE001
            fail("plan", f"plan or attributes failed: {type(e).__name__}: "
                 f"{e}")
            continue
        rec = LaunchPlan.from_plan(
            p, attrs=attrs, smem_optin=limits["smem_optin"],
            spill=ptxas_spill(entry, log, attrs["local_bytes"]))
        findings.extend(check_record(entry, case, rec))
        plans.append({"case": case.label, **rec.summary()})
    return findings, plans


def run(entries: list[KernelEntry] | None = None, repo_root: str = "",
        device="cuda") -> tuple[list[Finding], dict]:
    entries = kernel_entries() if entries is None else entries
    import torch
    ncases = sum(len(e.cases) for e in entries)
    if torch.device(device).type != "cuda":
        return [], {"kernels": len(entries), "cases": ncases,
                    "device": str(device), "findings": 0,
                    "skipped": CPU_NOTE}
    from ..kernels import _build
    _build.build_all()
    limits = _build.device_limits()
    findings: list[Finding] = []
    plans = []
    for entry in entries:
        fs, ps = check_kernel(entry, device, limits)
        findings.extend(fs)
        plans.extend(ps)
    return findings, {"kernels": len(entries), "cases": ncases,
                      "device": str(device), "findings": len(findings),
                      "limits": limits, "plans": plans}
