"""k2lint CLI of the port: run all three passes, write
``k2lint_torch_report.json``, apply the committed baseline and gate
(DESIGN.md §15.6), as ``repro.analysis.cli`` does for the reference.

Exit codes: 0 — no new blocking findings; 1 — new ``error`` findings
(printed with fingerprints so they can be fixed or, with an audited
justification, baselined); 2 — the analyzer itself failed.

The passes run on the card unless ``--device cpu`` is given; without a
card the default raises (exit 2), as the port's entry points do. On the
CPU the audit and the lint run in full, and the kernel pass says in its
stats that it runs only on the card.

Usage (see ``scripts/lint_torch.sh``)::

    python -m repro_torch.analysis [--device cuda|cpu]
                                   [--out k2lint_torch_report.json]
                                   [--baseline src/repro_torch/analysis/baseline.json]
                                   [--update-baseline] [--quiet]
"""
from __future__ import annotations

import argparse
import os
import sys

from . import host_sync_audit, kernel_contracts, opcount_lint, report

DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"
DEFAULT_OUT = "k2lint_torch_report.json"
PASSES = (("host_sync_audit", host_sync_audit.run),
          ("kernel_contracts", kernel_contracts.run),
          ("opcount_lint", opcount_lint.run))


def _repo_root() -> str:
    """src/repro_torch/analysis/cli.py -> the repo checkout root."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run(out: str = DEFAULT_OUT,
        baseline: str | None = None,
        update_baseline: bool = False,
        quiet: bool = False,
        repo_root: str | None = None,
        device=None,
        passes=None) -> int:
    from ..device import resolve
    passes = PASSES if passes is None else passes
    dev = resolve(device)
    root = _repo_root() if repo_root is None else repo_root
    base_path = os.path.join(root, baseline or DEFAULT_BASELINE)

    findings = []
    stats = {}
    for name, pass_run in passes:
        if name == "opcount_lint":
            fs, st = pass_run(repo_root=root)
        else:
            fs, st = pass_run(repo_root=root, device=dev)
        findings.extend(fs)
        stats[name] = st
        if not quiet:
            brief = {k: v for k, v in st.items()
                     if k not in ("per_entry", "plans", "limits")}
            print(f"k2lint: {name}: {brief}")

    report.finalize_findings(findings)
    baseline_map = report.load_baseline(base_path) \
        if os.path.exists(base_path) else {}
    blocking = report.apply_baseline(findings, baseline_map)

    if update_baseline:
        report.write_baseline(
            base_path, blocking,
            "UNREVIEWED (--update-baseline): replace with a per-finding "
            "justification before committing")
        if not quiet:
            print(f"k2lint: wrote {len(blocking)} accepted findings to "
                  f"{base_path}")
        blocking = []

    rep = report.make_report(findings, stats, blocking)
    out_path = out if os.path.isabs(out) else os.path.join(root, out)
    report.write_report(out_path, rep)

    if not quiet:
        c = rep["counts"]
        print(f"k2lint: {c['error']} error / {c['warn']} warn / "
              f"{c['info']} info findings "
              f"({c['baselined']} baselined) -> {out_path}")
        for f in blocking:
            print(f"k2lint: NEW {f.rule} [{f.fingerprint}] "
                  f"{f.file}:{f.line} ({f.entry or f.site}): {f.message}")
    return 1 if blocking else 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="k2lint-torch", description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--baseline", default=None)
    p.add_argument("--update-baseline", action="store_true")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)
    try:
        return run(out=args.out, baseline=args.baseline,
                   update_baseline=args.update_baseline, quiet=args.quiet,
                   device=args.device)
    except Exception as e:  # noqa: BLE001 — analyzer crash != clean tree
        print(f"k2lint: analyzer failure: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 2
