"""k2lint findings, fingerprints, report and baseline I/O (DESIGN.md §15):
the port's own copy of ``repro.analysis.report``, the same schema.

A finding's *fingerprint* is a stable hash of ``(rule, file, entry,
site)`` — deliberately **not** the line number or message text, so a
baselined finding survives unrelated edits that shift lines, while any
new violation (new rule firing, new site, new entry) produces a new
fingerprint and fails CI. When one (rule, file, entry, site) key fires
more than once in a run the repeats get ``#2``, ``#3``… suffixes before
hashing, so "a second callback appeared in the same loop" is a *new*
finding, not a silent ride-along on the old baseline entry.

Severities: ``error`` findings block CI unless baselined; ``warn`` and
``info`` findings are reported in ``k2lint_report.json`` but never
block (perf hints like a scalar copy path or spills land there).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

SEVERITIES = ("error", "warn", "info")

REPORT_SCHEMA = "k2lint_report"
REPORT_VERSION = 1


@dataclasses.dataclass
class Finding:
    rule: str           # "K2L1xx" audit | "K2L2xx" kernel | "K2L3xx" ast
    severity: str       # "error" | "warn" | "info"
    file: str           # repo-relative source file of the flagged code
    line: int           # 1-based; 0 when not source-anchored
    entry: str          # registered entry/kernel name; "" for AST findings
    site: str           # stable site token (qualname / operand / prim path)
    message: str
    fingerprint: str = ""   # filled by finalize_findings()
    baselined: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def fingerprint(rule: str, file: str, entry: str, site: str) -> str:
    key = "|".join((rule, file, entry, site))
    return hashlib.sha1(key.encode()).hexdigest()[:16]


def finalize_findings(findings: list[Finding]) -> list[Finding]:
    """Assign fingerprints, disambiguating repeated (rule, file, entry,
    site) keys with ordinal suffixes (see module docstring)."""
    seen: dict[tuple, int] = {}
    for f in findings:
        if f.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {f.severity!r}")
        key = (f.rule, f.file, f.entry, f.site)
        n = seen.get(key, 0) + 1
        seen[key] = n
        site = f.site if n == 1 else f"{f.site}#{n}"
        f.fingerprint = fingerprint(f.rule, f.file, f.entry, site)
    return findings


def load_baseline(path: str) -> dict[str, dict]:
    """Committed accepted findings: ``{"findings": [{"fingerprint": ...,
    "rule": ..., "justification": ...}, ...]}``. Every entry MUST carry a
    non-empty justification — the baseline is an audited debt list, not
    a mute button. Returns {fingerprint: entry}."""
    with open(path) as fh:
        data = json.load(fh)
    out = {}
    for ent in data.get("findings", []):
        fp = ent.get("fingerprint")
        if not fp:
            raise ValueError(f"baseline entry without fingerprint: {ent}")
        if not ent.get("justification"):
            raise ValueError(
                f"baseline entry {fp} has no justification; every "
                "accepted finding must say why it is accepted")
        out[fp] = ent
    return out


def write_baseline(path: str, findings: list[Finding],
                   justification: str) -> None:
    """Serialize the *blocking* findings as an accepted baseline (used by
    ``--update-baseline``; the shared justification should immediately be
    hand-edited into per-finding reasons before committing)."""
    entries = [{"fingerprint": f.fingerprint, "rule": f.rule,
                "file": f.file, "entry": f.entry, "site": f.site,
                "justification": justification}
               for f in findings if f.severity == "error"]
    with open(path, "w") as fh:
        json.dump({"findings": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


def apply_baseline(findings: list[Finding],
                   baseline: dict[str, dict]) -> list[Finding]:
    """Mark suppressed findings; returns the still-blocking subset (new
    ``error`` findings)."""
    blocking = []
    for f in findings:
        f.baselined = f.fingerprint in baseline
        if f.severity == "error" and not f.baselined:
            blocking.append(f)
    return blocking


def make_report(findings: list[Finding], passes: dict[str, dict],
                blocking: list[Finding]) -> dict:
    counts = {s: 0 for s in SEVERITIES}
    nbase = 0
    for f in findings:
        counts[f.severity] += 1
        nbase += int(f.baselined)
    return {
        "schema": REPORT_SCHEMA,
        "version": REPORT_VERSION,
        "passes": passes,
        "counts": {**counts, "baselined": nbase,
                   "blocking": len(blocking)},
        "findings": [f.to_dict() for f in findings],
        "blocking": [f.fingerprint for f in blocking],
        "ok": not blocking,
    }


def write_report(path: str, report: dict) -> None:
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")


def validate_report(report: dict) -> None:
    """Schema check used by the benchmark smoke and the tests."""
    if report.get("schema") != REPORT_SCHEMA:
        raise ValueError("not a k2lint report")
    for key in ("version", "passes", "counts", "findings", "blocking",
                "ok"):
        if key not in report:
            raise ValueError(f"k2lint report missing key {key!r}")
    for f in report["findings"]:
        for key in ("rule", "severity", "file", "line", "entry", "site",
                    "message", "fingerprint", "baselined"):
            if key not in f:
                raise ValueError(f"finding missing key {key!r}: {f}")
        if f["severity"] not in SEVERITIES:
            raise ValueError(f"bad severity in finding: {f}")
