"""k2lint for the port: run-level analysis of ``repro_torch``'s hot
paths, the counterpart of ``repro.analysis`` (DESIGN.md §15). Three
passes, each runnable on the CPU but the kernel pass, which needs the
card:

``host_sync_audit``
    runs every registered entry point (``analysis.registry``) eagerly
    under torch's function and dispatch modes and checks the §3
    deferred-host-read contract, dynamic-shape ops, dtype discipline
    (f64 only where the correct rounding puts it, no unsanctioned
    dequantization in int8 regions), run-to-run op sequences (what a
    CUDA graph capture needs) and collective placement.

``kernel_contracts``
    reads each CUDA kernel's launch plan from the ``k2_plan_*`` function
    its launcher launches by, launches the kernel once, and checks tile
    divisibility, the 16-byte copy path, shared memory and residency
    against the card, grid coverage and spills.

``opcount_lint``
    walks the source for distance-computation idioms and flags any site
    not paired with an ``OpCounter`` charge (the §2 counted-op
    methodology).

Findings carry stable fingerprints (``analysis.report``); the committed
``analysis/baseline.json`` suppresses accepted findings while any new
``error`` finding fails the gate (``scripts/lint_torch.sh``).
"""
from .report import Finding, fingerprint  # noqa: F401
