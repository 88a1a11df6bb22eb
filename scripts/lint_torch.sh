#!/usr/bin/env bash
# k2lint for the PyTorch/CUDA port: the analysis gate of src/repro_torch
# (DESIGN.md §15), the counterpart of scripts/lint.sh.
#
# Runs all three passes — the host-sync auditor (K2L100-K2L105), the CUDA
# launch-plan checker (K2L200-K2L205) and the counted-op coverage lint
# (K2L300-K2L301) — writes k2lint_torch_report.json at the repo root and
# exits 1 on any error finding not in the committed baseline
# (src/repro_torch/analysis/baseline.json), 2 when the analyzer itself
# fails. It runs on the card by default and fails without one; on the CPU
# the kernel pass is reported as needing the card. Extra args pass
# through, e.g.:
#
#   scripts/lint_torch.sh                    # on the card: every pass
#   scripts/lint_torch.sh --device cpu       # the audit and the lint
#   scripts/lint_torch.sh --update-baseline  # accept current findings
#                                            # (then edit in per-finding
#                                            # justifications)
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src
exec python -m repro_torch.analysis "$@"
