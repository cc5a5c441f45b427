"""graftlint for the port: torch-aware static analysis of
``hydragnn_tpu_torch``.

Catches, at commit time, the failure classes that otherwise surface
hours into a run on the card: torch API drift (attributes that do not
exist in the installed torch), host-device syncs in the step hot path
and in code a CUDA graph records, nondeterminism in the batch plan,
config keys the port silently ignores, and the concurrency and
durability contracts of the serving tier and the checkpoint writer.

CLI: ``python -m hydragnn_tpu_torch.analysis --check``.
Library: ``run_lint(root)`` -> ``LintResult``.
"""

from hydragnn_tpu_torch.analysis.engine import (
    Finding,
    LintResult,
    Rule,
    lint_sources,
    load_baseline,
    run_lint,
    write_baseline,
)
from hydragnn_tpu_torch.analysis.rules import DEFAULT_PATHS, all_rules, rules_by_name

__all__ = [
    "DEFAULT_PATHS",
    "Finding",
    "LintResult",
    "Rule",
    "all_rules",
    "lint_sources",
    "load_baseline",
    "rules_by_name",
    "run_lint",
    "write_baseline",
]
