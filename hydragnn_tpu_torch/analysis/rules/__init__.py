"""graftlint rule registry of the port.

Every rule family lives in its own module; ``all_rules()`` is the
default set run by the CLI and the repo gate test. Adding a rule:
subclass ``hydragnn_tpu_torch.analysis.engine.Rule``, implement
``run(ctx)`` yielding ``Finding``s, register it here, and add
positive/negative fixtures to tests/test_torch_analysis.py.
"""

from __future__ import annotations

from typing import List

from hydragnn_tpu_torch.analysis.engine import Rule

# What the CLI lints when no paths are given: the port's package (its
# drivers included) and chip_smoke.py, plus the JSON configs of the
# example fleet and the test inputs. Only JSON is collected under
# JSON_ONLY_PATHS: the JAX package's example scripts are neither linted
# nor harvested for config keys.
DEFAULT_PATHS = (
    "hydragnn_tpu_torch",
    "chip_smoke.py",
    "examples",
    "tests/inputs",
)
JSON_ONLY_PATHS = ("examples", "tests/inputs")


def all_rules() -> List[Rule]:
    from hydragnn_tpu_torch.analysis.rules.barrier_discipline import (
        BarrierDisciplineRule,
    )
    from hydragnn_tpu_torch.analysis.rules.config_schema import ConfigSchemaRule
    from hydragnn_tpu_torch.analysis.rules.guarded_field import GuardedFieldRule
    from hydragnn_tpu_torch.analysis.rules.host_sync import HostSyncRule
    from hydragnn_tpu_torch.analysis.rules.hot_coverage import HotCoverageRule
    from hydragnn_tpu_torch.analysis.rules.lock_order import LockOrderRule
    from hydragnn_tpu_torch.analysis.rules.nondet import NondetRule
    from hydragnn_tpu_torch.analysis.rules.suppression import SuppressionRule
    from hydragnn_tpu_torch.analysis.rules.thread_discipline import (
        ThreadDisciplineRule,
    )
    from hydragnn_tpu_torch.analysis.rules.torch_api import TorchApiRule

    return [
        TorchApiRule(),
        HostSyncRule(),
        NondetRule(),
        ConfigSchemaRule(),
        ThreadDisciplineRule(),
        LockOrderRule(),
        GuardedFieldRule(),
        BarrierDisciplineRule(),
        HotCoverageRule(),
        SuppressionRule(),
    ]


def rules_by_name(names) -> List[Rule]:
    sel = set(names)
    out = [r for r in all_rules() if r.name in sel]
    missing = sel - {r.name for r in out}
    if missing:
        raise ValueError(f"unknown rule(s): {sorted(missing)}")
    return out
