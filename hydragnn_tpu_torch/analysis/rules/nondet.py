"""nondet: nondeterminism sources in code that must be bit-reproducible.

The input pipeline guarantees bit-identical batch sequences between
``workers: 0`` and the parallel feed because ``GraphLoader.epoch_plan``
is a pure function of (dataset sizes, seed, epoch). A ``time.time()``,
global-state ``np.random.*`` call, or unseeded ``random`` module call
anywhere in that plan (or inside code a CUDA graph records, where it
would bake a capture-time constant into every replay) breaks the
invariant in ways that only surface as cross-run or cross-worker
divergence.

Scope = captured functions (``callgraph.captured``) and what they reach
+ everything statically reachable from ``GraphLoader.epoch_plan``.
Seeded constructs (``np.random.default_rng``,
``Generator``/``RandomState``/``SeedSequence``/bit generators,
``random.Random(seed)``) are allowed everywhere — the rule targets the
process-global implicit RNG state and wall clocks only.
"""

from __future__ import annotations

import ast
from typing import Iterable

from hydragnn_tpu_torch.analysis.callgraph import (
    module_env,
    own_statements,
    seed_scope,
)
from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

PLAN_SEEDS = (
    ("data/loader.py", "GraphLoader.epoch_plan"),
    ("data/loader.py", "GraphLoader._epoch_batches"),
)

_CLOCK_FNS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time",
}
# np.random.* entry points that are seeded objects, not global-state draws
_NP_RANDOM_OK = {
    "default_rng", "Generator", "RandomState", "SeedSequence",
    "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937", "BitGenerator",
    "get_state", "set_state", "seed",
}
_RANDOM_MOD_OK = {"Random", "SystemRandom", "seed", "getstate", "setstate"}


class NondetRule(Rule):
    name = "nondet"
    description = (
        "clocks / global-RNG calls in captured or epoch-plan-reachable code"
    )
    seeds = PLAN_SEEDS

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        graph = ctx.callgraph
        plan_reach = seed_scope(graph, PLAN_SEEDS)
        cap_reach = graph.reachable({f.key for f in graph.captured()})
        envs = {}
        for key in sorted(plan_reach | cap_reach):
            info = graph.funcs[key]
            sf = info.module
            env = envs.setdefault(sf.relpath, module_env(sf))
            where = (
                f"captured `{key[1]}`"
                if info.captured and key not in plan_reach
                else f"`{key[1]}` (reachable from GraphLoader.epoch_plan)"
                if key in plan_reach
                else f"`{key[1]}` (reachable from captured code)"
            )
            for node in own_statements(info.node):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if not (
                    isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, (ast.Name, ast.Attribute))
                ):
                    continue
                # time.X()
                if (
                    isinstance(fn.value, ast.Name)
                    and env.mod_aliases.get(fn.value.id) == "time"
                    and fn.attr in _CLOCK_FNS
                ):
                    yield Finding(
                        self.name, sf.relpath, node.lineno,
                        f"`time.{fn.attr}()` in {where} — wall-clock "
                        "value breaks bit-reproducibility of the "
                        "batch plan / traced constant",
                    )
                # random.X() on the global random module
                elif (
                    isinstance(fn.value, ast.Name)
                    and env.mod_aliases.get(fn.value.id) == "random"
                    and fn.attr not in _RANDOM_MOD_OK
                ):
                    yield Finding(
                        self.name, sf.relpath, node.lineno,
                        f"global-state `random.{fn.attr}()` in {where} "
                        "— use a seeded random.Random / "
                        "np.random.default_rng instance",
                    )
                # np.random.X()
                elif (
                    isinstance(fn.value, ast.Attribute)
                    and fn.value.attr == "random"
                    and isinstance(fn.value.value, ast.Name)
                    and env.mod_aliases.get(fn.value.value.id) == "numpy"
                    and fn.attr not in _NP_RANDOM_OK
                ):
                    yield Finding(
                        self.name, sf.relpath, node.lineno,
                        f"global-state `np.random.{fn.attr}()` in "
                        f"{where} — draws from process-global RNG "
                        "state; use np.random.default_rng(seed)",
                    )
