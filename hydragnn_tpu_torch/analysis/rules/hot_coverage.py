"""hot-coverage: every captured function on a production path must be
a host-sync HOT_SEED (or an explicit exemption).

Every hot path the port grows has to be appended to
``host_sync.HOT_SEEDS`` by hand — a convention that holds only by
review vigilance. This rule turns the forgotten append into a lint
failure: it walks the callgraph from the production entry points
(``run_training`` / ``run_prediction`` / every ``ServingEngine``
method / the rollout surface), collects every CAPTURED function on
those paths (``callgraph.captured``: what a CUDA graph records,
INCLUDING functions nested under reachable builders — step closures are
passed by value, so qualname nesting is the ground truth, exactly as
host-sync expands its seeds), and requires each to be covered:

- the function itself, or any enclosing def on its qualname chain,
  matches a ``HOT_SEEDS`` entry (seeding a builder covers everything
  nested under it); or
- it matches an entry in the ``HOT_EXEMPT`` registry below, whose
  grammar is ``(path_suffix, qualname): "reason"`` — the reason is
  mandatory and rendered by ``--explain hot-coverage``.

An uncovered captured entry means a stray ``.item()`` added to it later
would never lint — until the capture fails on the card.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

# The production entry points whose transitive captured surface must be
# host-sync covered. A class name seeds every method (qualname prefix).
ENTRY_SEEDS = (
    ("runner.py", "run_training"),
    ("runner.py", "run_prediction"),
    ("serve/engine.py", "ServingEngine"),
    # The MD rollout surface: every captured function reachable from
    # the public simulation entry (the macro, its step, the neighbour
    # builder and the t=0 force pass) must be a host-sync HOT_SEED —
    # the macro replays millions of physics steps per run.
    ("simulate/engine.py", "run_simulation"),
    ("simulate/engine.py", "RolloutEngine"),
)

# (path_suffix, qualname): reason. Exemptions are for captured
# functions on a production path whose run is NOT step-hot — one-shot
# or end-of-run work where a per-run host sync is the design, not a
# defect. The qualname may name the captured def or any enclosing def
# (same chain rule as HOT_SEEDS coverage).
HOT_EXEMPT: Dict[Tuple[str, str], str] = {
    ("train/loop.py", "recalibrate_batch_stats"): (
        "end-of-training BN recalibration: ONE bounded eager pass that "
        "fetches pooled moments per batch by design — never inside the "
        "epoch loop, never captured"
    ),
}


def _covered_by_seeds(key, seeds) -> bool:
    """Does (rel, qual) — or any enclosing def on its qualname chain —
    match a (path_suffix, qualname) seed, by graph.find's rules?"""
    rel, qual = key
    parts = qual.split(".")
    prefixes = [".".join(parts[: i + 1]) for i in range(len(parts))]
    for path_sfx, seed_qual in seeds:
        if not rel.endswith(path_sfx):
            continue
        for p in prefixes:
            if p == seed_qual or p.endswith("." + seed_qual):
                return True
    return False


class HotCoverageRule(Rule):
    name = "hot-coverage"
    description = (
        "captured functions reachable from run_training/"
        "run_prediction/ServingEngine/run_simulation must be "
        "HOT_SEEDS-covered"
    )
    seeds = ENTRY_SEEDS

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        from hydragnn_tpu_torch.analysis.rules.host_sync import HOT_SEEDS

        graph = ctx.callgraph
        entry_keys: Set = set()
        for path_sfx, qual in ENTRY_SEEDS:
            entry_keys.update(graph.find(path_sfx, qual))
            # class seed: every method under the qualname
            for (rel, q) in graph.funcs:
                if rel.endswith(path_sfx) and q.startswith(qual + "."):
                    entry_keys.add((rel, q))
        if not entry_keys:
            return  # restricted run without the entry modules
        reach = graph.reachable(entry_keys)
        # step closures nested under reachable builders
        candidates: Set = set()
        for key, info in graph.funcs.items():
            if not info.captured:
                continue
            if key in reach:
                candidates.add(key)
                continue
            rel, qual = key
            parts = qual.split(".")
            for i in range(1, len(parts)):
                if (rel, ".".join(parts[:i])) in reach:
                    candidates.add(key)
                    break
        for key in sorted(candidates):
            if _covered_by_seeds(key, HOT_SEEDS):
                continue
            if _covered_by_seeds(key, HOT_EXEMPT):
                continue
            rel, qual = key
            root = qual.split(".")[0]
            yield Finding(
                self.name, rel, graph.funcs[key].node.lineno,
                f"captured `{qual}` is reachable from a production "
                "entry point but not covered by host-sync HOT_SEEDS — "
                f"append ('{_suffix(rel)}', '{root}') to HOT_SEEDS "
                "(hydragnn_tpu_torch/analysis/rules/host_sync.py) or exempt "
                "it in HOT_EXEMPT with a reason",
            )


def _suffix(rel: str) -> str:
    """Render the conventional 2-component path suffix used by
    HOT_SEEDS entries (stable across repo-root layouts)."""
    parts = rel.split("/")
    return "/".join(parts[-2:]) if len(parts) > 1 else rel
