"""host-sync: device-to-host synchronization inside the step hot path
and inside code a CUDA graph records.

Every ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` of a device
tensor, ``torch.cuda.synchronize()`` or event/stream ``.synchronize()``
between steps drains the card's queue: the card idles until the host
catches up, which shows up as an unexplained throughput cliff on long
runs (the reference implementation pays a per-batch ``.item()`` —
train_validate_test.py:749 — that this codebase's epoch loop amortizes
to ONE fetch per epoch). Inside a capture the same call is worse: a
sync while ``torch.cuda.graph`` records fails the capture, and a host
value read there is baked into every replay.

Scope = the union of
- every captured function (``callgraph.captured``: what a
  ``torch.cuda.graph`` block runs, the ``fn`` handed to
  ``StepGraphs.run``/``capture``/``record``, the rollout macro) and
  everything it reaches — the CAPTURED context, and
- everything statically reachable from the ``HOT_SEEDS`` below,
  INCLUDING functions nested under a seed: closures and callbacks are
  passed by value (the step bodies ``_steps_fn`` hands to the graph
  cache, a lambda handed to ``record``), so no call edge reaches them —
  qualname nesting is the ground truth.

Flagged in that scope: ``x.item()``, ``x.tolist()``, ``x.cpu()``,
``x.numpy()`` (all with no argument), ``torch.cuda.synchronize(...)``
and ``x.synchronize()`` (an event or a stream), and — in CAPTURED
context only, where it reads a capture-time value into every replay —
``np.asarray(...)`` / ``np.array(...)``. The rule cannot know a
receiver's type: a ``.numpy()`` of a host tensor is no sync, and
carries its reason in place.

Intentional syncs — the once-per-epoch metric fetch, the engine's
``_resolve`` fetch, the rollout's per-macro policy fetch, the syncs
around a capture — carry ``# graftlint: disable=host-sync -- why``
comments; that is the designed workflow, not an exception to it.
``chip_smoke.py``'s [lint] phase holds the rule to the card: under
``torch.cuda.set_sync_debug_mode("warn")`` every synchronizing call of
replayed train steps and a served bin must sit on a line this rule
flags, or in a function outside its scope (``site_verdict``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional, Set, Tuple

from hydragnn_tpu_torch.analysis.callgraph import (
    FuncKey,
    module_env,
    own_statements,
    seed_scope,
)
from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

HOT_SEEDS = (
    ("train/loop.py", "_run_epoch"),
    # The single-step builders: their step closures dispatch once per
    # batch on the non-superstep path. Seeding the builders makes the
    # nested steps hot directly.
    ("train/loop.py", "make_train_step"),
    ("train/loop.py", "make_eval_step"),
    ("parallel/dp.py", "make_dp_train_step"),
    ("parallel/dp.py", "make_dp_eval_step"),
    ("parallel/multibranch.py", "make_multibranch_train_step"),
    # The superstep executors: the K-step closure is handed to the
    # graph cache by value (``_dispatch``), invisible to the name-based
    # call edges — the nested-def expansion makes it hot. The dp
    # variant runs the data-parallel step with its all-reduce inside.
    ("train/loop.py", "make_superstep_fn"),
    ("parallel/dp.py", "make_dp_superstep_fn"),
    # The dp epoch driver: DPLoader's iterator and its per-delivery
    # collation run between every step dispatch — a stray sync there
    # stalls every rank.
    ("parallel/dp.py", "DPLoader.__iter__"),
    ("parallel/dp.py", "DPLoader._collate"),
    # The multibranch epoch driver + its plan-domain resume cursor: the
    # stacked-batch iterator runs between every step dispatch, and
    # skip_to's per-slot epoch_plan replay runs inside a resumed
    # epoch's first fetch — spec arithmetic only, nothing may touch
    # the device.
    ("parallel/multibranch.py", "MultiBranchLoader.__iter__"),
    ("parallel/multibranch.py", "MultiBranchLoader.skip_to"),
    # The async checkpoint path: save() runs on the CALLER thread
    # between optimizer steps — its only permitted sync is the designed
    # snapshot (suppressed in place); the background worker must only
    # ever touch host-materialized trees — a device access there
    # re-serializes against the training stream the whole writer exists
    # to stay off of.
    ("utils/checkpoint.py", "CheckpointWriter.save"),
    ("utils/checkpoint.py", "CheckpointWriter._worker_main"),
    # The mid-epoch resume fast-forward: skip_to + the plan-domain
    # group cutters run once per resume inside the epoch's first fetch
    # — spec arithmetic only, nothing may touch the device.
    ("data/loader.py", "GraphLoader.skip_to"),
    ("data/loader.py", "drop_consumed_groups"),
    ("data/loader.py", "skip_delivered_items"),
    ("data/pipeline.py", "ParallelPipelineLoader.skip_to"),
    # The run-telemetry emit paths: emit() and record() run between
    # every step dispatch and must stay pure host work — the ONLY
    # permitted syncs are the config-gated sampled fence in
    # StepClock.record and the one batched epoch-end fetch in
    # StepClock.finish, both suppressed in place. The stream's worker
    # thread may never touch the device at all.
    ("utils/telemetry.py", "TelemetryStream.emit"),
    ("utils/telemetry.py", "emit"),
    ("utils/telemetry.py", "StepClock.record"),
    ("utils/telemetry.py", "StepClock.finish"),
    ("utils/telemetry.py", "TelemetryStream._worker_main"),
    # Roofline attribution: the first-run counter runs the key's first
    # step eagerly on the step thread (the counterpart of the JAX
    # package's first-dispatch executable capture) — it may count,
    # never sync; the memory sampler runs at epoch boundaries and after
    # captures and must stay pure host reads; the trace-annotation
    # helpers run per dispatch while a profiler window is live.
    ("utils/telemetry.py", "ExecCounter.run"),
    ("utils/telemetry.py", "memory_row"),
    ("utils/tracer.py", "note_trace_step"),
    ("utils/tracer.py", "step_annotation"),
    # Fleet observability: the liveness counters/phase marks run on the
    # feed hot paths (once per delivery) and per epoch; the heartbeat
    # builder runs on its own thread but must stay pure host reads (a
    # device touch there would serialize against the step stream from
    # a background thread); emit_barrier runs on the checkpoint worker
    # AND the caller thread — all must never sync.
    ("utils/telemetry.py", "bump"),
    ("utils/telemetry.py", "note_phase"),
    ("utils/telemetry.py", "heartbeat_row"),
    ("utils/telemetry.py", "emit_barrier"),
    ("utils/telemetry.py", "TelemetryStream._heartbeat_main"),
    # The instrumented rendezvous themselves: barrier timing must ride
    # the process group and its store only — a device sync in
    # _barrier or _store_meet would fence the training stream from the
    # writer thread. _processes_agree_finite's one flag fetch after its
    # all-reduce is the designed exception, suppressed in place.
    ("utils/checkpoint.py", "_barrier"),
    ("utils/checkpoint.py", "_store_meet"),
    ("utils/checkpoint.py", "_processes_agree_finite"),
    # The divergence guard: guarded_commit + the poison helpers run in
    # every guarded step (inside the captured K-step graph);
    # GuardMonitor.observe runs between every dispatch and must stay
    # list appends, and the monitor's ONLY legal sync is the designed
    # resolution fetch in check() (epoch-end / opt-in sampled cadence),
    # suppressed in place. A stray `.item()` anywhere here fences every
    # dispatch, and inside the graph fails the capture.
    ("train/guard.py", "guarded_commit"),
    ("train/guard.py", "poison_scalar"),
    ("train/guard.py", "poison_grads"),
    ("train/guard.py", "poison_batch"),
    ("train/guard.py", "GuardMonitor.observe"),
    ("train/guard.py", "GuardMonitor.check"),
    # The online-serving hot paths: the batcher's submit/placement/
    # next_bin run between every request and every dispatch, and the
    # engine's dispatch loop is the serving twin of _run_epoch — its
    # ONLY permitted sync is the designed response fetch in _resolve
    # (suppressed in place; paid AFTER the next bin was dispatched,
    # preserving the double-buffer overlap).
    ("serve/batcher.py", "DynamicBatcher.submit"),
    ("serve/batcher.py", "DynamicBatcher._place"),
    ("serve/batcher.py", "DynamicBatcher.next_bin"),
    ("serve/engine.py", "ServingEngine.process"),
    ("serve/engine.py", "ServingEngine._dispatch"),
    ("serve/engine.py", "ServingEngine._resolve"),
    ("serve/engine.py", "ServingEngine.collate_bin"),
    # The fleet routing front: submit runs on every frontend thread
    # between requests — policy arithmetic over host-side queue gauges
    # only. The swap is the rollover's atomic section: anything slow
    # inside it widens the window every concurrent submit serializes
    # behind.
    ("serve/router.py", "Router.submit"),
    ("serve/router.py", "Router._route"),
    ("serve/router.py", "Router._shed"),
    ("serve/fleet.py", "ServingTier.submit"),
    ("serve/fleet.py", "ReplicaHandle.submit_inner"),
    ("serve/fleet.py", "ReplicaHandle.swap"),
    # The replica worker mains: the pump IS the per-replica dispatch
    # loop (its only legal sync is inside engine.process's designed
    # resolve fetch), and the beat main must stay a clock read + flag
    # write — a device touch there turns the liveness signal into a
    # liveness HAZARD. The kill path is flag-flips only for the same
    # reason.
    ("serve/fleet.py", "ReplicaHandle._pump_main"),
    ("serve/fleet.py", "ReplicaHandle._beat_main"),
    ("serve/fleet.py", "ReplicaHandle.kill"),
    ("serve/fleet.py", "ServingTier.kill_replica"),
    # K1 and K2, the hand-written Hopper kernels: the planned entry
    # points, their autograd functions' backward and second-order
    # passes, and the CUDA launchers run inside every planned train
    # step (and inside its graph) — any host touch here (a size read
    # back from the device, a stray .item() on the plan) stalls the
    # hottest dispatch in the repo, and fails the capture.
    ("ops/edge_pipeline.py", "edge_pipeline_planned"),
    ("ops/edge_pipeline.py", "edge_pipeline_bwd_planned"),
    ("ops/edge_pipeline.py", "_edge_pipeline_fwd"),
    ("ops/edge_pipeline.py", "_edge_pipeline_bwd"),
    ("ops/edge_pipeline.py", "_edge_pipeline_cuda"),
    ("ops/edge_pipeline.py", "_edge_pipeline_bwd_cuda"),
    ("ops/edge_pipeline.py", "_k1_backward"),
    ("ops/edge_pipeline.py", "_k2_backward"),
    # The MD rollout engine: the macro (K physics steps recorded into
    # one graph) is the hottest region of the subsystem — it runs
    # millions of times per simulation; _body is its step, _neighbor
    # and _init_forces the device neighbour builder and the t=0 force
    # pass. _dispatch/_replay run between macros, and run() is the
    # loop; its ONLY permitted syncs are the designed per-macro fetch
    # of the packed rows and the policy reads, suppressed in place.
    ("simulate/engine.py", "RolloutEngine._macro"),
    ("simulate/engine.py", "RolloutEngine._body"),
    ("simulate/engine.py", "RolloutEngine._neighbor"),
    ("simulate/engine.py", "RolloutEngine._init_forces"),
    ("simulate/engine.py", "RolloutEngine._energy_forces"),
    ("simulate/engine.py", "RolloutEngine._dispatch"),
    ("simulate/engine.py", "RolloutEngine._replay"),
    ("simulate/engine.py", "RolloutEngine.run"),
    # The rollout's device neighbour rebuild plans K1/K2's blocks on
    # the card inside the macro graph: the planner and its static
    # bound must read nothing back.
    ("ops/edge_pipeline.py", "plan_blocks_device"),
    ("ops/edge_pipeline.py", "static_block_bound"),
    # The port's own step machinery: the graph cache's run/replay path
    # (every replayed train, eval and served step), the one
    # host-to-device copy of a step's batches (StaticBatches.load: one
    # pinned buffer, one asynchronous copy), the step bodies the graphs
    # record (``_train_body``/``_eval_body`` build them, ``_steps_fn``
    # runs K of them in one graph) and the serving forward
    # (``make_forward``'s closure, recorded once per budget shape and
    # replayed for every served bin).
    ("train/capture.py", "StepGraphs.run"),
    ("train/capture.py", "StepGraphs.replay"),
    ("train/capture.py", "StaticBatches.load"),
    ("train/loop.py", "_train_body"),
    ("train/loop.py", "_eval_body"),
    ("train/loop.py", "_steps_fn"),
    ("export.py", "make_forward"),
)

# tensor methods that copy to the host and wait for the card
_FETCH_ATTRS = ("item", "tolist", "cpu", "numpy")


def hot_scope(ctx) -> Tuple[Set[FuncKey], Set[FuncKey]]:
    """(captured context, seeded hot scope) — the rule's two scopes."""
    graph = ctx.callgraph
    cap_reach = graph.reachable({f.key for f in graph.captured()})
    return cap_reach, seed_scope(graph, HOT_SEEDS)


def _is_cuda_synchronize(fn: ast.Attribute, env) -> bool:
    """``torch.cuda.synchronize`` through an import alias."""
    base = fn.value
    if isinstance(base, ast.Attribute) and base.attr == "cuda":
        return (
            isinstance(base.value, ast.Name)
            and env.mod_aliases.get(base.value.id) == "torch"
        )
    if isinstance(base, ast.Name):
        return env.mod_aliases.get(base.id) == "torch.cuda" or (
            env.from_imports.get(base.id) == ("torch", "cuda")
        )
    return False


class HostSyncRule(Rule):
    name = "host-sync"
    description = (
        "host-device sync points in the step hot path and captured code"
    )
    seeds = HOT_SEEDS

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        graph = ctx.callgraph
        cap_reach, hot_reach = hot_scope(ctx)
        envs = {}
        for key in sorted(cap_reach | hot_reach):
            info = graph.funcs[key]
            sf = info.module
            env = envs.setdefault(sf.relpath, module_env(sf))
            captured = key in cap_reach
            where = (
                f"captured `{key[1]}`"
                if info.captured
                else f"`{key[1]}` (reachable from captured code)"
                if captured
                else f"`{key[1]}` (reachable from the step path)"
            )
            for node in own_statements(info.node):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if not isinstance(fn, ast.Attribute):
                    continue
                if fn.attr in _FETCH_ATTRS and not node.args:
                    yield Finding(
                        self.name, sf.relpath, node.lineno,
                        f"`.{fn.attr}()` in {where} — a device tensor's "
                        "copy to the host waits for the card; keep it "
                        "on the device and fetch once",
                    )
                    continue
                if fn.attr == "synchronize":
                    what = (
                        "torch.cuda.synchronize(...)"
                        if _is_cuda_synchronize(fn, env)
                        else ".synchronize()"
                    )
                    yield Finding(
                        self.name, sf.relpath, node.lineno,
                        f"`{what}` in {where} — drains the card's queue",
                    )
                    continue
                base = fn.value
                if (
                    captured
                    and isinstance(base, ast.Name)
                    and env.mod_aliases.get(base.id) == "numpy"
                    and fn.attr in ("asarray", "array")
                ):
                    yield Finding(
                        self.name, sf.relpath, node.lineno,
                        f"`np.{fn.attr}(...)` inside {where} — reads a "
                        "host value at capture time into every replay "
                        "(keep the data on the device)",
                    )


def _innermost_def(tree: ast.AST, line: int, prefix: str = ""):
    """Qualname of the innermost def whose span holds ``line``."""
    best = None
    for node in getattr(tree, "body", ()):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                qual = f"{prefix}{node.name}"
                inner = _innermost_def(node, line, qual + ".")
                if inner is not None:
                    return inner
                if not isinstance(node, ast.ClassDef):
                    best = qual
    return best


def _statement_span(tree: ast.AST, line: int) -> Tuple[int, int]:
    """Lines of the innermost statement holding ``line`` (a call that
    spans lines is reported by the card at any of them)."""
    span = (line, line)
    for node in ast.walk(tree):
        if isinstance(node, ast.stmt) and not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end and (
                span == (line, line) or end - node.lineno < span[1] - span[0]
            ):
                span = (node.lineno, end)
    return span


def site_verdict(ctx, sites) -> Dict[Tuple[str, int], str]:
    """For each ``(relpath, line)`` where the card reported a
    synchronizing call: ``"flagged"`` when this rule reports a call in
    the statement on that line (suppressed and baselined findings
    count), ``"out of scope"`` when the line lies outside every
    function of the rule's scope (module level included), else
    ``"missed"`` — a sync in scope the rule does not see."""
    flagged: Dict[str, Set[int]] = {}
    for f in HostSyncRule().run(ctx):
        flagged.setdefault(f.path, set()).add(f.line)
    cap_reach, hot_reach = hot_scope(ctx)
    scope = cap_reach | hot_reach
    by_rel = {sf.relpath: sf for sf in ctx.py_files}
    out: Dict[Tuple[str, int], str] = {}
    for rel, line in sites:
        sf = by_rel.get(rel)
        if sf is not None and sf.tree is not None:
            lo, hi = _statement_span(sf.tree, line)
            if any(lo <= x <= hi for x in flagged.get(rel, ())):
                out[(rel, line)] = "flagged"
                continue
        qual: Optional[str] = (
            None if sf is None or sf.tree is None
            else _innermost_def(sf.tree, line)
        )
        out[(rel, line)] = (
            "missed" if qual is not None and (rel, qual) in scope
            else "out of scope"
        )
    return out
