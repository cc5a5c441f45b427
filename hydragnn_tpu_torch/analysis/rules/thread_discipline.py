"""thread-discipline: blocking primitives in never-block paths, and
worker threads without a close()-in-finally at their construction
site.

Two sub-checks, both encoding contracts the docs already state:

**Never-block paths.** ``TelemetryStream.emit`` "never blocks the
step" (docs/OBSERVABILITY.md), ``CheckpointWriter.save``'s only legal
stall is the designed snapshot barrier (docs/DURABILITY.md),
``DynamicBatcher.submit`` "never blocks" (docs/SERVING.md), and
``_run_epoch`` sits between every dispatch. In code reachable from the
NEVER_BLOCK_SEEDS registry below, flag the primitives that can park
the calling thread:

- ``q.put(...)`` — blocks when the queue is bounded-and-full; the
  sanctioned idiom is ``put_nowait`` + an explicit drop/overflow
  policy (``TelemetryStream.emit`` is the exemplar);
- ``x.join()`` (no-arg: unbounded thread join; ``", ".join(parts)``
  takes an argument and is not matched);
- ``x.wait()`` with neither positional nor ``timeout=`` bound —
  an ``Event``/``Condition`` wait that can hang forever;
- ``time.sleep(...)`` and builtin ``open(...)`` — host stalls / sync
  file I/O that belong on the worker thread.

Designed blocking — the checkpoint writer's single-writer
backpressure, a dispatch loop's idle wait — carries
``# graftlint: disable=thread-discipline -- why`` in place.

**Close-in-finally.** A class that spawns a ``threading.Thread``
(``FuncInfo.spawns_thread``) leaks its worker into the next in-process
trial unless every construction site ties teardown to scope — the HPO
leak class (runner.run_training closes the writer AND the telemetry
stream in one ``finally``). At every call
site that binds such a class to a LOCAL name, require a ``finally``
(or ``with``) in the same function that reaches ``close()`` /
``stop()`` / ``shutdown()`` on it (passing the name to a
``close*``-named helper counts: ``telemetry.close_run(stream)``).
Bindings that escape the scope — ``self._writer = ...``, a name that
is returned, module-level singletons — are ownership transfers the
local check cannot judge and are skipped.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from hydragnn_tpu_torch.analysis.callgraph import (
    module_env,
    own_statements,
    seed_scope,
)
from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

# The never-block surfaces (docs/OBSERVABILITY.md, DURABILITY.md,
# SERVING.md): everything here runs on the step/request thread between
# dispatches. Worker-thread mains are deliberately absent — blocking
# is their job.
NEVER_BLOCK_SEEDS = (
    ("train/loop.py", "_run_epoch"),
    ("utils/telemetry.py", "TelemetryStream.emit"),
    ("utils/telemetry.py", "emit"),
    ("utils/telemetry.py", "StepClock.record"),
    # Fleet observability: the barrier-row emitter and the
    # liveness counters run on the step/feed/checkpoint-worker
    # threads between dispatches — put_nowait discipline only (the
    # barrier WAIT itself is the designed block; its row emission
    # must not add another).
    ("utils/telemetry.py", "emit_barrier"),
    ("utils/telemetry.py", "bump"),
    ("utils/telemetry.py", "note_phase"),
    ("utils/checkpoint.py", "CheckpointWriter.save"),
    ("serve/batcher.py", "DynamicBatcher.submit"),
    ("serve/batcher.py", "DynamicBatcher._place"),
    ("serve/engine.py", "ServingEngine._dispatch"),
    # Fleet tier: the router dispatch and the rollover swap
    # both run on the caller's request thread — policy arithmetic plus
    # one atomic batcher put; a block here parks every frontend (and,
    # in the swap, would widen the not-atomic window a concurrent
    # submit could fall into).
    ("serve/router.py", "Router.submit"),
    ("serve/router.py", "Router._route"),
    ("serve/router.py", "Router._shed"),
    ("serve/fleet.py", "ServingTier.submit"),
    ("serve/fleet.py", "ReplicaHandle.submit_inner"),
    ("serve/fleet.py", "ReplicaHandle.swap"),
    # The kill path: the drill hook murders a replica
    # mid-flight — it must be flag-flips only. A block here means the
    # SIGKILL analog isn't one (a real SIGKILL can't wait), and the
    # fleet drill's detection-latency gate measures from the kill
    # call's return. ``ServingTier.rollover`` is deliberately ABSENT:
    # it is control-plane (its drain loop sleeps by design); its
    # atomic section is ``ReplicaHandle.swap``, seeded above.
    ("serve/fleet.py", "ReplicaHandle.kill"),
    ("serve/fleet.py", "ServingTier.kill_replica"),
    ("train/guard.py", "GuardMonitor.observe"),
)

_CLOSERS = ("close", "stop", "shutdown")


def _has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or any(
        kw.arg == "timeout" for kw in call.keywords
    )


class ThreadDisciplineRule(Rule):
    name = "thread-discipline"
    description = (
        "blocking primitives in never-block paths; worker threads "
        "without close-in-finally"
    )
    seeds = NEVER_BLOCK_SEEDS

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        yield from self._check_never_block(ctx)
        yield from self._check_worker_lifecycle(ctx)

    # -- never-block paths ---------------------------------------------

    def _check_never_block(self, ctx) -> Iterable[Finding]:
        graph = ctx.callgraph
        envs: Dict[str, object] = {}
        for key in sorted(seed_scope(graph, NEVER_BLOCK_SEEDS)):
            info = graph.funcs[key]
            sf = info.module
            env = envs.setdefault(sf.relpath, module_env(sf))
            where = f"never-block path `{key[1]}`"
            for node in own_statements(info.node):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                if isinstance(fn, ast.Attribute):
                    # only an explicit constant block=False is the
                    # non-blocking form — block=True (or a variable)
                    # must not wave the call through
                    nonblocking = any(
                        kw.arg == "block"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is False
                        for kw in node.keywords
                    )
                    if fn.attr == "put" and not nonblocking:
                        yield Finding(
                            self.name, sf.relpath, node.lineno,
                            f"blocking `.put(...)` in {where} — parks "
                            "the step/request thread when the queue "
                            "fills; use put_nowait with an explicit "
                            "overflow policy (TelemetryStream.emit is "
                            "the exemplar)",
                        )
                    elif fn.attr == "join" and not node.args:
                        yield Finding(
                            self.name, sf.relpath, node.lineno,
                            f"unbounded `.join()` in {where} — waits "
                            "on a worker thread with no timeout",
                        )
                    elif fn.attr == "wait" and not _has_timeout(node):
                        yield Finding(
                            self.name, sf.relpath, node.lineno,
                            f"unbounded `.wait()` in {where} — an "
                            "Event/Condition wait with no timeout can "
                            "park the thread forever",
                        )
                    elif (
                        fn.attr == "sleep"
                        and isinstance(fn.value, ast.Name)
                        and env.mod_aliases.get(fn.value.id) == "time"
                    ):
                        yield Finding(
                            self.name, sf.relpath, node.lineno,
                            f"`time.sleep(...)` in {where} — a host "
                            "stall between dispatches",
                        )
                elif isinstance(fn, ast.Name):
                    if fn.id == "open":
                        yield Finding(
                            self.name, sf.relpath, node.lineno,
                            f"sync file I/O `open(...)` in {where} — "
                            "serialize/write belongs on the worker "
                            "thread (docs/DURABILITY.md async writer "
                            "phases)",
                        )
                    elif env.from_imports.get(fn.id) == (
                        "time", "sleep"
                    ):
                        yield Finding(
                            self.name, sf.relpath, node.lineno,
                            f"`time.sleep(...)` in {where} — a host "
                            "stall between dispatches",
                        )

    # -- worker-class lifecycle ----------------------------------------

    def _worker_classes(self, ctx) -> Dict[str, List[Tuple[str, bool]]]:
        """class name -> [(relpath, has_closer)] across linted files
        (name-keyed: constructor calls resolve by name the same way
        the callgraph resolves them)."""
        graph = ctx.callgraph
        spawning: Set[Tuple[str, str]] = set()  # (relpath, class qual)
        for info in graph.funcs.values():
            if info.spawns_thread and info.class_name:
                # class qual = everything up to the method name
                qual = info.key[1]
                if "." in qual:
                    spawning.add((info.key[0], qual.rsplit(".", 1)[0]))
        out: Dict[str, List[Tuple[str, bool]]] = {}
        for rel, cls_qual in spawning:
            has_closer = any(
                (rel, f"{cls_qual}.{m}") in graph.funcs
                for m in _CLOSERS
            )
            out.setdefault(
                cls_qual.rsplit(".", 1)[-1], []
            ).append((rel, has_closer))
        return out

    def _check_worker_lifecycle(self, ctx) -> Iterable[Finding]:
        workers = self._worker_classes(ctx)
        if not workers:
            return
        graph = ctx.callgraph
        # classes that spawn threads but expose no teardown at all
        seen_cls: Set[Tuple[str, str]] = set()
        for cls, sites in workers.items():
            for rel, has_closer in sites:
                if not has_closer and (rel, cls) not in seen_cls:
                    seen_cls.add((rel, cls))
                    sf = next(
                        s for s in ctx.py_files if s.relpath == rel
                    )
                    yield Finding(
                        self.name, rel, _class_line(sf, cls),
                        f"worker-thread class `{cls}` defines no "
                        "close()/stop()/shutdown() — its thread can "
                        "only leak (the HPO-trial leak class)",
                    )
        # construction sites
        envs: Dict[str, object] = {}
        for key in sorted(graph.funcs):
            info = graph.funcs[key]
            sf = info.module
            env = envs.setdefault(sf.relpath, module_env(sf))
            for stmt in info.node.body:
                yield from self._scan_constructions(
                    sf, env, info, stmt, workers
                )

    def _scan_constructions(
        self, sf, env, info, stmt, workers
    ) -> Iterable[Finding]:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return
        if isinstance(stmt, ast.Assign) and isinstance(
            stmt.value, ast.Call
        ):
            cls = _constructed_worker(stmt.value, env, workers)
            if cls is not None and len(stmt.targets) == 1 and isinstance(
                stmt.targets[0], ast.Name
            ):
                name = stmt.targets[0].id
                if not _ownership_escapes(
                    info.node, name
                ) and not _closed_in_finally_or_with(info.node, name):
                    yield Finding(
                        self.name, sf.relpath, stmt.lineno,
                        f"worker-thread `{cls}` bound to `{name}` in "
                        f"`{info.key[1]}` without close()/stop() in a "
                        "finally — a failure before teardown leaks "
                        "the worker into the next in-process trial "
                        "(the HPO leak class); wrap in try/finally or "
                        "`with`",
                    )
        for attr in ("body", "orelse", "finalbody"):
            for sub in getattr(stmt, attr, ()) or ():
                yield from self._scan_constructions(
                    sf, env, info, sub, workers
                )
        for h in getattr(stmt, "handlers", ()) or ():
            for sub in h.body:
                yield from self._scan_constructions(
                    sf, env, info, sub, workers
                )


def _class_line(sf, cls: str) -> int:
    needle = f"class {cls}"
    for i, line in enumerate(sf.lines, start=1):
        if needle in line:
            return i
    return 1


def _constructed_worker(call: ast.Call, env, workers):
    """Class name when this call constructs a known worker class that
    HAS a closer (closer-less classes are flagged at the class)."""
    fn = call.func
    name = None
    if isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
    if name in workers and any(h for _, h in workers[name]):
        return name
    return None


def _ownership_escapes(func_node, name: str) -> bool:
    """The bound object leaves the constructing scope: returned,
    yielded, stored on an attribute/subscript/global, or appended into
    a container — the local close-in-finally contract doesn't apply."""
    for node in ast.walk(func_node):
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            if node.value is not None and any(
                isinstance(s, ast.Name) and s.id == name
                for s in ast.walk(node.value)
            ):
                return True
        elif isinstance(node, ast.Assign):
            if any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in node.targets
            ) and any(
                isinstance(s, ast.Name)
                and s.id == name
                and isinstance(s.ctx, ast.Load)
                for s in ast.walk(node.value)
            ):
                return True
        elif isinstance(node, ast.Global) and name in node.names:
            return True
        elif isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("append", "add", "register")
                and any(
                    isinstance(s, ast.Name) and s.id == name
                    for a in node.args
                    for s in ast.walk(a)
                )
            ):
                return True
    return False


def _closed_in_finally_or_with(func_node, name: str) -> bool:
    for node in ast.walk(func_node):
        if isinstance(node, ast.Try):
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    fn = sub.func
                    # writer.close() / writer.stop()
                    if (
                        isinstance(fn, ast.Attribute)
                        and fn.attr in _CLOSERS
                        and isinstance(fn.value, ast.Name)
                        and fn.value.id == name
                    ):
                        return True
                    # close_run(stream): the name handed to a
                    # close*-named helper
                    label = (
                        fn.id
                        if isinstance(fn, ast.Name)
                        else fn.attr
                        if isinstance(fn, ast.Attribute)
                        else ""
                    )
                    if any(c in label for c in _CLOSERS) and any(
                        isinstance(s, ast.Name) and s.id == name
                        for a in sub.args
                        for s in ast.walk(a)
                    ):
                        return True
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    if isinstance(sub, ast.Name) and sub.id == name:
                        return True
    return False
