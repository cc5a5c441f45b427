"""lock-order: ABBA deadlock cycles and blocking calls under a held
lock, across everything reachable from thread entry points.

The serving tier is a thicket of threads (replica pumps, beat threads,
the tier monitor, the checkpoint worker, telemetry workers, pipeline
workers) sharing ``self._lock``-style locks with the request threads
(docs/SERVING.md "Fleet tier"). Two static invariants keep that safe,
and this rule checks both over the whole program:

**May-hold-while-acquiring cycles.** Every acquisition site reachable
from a thread entry point (``threading.Thread(target=...)``
constructions discovered by the call graph, plus the registered
never-block request surfaces) contributes edges ``held -> acquired``
to the lock-order graph; held sets propagate through resolvable call
edges, so a function that takes lock B while its caller holds lock A
contributes ``A -> B`` even though no single function takes both. A
cycle is an ABBA deadlock waiting for the right interleaving — flagged
at one witness acquisition per cycle. The rollover swap path and the
submit path taking the SAME ``ReplicaHandle._lock`` is the shape this
proves safe: one lock, no second acquisition under it, no edge.

**Blocking under a lock.** While any resolvable lock is held, flag the
primitives that can park the holder: ``.put(...)`` (non-``nowait``,
without a constant ``block=False``), zero-positional ``.get(...)``
(a queue get — ``dict.get`` always takes a key), zero-positional
``.join(...)``, ``.wait(...)`` on anything that is NOT the held lock
itself, ``time.sleep``, builtin ``open``, and zero-argument
``.item()`` and any ``.synchronize(...)`` device sync
(``torch.cuda.synchronize``, an event's or a stream's). Everyone
queued on that lock inherits the stall; with the GIL-released wait the
stall can be unbounded.

Carve-out: ``cv.wait(...)`` where ``cv`` IS a held ``Condition``
RELEASES the lock while parked — that is the condition-variable
protocol (``CheckpointWriter.wait`` is the exemplar), not a stall
under lock, and is never flagged.

Lock identity is nameable roots only (``self._lock`` attributes,
module-level globals — callgraph.LockTable); locks passed through
parameters are conservatively unresolved and never enter a held set.
Designed exceptions carry ``# graftlint: disable=lock-order -- why``
in place.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hydragnn_tpu_torch.analysis.callgraph import (
    FuncKey,
    LockId,
    lock_events,
    lock_table,
    module_env,
    seed_scope,
    thread_entries,
)
from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule
from hydragnn_tpu_torch.analysis.rules.thread_discipline import (
    NEVER_BLOCK_SEEDS,
)



def thread_scope(ctx) -> Set[FuncKey]:
    """THE thread-reachable scope shared by lock-order and
    guarded-field: forward closure from every discovered thread entry
    (``Thread(target=...)``) plus the registered never-block request
    surfaces — the code that can run concurrently with a worker."""
    graph = ctx.callgraph
    entries = thread_entries(graph, ctx)
    seeds = list(NEVER_BLOCK_SEEDS) + [
        (rel, qual) for rel, qual in sorted(entries)
    ]
    return seed_scope(graph, seeds)


class LockOrderRule(Rule):
    name = "lock-order"
    description = (
        "ABBA lock-order cycles and blocking calls while a lock is "
        "held, across thread-reachable code"
    )
    seeds = NEVER_BLOCK_SEEDS  # plus discovered Thread(target=...) entries

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        graph = ctx.callgraph
        table = lock_table(graph, ctx)
        if not table.class_locks and not table.module_locks:
            return
        scope = thread_scope(ctx)

        # Per-function direct analysis over the WHOLE tree (the
        # closure below needs callees' acquisitions even when the
        # callee itself is outside the thread scope).
        events: Dict[FuncKey, Tuple[list, list]] = {}
        for key, info in graph.funcs.items():
            events[key] = lock_events(
                info.node, table.resolver(info)
            )

        # acquires_closure: every lock a function (or anything it can
        # reach) may acquire.
        direct_acquires: Dict[FuncKey, Set[LockId]] = {
            key: {lid for _, lid, _ in acqs}
            for key, (_, acqs) in events.items()
        }
        closure_cache: Dict[FuncKey, Set[LockId]] = {}

        def acquires_closure(key: FuncKey) -> Set[LockId]:
            if key not in closure_cache:
                out: Set[LockId] = set()
                for k in graph.reachable([key]):
                    out |= direct_acquires.get(k, set())
                closure_cache[key] = out
            return closure_cache[key]

        # ---- may-hold-while-acquiring edges + blocking checks, with
        # held sets propagated into resolvable callees.
        order_edges: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}
        # one blocking finding per site — the same function can be
        # visited under several caller-held contexts; the lexically
        # smallest message wins so output is deterministic
        blocking: Dict[Tuple[str, int], Finding] = {}
        envs: Dict[str, object] = {}
        call_tgt: Dict[FuncKey, Dict[int, FuncKey]] = {}
        for key, pairs in graph.call_targets.items():
            call_tgt[key] = {id(node): tgt for node, tgt in pairs}

        seen: Set[Tuple[FuncKey, frozenset]] = set()
        work: List[Tuple[FuncKey, frozenset]] = [
            (k, frozenset()) for k in sorted(scope)
        ]
        while work:
            key, entry_held = work.pop()
            if (key, entry_held) in seen:
                continue
            seen.add((key, entry_held))
            info = graph.funcs[key]
            sf = info.module
            env = envs.setdefault(sf.relpath, module_env(sf))
            nodes, acqs = events[key]
            for held_before, lid, line in acqs:
                for h in (held_before | entry_held) - {lid}:
                    edge = (h, lid)
                    if edge not in order_edges:
                        order_edges[edge] = (sf.relpath, line)
            for node, held in nodes:
                held = held | entry_held
                if not held or not isinstance(node, ast.Call):
                    continue
                tgt = call_tgt.get(key, {}).get(id(node))
                if tgt is not None:
                    for lid in acquires_closure(tgt) - held:
                        for h in held:
                            edge = (h, lid)
                            if edge not in order_edges:
                                order_edges[edge] = (
                                    sf.relpath, node.lineno,
                                )
                    work.append((tgt, frozenset(held)))
                f = self._blocking_finding(
                    node, held, sf, env, table, info
                )
                if f is not None:
                    site = (f.path, f.line)
                    prev = blocking.get(site)
                    if prev is None or f.message < prev.message:
                        blocking[site] = f
        yield from (blocking[s] for s in sorted(blocking))

        # ---- cycle detection over the order graph
        adj: Dict[LockId, Set[LockId]] = {}
        for a, b in order_edges:
            adj.setdefault(a, set()).add(b)
        reported: Set[frozenset] = set()
        for start in sorted(adj, key=lambda l: (l.path, l.label)):
            cycle = _find_cycle(adj, start)
            if cycle is None:
                continue
            ident = frozenset(cycle)
            if ident in reported:
                continue
            reported.add(ident)
            labels = " -> ".join(
                l.label for l in cycle + [cycle[0]]
            )
            path, line = order_edges[(cycle[0], cycle[1 % len(cycle)])]
            yield Finding(
                self.name, path, line,
                f"lock-order cycle {labels} — two threads taking "
                "these locks in opposite orders deadlock (ABBA); "
                "impose one global order or merge the critical "
                "sections",
            )

    # -- blocking-call classification ----------------------------------

    def _blocking_finding(
        self, node: ast.Call, held, sf, env, table, info
    ) -> Optional[Finding]:
        labels = ", ".join(
            sorted(l.label for l in held)
        )
        where = f"while holding `{labels}`"
        fn = node.func
        resolve = table.resolver(info)
        if isinstance(fn, ast.Attribute):
            nonblocking = any(
                kw.arg == "block"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is False
                for kw in node.keywords
            )
            if fn.attr == "put" and not nonblocking:
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"blocking `.put(...)` {where} — everyone queued "
                    "on the lock inherits the stall when the queue "
                    "fills; use put_nowait or move the put outside "
                    "the critical section",
                )
            if fn.attr == "get" and not node.args and not nonblocking:
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"blocking queue `.get(...)` {where} — parks the "
                    "holder until an item arrives; drain outside the "
                    "critical section",
                )
            if fn.attr == "join" and not node.args and not any(
                kw.arg == "timeout" for kw in node.keywords
            ):
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"unbounded `.join()` {where} — waits on a "
                    "worker thread with the lock held",
                )
            if fn.attr == "wait":
                lid = resolve(fn.value)
                if lid is not None and lid in held:
                    return None  # Condition.wait RELEASES the held lock
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"`.wait(...)` on a foreign object {where} — "
                    "only waiting on the HELD Condition releases the "
                    "lock; this parks the holder with the lock taken",
                )
            if (
                fn.attr == "sleep"
                and isinstance(fn.value, ast.Name)
                and env.mod_aliases.get(fn.value.id) == "time"
            ):
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"`time.sleep(...)` {where} — a deliberate stall "
                    "inside the critical section",
                )
            if fn.attr == "synchronize" or (
                fn.attr == "item" and not node.args
            ):
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"`.{fn.attr}()` {where} — a device fence inside "
                    "the critical section",
                )
        elif isinstance(fn, ast.Name):
            if fn.id == "open":
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"sync file I/O `open(...)` {where} — disk "
                    "latency inside the critical section",
                )
            if env.from_imports.get(fn.id) == ("time", "sleep"):
                return Finding(
                    self.name, sf.relpath, node.lineno,
                    f"`time.sleep(...)` {where} — a deliberate stall "
                    "inside the critical section",
                )
        return None


def _find_cycle(adj, start) -> Optional[List[LockId]]:
    """First cycle reachable from ``start`` (DFS with an explicit
    path), as the list of locks around the loop."""
    path: List[LockId] = []
    on_path: Set[LockId] = set()
    done: Set[LockId] = set()

    def dfs(node) -> Optional[List[LockId]]:
        path.append(node)
        on_path.add(node)
        for nxt in sorted(
            adj.get(node, ()), key=lambda l: (l.path, l.label)
        ):
            if nxt in on_path:
                return path[path.index(nxt):]
            if nxt not in done:
                found = dfs(nxt)
                if found is not None:
                    return found
        on_path.discard(node)
        done.add(node)
        path.pop()
        return None

    return dfs(start)
