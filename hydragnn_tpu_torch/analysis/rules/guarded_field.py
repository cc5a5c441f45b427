"""guarded-field: lock-set race detection for ``self.X`` attributes.

For every class that owns a lock attribute (``self._lock =
threading.Lock()`` — callgraph.LockTable) AND is concurrency-exposed
(spawns a worker thread, or has a method in the thread-reachable
scope), compute the set of self-attributes accessed inside that lock's
spans anywhere in the class. Those attributes are the lock's protected
state — the author already decided they need the lock somewhere; an
access from another method NOT holding it is a data race with the
rollover/submit/pump interleavings the serving tier actually runs
(``ReplicaHandle.swap`` flips ``engine``/``batcher`` under ``_lock``
while gauges read them from the router thread — the exact class of
bug this rule exists to catch).

Sanctioned idioms (never flagged):

- **init-then-publish**: any access inside ``__init__`` — the object
  is not yet visible to other threads (``Thread.start()`` is the
  publication barrier).
- **single-assignment-before-thread-start**: attributes whose only
  attribute-STORES live in ``__init__`` (e.g. a ``queue.Queue`` bound
  once and then only method-called) are immutable references after
  publication; unlocked reads are safe.
- **private-helper lock inheritance** (the ``_``-local escape): a
  ``_``-prefixed method whose every resolvable intra-class call site
  holds lock L is analyzed WITH L held — the body executes inside the
  caller's critical section, splitting it out is not an escape.

The snapshot-under-lock FIX idiom — ``with self._lock: b =
self.batcher`` then use ``b`` — is naturally clean: the attribute
access is under the lock; the local carries a consistent reference.
Benign races the author keeps lock-free on purpose (monotonic beat
timestamps, shutdown flags) stay unflagged automatically as long as
NO access to them happens under the lock; once one does, every access
must either hold it or carry a justified in-place suppression
(``graftlint: disable=guarded-field -- why``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hydragnn_tpu_torch.analysis.callgraph import (
    FuncKey,
    LockId,
    lock_events,
    lock_table,
)
from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule
from hydragnn_tpu_torch.analysis.rules.thread_discipline import (
    NEVER_BLOCK_SEEDS,
)


class GuardedFieldRule(Rule):
    name = "guarded-field"
    description = (
        "reads/writes of lock-guarded self-attributes from "
        "thread-reachable code not holding the lock"
    )
    seeds = NEVER_BLOCK_SEEDS  # plus discovered Thread(target=...) entries

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        from hydragnn_tpu_torch.analysis.rules.lock_order import thread_scope

        graph = ctx.callgraph
        table = lock_table(graph, ctx)
        if not table.class_locks:
            return
        scope = thread_scope(ctx)

        # group methods by (relpath, class name)
        classes: Dict[Tuple[str, str], List[FuncKey]] = {}
        for key, info in graph.funcs.items():
            if info.class_name:
                classes.setdefault(
                    (key[0], info.class_name), []
                ).append(key)

        for (rel, cls), methods in sorted(classes.items()):
            locks = [
                lid
                for (r, c, _), lid in table.class_locks.items()
                if r == rel and c == cls
            ]
            if not locks:
                continue
            exposed = any(
                graph.funcs[m].spawns_thread or m in scope
                for m in methods
            )
            if not exposed:
                continue
            yield from self._check_class(
                graph, table, rel, cls, sorted(methods), locks
            )

    def _check_class(
        self, graph, table, rel, cls, methods, locks
    ) -> Iterable[Finding]:
        infos = {m: graph.funcs[m] for m in methods}
        events = {
            m: lock_events(i.node, table.resolver(i))
            for m, i in infos.items()
        }

        # -- private-helper lock inheritance: L is held on entry to a
        # ``_``-method when every resolvable intra-class call site
        # holds L.
        entry_held: Dict[FuncKey, frozenset] = {}
        call_held: Dict[FuncKey, List[frozenset]] = {}
        for m in methods:
            for node, held in events[m][0]:
                if not isinstance(node, ast.Call):
                    continue
                for cn, tgt in graph.call_targets.get(m, ()):
                    if cn is node and tgt in infos:
                        call_held.setdefault(tgt, []).append(held)
        for m in methods:
            name = m[1].rsplit(".", 1)[-1]
            sites = call_held.get(m, [])
            if (
                name.startswith("_")
                and name != "__init__"
                and sites
                and all(sites)
            ):
                common = frozenset.intersection(*sites)
                if common:
                    entry_held[m] = common

        # -- pass 1: guarded sets + attribute stores
        guarded: Dict[LockId, Set[str]] = {l: set() for l in locks}
        stores_outside_init: Set[str] = set()
        for m in methods:
            is_init = m[1].endswith(".__init__")
            extra = entry_held.get(m, frozenset())
            for node, held in events[m][0]:
                attr = _self_attr(node)
                if attr is None:
                    continue
                for lid in (held | extra) & set(locks):
                    guarded[lid].add(attr)
                if not is_init and isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ):
                    stores_outside_init.add(attr)

        # single-assignment-before-thread-start: stores only in
        # __init__ -> immutable reference after publication
        sanctioned = {
            a
            for l in locks
            for a in guarded[l]
            if a not in stores_outside_init
        }
        # the lock attributes themselves are not protected state
        sanctioned |= {l.name for l in locks}

        # -- pass 2: unlocked accesses of guarded attrs
        emitted: Set[Tuple[str, int, str]] = set()
        for m in methods:
            if m[1].endswith(".__init__"):
                continue  # init-then-publish
            extra = entry_held.get(m, frozenset())
            sf = infos[m].module
            for node, held in events[m][0]:
                attr = _self_attr(node)
                if attr is None or attr in sanctioned:
                    continue
                held = held | extra
                owners = [
                    l
                    for l in locks
                    if attr in guarded[l] and l not in held
                ]
                if not owners:
                    continue
                lid = owners[0]
                kind = (
                    "write"
                    if isinstance(node.ctx, (ast.Store, ast.Del))
                    else "read"
                )
                ident = (sf.relpath, node.lineno, attr)
                if ident in emitted:
                    continue
                emitted.add(ident)
                yield Finding(
                    self.name, sf.relpath, node.lineno,
                    f"unlocked {kind} of `self.{attr}` in "
                    f"`{m[1]}` — `{cls}` accesses it under "
                    f"`{lid.label}` elsewhere, so this races the "
                    "critical section (snapshot it under the lock: "
                    "`with self."
                    f"{lid.name}: x = self.{attr}`)",
                )


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None
