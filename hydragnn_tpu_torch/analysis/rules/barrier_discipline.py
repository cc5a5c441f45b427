"""barrier-discipline: name minting, collective placement, and
rendezvous symmetry on multi-process coordination paths.

The reference framework's hard failures are DDP rendezvous hangs and
collective mismatches; the local analogue is a store key or barrier
name minted from a CALL-SITE counter, where one rank failing mid-job
desyncs every later name and wedges every subsequent save. The durable
contract: the checkpoint writer's store keys derive from the WRITER'S
ENQUEUE-TIME per-job sequence (``CheckpointWriter._key(seq, ...)``,
minted in ``save()`` on the caller thread and carried with the job),
never from whatever a call site happens to count. This rule enforces
three checks statically over multi-process-reachable code — the
registered coordination seeds plus every function carrying the
per-process-path marker (a direct ``torch.distributed`` collective or
barrier, or a store's ``set`` / ``get`` / ``wait`` / ``add``), closed
over call edges:

**Counter-minted names.** A store key (the first argument of a store's
``set`` / ``get`` / ``wait`` / ``add``) that interpolates a value
minted AT THE CALL SITE — bare ``next(...)``, ``time.time()``,
``os.getpid()``, ``id(...)``, a ``_barrier_seq(...)`` helper — is
flagged at the mint site: after one asymmetric failure the counters
disagree across ranks forever (rank A waits on ``tag/7/open`` while
rank B waits on ``tag/8/open`` — both time out, and so does every save
after them). Values received as PARAMETERS are clean — that is exactly
the enqueue-time-sequence idiom. ``_barrier(...)``'s per-site count
names no rendezvous (``dist.barrier`` takes no name): it only labels
the telemetry row.

**Collectives on writer threads.** A ``torch.distributed`` collective
or barrier reachable from a THREAD entry (``Thread(target=...)``) on a
coordination path is flagged: the loop thread issues the step's
collectives (dp's all-reduce, inside the captured step) on the same
process group, and two threads issuing collectives on one group
interleave them differently on each rank — a hang. Coordination from a
worker thread goes through the store (``_store_meet``), full stop.
Collectives on the loop thread (``_barrier`` at ``wait``/``close``,
``_processes_agree_finite``'s MIN all-reduce) are out of this check by
construction.

**Conditional rendezvous.** A rendezvous (``dist.barrier`` and the
collectives, ``_barrier``, ``_store_meet``,
``_processes_agree_finite``) lexically under an ``if``
testing the rank (``rank``, ``get_rank``, ``process_index``) means one
rank can skip a rendezvous its peers perform — they hang until
timeout. ``world_size`` tests are uniform across ranks and sanctioned;
asymmetric store set/get under a rank test (rank 0 publishing a
pointer) is NOT flagged — only the rendezvous itself must be
unconditional.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hydragnn_tpu_torch.analysis.callgraph import (
    coord_call,
    coord_sites,
    module_env,
    own_statements,
    seed_scope,
    thread_entries,
)
from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

# The multi-process-reachable surfaces: the checkpoint writer's worker
# and its save path, the sharded format's writer entry (every rank's
# shards, three store meetings), the rendezvous helpers themselves, and
# the walltime broadcast. Functions carrying the per-process-path marker
# (a direct rendezvous) join the scope automatically — a new
# coordination call site cannot dodge the rule by not being registered
# here.
COORD_SEEDS = (
    ("utils/checkpoint.py", "_barrier"),
    ("utils/checkpoint.py", "_store_meet"),
    ("utils/checkpoint.py", "_processes_agree_finite"),
    ("utils/checkpoint.py", "CheckpointWriter._worker_main"),
    ("utils/checkpoint.py", "CheckpointWriter.save"),
    ("utils/checkpoint.py", "_write_sharded_dir"),
    ("utils/runtime.py", "check_remaining"),
)

# Call-site mints: interpolating any of these into a store key desyncs
# ranks after one asymmetric failure.
_MINT_TIME = {("time", "time"), ("time", "monotonic"), ("os", "getpid")}

_RENDEZVOUS = ("_barrier", "_store_meet", "_processes_agree_finite")
_RANK_NAMES = ("rank", "get_rank", "process_index")


class BarrierDisciplineRule(Rule):
    name = "barrier-discipline"
    description = (
        "call-site-counter store keys, collectives on writer threads, "
        "and conditional rendezvous on coordination paths"
    )
    seeds = COORD_SEEDS

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        graph = ctx.callgraph
        marked = coord_sites(graph)
        scope = seed_scope(
            graph,
            list(COORD_SEEDS)
            + [(rel, qual) for rel, qual in sorted(marked)],
        )
        threaded = graph.reachable(thread_entries(graph, ctx)) & scope
        envs: Dict[str, object] = {}
        for key in sorted(scope):
            info = graph.funcs[key]
            sf = info.module
            env = envs.setdefault(sf.relpath, module_env(sf))
            yield from self._check_minting(key, info, sf, env)
            if key in threaded:
                yield from self._check_collectives(key, info, sf, env)
            yield from self._check_conditional(key, info, sf, env)

    # -- counter-minted names ------------------------------------------

    def _is_mint_call(self, node: ast.AST, env) -> Optional[str]:
        """Human label when ``node`` is a call minting a call-site
        value: _barrier_seq / next / time.time / os.getpid / id."""
        if not isinstance(node, ast.Call):
            return None
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id == "_barrier_seq" or env.from_imports.get(
                fn.id, ("", "")
            )[1] == "_barrier_seq":
                return "_barrier_seq(...)"
            if fn.id == "next" and node.args:
                return "next(...)"
            if fn.id == "id" and node.args:
                return "id(...)"
            if env.from_imports.get(fn.id) in _MINT_TIME:
                return f"{fn.id}(...)"
        elif isinstance(fn, ast.Attribute):
            if fn.attr == "_barrier_seq":
                return "_barrier_seq(...)"
            if isinstance(fn.value, ast.Name):
                mod = env.mod_aliases.get(fn.value.id)
                if (mod, fn.attr) in _MINT_TIME:
                    return f"{mod}.{fn.attr}()"
        return None

    def _check_minting(self, key, info, sf, env) -> Iterable[Finding]:
        if key[1].rsplit(".", 1)[-1] == "_barrier_seq":
            return  # the mint helper's own body is not a mint SITE
        # taint: local name -> (mint line, mint label). Assignments
        # are processed in SOURCE order (own_statements walks in stack
        # order) so taint propagates through `seq = mint(); key =
        # f"...{seq}"` chains.
        taint: Dict[str, Tuple[int, str]] = {}
        assigns = sorted(
            (
                n
                for n in own_statements(info.node)
                if isinstance(n, (ast.Assign, ast.AnnAssign))
            ),
            key=lambda n: n.lineno,
        )
        for node in assigns:
            value = node.value
            if value is None:
                continue
            origin = None
            for sub in ast.walk(value):
                label = self._is_mint_call(sub, env)
                if label is not None:
                    origin = (node.lineno, label)
                    break
                if isinstance(sub, ast.Name) and sub.id in taint:
                    origin = taint[sub.id]
                    break
            if origin is None:
                continue
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            for t in targets:
                if isinstance(t, ast.Name):
                    taint[t.id] = origin

        emitted: Set[Tuple[int, str]] = set()
        for node in own_statements(info.node):
            label = coord_call(node, env)
            if label is None or not label.startswith("store."):
                continue
            if not node.args:
                continue
            name_arg = node.args[0]
            for sub in ast.walk(name_arg):
                origin = None
                if isinstance(sub, ast.Name) and sub.id in taint:
                    origin = taint[sub.id]
                else:
                    mint = self._is_mint_call(sub, env)
                    if mint is not None:
                        origin = (node.lineno, mint)
                if origin is None:
                    continue
                line, mint = origin
                if (line, mint) in emitted:
                    continue
                emitted.add((line, mint))
                yield Finding(
                    self.name, sf.relpath, line,
                    f"barrier/KV name in `{key[1]}` derives from "
                    f"call-site mint `{mint}` — one asymmetric "
                    "failure desyncs the counters across processes "
                    "and wedges every later rendezvous; derive the "
                    "name from an enqueue-time "
                    "job sequence passed in as a parameter",
                )
        # a mint interpolated straight into ANY name string (f-string)
        # is flagged even when the consumer is out of lexical sight:
        # the minted prefix IS the name.
        for node in own_statements(info.node):
            if not isinstance(node, ast.JoinedStr):
                continue
            for sub in ast.walk(node):
                mint = self._is_mint_call(sub, env)
                if mint is None or mint != "_barrier_seq(...)":
                    continue
                if (node.lineno, mint) in emitted:
                    continue
                emitted.add((node.lineno, mint))
                yield Finding(
                    self.name, sf.relpath, node.lineno,
                    f"barrier-name string in `{key[1]}` interpolates "
                    f"call-site mint `{mint}` — names must derive "
                    "from an enqueue-time job sequence",
                )

    # -- collectives on writer threads ---------------------------------

    def _check_collectives(
        self, key, info, sf, env
    ) -> Iterable[Finding]:
        for node in own_statements(info.node):
            label = coord_call(node, env)
            if label is None or not label.startswith("dist."):
                continue
            yield Finding(
                self.name, sf.relpath, node.lineno,
                f"collective `{label}` on coordination path "
                f"`{key[1]}`, reachable from a worker thread — the "
                "loop thread issues the step's collectives on the "
                "same process group, and two threads' collectives "
                "interleave differently on each rank (a hang); meet "
                "through the store (`_store_meet`)",
            )

    # -- conditional rendezvous ----------------------------------------

    def _check_conditional(self, key, info, sf, env) -> Iterable[Finding]:
        found: List[Finding] = []

        def is_rendezvous(node: ast.AST) -> Optional[str]:
            if not isinstance(node, ast.Call):
                return None
            label = coord_call(node, env)
            if label is not None and label.startswith("dist."):
                return label
            fn = node.func
            name = (
                fn.id
                if isinstance(fn, ast.Name)
                else fn.attr
                if isinstance(fn, ast.Attribute)
                else ""
            )
            return name if name in _RENDEZVOUS else None

        def test_is_asymmetric(test: ast.AST) -> bool:
            for sub in ast.walk(test):
                if (
                    isinstance(sub, ast.Attribute)
                    and sub.attr in _RANK_NAMES
                ) or (
                    isinstance(sub, ast.Name)
                    and sub.id in _RANK_NAMES
                ):
                    return True
            return False

        def walk(stmts, under: bool):
            for stmt in stmts:
                if isinstance(
                    stmt,
                    (
                        ast.FunctionDef,
                        ast.AsyncFunctionDef,
                        ast.ClassDef,
                    ),
                ):
                    continue
                inner = under
                if isinstance(stmt, ast.If) and test_is_asymmetric(
                    stmt.test
                ):
                    inner = True
                if inner:
                    for sub in ast.walk(stmt):
                        name = is_rendezvous(sub)
                        if name is not None:
                            found.append(
                                Finding(
                                    self.name,
                                    sf.relpath,
                                    sub.lineno,
                                    f"barrier wait `{name}` under a "
                                    f"rank test in "
                                    f"`{key[1]}` — one process skips "
                                    "a rendezvous its peers perform; "
                                    "they hang until the "
                                    "store timeout. Hoist the "
                                    "wait out of the branch "
                                    "(asymmetric store set/get is "
                                    "fine; the rendezvous is not)",
                                )
                            )
                    continue
                for field in ("body", "orelse", "finalbody"):
                    suite = getattr(stmt, field, ()) or ()
                    if suite:
                        walk(list(suite), inner)
                for h in getattr(stmt, "handlers", ()) or ():
                    walk(h.body, inner)

        walk(list(info.node.body), False)
        return found
