"""Best-effort static call graph over the linted python files.

Name-based and intentionally conservative: an edge exists when a call
site's callee can be resolved to a function DEFINED in the linted file
set — via local scope, class methods (``self.f()``), module aliases
(``tr.start()`` after ``from hydragnn_tpu_torch.utils import telemetry
as tr``), or from-imports (following one chain of package ``__init__``
re-exports). Dynamic dispatch (callables passed as arguments, e.g. the
``fn`` handed to ``StepGraphs.run``) is NOT resolved by the edges —
rules that care about code running inside a CUDA graph seed
reachability with every captured function instead (see ``captured``
below), which is exactly how those callables enter the hot path in
this codebase.

``captured`` marks the functions whose work a CUDA graph records:

- every call resolved inside the body of a ``with torch.cuda.graph(g):``
  block (the captures of ``train/capture.py``, the rollout engine's
  macros, the relaxation driver's descent step), and every function
  passed by name as an argument there;
- the callables handed to a CAPTURE PARAMETER: a parameter a function
  calls inside such a block (``StepGraphs._record``'s ``fn``) is a
  capture parameter, and so is a parameter a function forwards to
  another's capture parameter (``record`` -> ``capture`` -> ``run``;
  ``train/loop._dispatch``'s ``run``). A call resolved to a method with
  capture parameters, or an attribute call whose method name matches
  one (``graphs.run(key, fn, batches)`` on a receiver no name resolves),
  marks the def its argument names: a def by name, a bound method
  (``self._warm``), a local or a ``self`` attribute bound to
  ``functools.partial(f, ...)``, to a lambda, or to the call of a
  builder that RETURNS a nested def (``run = _steps_fn(body)``,
  ``self._forward = make_forward(model, cfg)``: ``returns_def``),
  looked up through the enclosing defs' locals too;
- a captured function that calls a parameter of an enclosing def (a
  closure over the builder's argument: ``_steps_fn.run`` calling
  ``body``) makes that parameter a capture parameter of the builder.
  The marking runs to a fixpoint.

Edge metadata for the contract-aware rule families:

- ``spawns_thread``: the function body constructs a
  ``threading.Thread`` — marks worker classes for the
  thread-discipline close-in-finally check.
- ``seed_scope(graph, seeds)``: shared scope plumbing — every seeded
  rule expands (path, qualname) seeds the same way (nested defs are
  pulled in because closures and callbacks are passed by value,
  invisible to name-based edges).

Concurrency-analysis substrate:

- ``call_targets``: the per-call-site resolution the edge pass already
  computes, preserved as ``(ast.Call, FuncKey)`` pairs so rules can
  propagate context (held locks) into the exact callee of a call.
- ``thread_entries(graph, ctx)``: FuncKeys resolved from the
  ``target=`` of every ``threading.Thread(...)`` construction — the
  thread entry points whole-program lock analysis starts from.
- ``lock_table(graph, ctx)`` / ``resolve_lock_expr``: lock-object
  identity. ``self._lock = threading.Lock()`` in any method of class C
  names the lock ``(rel, "C", "_lock")``; ``_LOCK = threading.Lock()``
  at module top level names ``(rel, "", "_LOCK")``. Locals and
  parameters bound to locks are deliberately unresolved (a lock handed
  through a parameter cannot be identified across functions by name).
- ``lock_events(func_node, resolve)``: the ``with``/``acquire``/
  ``release`` span walker — yields every non-nested-def node with the
  set of locks held at that point, plus the acquisition sites with the
  set held BEFORE each (the may-hold-while-acquiring input).
- ``coord_op``/``coord_sites``: the per-process-path marker — a
  function whose body performs a rendezvous directly (a
  ``torch.distributed`` collective or barrier, or a store's ``set`` /
  ``get`` / ``wait`` / ``add``) is multi-process path code by
  construction; barrier-discipline anchors its scope there.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

FuncKey = Tuple[str, str]  # (relpath, qualname)


@dataclasses.dataclass
class FuncInfo:
    key: FuncKey
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    module: "object"  # SourceFile
    class_name: Optional[str] = None
    # a CUDA graph records this function's work (module docstring)
    captured: bool = False
    # positional indices (``self``/``cls`` not counted) of the
    # parameters whose callable a CUDA graph records
    capture_params: Set[int] = dataclasses.field(default_factory=set)
    # builder: returns one of its nested defs by name (the def's key)
    returns_def: Optional[FuncKey] = None
    # body constructs a threading.Thread (worker-class marker)
    spawns_thread: bool = False
    # body performs a rendezvous directly (a torch.distributed
    # collective or barrier, or a store's set / get / wait / add) — the
    # per-process-path marker barrier-discipline anchors on
    coord_op: bool = False


class CallGraph:
    def __init__(self):
        self.funcs: Dict[FuncKey, FuncInfo] = {}
        self.edges: Dict[FuncKey, Set[FuncKey]] = {}
        # per-call-site resolution: caller -> [(ast.Call, callee key)]
        # — rules that propagate context into callees (held locks)
        # need the exact target of a SPECIFIC call, not just the edge
        # set. The Call nodes are the same objects the edge pass saw
        # (SourceFile trees are shared through the LintContext).
        self.call_targets: Dict[FuncKey, List[Tuple[ast.AST, FuncKey]]] = {}

    def reachable(self, seeds: Iterable[FuncKey]) -> Set[FuncKey]:
        out: Set[FuncKey] = set()
        stack = [s for s in seeds if s in self.funcs]
        while stack:
            k = stack.pop()
            if k in out:
                continue
            out.add(k)
            stack.extend(self.edges.get(k, ()))
        return out

    def find(self, path_suffix: str, qual_suffix: str) -> List[FuncKey]:
        """Keys whose relpath ends with ``path_suffix`` and qualname
        equals or ends with ``.qual_suffix`` (or matches exactly)."""
        out = []
        for (rel, qual) in self.funcs:
            if not rel.endswith(path_suffix):
                continue
            if qual == qual_suffix or qual.endswith("." + qual_suffix):
                out.append((rel, qual))
        return out

    def captured(self) -> List[FuncInfo]:
        return [f for f in self.funcs.values() if f.captured]


def _module_path_of(relpath: str) -> str:
    """'hydragnn_tpu/data/loader.py' -> 'hydragnn_tpu.data.loader';
    package __init__.py maps to the package path itself."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class _ModuleIndex:
    """Per-module name environment used during call resolution."""

    def __init__(self, sf):
        self.sf = sf
        self.mod_aliases: Dict[str, str] = {}  # name -> module path
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # name -> (mod, attr)
        self.top_defs: Dict[str, str] = {}  # top-level name -> qualname


def _scan_imports(sf, by_module_path=None) -> _ModuleIndex:
    """THE import scanner — shared by build_callgraph and module_env so
    alias resolution can never diverge between the call graph and the
    rules that pair with it. With ``by_module_path``, ``from pkg import
    submodule`` of a LINTED submodule becomes a module alias instead of
    a from-import."""
    index = _ModuleIndex(sf)
    if sf.tree is None:
        return index
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                index.mod_aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                local = a.asname or a.name
                sub = f"{node.module}.{a.name}"
                if by_module_path and sub in by_module_path:
                    index.mod_aliases[local] = sub
                else:
                    index.from_imports[local] = (node.module, a.name)
    return index


def _is_thread_ctor(node: ast.AST, index: _ModuleIndex) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if (
        isinstance(fn, ast.Attribute)
        and fn.attr == "Thread"
        and isinstance(fn.value, ast.Name)
        and index.mod_aliases.get(fn.value.id) == "threading"
    ):
        return True
    return isinstance(fn, ast.Name) and index.from_imports.get(
        fn.id
    ) == ("threading", "Thread")


def _spawns_thread(func_node: ast.AST, index: _ModuleIndex) -> bool:
    """Does the body bind a ``threading.Thread`` to a ``self``
    attribute — a PERSISTENT worker that outlives the call? Thread
    locals whose lifetime is the spawning call itself (the prefetch /
    pipeline generators tear their workers down in their own
    ``finally``) are deliberately not markers: the close-in-finally
    contract is about workers that survive until someone calls
    ``close()``."""
    for node in ast.walk(func_node):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        else:
            continue
        if node.value is None or not _is_thread_ctor(node.value, index):
            continue
        if any(
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
            for t in targets
        ):
            return True
    return False


def seed_scope(
    graph: CallGraph,
    seeds: Iterable[Tuple[str, str]],
    include_nested: bool = True,
) -> Set[FuncKey]:
    """THE shared seed expansion (host-sync, nondet, thread-discipline
    all scope this way): resolve (path_suffix, qualname) seeds with
    ``find``, pull in every function NESTED under a seed (closures and
    callbacks are passed as values — no call edge reaches them;
    qualname nesting is the ground truth), then close over static call
    edges."""
    keys: Set[FuncKey] = set()
    for path_sfx, qual in seeds:
        matched = graph.find(path_sfx, qual)
        keys.update(matched)
        if include_nested:
            for rel, q in matched:
                prefix = q + "."
                keys.update(
                    k
                    for k in graph.funcs
                    if k[0] == rel and k[1].startswith(prefix)
                )
    return graph.reachable(keys)


def build_callgraph(ctx) -> CallGraph:
    graph = CallGraph()
    indexes: Dict[str, _ModuleIndex] = {}
    by_module_path: Dict[str, object] = {}
    for sf in ctx.py_files:
        by_module_path[_module_path_of(sf.relpath)] = sf

    # ---- pass 1: per-module name environments + function inventory
    for sf in ctx.py_files:
        if sf.tree is None:
            continue
        index = _scan_imports(sf, by_module_path)
        indexes[sf.relpath] = index

        def visit(body, prefix: str, class_name: Optional[str]):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{node.name}"
                    key = (sf.relpath, qual)
                    graph.funcs[key] = FuncInfo(
                        key, node, sf, class_name=class_name,
                        spawns_thread=_spawns_thread(node, index),
                        coord_op=_has_coord_op(node, index),
                    )
                    if not prefix:
                        index.top_defs[node.name] = qual
                    visit(node.body, qual + ".", class_name)
                elif isinstance(node, ast.ClassDef):
                    if not prefix:
                        index.top_defs[node.name] = node.name
                    visit(node.body, f"{prefix}{node.name}.", node.name)

        visit(sf.tree.body, "", None)

    # ---- pass 2: call edges
    def resolve_from_import(mod: str, attr: str, depth: int = 0):
        """(module, attr) -> FuncKey | None, following one chain of
        package __init__ re-exports."""
        if depth > 5:
            return None
        sub = f"{mod}.{attr}"
        if sub in by_module_path:
            return None  # submodule import, not a function
        sf = by_module_path.get(mod)
        if sf is None:
            return None
        key = (sf.relpath, attr)
        if key in graph.funcs:
            return key
        idx = indexes.get(sf.relpath)
        if idx and attr in idx.from_imports:
            m2, a2 = idx.from_imports[attr]
            return resolve_from_import(m2, a2, depth + 1)
        return None

    def resolver(key: FuncKey):
        """(resolve_name, resolve_call) for code inside ``key``."""
        info = graph.funcs[key]
        sf = info.module
        index = indexes[sf.relpath]
        # scope chain for nested-def resolution, innermost first — the
        # function's OWN qualname comes first so calls to its own
        # nested defs resolve (reachability must descend into nested
        # helpers; they are where hot-path sync calls hide)
        parts = key[1].split(".")
        scopes = [
            ".".join(parts[:i]) for i in range(len(parts), 0, -1)
        ]

        def resolve_name(name: str) -> Optional[FuncKey]:
            for sc in scopes:  # nested sibling defs
                cand = (sf.relpath, f"{sc}.{name}")
                if cand in graph.funcs:
                    return cand
            if name in index.top_defs:
                cand = (sf.relpath, index.top_defs[name])
                if cand in graph.funcs:
                    return cand
                # class: constructor call -> its __init__
                init = (sf.relpath, f"{index.top_defs[name]}.__init__")
                if init in graph.funcs:
                    return init
            if name in index.from_imports:
                return resolve_from_import(*index.from_imports[name])
            return None

        def resolve_ref(fn: ast.AST) -> Optional[FuncKey]:
            if isinstance(fn, ast.Name):
                return resolve_name(fn.id)
            if isinstance(fn, ast.Attribute) and isinstance(
                fn.value, ast.Name
            ):
                base = fn.value.id
                if base == "self" and info.class_name:
                    cand = (sf.relpath, f"{info.class_name}.{fn.attr}")
                    if cand in graph.funcs:
                        return cand
                elif base in index.mod_aliases:
                    mod = index.mod_aliases[base]
                    msf = by_module_path.get(mod)
                    if msf is not None:
                        cand = (msf.relpath, fn.attr)
                        if cand in graph.funcs:
                            return cand
            return None

        return resolve_name, resolve_ref

    resolvers = {}
    for key in graph.funcs:
        resolvers[key] = resolver(key)
        resolve_ref = resolvers[key][1]
        edges: Set[FuncKey] = set()
        for node in _own_nodes(graph.funcs[key].node):
            if not isinstance(node, ast.Call):
                continue
            tgt = resolve_ref(node.func)
            if tgt is not None and tgt != key:
                edges.add(tgt)
                graph.call_targets.setdefault(key, []).append(
                    (node, tgt)
                )
        graph.edges[key] = edges

    _mark_captured(graph, indexes, resolvers)
    return graph


# ---------------------------------------------------------------------------
# captured marking (module docstring)

def _is_graph_ctx(expr: ast.AST, env: _ModuleIndex) -> bool:
    """Is this ``with`` item ``torch.cuda.graph(...)`` (through any
    import alias)?"""
    if not isinstance(expr, ast.Call):
        return False
    fn = expr.func
    if isinstance(fn, ast.Attribute) and fn.attr == "graph":
        base = fn.value
        if (
            isinstance(base, ast.Attribute)
            and base.attr == "cuda"
            and isinstance(base.value, ast.Name)
        ):
            return env.mod_aliases.get(base.value.id) == "torch"
        if isinstance(base, ast.Name):
            return env.mod_aliases.get(base.id) == "torch.cuda" or (
                env.from_imports.get(base.id) == ("torch", "cuda")
            )
        return False
    if isinstance(fn, ast.Name):
        return env.from_imports.get(fn.id) == ("torch.cuda", "graph")
    return False


def _params(node: ast.AST, is_method: bool) -> List[str]:
    """Positional parameter names, ``self``/``cls`` dropped."""
    args = node.args
    names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
    static = any(
        isinstance(d, ast.Name) and d.id == "staticmethod"
        for d in getattr(node, "decorator_list", ())
    )
    if is_method and not static and names:
        names = names[1:]
    return names


def _mark_captured(graph: CallGraph, indexes, resolvers) -> None:
    funcs = graph.funcs
    # a method's parent qualname is its class, which is no FuncKey
    is_method = {
        k: bool(i.class_name) and (k[0], k[1].rsplit(".", 1)[0]) not in funcs
        for k, i in funcs.items()
    }
    params = {k: _params(i.node, is_method[k]) for k, i in funcs.items()}
    # locals bound in each def (name -> value expressions), and the
    # ``self.X = value`` bindings of each class ((rel, class, X) ->
    # [(binding method, value)])
    local_values: Dict[FuncKey, Dict[str, List[ast.AST]]] = {}
    attr_values: Dict[Tuple[str, str, str], List[Tuple[FuncKey, ast.AST]]] = {}
    for key, info in funcs.items():
        table: Dict[str, List[ast.AST]] = {}
        for node in _own_nodes(info.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                if isinstance(t, ast.Name):
                    table.setdefault(t.id, []).append(node.value)
                elif (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    and info.class_name
                ):
                    attr_values.setdefault(
                        (key[0], info.class_name, t.attr), []
                    ).append((key, node.value))
        local_values[key] = table
    # builders returning one of their nested defs by name
    for key, info in funcs.items():
        for node in _own_nodes(info.node):
            if isinstance(node, ast.Return) and isinstance(
                node.value, ast.Name
            ):
                cand = (key[0], f"{key[1]}.{node.value.id}")
                if cand in funcs:
                    info.returns_def = cand
                    break
    methods_by_name: Dict[str, List[FuncKey]] = {}
    for key in funcs:
        if is_method[key]:
            methods_by_name.setdefault(
                key[1].rsplit(".", 1)[-1], []
            ).append(key)

    def enclosing(key: FuncKey) -> List[FuncKey]:
        """``key`` and its enclosing defs, innermost first."""
        parts = key[1].split(".")
        out = []
        for i in range(len(parts), 0, -1):
            k = (key[0], ".".join(parts[:i]))
            if k in funcs:
                out.append(k)
        return out

    changed = True

    def mark(k: Optional[FuncKey]) -> None:
        nonlocal changed
        if k is not None and not funcs[k].captured:
            funcs[k].captured = True
            changed = True

    def add_param(owner: FuncKey, name: str) -> bool:
        nonlocal changed
        if name in params[owner]:
            i = params[owner].index(name)
            if i not in funcs[owner].capture_params:
                funcs[owner].capture_params.add(i)
                changed = True
            return True
        return False

    def callable_ref(key: FuncKey, expr: ast.AST, depth: int = 0,
                     named: bool = True) -> None:
        """``expr``, a callable that a graph records, seen from inside
        ``key``: mark the def it names, or make the parameter it names
        a capture parameter of its def. ``named=False`` (a call inside
        a captured body) leaves a def the name resolves to unmarked:
        the call edge reaches it."""
        if depth > 4 or expr is None:
            return
        resolve_name, resolve_ref = resolvers[key]
        if isinstance(expr, ast.IfExp):
            callable_ref(key, expr.body, depth + 1)
            callable_ref(key, expr.orelse, depth + 1)
            return
        if isinstance(expr, ast.Lambda):
            recorded_calls(key, [expr.body], depth + 1, named)
            return
        if isinstance(expr, ast.Call):
            fn = expr.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else "")
            if name == "partial" and expr.args:
                callable_ref(key, expr.args[0], depth + 1)
                return
            tgt = resolve_ref(fn)
            if tgt is not None and funcs[tgt].returns_def:
                mark(funcs[tgt].returns_def)
            return
        if isinstance(expr, ast.Attribute):
            ref = resolve_ref(expr)
            if ref is not None:
                if named:
                    mark(ref)
            elif (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and funcs[key].class_name
            ):
                for owner, v in attr_values.get(
                    (key[0], funcs[key].class_name, expr.attr), ()
                ):
                    callable_ref(owner, v, depth + 1)
            return
        if not isinstance(expr, ast.Name):
            return
        for owner in enclosing(key):
            if add_param(owner, expr.id):
                return
            values = local_values[owner].get(expr.id)
            if values:
                for v in values:
                    callable_ref(owner, v, depth + 1)
                return
        if named:
            mark(resolve_name(expr.id))

    def recorded_calls(key: FuncKey, roots, depth: int = 0,
                       named: bool = True) -> None:
        """Every call under ``roots`` runs inside a graph: its callee
        (and every callable argument) is recorded."""
        for root in roots:
            for sub in ast.walk(root):
                if not isinstance(sub, ast.Call):
                    continue
                callable_ref(key, sub.func, depth, named)
                # a def handed over by name or as a bound method runs
                # in the graph too; other arguments are data
                for arg in sub.args:
                    if isinstance(arg, ast.Lambda):
                        callable_ref(key, arg, depth)
                    elif isinstance(arg, (ast.Name, ast.Attribute)):
                        ref = (resolvers[key][0](arg.id)
                               if isinstance(arg, ast.Name)
                               else resolvers[key][1](arg))
                        mark(ref)

    def forward_capture_args(key: FuncKey) -> None:
        """Calls from ``key`` to a def with capture parameters hand it
        a callable that a graph records."""
        resolve_ref = resolvers[key][1]
        for node in _own_nodes(funcs[key].node):
            if not isinstance(node, ast.Call):
                continue
            tgt = resolve_ref(node.func)
            targets = [tgt] if tgt is not None else []
            if (
                tgt is None
                and isinstance(node.func, ast.Attribute)
                and not (
                    isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                )
            ):
                targets = methods_by_name.get(node.func.attr, [])
            for t in targets:
                for i in sorted(funcs[t].capture_params):
                    arg = None
                    if i < len(node.args) and not any(
                        isinstance(a, ast.Starred) for a in node.args[: i + 1]
                    ):
                        arg = node.args[i]
                    else:
                        pname = params[t][i]
                        arg = next(
                            (kw.value for kw in node.keywords
                             if kw.arg == pname),
                            None,
                        )
                    if arg is not None:
                        callable_ref(key, arg)

    graph_blocks: Dict[FuncKey, List[ast.AST]] = {}
    for key, info in funcs.items():
        env = indexes[info.module.relpath]
        for node in _own_nodes(info.node):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_ctx(item.context_expr, env) for item in node.items
            ):
                graph_blocks.setdefault(key, []).extend(node.body)

    while changed:
        changed = False
        for key, roots in graph_blocks.items():
            recorded_calls(key, roots)
        for key in list(funcs):
            if funcs[key].captured:
                recorded_calls(key, [
                    n for n in ast.iter_child_nodes(funcs[key].node)
                    if not isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef))
                ], named=False)
            forward_capture_args(key)


def module_env(sf) -> _ModuleIndex:
    """Standalone import environment for one module — for rules that
    need alias matching without the full graph. Built once per file."""
    env = getattr(sf, "_module_env", None)
    if env is None:
        env = sf._module_env = _scan_imports(sf)
    return env


def _own_nodes(func_node: ast.AST):
    """Walk a function body WITHOUT descending into nested def/class
    (those are separate FuncInfos with their own edges)."""
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def own_statements(func_node: ast.AST):
    """Public alias of the nested-def-excluding walker for rules."""
    return _own_nodes(func_node)


# ---------------------------------------------------------------------------
# concurrency-analysis substrate: thread entries, lock
# identity, held-lock spans, coordination-path markers


# Hold-semantics primitives only: Event deliberately excluded (set/wait
# has no critical section, so "held" is meaningless for it).
_LOCK_CTOR_ATTRS = (
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"
)

# The rendezvous surface of ``torch.distributed``: a function calling a
# collective or barrier, or a store's set / get / wait / add, IS
# multi-process path code, whatever its name.
_COLLECTIVES = (
    "barrier",
    "monitored_barrier",
    "all_reduce",
    "all_gather",
    "all_gather_into_tensor",
    "all_gather_object",
    "broadcast",
    "broadcast_object_list",
    "reduce_scatter",
    "reduce_scatter_tensor",
)
_STORE_OPS = ("set", "get", "wait", "add")


def _is_dist_base(base: ast.AST, env: _ModuleIndex) -> bool:
    """Does this expression denote ``torch.distributed``?"""
    if isinstance(base, ast.Name):
        return env.mod_aliases.get(base.id) == "torch.distributed" or (
            env.from_imports.get(base.id) == ("torch", "distributed")
        )
    return (
        isinstance(base, ast.Attribute)
        and base.attr == "distributed"
        and isinstance(base.value, ast.Name)
        and env.mod_aliases.get(base.value.id) == "torch"
    )


def _names_store(expr: ast.AST) -> bool:
    """Is the receiver a store by its name (``store``, ``self._store``,
    ``_store()``, ``file_store``)?"""
    if isinstance(expr, ast.Call):
        expr = expr.func
    name = (
        expr.id if isinstance(expr, ast.Name)
        else expr.attr if isinstance(expr, ast.Attribute) else ""
    )
    return name.lower().endswith("store")


def coord_call(node: ast.AST, env: _ModuleIndex) -> Optional[str]:
    """``dist.<collective>`` / ``store.<op>`` when this call is a
    rendezvous (through any import alias), else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        if fn.attr in _COLLECTIVES and _is_dist_base(fn.value, env):
            return f"dist.{fn.attr}"
        if fn.attr in _STORE_OPS and _names_store(fn.value):
            return f"store.{fn.attr}"
    elif isinstance(fn, ast.Name):
        imp = env.from_imports.get(fn.id)
        if imp and imp[0] == "torch.distributed" and imp[1] in _COLLECTIVES:
            return f"dist.{imp[1]}"
    return None


def _has_coord_op(func_node: ast.AST, env: _ModuleIndex) -> bool:
    return any(coord_call(n, env) for n in _own_nodes(func_node))


def coord_sites(graph: CallGraph) -> Set[FuncKey]:
    """Every function carrying the per-process-path marker (a direct
    rendezvous in its own body)."""
    return {k for k, f in graph.funcs.items() if f.coord_op}


def lock_ctor_kind(node: ast.AST, index: _ModuleIndex) -> Optional[str]:
    """'Lock' / 'RLock' / 'Condition' / 'Semaphore' /
    'BoundedSemaphore' when this expression constructs one (via the
    ``threading`` module alias or a from-import), else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if (
        isinstance(fn, ast.Attribute)
        and fn.attr in _LOCK_CTOR_ATTRS
        and isinstance(fn.value, ast.Name)
        and index.mod_aliases.get(fn.value.id) == "threading"
    ):
        return fn.attr
    if isinstance(fn, ast.Name):
        imp = index.from_imports.get(fn.id)
        if imp and imp[0] == "threading" and imp[1] in _LOCK_CTOR_ATTRS:
            return imp[1]
    return None


def thread_entries(graph: CallGraph, ctx) -> Set[FuncKey]:
    """FuncKeys resolved from the ``target=`` of every
    ``threading.Thread(...)`` construction in the linted files — the
    pump/beat/monitor/worker mains concurrency rules treat as roots.
    ``target=self._main`` resolves through the constructing method's
    class; ``target=worker`` resolves to any same-module def of that
    name (the same over-approximation the captured marking uses)."""
    out: Set[FuncKey] = set()
    by_name: Dict[str, Dict[str, List[FuncKey]]] = {}
    for key in graph.funcs:
        by_name.setdefault(key[0], {}).setdefault(
            key[1].rsplit(".", 1)[-1], []
        ).append(key)
    for key, info in graph.funcs.items():
        sf = info.module
        env = module_env(sf)
        for node in _own_nodes(info.node):
            if not _is_thread_ctor(node, env):
                continue
            target = next(
                (kw.value for kw in node.keywords if kw.arg == "target"),
                None,
            )
            if target is None:
                continue
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
                and info.class_name
            ):
                cand = (sf.relpath, f"{info.class_name}.{target.attr}")
                if cand in graph.funcs:
                    out.add(cand)
            elif isinstance(target, ast.Name):
                out.update(
                    by_name.get(sf.relpath, {}).get(target.id, ())
                )
    return out


@dataclasses.dataclass(frozen=True)
class LockId:
    """Identity of a lock OBJECT (not a lock expression): the module
    that constructs it, the class scope for ``self.X`` locks ("" for
    module globals), the attribute/global name, and the primitive
    kind. Two expressions naming the same LockId are the same lock."""

    path: str
    scope: str
    name: str
    kind: str

    @property
    def label(self) -> str:
        return f"{self.scope}.{self.name}" if self.scope else self.name


class LockTable:
    """Every lock construction bound to a nameable root:
    ``self.X = threading.Lock()`` in any method of a class, or a
    module-level ``NAME = threading.Lock()``."""

    def __init__(self):
        # (relpath, class name, attr) -> LockId
        self.class_locks: Dict[Tuple[str, str, str], LockId] = {}
        # (relpath, global name) -> LockId
        self.module_locks: Dict[Tuple[str, str], LockId] = {}

    def resolver(self, info: FuncInfo):
        """Lock-expression resolver for one function: ``self.X`` via
        the enclosing class, bare names via module globals. Locals /
        parameters / foreign attributes resolve to None (conservative:
        unknown locks never enter a held set)."""
        rel = info.key[0]
        cls = info.class_name

        def resolve(expr: ast.AST) -> Optional[LockId]:
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and cls
            ):
                return self.class_locks.get((rel, cls, expr.attr))
            if isinstance(expr, ast.Name):
                return self.module_locks.get((rel, expr.id))
            return None

        return resolve


def lock_table(graph: CallGraph, ctx) -> LockTable:
    table = LockTable()
    for key, info in graph.funcs.items():
        if not info.class_name:
            continue
        env = module_env(info.module)
        for node in _own_nodes(info.node):
            if not isinstance(node, ast.Assign):
                continue
            kind = lock_ctor_kind(node.value, env)
            if kind is None:
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    k = (key[0], info.class_name, t.attr)
                    table.class_locks[k] = LockId(
                        key[0], info.class_name, t.attr, kind
                    )
    for sf in ctx.py_files:
        if sf.tree is None:
            continue
        env = module_env(sf)
        for node in sf.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            kind = lock_ctor_kind(node.value, env)
            if kind is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    table.module_locks[(sf.relpath, t.id)] = LockId(
                        sf.relpath, "", t.id, kind
                    )
    return table


def lock_events(func_node: ast.AST, resolve):
    """Span tracking over one function body (nested defs excluded):
    returns ``(nodes, acquisitions)`` where ``nodes`` is every
    ``(ast node, frozenset[LockId] held)`` pair and ``acquisitions``
    is ``(frozenset held BEFORE, LockId, lineno)`` per ``with`` item /
    ``.acquire()`` call on a resolvable lock. ``.release()`` drops the
    lock for the remainder of its suite; branch merging is
    deliberately simple (a suite inherits its parent's held set) —
    conservative both ways for the rules built on top."""
    nodes: List[Tuple[ast.AST, frozenset]] = []
    acquisitions: List[Tuple[frozenset, "LockId", int]] = []

    def expr_nodes(expr, held):
        for sub in ast.walk(expr):
            if not isinstance(
                sub,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                nodes.append((sub, held))

    def lock_method(call: ast.Call, name: str) -> Optional["LockId"]:
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == name
        ):
            return resolve(call.func.value)
        return None

    def walk(stmts, held: frozenset) -> frozenset:
        for stmt in stmts:
            if isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    expr_nodes(item.context_expr, held)
                    lid = resolve(item.context_expr)
                    if lid is not None and lid not in inner:
                        acquisitions.append((inner, lid, stmt.lineno))
                        inner = inner | {lid}
                walk(stmt.body, inner)
                continue
            if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Call
            ):
                acq = lock_method(stmt.value, "acquire")
                rel = lock_method(stmt.value, "release")
                expr_nodes(stmt.value, held)
                if acq is not None and acq not in held:
                    acquisitions.append((held, acq, stmt.lineno))
                    held = held | {acq}
                elif rel is not None and rel in held:
                    held = held - {rel}
                continue
            for field in (
                "body", "orelse", "finalbody",
            ):
                suite = getattr(stmt, field, ()) or ()
                if suite:
                    walk(list(suite), held)
            for h in getattr(stmt, "handlers", ()) or ():
                walk(h.body, held)
            # expression children of compound statements (test of an
            # if, iterator of a for, value of an assign …)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, (ast.stmt, ast.excepthandler)):
                    continue
                expr_nodes(child, held)
            nodes.append((stmt, held))
        return held

    walk(list(getattr(func_node, "body", ())), frozenset())
    return nodes, acquisitions
