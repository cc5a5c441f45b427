"""torch-api: every ``torch.*`` attribute chain must resolve against the
installed torch.

torch moves and removes APIs between minor releases (``torch.cuda.amp``
to ``torch.amp``, ``torch._six``, the ``torch.distributed`` tensor
modules), and the card's host runs another torch than the CPU hosts the
tests run on. So chains are resolved against the interpreter's actual
torch at lint time, not a vendored stub: ``chip_smoke.py``'s [lint]
phase runs this rule on the card's host, where a chain that exists only
in the CPU host's torch fails.

Mechanics: for each module, import aliases rooted at torch are tracked
(``import torch.nn.functional as F``, ``from torch import nn``, ``from
torch.distributed.tensor import DTensor``, ...); every Load-context
attribute chain whose base resolves into torch is then checked
attribute by attribute, importing not-yet-imported submodules along
the way. From-import statements of torch modules are checked the same
way. ``torch.ops.*`` and ``torch.classes.*`` are dynamic namespaces
(operators and classes registered at run time, e.g.
``torch.ops.hydragnn.edge_pipeline`` once the kernel library loads) and
are skipped. ``getattr(torch, "name", ...)`` probes are invisible to
this rule by construction — that is the sanctioned version-tolerant
accessor pattern.
"""

from __future__ import annotations

import ast
import importlib
import types
from typing import Dict, Iterable, List, Optional, Tuple

from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

# dotted chain -> None (resolves) | error message
_RESOLVE_CACHE: Dict[str, Optional[str]] = {}

# namespaces filled at run time
_DYNAMIC = ("torch.ops", "torch.classes")


def installed_torch_version() -> str:
    """For CLI/report headers — never embedded in finding messages
    (fingerprints must survive torch upgrades)."""
    try:
        import torch

        return torch.__version__
    except Exception:  # pragma: no cover - torch is a hard dep here
        return "unknown"


def _import_maybe(name: str):
    try:
        return importlib.import_module(name)
    except Exception:
        return None


def _dynamic(dotted: str) -> bool:
    return any(dotted == d or dotted.startswith(d + ".") for d in _DYNAMIC)


def resolve_chain(dotted: str) -> Optional[str]:
    """None when the chain resolves (or is dynamic); otherwise the
    missing prefix."""
    if _dynamic(dotted):
        return None
    if dotted in _RESOLVE_CACHE:
        return _RESOLVE_CACHE[dotted]
    parts = dotted.split(".")
    obj = None
    consumed = 0
    for i in range(len(parts), 0, -1):
        obj = _import_maybe(".".join(parts[:i]))
        if obj is not None:
            consumed = i
            break
    err: Optional[str] = None
    if obj is None:
        err = f"`{parts[0]}` is not importable"
    else:
        for j in range(consumed, len(parts)):
            attr = parts[j]
            if _dynamic(".".join(parts[: j + 1])):
                break
            nxt = getattr(obj, attr, _MISSING)
            if nxt is _MISSING and isinstance(obj, types.ModuleType):
                nxt = _import_maybe(f"{obj.__name__}.{attr}")
                if nxt is None:
                    nxt = _MISSING
            if nxt is _MISSING:
                missing = ".".join(parts[: j + 1])
                # NOTE: no version string here — the message feeds the
                # baseline fingerprint, which must survive upgrades
                err = f"`{missing}` does not exist in the installed torch"
                break
            obj = nxt
    _RESOLVE_CACHE[dotted] = err
    return err


_MISSING = object()


def _attr_chain(node: ast.Attribute) -> Optional[Tuple[str, List[str]]]:
    """(base_name, [attr, ...]) for a pure Name.attr.attr... chain."""
    attrs: List[str] = []
    cur: ast.AST = node
    while isinstance(cur, ast.Attribute):
        attrs.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        return cur.id, list(reversed(attrs))
    return None


class TorchApiRule(Rule):
    name = "torch-api"
    description = (
        "torch.* attribute chains and from-imports must resolve against "
        "the installed torch"
    )

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        for sf in ctx.py_files:
            if sf.tree is None:
                continue
            yield from self._check_module(sf)

    def _check_module(self, sf) -> Iterable[Finding]:
        aliases: Dict[str, str] = {}  # local name -> torch-rooted dotted path
        reported = set()  # (line, message) dedupe for nested chains

        def report(line: int, err: str):
            if (line, err) not in reported:
                reported.add((line, err))
                yield Finding(self.name, sf.relpath, line, err)

        # pass 1: aliases + import-site checks
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "torch" or a.name.startswith("torch."):
                        local = a.asname or a.name.split(".")[0]
                        aliases[local] = a.name if a.asname else "torch"
                        err = resolve_chain(a.name)
                        if err:
                            yield from report(node.lineno, err)
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level or not (
                    node.module == "torch" or node.module.startswith("torch.")
                ):
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    dotted = f"{node.module}.{a.name}"
                    err = resolve_chain(dotted)
                    if err:
                        yield from report(node.lineno, err)
                    else:
                        aliases[a.asname or a.name] = dotted

        if not aliases:
            return

        # pass 2: attribute chains rooted at a torch alias
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Attribute):
                continue
            if not isinstance(node.ctx, ast.Load):
                continue  # setting/deleting attrs is not an API read
            chain = _attr_chain(node)
            if chain is None:
                continue
            base, attrs = chain
            root = aliases.get(base)
            if root is None:
                continue
            err = resolve_chain(".".join([root] + attrs))
            if err:
                yield from report(node.lineno, err)
