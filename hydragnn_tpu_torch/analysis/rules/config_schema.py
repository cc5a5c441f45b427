"""config-schema: JSON configs must only use keys some reader of the
port accepts.

A misspelled config key (``"hidden_dmi"``) is silently ignored by the
defaulting pass in ``hydragnn_tpu_torch/config/config.py`` — the run
trains with the default value and the mistake surfaces, if ever, as a
quality regression days later. The same silence hides a parity gap: a
key the JAX package reads and the port does not is ignored by the port.
This rule validates every JSON config under ``examples/`` and
``tests/inputs/`` against the ACCEPTED KEY VOCABULARY harvested
statically from the port's code that reads configs.

Harvest (over the linted python files — the port's package, its
drivers under ``hydragnn_tpu_torch/drivers/`` included, so
driver-private keys stay legal; the JAX package's ``examples/*.py`` are
never harvested):

- ``x.get("K", ...)`` / ``x.setdefault("K", ...)`` / ``x.pop("K")``
- ``x["K"]`` subscripts and ``"K" in x`` membership tests
- string elements of pure-string tuple/list literals (covers
  ``_ARCH_NONE_DEFAULTS``-style key tables and ``for split in
  ("train", "validate", "test")`` iteration)

Validation walks every object key at every depth. Multibranch head
lists use the ``branch-<n>`` naming convention, which is allowed by
pattern; keys starting with ``_`` are internal bookkeeping and skipped.

The vocabulary is flat (a key accepted in one section is accepted in
all) — this is a typo and parity catcher with zero false positives by
construction, not a full structural schema.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterable, Set, Tuple

from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule

_DEFAULT_KEYS_CACHE: Dict[str, Set[str]] = {}


def _default_scope_keys(root: str) -> Set[str]:
    """Vocabulary harvested from the default python scope on disk —
    the fallback for path-restricted runs whose context lacks the
    config readers. Empty for roots without the package (in-memory
    fixture runs provide their own readers)."""
    if root in _DEFAULT_KEYS_CACHE:
        return _DEFAULT_KEYS_CACHE[root]
    from hydragnn_tpu_torch.analysis.engine import collect_files
    from hydragnn_tpu_torch.analysis.rules import DEFAULT_PATHS

    paths = [
        p for p in DEFAULT_PATHS
        if os.path.exists(os.path.join(root, p))
    ]
    keys: Set[str] = set()
    if paths:
        keys = harvest_accepted_keys(collect_files(root, paths))
    _DEFAULT_KEYS_CACHE[root] = keys
    return keys

_BRANCH_KEY = re.compile(r"^branch-\d+$")
_MAX_LITERAL_TABLE = 64  # str-tuple/list literals longer than this are data


def harvest_accepted_keys(ctx: LintContext) -> Set[str]:
    keys: Set[str] = set()
    for sf in ctx.py_files:
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in ("get", "setdefault", "pop")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    keys.add(node.args[0].value)
            elif isinstance(node, ast.Subscript):
                sl = node.slice
                if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                    keys.add(sl.value)
            elif isinstance(node, ast.Compare):
                if (
                    isinstance(node.left, ast.Constant)
                    and isinstance(node.left.value, str)
                    and any(isinstance(op, (ast.In, ast.NotIn))
                            for op in node.ops)
                ):
                    keys.add(node.left.value)
            elif isinstance(node, (ast.Tuple, ast.List)):
                elts = node.elts
                if (
                    0 < len(elts) <= _MAX_LITERAL_TABLE
                    and all(
                        isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                        for e in elts
                    )
                ):
                    keys.update(e.value for e in elts)
    return keys


def _walk_keys(doc, path: str) -> Iterable[Tuple[str, str]]:
    """Yield (key, dotted_path) for every object key at every depth."""
    if isinstance(doc, dict):
        for k, v in doc.items():
            p = f"{path}.{k}" if path else k
            yield k, p
            yield from _walk_keys(v, p)
    elif isinstance(doc, list):
        for i, v in enumerate(doc):
            yield from _walk_keys(v, f"{path}[{i}]")


class ConfigSchemaRule(Rule):
    name = "config-schema"
    description = (
        "JSON config keys must be accepted by some config reader"
    )

    # JSON directories this rule owns
    scopes = ("examples/", "tests/inputs/")

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        targets = [
            sf for sf in ctx.json_files
            if sf.relpath.startswith(self.scopes)
        ]
        if not targets:
            return
        accepted = harvest_accepted_keys(ctx)
        # A path-restricted run (`--diff`, explicit paths) sees only a
        # subset of the reader fleet — and the subset can INCLUDE the
        # canonical config module while missing the other readers (a
        # diff touching config/config.py used to flag every key that
        # lives in runner.py/models/examples), so no single module's
        # presence is evidence of full scope. Always supplement from
        # the default scope on disk: in-memory fixture roots carry no
        # package (empty harvest, negative tests unaffected) and the
        # result is cached per root, so a full default run pays one
        # extra pass.
        accepted |= _default_scope_keys(ctx.root)
        if not accepted:
            # no vocabulary -> no basis for claims
            return
        for sf in targets:
            try:
                doc = json.loads(sf.text)
            except json.JSONDecodeError as e:
                yield Finding(
                    self.name, sf.relpath, e.lineno,
                    f"invalid JSON: {e.msg}",
                )
                continue
            seen: Set[str] = set()
            for key, dotted in _walk_keys(doc, ""):
                if key in accepted or key in seen:
                    continue
                if key.startswith("_") or _BRANCH_KEY.match(key):
                    continue
                seen.add(key)
                yield Finding(
                    self.name, sf.relpath, _line_of_key(sf, key),
                    f"unknown config key `{key}` (at {dotted}) — no "
                    "reader in hydragnn_tpu_torch/ accepts it; "
                    "misspelled keys are silently ignored at run time",
                )


def _line_of_key(sf, key: str) -> int:
    needle = f'"{key}"'
    for i, line in enumerate(sf.lines, start=1):
        if needle in line:
            return i
    return 1
