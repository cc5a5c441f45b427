"""graftlint core (the port's copy): findings, suppressions, baseline,
and the runner.

The engine is deliberately framework-free: a ``SourceFile`` is a parsed
python module (or JSON document) plus its suppression index, a ``Rule``
is anything with a ``name`` and a ``run(ctx)`` yielding ``Finding``s,
and ``run_lint`` wires file collection, rule execution, per-line
suppression comments, and the checked-in JSON baseline into one result.

Suppression grammar (mirrors pylint's, with a graftlint prefix):

    x = acc.cpu()  # graftlint: disable=host-sync -- one sync/epoch
    # graftlint: disable-next-line=nondet -- wall-clock for logging only
    t0 = time.time()
    # graftlint: disable-file=config-schema -- generated fixture (anywhere in the file)

``disable=all`` silences every rule on that line. Everything after
``--`` is a free-form justification. A disable WITHOUT a
justification still suppresses its target (changing that would
silently un-suppress on upgrade), but it is surfaced as a finding of
the ``suppression`` hygiene rule — so ``--check`` rejects new bare
disables while pre-existing ones can be grandfathered through the
baseline like any other finding. The ``all`` wildcard deliberately
does NOT cover the ``suppression`` rule (a bare ``disable=all`` must
not silence the complaint about itself); only an explicit, justified
``disable=suppression -- why`` does.

Baseline: grandfathered findings live in a JSON file keyed by a stable
fingerprint of (rule, path, message) — line numbers are excluded so
unrelated edits above a finding don't invalidate the baseline. A
baselined finding is reported but does not fail ``--check``; a fixed
finding simply stops matching (stale entries are listed by the CLI so
they can be pruned with ``--write-baseline``).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

BASELINE_VERSION = 1

# Directories never worth walking for lintable files.
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "logs", "node_modules"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``path`` is repo-relative posix; ``line`` is
    1-based. The fingerprint intentionally omits the line number (see
    module docstring)."""

    rule: str
    path: str
    line: int
    message: str

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}|{self.path}|{self.message}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_DISABLE_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-next-line|disable-file)="
    r"([A-Za-z0-9_,\- ]+)"
)


def _parse_rule_list(raw: str) -> Set[str]:
    raw = raw.split("--")[0]  # strip the free-form justification
    out = set()
    for part in raw.split(","):
        words = part.split()
        if words:
            out.add(words[0])
    return out


def _has_justification(raw: str, rest_of_line: str) -> bool:
    """Is there a non-empty free-form justification after ``--``? The
    rule-list regex greedily consumes letters/dashes/spaces, so the
    justification may sit partly inside ``raw`` (``host-sync -- one
    sync``) and/or continue past it (``all -- (reason)``)."""
    parts = raw.split("--", 1)
    if len(parts) < 2:
        return False
    return bool(parts[1].strip(" -") or rest_of_line.strip(" -"))


class SourceFile:
    """A lintable file: source text, (for .py) the AST, and the
    suppression index parsed from graftlint comments."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.is_python = relpath.endswith(".py")
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        if self.is_python:
            try:
                self.tree = ast.parse(text)
            except SyntaxError as e:  # surfaced as a finding by run_lint
                self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
        # line (1-based) -> {rule name ("all" wildcard): justified?}
        self._line_disables: Dict[int, Dict[str, bool]] = {}
        self._file_disables: Dict[str, bool] = {}
        # (comment line, rule name) per disable lacking a justification
        # — surfaced by the `suppression` hygiene rule
        self.bare_suppressions: List[Tuple[int, str]] = []
        self._index_suppressions()

    def _index_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            if "graftlint" not in line:
                continue
            for m in _DISABLE_RE.finditer(line):
                kind, raw = m.group(1), m.group(2)
                rules = _parse_rule_list(raw)
                justified = _has_justification(raw, line[m.end():])
                if not justified:
                    self.bare_suppressions.extend(
                        (i, r) for r in sorted(rules)
                    )
                if kind == "disable":
                    dst = self._line_disables.setdefault(i, {})
                elif kind == "disable-next-line":
                    dst = self._line_disables.setdefault(i + 1, {})
                else:  # disable-file
                    dst = self._file_disables
                for r in rules:
                    dst[r] = dst.get(r, False) or justified

    def suppressed(self, rule: str, line: int) -> bool:
        active = self._line_disables.get(line, {})
        if rule == "suppression":
            # the hygiene rule's own findings: only an explicit,
            # justified disable counts — "all" (or a bare
            # disable=suppression) must not silence the complaint
            # about itself
            return bool(
                self._file_disables.get(rule) or active.get(rule)
            )
        if "all" in self._file_disables or rule in self._file_disables:
            return True
        return "all" in active or rule in active


class LintContext:
    """Shared state handed to every rule: the file sets (parsed once)
    plus lazily-built cross-file analyses (the call graph)."""

    def __init__(self, root: str, py_files: List[SourceFile],
                 json_files: List[SourceFile]):
        self.root = root
        self.py_files = py_files
        self.json_files = json_files
        self._callgraph = None

    @property
    def callgraph(self):
        if self._callgraph is None:
            from hydragnn_tpu_torch.analysis.callgraph import build_callgraph

            self._callgraph = build_callgraph(self)
        return self._callgraph


class Rule:
    """Base class: subclasses set ``name`` and implement ``run``.
    ``seeds`` is the rule's (path_suffix, qualname) seed registry when
    it scopes by call-graph reachability — surfaced by ``--explain``
    so the per-rule scope is inspectable without reading the source."""

    name: str = ""
    description: str = ""
    seeds: Sequence[Tuple[str, str]] = ()

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# file collection


def collect_files(root: str, paths: Sequence[str]) -> LintContext:
    """Build a LintContext from the given paths (files or directories,
    absolute or root-relative). ``.py`` files are parsed; ``.json``
    files are collected for document-level rules (config-schema).
    Python files under ``rules.JSON_ONLY_PATHS`` (the JAX package's
    example scripts) are never collected."""
    from hydragnn_tpu_torch.analysis.rules import JSON_ONLY_PATHS

    json_only = tuple(
        os.path.join(os.path.abspath(root), p) + os.sep
        for p in JSON_ONLY_PATHS
    )
    py: List[SourceFile] = []
    js: List[SourceFile] = []
    seen: Set[str] = set()

    def add(abspath: str) -> None:
        abspath = os.path.abspath(abspath)
        if abspath in seen or (
            abspath.endswith(".py") and abspath.startswith(json_only)
        ):
            return
        seen.add(abspath)
        rel = os.path.relpath(abspath, root)
        try:
            with open(abspath, encoding="utf-8") as f:
                text = f.read()
        except (OSError, UnicodeDecodeError):
            return
        sf = SourceFile(abspath, rel, text)
        (py if sf.is_python else js).append(sf)

    for p in paths:
        abspath = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(abspath):
            add(abspath)
            continue
        if not os.path.isdir(abspath):
            # a typo'd path must be a usage error, not a green no-op gate
            raise ValueError(f"no such file or directory: {p}")
        for dirpath, dirnames, filenames in os.walk(abspath):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith((".py", ".json")):
                    add(os.path.join(dirpath, fn))
    py.sort(key=lambda f: f.relpath)
    js.sort(key=lambda f: f.relpath)
    return LintContext(root, py, js)


# ---------------------------------------------------------------------------
# baseline


def load_baseline(path: str) -> Dict[str, int]:
    """fingerprint -> grandfathered occurrence count; empty when
    absent. The count is a ratchet: fingerprints omit line numbers (so
    line moves don't invalidate entries), but a NEW occurrence of the
    same (rule, path, message) beyond the recorded count still gates."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    return {
        e["fingerprint"]: int(e.get("count", 1))
        for e in doc.get("findings", [])
    }

def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Write sorted grandfather entries (one per fingerprint, with an
    occurrence count). Entries carry the human-readable fields next to
    the fingerprint so diffs of the baseline file review like
    findings."""
    entries: Dict[str, dict] = {}
    for f in findings:
        e = entries.setdefault(f.fingerprint, {
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "message": f.message,
            "count": 0,
        })
        e["count"] += 1
    doc = {
        "version": BASELINE_VERSION,
        "findings": [entries[k] for k in sorted(entries)],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# runner


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]        # reportable (suppressions removed)
    new: List[Finding]             # findings not covered by the baseline
    baselined: List[Finding]       # findings matched by the baseline
    suppressed: int                # count removed by disable comments
    stale_baseline: Set[str]       # baseline fingerprints nothing matched
    # rule name -> {"new", "baselined", "suppressed"} counts — the
    # --stats surface (ratchet drift per family is visible in PR
    # diffs instead of one opaque total)
    per_rule: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict
    )

    @property
    def ok(self) -> bool:
        return not self.new


def default_rules() -> List[Rule]:
    from hydragnn_tpu_torch.analysis.rules import all_rules

    return all_rules()


def run_lint(
    root: str,
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[Rule]] = None,
    baseline_path: Optional[str] = None,
) -> LintResult:
    """Collect files, run every rule, apply suppressions + baseline."""
    from hydragnn_tpu_torch.analysis.rules import DEFAULT_PATHS

    ctx = collect_files(root, list(paths or DEFAULT_PATHS))
    return run_on_context(ctx, rules=rules, baseline_path=baseline_path)


def run_on_context(
    ctx: LintContext,
    rules: Optional[Sequence[Rule]] = None,
    baseline_path: Optional[str] = None,
) -> LintResult:
    rules = list(rules) if rules is not None else default_rules()
    raw: List[Finding] = []
    for sf in ctx.py_files:
        if sf.parse_error:
            raw.append(
                Finding("parse", sf.relpath, 1, sf.parse_error)
            )
    for rule in rules:
        raw.extend(rule.run(ctx))
    raw.sort(key=lambda f: (f.path, f.line, f.rule, f.message))

    per_rule: Dict[str, Dict[str, int]] = {
        r.name: {"new": 0, "baselined": 0, "suppressed": 0}
        for r in rules
    }

    def bump(rule: str, bucket: str) -> None:
        per_rule.setdefault(
            rule, {"new": 0, "baselined": 0, "suppressed": 0}
        )[bucket] += 1

    by_rel = {sf.relpath: sf for sf in ctx.py_files + ctx.json_files}
    kept: List[Finding] = []
    suppressed = 0
    for f in raw:
        sf = by_rel.get(f.path)
        if sf is not None and sf.suppressed(f.rule, f.line):
            suppressed += 1
            bump(f.rule, "suppressed")
        else:
            kept.append(f)

    known = load_baseline(baseline_path) if baseline_path else {}
    budget = dict(known)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in kept:  # kept is sorted, so the match is deterministic
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            old.append(f)
            bump(f.rule, "baselined")
        else:
            new.append(f)
            bump(f.rule, "new")
    stale = set(known) - {f.fingerprint for f in kept}
    return LintResult(
        findings=kept,
        new=new,
        baselined=old,
        suppressed=suppressed,
        stale_baseline=stale,
        per_rule=per_rule,
    )


def lint_sources(
    sources: Dict[str, str],
    rules: Sequence[Rule],
    root: str = "/virtual",
) -> List[Finding]:
    """Test/fixture helper: lint in-memory sources (relpath -> text)
    with the given rules; no baseline, suppressions honored."""
    py: List[SourceFile] = []
    js: List[SourceFile] = []
    for rel, text in sources.items():
        sf = SourceFile(os.path.join(root, rel), rel, text)
        (py if sf.is_python else js).append(sf)
    ctx = LintContext(root, py, js)
    return run_on_context(ctx, rules=rules).findings
