"""graftlint CLI of the port — torch-aware static analysis for
hydragnn_tpu_torch.

Usage:
    python -m hydragnn_tpu_torch.analysis [paths...] [options]

Options:
    --check            gate mode: exit 1 when any NEW finding exists
                       (not suppressed, not in the baseline); exit 0
                       otherwise. Stale baseline entries are reported
                       but do not fail the gate.
    --baseline PATH    baseline file (default
                       hydragnn_tpu_torch/analysis/baseline.json; pass
                       --baseline '' to disable baselining)
    --write-baseline   rewrite the baseline to exactly the current
                       finding set (prunes stale entries), then exit 0
    --json             machine-readable output (findings + summary,
                       including the per-rule stats table)
    --stats            print the per-rule finding/suppression/baseline
                       table (ratchet drift is visible in diffs);
                       composes with --check
    --rules r1,r2      run only the named rules
    --diff REV         lint only files changed vs git REV (plus
                       untracked files) that fall inside the default
                       scope — the pre-commit fast path. A restricted
                       view: config-schema falls back to the on-disk
                       default vocabulary, stale-baseline reporting is
                       suppressed (unchanged files can't vouch for
                       their entries), and --write-baseline refuses it
                       like any restricted run.
    --explain RULE     print the rule's catalog entry: description,
                       seed registry (when call-graph scoped), and the
                       rule module's full docstring
    --list-rules       print the rule catalog and exit

Exit codes: 0 clean (or informational mode), 1 new findings under
--check, 2 usage / internal error.

Paths default to the port's package + chip_smoke.py + the JSON configs
of examples/ and tests/inputs (see
hydragnn_tpu_torch.analysis.DEFAULT_PATHS). The repo root is located
from this module's own path, so the CLI works from any cwd.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_PACKAGE_DIR))

DEFAULT_BASELINE = os.path.join(_PACKAGE_DIR, "baseline.json")


def _changed_files(rev: str):
    """Lintable files changed between REV and the working tree (plus
    untracked), restricted to the default scope. Raises ValueError on
    a bad rev — a typo must be a usage error, never a green no-op."""
    import subprocess

    from hydragnn_tpu_torch.analysis.rules import DEFAULT_PATHS, JSON_ONLY_PATHS

    def git(*args):
        r = subprocess.run(
            ["git", "-C", _REPO_ROOT] + list(args),
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise ValueError(
                f"git {' '.join(args[:2])} failed: "
                f"{r.stderr.strip() or r.stdout.strip()}"
            )
        return r.stdout.splitlines()

    names = set(git("diff", "--name-only", rev, "--"))
    names.update(
        git("ls-files", "--others", "--exclude-standard")
    )
    scope_dirs = tuple(
        p + "/" for p in DEFAULT_PATHS if not p.endswith(".py")
    )
    scope_files = tuple(p for p in DEFAULT_PATHS if p.endswith(".py"))
    out = []
    for n in sorted(names):
        if not n.endswith((".py", ".json")):
            continue
        if not (n.startswith(scope_dirs) or n in scope_files):
            continue
        if n.endswith(".py") and n.startswith(
            tuple(p + "/" for p in JSON_ONLY_PATHS)
        ):
            continue
        if os.path.exists(os.path.join(_REPO_ROOT, n)):
            out.append(n)  # deleted files have nothing to lint
    return out


def _stats_table(result) -> str:
    """Fixed-width per-rule counts, rules sorted by name — the table
    diffs cleanly in PRs, so a family's ratchet drifting (new
    baselined entries, suppression creep) is one visible hunk."""
    header = f"{'rule':22s} {'new':>5s} {'baselined':>10s} {'suppressed':>11s}"
    lines = [header, "-" * len(header)]
    tot = {"new": 0, "baselined": 0, "suppressed": 0}
    for rule in sorted(result.per_rule):
        c = result.per_rule[rule]
        lines.append(
            f"{rule:22s} {c['new']:>5d} {c['baselined']:>10d} "
            f"{c['suppressed']:>11d}"
        )
        for k in tot:
            tot[k] += c[k]
    lines.append(
        f"{'total':22s} {tot['new']:>5d} {tot['baselined']:>10d} "
        f"{tot['suppressed']:>11d}"
    )
    return "\n".join(lines)


def _explain(rule) -> str:
    import inspect
    import sys as _sys

    lines = [f"{rule.name} — {rule.description}", ""]
    if getattr(rule, "seeds", ()):
        lines.append("seed registry (path suffix, qualname):")
        for path_sfx, qual in rule.seeds:
            lines.append(f"  {path_sfx:28s} {qual}")
        from hydragnn_tpu_torch.analysis.rules.hot_coverage import (
            HOT_EXEMPT,
            HotCoverageRule,
        )

        if isinstance(rule, HotCoverageRule) and HOT_EXEMPT:
            lines.append("exemptions:")
            for (p, q), why in sorted(HOT_EXEMPT.items()):
                lines.append(f"  {p}:{q} — {why}")
        lines.append("")
    doc = inspect.getdoc(_sys.modules[type(rule).__module__]) or ""
    lines.append(doc)
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hydragnn_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", help="files/dirs to lint")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--stats", action="store_true")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--diff", default=None, metavar="REV")
    ap.add_argument("--explain", default=None, metavar="RULE")
    ap.add_argument("--list-rules", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code in (0, None) else 2

    baseline = args.baseline or None
    if args.diff is not None and args.paths:
        print("graftlint: --diff and explicit paths are exclusive",
              file=sys.stderr)
        return 2
    if args.write_baseline:
        # validate BEFORE the (multi-second) lint run
        if not baseline:
            print("graftlint: --write-baseline needs a --baseline path",
                  file=sys.stderr)
            return 2
        if args.paths or args.rules or args.diff:
            # a restricted run sees only a subset of findings; writing
            # it would silently drop every grandfathered entry outside
            # the restriction
            print(
                "graftlint: --write-baseline requires a full default-"
                "scope run (no explicit paths, no --rules, no --diff)",
                file=sys.stderr,
            )
            return 2

    try:
        from hydragnn_tpu_torch.analysis import (
            rules_by_name, run_lint, write_baseline,
        )
        from hydragnn_tpu_torch.analysis.rules import all_rules

        if args.list_rules:
            for r in all_rules():
                print(f"{r.name:18s} {r.description}")
            return 0
        if args.explain:
            (rule,) = rules_by_name([args.explain])
            print(_explain(rule))
            return 0

        paths = args.paths or None
        if args.diff is not None:
            paths = _changed_files(args.diff)
            if not paths:
                print(
                    f"graftlint: no lintable files changed vs "
                    f"{args.diff}"
                )
                return 0

        rules = (
            rules_by_name(args.rules.split(",")) if args.rules else None
        )
        result = run_lint(
            _REPO_ROOT,
            paths=paths,
            rules=rules,
            baseline_path=None if args.write_baseline else baseline,
        )
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # internal error must not masquerade as clean
        import traceback

        traceback.print_exc()
        print(f"graftlint: internal error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(baseline, result.findings)
        print(
            f"graftlint: wrote {len(result.findings)} finding(s) to "
            f"{os.path.relpath(baseline, _REPO_ROOT)}"
        )
        return 0

    from hydragnn_tpu_torch.analysis.rules.torch_api import (
        installed_torch_version,
    )

    if args.as_json:
        # identity, not equality: duplicate findings share (rule, path,
        # message) but only `count` of them are baselined
        baselined_ids = {id(f) for f in result.baselined}
        print(json.dumps({
            "torch_version": installed_torch_version(),
            "findings": [
                {
                    "rule": f.rule, "path": f.path, "line": f.line,
                    "message": f.message,
                    "fingerprint": f.fingerprint,
                    "baselined": id(f) in baselined_ids,
                }
                for f in result.findings
            ],
            "new": len(result.new),
            "baselined": len(result.baselined),
            "suppressed": result.suppressed,
            "per_rule": result.per_rule,
            # --diff is a restricted view: entries for unchanged files
            # vanish from the finding set, which is not staleness
            "stale_baseline": (
                sorted(result.stale_baseline)
                if args.diff is None
                else []
            ),
            "ok": result.ok,
        }, indent=2))
    else:
        for f in result.new:
            print(f.render())
        if result.baselined and not args.check:
            for f in result.baselined:
                print(f"{f.render()}  [baselined]")
        if result.stale_baseline and args.diff is None:
            # a --diff view can't judge staleness: entries for
            # unchanged files vanish from the restricted finding set
            print(
                f"graftlint: {len(result.stale_baseline)} stale baseline "
                "entr(ies) no longer match — prune with --write-baseline"
            )
        if args.stats:
            print(_stats_table(result))
        print(
            f"graftlint: {len(result.new)} new, "
            f"{len(result.baselined)} baselined, "
            f"{result.suppressed} suppressed "
            f"(torch {installed_torch_version()})"
        )

    if args.check:
        return 0 if result.ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
