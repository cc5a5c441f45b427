"""suppression: every graftlint disable must carry a justification.

A suppression is a claim — "this finding is a designed exception" —
and a claim without a reason is indistinguishable from a silenced
defect six months later. The grammar asks for ``-- why``; this rule
makes the convention a gate: a bare
``graftlint: disable=rule`` comment (or ``disable-next-line`` /
``disable-file``) with no ``--`` justification still suppresses its
target (un-suppressing on upgrade would silently change results) but
is itself a finding, so ``--check`` rejects NEW bare disables while
pre-existing ones ride the baseline's grandfathering/count-ratchet
like any other finding.

The engine's wildcard semantics protect this rule from itself: a bare
``disable=all`` on the offending line does NOT silence the hygiene
finding (``engine.SourceFile.suppressed``); only an explicit,
justified ``disable=suppression -- why`` does.
"""

from __future__ import annotations

from typing import Iterable

from hydragnn_tpu_torch.analysis.engine import Finding, LintContext, Rule


class SuppressionRule(Rule):
    name = "suppression"
    description = (
        "graftlint disables must carry a `-- justification`"
    )

    def run(self, ctx: LintContext) -> Iterable[Finding]:
        for sf in ctx.py_files:
            for line, rule in sf.bare_suppressions:
                yield Finding(
                    self.name, sf.relpath, line,
                    f"bare `graftlint: disable={rule}` without a "
                    "`-- justification` — a suppression must say why "
                    "(docs/STATIC_ANALYSIS.md); it still suppresses, "
                    "but new bare disables fail --check",
                )
