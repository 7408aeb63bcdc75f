"""Shared finding/report types and the ``# lint: racy-ok(...)`` waiver scan.

Port of ``repro.analysis.static.report``, unchanged but for the pass
names.

A Finding is one violated (or waived) invariant. Passes return lists of
findings; the Report aggregates them and decides the process exit code —
only *unwaived errors* fail the lint. Waivers are source-line comments:

    self.completed += 1  # lint: racy-ok(monotonic counter, GIL-atomic)

A waiver on either side of a race (the write line or the read line)
suppresses that finding; the reason string is carried into the report so
``-v`` output documents every deliberate exception in one place.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Tuple

WAIVER_RE = re.compile(r"#\s*lint:\s*racy-ok\(([^)]*)\)")


@dataclasses.dataclass
class Finding:
    pass_name: str            # "launch" | "kernel" | "concurrency"
    rule: str                 # e.g. "single-launch", "vmem-budget"
    severity: str             # "error" | "warn"
    location: str             # "path:line" or a symbol name
    message: str
    waived: bool = False
    waive_reason: str = ""

    def render(self) -> str:
        tag = "WAIVED" if self.waived else self.severity.upper()
        line = f"[{self.pass_name}/{self.rule}] {tag} {self.location}: {self.message}"
        if self.waived and self.waive_reason:
            line += f"  (waiver: {self.waive_reason})"
        return line


def scan_waivers(path: str, text: str) -> Dict[int, str]:
    """1-based line number -> waiver reason, for one source file."""
    out: Dict[int, str] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = WAIVER_RE.search(line)
        if m:
            out[i] = m.group(1).strip()
    return out


class Report:
    """Aggregates findings across passes; renders and gates on them."""

    def __init__(self) -> None:
        self.findings: List[Finding] = []

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def errors(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == "error" and not f.waived]

    def counts(self) -> Tuple[int, int, int]:
        """(unwaived errors, warnings, waived)."""
        err = len(self.errors())
        warn = sum(1 for f in self.findings
                   if f.severity == "warn" and not f.waived)
        waived = sum(1 for f in self.findings if f.waived)
        return err, warn, waived

    def render(self, verbose: bool = False) -> str:
        lines = []
        for f in self.findings:
            if f.waived and not verbose:
                continue
            if f.severity == "warn" and not verbose:
                continue
            lines.append(f.render())
        err, warn, waived = self.counts()
        lines.append(f"repro_torch-lint: {err} error(s), {warn} warning(s), "
                     f"{waived} waived")
        return "\n".join(lines)

    @property
    def ok(self) -> bool:
        return not self.errors()
