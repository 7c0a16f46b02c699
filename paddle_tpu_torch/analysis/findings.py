"""Typed findings of the analysis passes.

The part of ``paddle_tpu/analysis/findings.py`` that the Concurrency Doctor
needs: a ``Finding`` is one detected hazard (a stable CODE, a severity, a
message and location breadcrumbs), a ``Report`` what a sweep returns
(active and suppressed findings, the passes that ran); ``report.ok`` is the
gate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    code: str                       # stable id, e.g. "RACE001"
    message: str
    severity: str = "error"
    pass_name: str = ""
    where: Optional[str] = None     # "inference/fleet.py:585 (Router.step)"
    arg_path: Optional[str] = None  # for per-argument findings
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    exemption_id: Optional[str] = None   # set when suppressed

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def format(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        ap = f" [{self.arg_path}]" if self.arg_path else ""
        ex = f" (exempt: {self.exemption_id})" if self.exemption_id else ""
        return f"{self.code} {self.severity.upper()}{loc}{ap}: " \
               f"{self.message}{ex}"


@dataclasses.dataclass
class Report:
    target: str                                  # what was checked
    findings: List[Finding] = dataclasses.field(default_factory=list)
    suppressed: List[Finding] = dataclasses.field(default_factory=list)
    passes_run: Tuple[str, ...] = ()
    skipped: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def codes(self) -> List[str]:
        return [f.code for f in self.findings]

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def summary(self) -> str:
        lines = [f"doctor report for {self.target}: "
                 f"{len(self.findings)} finding(s), "
                 f"{len(self.suppressed)} suppressed, "
                 f"passes={','.join(self.passes_run) or '-'}"]
        for f in self.findings:
            lines.append("  " + f.format())
        for f in self.suppressed:
            lines.append("  (suppressed) " + f.format())
        for name, why in self.skipped.items():
            lines.append(f"  (skipped {name}: {why})")
        return "\n".join(lines)


__all__ = ["SEVERITIES", "Finding", "Report"]
