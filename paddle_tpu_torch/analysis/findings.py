"""Typed findings of the analysis passes.

Port of ``paddle_tpu/analysis/findings.py``: a ``Finding`` is one detected
hazard (a stable CODE, a severity, a message and location breadcrumbs: the
source frame of a graph node, the argument of a per-argument finding), a
``Report`` what ``check`` or a sweep returns (active and suppressed
findings, the passes that ran, the passes skipped and why);
``report.ok`` is the gate and ``raise_if_findings`` raises
``AnalysisError`` with the report's summary.
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

    def raise_if_findings(self):
        if self.findings:
            raise AnalysisError(self)


class AnalysisError(AssertionError):
    """Raised by ``Report.raise_if_findings``: an AssertionError, so pytest
    renders the whole report."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(report.summary())


__all__ = ["SEVERITIES", "AnalysisError", "Finding", "Report"]
