"""Tracked exemptions of the Graph Doctor.

Port of ``paddle_tpu/analysis/exemptions.py``.  An exemption is an ACCEPTED
finding: the pass still detects it, and the report moves it to
``report.suppressed`` instead of failing the gate.  Every entry carries an
id, the code it covers, a source match (the finding's ``where``, the file
and line of the node or of the entry point) and a reason, so an accepted
fp32 region or an undonated state is a decision with a record.  The
self-check (``python -m paddle_tpu_torch.analysis --self-check``) runs each
entry's liveness probe and fails when the entry no longer matches a live
suppressed finding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .findings import Finding


@dataclasses.dataclass(frozen=True)
class Exemption:
    id: str                      # stable handle, e.g. "EX-DT003-masked-..."
    code: str                    # finding code this entry covers
    file_pattern: str            # substring of the finding's where
    reason: str
    function: Optional[str] = None   # a function anywhere in its stack

    def matches(self, finding: Finding) -> bool:
        if finding.code != self.code:
            return False
        if self.file_pattern not in (finding.where or ""):
            return False
        if self.function is not None:
            fns = tuple(finding.data.get("stack_functions") or ())
            fns += (finding.data.get("function"),)
            if self.function not in fns:
                return False
        return True


# The standing table.  Add entries here (never inline at call sites), so
# that the history of this file is the history of accepted hazards.
EXEMPTIONS: Sequence[Exemption] = (
    Exemption(
        id="EX-DT003-masked-grad-accum",
        code="DT003",
        file_pattern="models/llama.py",
        function="micro_steps_masked",
        reason=(
            "the token-weighted gradient merge keeps an fp32 accumulator by "
            "design: micro-gradients are weighted by the step's total "
            "valid-token count and the partial sums span the whole "
            "accumulation window, so there is no bounded-depth fold point "
            "for a bf16 carry (the unmasked path has one and uses it).  "
            "Mirror of the JAX entry of the same id; design note: "
            "models/llama.py build_train_step, micro_steps_masked."),
    ),
)


def apply_exemptions(findings, exemptions=None):
    """Split findings into (active, suppressed) under the exemption table
    (None: the standing ``EXEMPTIONS``); suppressed findings get their
    ``exemption_id`` stamped."""
    table = EXEMPTIONS if exemptions is None else exemptions
    active, suppressed = [], []
    for f in findings:
        hit = next((e for e in table if e.matches(f)), None)
        if hit is None:
            active.append(f)
        else:
            f.exemption_id = hit.id
            suppressed.append(f)
    return active, suppressed


__all__ = ["EXEMPTIONS", "Exemption", "apply_exemptions"]
