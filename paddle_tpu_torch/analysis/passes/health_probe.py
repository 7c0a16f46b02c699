"""HEALTH - the health probe's fusion contract.

Port of ``paddle_tpu/analysis/passes/health_probe.py``.  The training
health guardian (``distributed/health.py``) fuses its probe (global grad
norm, per-bucket non-finite counts, loss, update/param ratio) into the
train step, so detection costs reductions over buffers the step already
holds and one small host transfer.  The pass pins that against the SAME
step built without ``health=``:

- HEALTH001: the probed step's static peak exceeds
  ``baseline_peak_bytes + probe_overhead_bytes`` (the probe materialised
  something tree-sized);
- HEALTH002: the probed graph holds more collectives of a kind (``c10d``
  and ``_c10d_functional`` nodes) than ``baseline_collectives`` declares
  (missing kinds are 0: on the one-device step any collective fires).

``options={"health_probe": {"baseline_peak_bytes": N,
"probe_overhead_bytes": M, "baseline_collectives": {kind: count}}}``;
with neither contract declared the pass skips.
"""

from __future__ import annotations

from collections import Counter
from typing import List

from ..core import (AnalysisContext, AnalysisPass, SkipPass, call_nodes,
                    collective_kind, register_pass)
from ..findings import Finding


def count_collectives(cap) -> Counter:
    return Counter(k for k in (collective_kind(n) for n in call_nodes(cap))
                   if k is not None)


@register_pass
class HealthProbePass(AnalysisPass):
    name = "health_probe"
    codes = ("HEALTH001", "HEALTH002")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        opts = ctx.options.get(self.name, {}) if ctx.options else {}
        baseline_peak = opts.get("baseline_peak_bytes")
        baseline_coll = opts.get("baseline_collectives")
        if baseline_peak is None and baseline_coll is None:
            raise SkipPass(
                "no probe-fusion contract declared for this entry point "
                "(options={'health_probe': {'baseline_peak_bytes': ..., "
                "'probe_overhead_bytes': ..., "
                "'baseline_collectives': {...}}})")
        findings: List[Finding] = []
        if baseline_peak is not None:
            findings.extend(self._check_peak(
                ctx, int(baseline_peak),
                int(opts.get("probe_overhead_bytes", 64 << 10))))
        if baseline_coll is not None:
            findings.extend(self._check_collectives(ctx, baseline_coll))
        return findings

    def _check_peak(self, ctx, baseline: int, overhead: int):
        peak = ctx.peak["peak_bytes"]
        budget = baseline + overhead
        if peak <= budget:
            return []
        return [self.finding(
            "HEALTH001",
            f"probed step's static peak {peak / 1e6:.2f} MB exceeds the "
            f"unprobed baseline {baseline / 1e6:.2f} MB by more than the "
            f"declared probe overhead {overhead / 1e6:.2f} MB: the health "
            f"probe materialised tree-sized intermediates instead of "
            f"reducing buffers the step already holds "
            f"(distributed/health.make_probe is the reductions-only "
            f"reference)",
            data={"peak_bytes": peak, "baseline_bytes": baseline,
                  "overhead_bytes": overhead, "budget_bytes": budget})]

    def _check_collectives(self, ctx, baseline):
        counts = count_collectives(ctx.graph)
        over = {kind: {"count": c, "allowed": int(baseline.get(kind, 0))}
                for kind, c in counts.items()
                if c > int(baseline.get(kind, 0))}
        if not over:
            return []
        detail = ", ".join(f"{k} {v['count']}>{v['allowed']}"
                           for k, v in sorted(over.items()))
        return [self.finding(
            "HEALTH002",
            f"probed step's graph carries collectives beyond the unprobed "
            f"baseline ({detail}): the health probe added communication; "
            f"on the one-device step the probe must add none",
            data={"over": over})]
