"""HLO - the check of a stage-3 step's gathers.

Port of HLO002 of ``paddle_tpu/analysis/passes/hlo_checks.py``.  A ZeRO-3
step gathers each layer's weights where they are used; a step that
gathers the whole parameter set at once has lost the memory win of
sharding stage 3 without any error.  JAX reads the gathers from XLA's
optimized HLO text; the port's gathers are explicit, so the capture holds
them (``core.Collective``).

Codes:
- HLO002: an all-gather whose result is larger than the largest argument
  leaf of the call: for a stage-3 step, more than one parameter gathered
  wholesale instead of per layer.  The limit can be set with
  ``options={"hlo_post_checks": {"max_allgather_bytes": N}}``.

HLO001 (XLA's involuntary full rematerialization) and HLO003 (a scanned
layer's collectives peeled out of its while loop) have no counterpart:
there is no SPMD partitioner and no compiled loop in eager PyTorch.
"""

from __future__ import annotations

from typing import List

from ..core import (AnalysisContext, AnalysisPass, node_tensors, node_where,
                    register_pass, tensor_bytes)
from ..findings import Finding
from .collective_budget import TRANSPORT_FRAMES, result_bytes


def max_arg_leaf_bytes(cap) -> int:
    """The largest argument leaf, a ``ShardedTensor`` at its global size
    (JAX's arguments are global arrays)."""
    return max((ph.global_bytes if ph.global_bytes is not None
                else tensor_bytes(t) for ph in cap.placeholders
                for t in node_tensors(ph.node)), default=0)


@register_pass
class HloPostChecksPass(AnalysisPass):
    name = "hlo_post_checks"
    codes = ("HLO002",)

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        cap = ctx.graph
        limit = ctx.opt(self.name, "max_allgather_bytes", None)
        if limit is None:
            limit = max_arg_leaf_bytes(cap)
        if not limit:
            return []          # no sizing information: nothing to gate on
        findings = []
        for c in cap.collectives:
            if c.kind != "allgather":
                continue
            nbytes = result_bytes(c)
            if nbytes <= limit:
                continue
            where, data = node_where(c.node, TRANSPORT_FRAMES)
            findings.append(self.finding(
                "HLO002",
                f"all-gather over {c.axis!r} with a result of "
                f"{nbytes / 1e6:.2f} MB exceeds the largest argument leaf "
                f"({limit / 1e6:.2f} MB): a sharded (stage-3) step gathers "
                f"more than one parameter wholesale instead of per layer",
                where=where,
                data={**data, "bytes": nbytes, "limit": int(limit),
                      "axis": c.axis}))
        return findings
