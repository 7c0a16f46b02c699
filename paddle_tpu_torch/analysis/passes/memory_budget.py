"""MEM - peak device bytes and host-transfer budgets per entry point.

Port of ``paddle_tpu/analysis/passes/memory_budget.py``.  A declared entry
point carries a capacity contract: its static peak (``core.static_peak``,
the live device bytes over the captured graph with the caller-held inputs
counted; the port's ``compiled.memory_analysis()``) must fit the declared
budget, and its host<->device traffic the declared streaming budget.

Codes:
- MEM000: the capture failed (``core.check`` reports it for every pass;
  the capacity numbers are moot and the step does not trace);
- MEM001: the static peak exceeds ``options={"memory_budget":
  {"hbm_bytes": N}}``;
- MEM002: the bytes of host<->device copies (``copy_`` or ``_to_copy``
  between the host and the device memory kinds: across devices on a card
  capture; on a CPU capture, to or from the memory engine's host-resident
  leaves under ``__offload__``) exceed ``{"host_transfer_bytes": N}``.

With neither budget declared the pass skips: a budget is a per-entry
contract, not a global default.
"""

from __future__ import annotations

from typing import List


from ..core import (AnalysisContext, AnalysisPass, SkipPass, call_nodes,
                    input_tensors, node_tensors, node_where, register_pass,
                    storage_key, tensor_bytes)
from ..findings import Finding


def host_storages(cap) -> set:
    """The storages of the host memory kind among the inputs."""
    return {storage_key(t) for ph in cap.placeholders if ph.host
            for t in node_tensors(ph.node)}


def scan_memory_transfers(cap) -> List[tuple]:
    """(bytes, direction, node) of every host<->device copy in the graph."""
    host = host_storages(cap)
    card = cap.device.type == "cuda"

    def kind(t):
        if card:
            return "host" if t.device.type == "cpu" else "device"
        return "host" if storage_key(t) in host else "device"

    out = []
    for n in call_nodes(cap):
        name = getattr(getattr(n.target, "_schema", None), "name", "")
        if name not in ("aten::copy_", "aten::_to_copy"):
            continue
        ins = input_tensors(n)
        if not ins:
            continue
        src = ins[1] if name == "aten::copy_" and len(ins) > 1 else ins[0]
        dst = ins[0] if name == "aten::copy_" else node_tensors(n)[0]
        a, b = kind(src), kind(dst)
        if a != b:
            out.append((tensor_bytes(src), f"{a}->{b}", n))
    return out


@register_pass
class MemoryBudgetPass(AnalysisPass):
    name = "memory_budget"
    codes = ("MEM000", "MEM001", "MEM002")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        opts = ctx.options.get(self.name, {}) if ctx.options else {}
        hbm = opts.get("hbm_bytes")
        host = opts.get("host_transfer_bytes")
        if hbm is None and host is None:
            raise SkipPass(
                "no memory budget declared for this entry point "
                "(options={'memory_budget': {'hbm_bytes': ..., "
                "'host_transfer_bytes': ...}})")
        findings: List[Finding] = []
        if hbm is not None:
            findings.extend(self._check_peak(ctx, int(hbm)))
        if host is not None:
            findings.extend(self._check_transfers(ctx, int(host)))
        return findings

    def _check_peak(self, ctx, hbm: int) -> List[Finding]:
        pk = ctx.peak
        peak = pk["peak_bytes"]
        if peak <= hbm:
            return []
        node = pk["peak_node"]
        where, data = (node_where(ctx.graph.nodes[node]) if node is not None
                       else (None, {}))
        return [self.finding(
            "MEM001",
            f"static peak {peak / 1e6:.2f} MB exceeds the declared device "
            f"budget of {hbm / 1e6:.2f} MB (caller-held inputs "
            f"{pk['argument_bytes'] / 1e6:.2f} MB, new outputs "
            f"{pk['output_bytes'] / 1e6:.2f} MB): pick a heavier point on "
            f"the remat/offload lattice (parallel.memory.tune_memory_config)"
            f" or raise the declared budget deliberately",
            where=where,
            data={**data, "peak_bytes": peak, "budget_bytes": hbm,
                  "argument_bytes": pk["argument_bytes"],
                  "output_bytes": pk["output_bytes"]})]

    def _check_transfers(self, ctx, budget: int) -> List[Finding]:
        transfers = scan_memory_transfers(ctx.graph)
        total = sum(nb for nb, _, _ in transfers)
        if total <= budget:
            return []
        worst = sorted(transfers, key=lambda t: -t[0])[:3]
        where, data = node_where(worst[0][2]) if worst else (None, {})
        return [self.finding(
            "MEM002",
            f"host<->device transfer traffic of {total / 1e6:.2f} MB per "
            f"step exceeds the declared streaming budget of "
            f"{budget / 1e6:.2f} MB over {len(transfers)} transfers: an "
            f"unbucketed full-state round trip defeats the memory engine's "
            f"size-capped streaming (largest: "
            f"{', '.join(f'{nb / 1e6:.2f} MB {d}' for nb, d, _ in worst)})",
            where=where,
            data={**data, "total_bytes": total, "budget_bytes": budget,
                  "transfers": len(transfers),
                  "largest_bytes": [int(nb) for nb, _, _ in worst]})]
