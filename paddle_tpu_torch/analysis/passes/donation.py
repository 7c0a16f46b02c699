"""DON - the donation analyzer.

Port of ``paddle_tpu/analysis/passes/donation.py``.  A JAX step that is
handed params and optimizer state without donating them holds two copies
of the model for the step.  Eager PyTorch has no donation: the port donates
by updating in place (the serving pools, the host-resident state of the
memory engine), and a functional update keeps both copies, the caller's and
the new one.  The pass reads the captured graph:

- DON001: a top-level argument whose leaves are not written in place while
  the program builds fresh outputs of their shapes and dtypes (the caller
  holds the old leaves, the program returns new ones: double residency).
  Aggregated per argument, as in JAX.  Arguments that persist by design
  (serving weights, rope tables, the params of a forward/backward) are
  declared with ``options={"donation": {"persistent": (0,)}}``;
  ``min_bytes`` (default 1 MB) is the per-argument floor.
- DON002: two argument leaves on one storage with one of them written in
  place: the other alias reads the written values (JAX's use-after-donate).
"""

from __future__ import annotations

from typing import Dict, List

from ..core import (AnalysisContext, AnalysisPass, call_nodes, fn_where,
                    node_tensors, register_pass, storage_key, tensor_bytes,
                    written_inputs)
from ..findings import Finding


def _written_storages(cap) -> set:
    out = set()
    for n in call_nodes(cap):
        for t in written_inputs(n):
            out.add(storage_key(t))
    return out


def undonated_bytes(cap, persistent=()) -> Dict[str, Dict[str, int]]:
    """{argument label: {"bytes", "leaves"}} of the leaves DON001 prices:
    not written in place, while the call returns a fresh output of the
    leaf's shape and dtype (a buffer the leaf's storage could have been;
    JAX prices every undonated leaf the same way)."""
    written = _written_storages(cap)
    inputs = {storage_key(t) for ph in cap.placeholders
              for t in node_tensors(ph.node)}
    fresh = {(tuple(t.shape), t.dtype) for t in cap.outputs
             if storage_key(t) not in inputs}
    per_arg: Dict[str, Dict[str, int]] = {}
    for ph in cap.placeholders:
        if ph.argnum is not None and ph.argnum in persistent:
            continue
        for t in node_tensors(ph.node):
            if storage_key(t) in written:
                continue
            if (tuple(t.shape), t.dtype) not in fresh:
                continue
            slot = per_arg.setdefault(ph.label, {"bytes": 0, "leaves": 0,
                                                 "biggest": ("", 0)})
            b = tensor_bytes(t)
            slot["bytes"] += b
            slot["leaves"] += 1
            if b > slot["biggest"][1]:
                slot["biggest"] = (ph.path, b)
    return per_arg


@register_pass
class DonationPass(AnalysisPass):
    name = "donation"
    codes = ("DON001", "DON002")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        min_bytes = ctx.opt(self.name, "min_bytes", 1 << 20)
        persistent = set(ctx.opt(self.name, "persistent", ()))
        cap = ctx.graph
        where, data = fn_where(ctx.fn)
        findings = []
        for label, slot in sorted(undonated_bytes(cap, persistent).items()):
            if slot["bytes"] < min_bytes:
                continue
            big_path, big_bytes = slot["biggest"]
            findings.append(self.finding(
                "DON001",
                f"{label}: {slot['bytes'] / 1e6:.2f} MB across "
                f"{slot['leaves']} leaf tensor(s) neither updated in place "
                f"nor released: the call builds new tensors of their shapes "
                f"beside the caller's, so both are resident at the end of "
                f"the step (largest leaf {big_path}, {big_bytes / 1e6:.2f} "
                f"MB); update it in place, or declare it persistent if it "
                f"is reused across calls",
                where=where, arg_path=label,
                data={**data, "bytes": slot["bytes"],
                      "leaves": slot["leaves"]}))
        findings.extend(self._aliased_writes(ctx, cap))
        return findings

    def _aliased_writes(self, ctx, cap) -> List[Finding]:
        written = _written_storages(cap)
        by_storage: Dict[int, List[str]] = {}
        for ph in cap.placeholders:
            for t in node_tensors(ph.node):
                by_storage.setdefault(storage_key(t), []).append(ph.path)
        where, data = fn_where(ctx.fn)
        out = []
        for key, paths in by_storage.items():
            if len(paths) < 2 or key not in written:
                continue
            out.append(self.finding(
                "DON002",
                f"the same storage is passed in {len(paths)} argument "
                f"positions {paths} and written in place through one of "
                f"them: the other alias reads the written values (the "
                f"eager form of use-after-donate)",
                where=where, arg_path=paths[0],
                data={**data, "paths": paths}))
        return out
