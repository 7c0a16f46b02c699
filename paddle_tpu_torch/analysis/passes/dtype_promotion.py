"""DT - the dtype-promotion audit.

Port of ``paddle_tpu/analysis/passes/dtype_promotion.py``.  A declared-bf16
compute region wins its milliseconds from tensor-core-native matmuls and
half-width memory traffic; one silent ``.float()`` in the wrong place gives
them back without failing any numeric test.  The pass walks the captured
graph:

- DT001: a large matmul (``mm``, ``bmm``, ``addmm``, ``baddbmm``) running in
  fp32/f64 inside a declared-bf16 region.  PyTorch refuses mixed-dtype
  matmuls, so JAX's mixed form cannot occur here;
- DT002: any float64 value;
- DT003: the micro-step accumulator: an fp32 buffer of at least
  ``min_elements`` that in-place adds (``add_``) update two or more times in
  a declared-bf16 region, the unrolled form of JAX's innermost scan carry.
  An fp32 buffer with a low-precision accumulator updated between its first
  two updates is a fold (JAX's outer fold carry) and is exempt.  The
  masked grad-accum branch is the tracked exemption
  EX-DT003-masked-grad-accum.

The declared dtype comes from ``check(..., declared_dtype=...)`` or is the
lowest precision any matmul (or kernel operator) runs in.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ...ops import _registry
from ..core import (AnalysisContext, AnalysisPass, call_nodes, input_tensors,
                    node_tensors, node_where, register_pass, storage_key,
                    written_inputs)
from ..findings import Finding

LOW_PRECISION = (torch.bfloat16, torch.float16)
_MATMULS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}
_ADDS = {"aten::add_"}


def _name(node) -> str:
    t = node.target
    return t._schema.name if isinstance(t, torch._ops.OpOverload) else ""


def _matmul_inputs(node) -> List[torch.Tensor]:
    ts = input_tensors(node)
    return ts[-2:] if _name(node) in ("aten::addmm", "aten::baddbmm") else ts


def infer_declared(cap):
    """The lowest-precision dtype any matmul or kernel operator reads, or
    None when every one runs in full precision."""
    seen = set()
    for n in call_nodes(cap):
        if _name(n) in _MATMULS:
            seen.update(t.dtype for t in _matmul_inputs(n))
        elif _registry.kernel_op(n.target):
            seen.update(t.dtype for t in input_tensors(n)[:1])
    for lp in LOW_PRECISION:
        if lp in seen:
            return lp
    return None


@register_pass
class DtypePromotionPass(AnalysisPass):
    name = "dtype_promotion"
    codes = ("DT001", "DT002", "DT003")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        min_elems = ctx.opt(self.name, "min_elements", 4096)
        cap = ctx.graph
        declared = ctx.declared_dtype if ctx.declared_dtype is not None \
            else infer_declared(cap)
        low = declared in LOW_PRECISION
        findings: List[Finding] = []
        for n in call_nodes(cap):
            findings.extend(self._check_f64(n))
            if low and _name(n) in _MATMULS:
                findings.extend(self._check_dot(n, declared, min_elems))
        if low:
            findings.extend(self._check_accumulators(cap, declared,
                                                     min_elems))
        return findings

    # ---- DT002 ------------------------------------------------------------

    def _check_f64(self, node) -> List[Finding]:
        for t in node_tensors(node):
            if t.dtype == torch.float64:
                where, data = node_where(node)
                return [self.finding(
                    "DT002",
                    f"float64 value produced by {_name(node) or node.target}"
                    f" (shape {tuple(t.shape)}): f64 runs at a fraction of "
                    f"the card's fp32 rate; a float64 input leaked into the "
                    f"program", where=where, data=data)]
        return []

    # ---- DT001 ------------------------------------------------------------

    def _check_dot(self, node, declared, min_elems) -> List[Finding]:
        ins = _matmul_inputs(node)
        if not any(t.dtype in (torch.float32, torch.float64) for t in ins):
            return []
        if max(t.numel() for t in ins) < min_elems:
            return []          # small glue math may legitimately be fp32
        where, data = node_where(node)
        shapes = [tuple(t.shape) for t in ins]
        return [self.finding(
            "DT001",
            f"fp32 matmul {shapes} inside a declared-{declared} compute "
            f"region: a silent upcast is paying full-precision cycles; cast "
            f"the operands to {declared} or add a tracked exemption",
            where=where, data={**data, "shapes": shapes, "mixed": False})]

    # ---- DT003 ------------------------------------------------------------

    def _check_accumulators(self, cap, declared, min_elems) -> List[Finding]:
        updates: Dict[int, List] = {}      # storage -> [(index, node, t)]
        for i, n in enumerate(cap.nodes):
            if n.op != "call_function" or _name(n) not in _ADDS:
                continue
            for t in written_inputs(n)[:1]:
                if t.numel() >= min_elems:
                    updates.setdefault(storage_key(t), []).append((i, n, t))
        low_at = sorted(i for ups in updates.values() for i, _, t in ups
                        if t.dtype in LOW_PRECISION)
        hot = []
        for ups in updates.values():
            t = ups[0][2]
            if t.dtype != torch.float32 or len(ups) < 2:
                continue
            first, second = ups[0][0], ups[1][0]
            if any(first < i < second for i in low_at):
                continue           # a fold over a low-precision carry
            hot.append(ups)
        if not hot:
            return []
        total = sum(ups[0][2].numel() * 4 for ups in hot)
        biggest = max(hot, key=lambda ups: ups[0][2].numel())
        where, data = node_where(biggest[-1][1])
        return [self.finding(
            "DT003",
            f"{len(hot)} fp32 accumulator(s) ({total / 1e6:.2f} MB) updated "
            f"in place every micro-step ({len(biggest)} updates of the "
            f"largest) in a declared-{declared} region: each "
            f"read-modify-write is full-width memory traffic; use a "
            f"bounded-depth bf16 carry with fp32 folds, or add a tracked "
            f"exemption", where=where,
            data={**data, "num_buffers": len(hot), "bytes": total,
                  "updates": len(biggest)})]
