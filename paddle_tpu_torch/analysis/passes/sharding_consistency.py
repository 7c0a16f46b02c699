"""SHARD - partition consistency across the stacks and in the step.

Port of ``paddle_tpu/analysis/passes/sharding_consistency.py``.  Several
stacks place the same parameters (the mesh step, the overlap engine, the
hybrid bodies, serving, expert parallelism); the canonical ``SpecLayout``
tables come from ``analysis/sharding.py``, one per stack, and this pass
audits them and the captured step.

Codes:
- SHARD001: the step issues more reshard-class collectives (all-to-all,
  permute, all-gather) than its declared schedule.  In the port every
  collective is explicit, so the declared schedule is the step's own
  planned collectives: those its plan's code issues (the engine's region
  functions, the step's modules; ``collective_budget.attribution``), to
  which ``options={"sharding_consistency": {"declared": {"allgather": n,
  ...}}}`` may add an allowance.  A reshard-class collective issued from
  anywhere else (a ``ShardedTensor.full()`` in the caller's code, a
  layout conversion nobody planned) counts against it.  JAX derives the
  allowance from GSPMD's measured reshards instead.
- SHARD002: a leaf over ``replicated_min_bytes`` replicated along a mesh
  axis its dims divide (a canonical ``layout`` table).
- SHARD003: one logical parameter with different canonical specs in two
  stacks' tables (``layouts``), compared over the axes both know.
- SHARD004: a shard dim its axis degree does not divide (padded shards).
- SHARD005: the flat update runs replicated where the weight update
  should be cut across the replicas (PAPERS.md 2004.13336): with
  ``expect_update_pin`` the flat optimizer state the step is given must
  hold, for every group of at least ``update_min_bytes``, this rank's
  block of the shard-major buffers of the step's ``FlatUpdateLayout``
  (``flat_layout``: its signature in the group's name, and the group's
  local size where ``flat_local_sizes`` gives it), not the whole buffer.
  JAX checks its ``sharding_constraint`` pins; the port's counterpart is
  the buffer sizes themselves.
"""

from __future__ import annotations

import math
from typing import Dict, List

from ..core import (AnalysisContext, AnalysisPass, SkipPass, node_tensors,
                    register_pass)
from ..findings import Finding

# the reshard-class collective kinds: layout conversions, not reductions
RESHARD_KINDS = ("alltoall", "collectivepermute", "allgather")

#: production default for SHARD002 (debug-shaped sweeps pass their own)
REPLICATED_MIN_BYTES = 1 << 20
#: production default for SHARD005's qualifying-buffer floor
UPDATE_MIN_BYTES = 64 << 10


def _finding(code, message, **kw) -> Finding:
    return Finding(code=code, message=message, severity="error",
                   pass_name="sharding_consistency", **kw)


def _itemsize(dtype: str) -> int:
    import torch

    return torch.empty((), dtype=getattr(torch, str(dtype))).element_size()


# ---------------------------------------------------------------------------
# table-level checks (pure functions over SpecLayout, which
# analysis/sharding.py reuses without a captured target)
# ---------------------------------------------------------------------------


def replication_waste_findings(layout, min_bytes: int = REPLICATED_MIN_BYTES,
                               ignore_axes=()) -> List[Finding]:
    """SHARD002 over one canonical table.  ``ignore_axes`` names the pure
    data axes (dp, pp, sep) the plan replicates params over by design."""
    findings = []
    sizes = {a: n for a, n in layout.mesh_axes
             if n > 1 and a not in set(ignore_axes)}
    for name, ts in sorted(layout.items()):
        if ts.nbytes < min_bytes:
            continue
        candidates = {}
        for axis, n in sizes.items():
            if axis in ts.axes_used:
                continue
            if any(not axes and d % n == 0 and d >= n
                   for d, axes in zip(ts.shape, ts.dim_axes)):
                candidates[axis] = ts.nbytes - ts.nbytes // n
        if not candidates:
            continue
        best_axis = max(candidates, key=lambda a: candidates[a])
        findings.append(_finding(
            "SHARD002",
            f"{name} ({ts.describe()}, {ts.nbytes} bytes) is replicated "
            f"along mesh axis '{best_axis}' (x{sizes[best_axis]}) though a "
            f"replicated dim divides it: {candidates[best_axis]} bytes of "
            f"per-device residency the at-rest plan leaves on the table"
            + (f" (also applicable: "
               f"{sorted(set(candidates) - {best_axis})})"
               if len(candidates) > 1 else ""),
            arg_path=name,
            data={"tensor": name, "bytes": ts.nbytes,
                  "wasted_bytes": candidates[best_axis],
                  "axes": {a: candidates[a] for a in sorted(candidates)}}))
    return findings


def shard_padding_findings(layout) -> List[Finding]:
    """SHARD004 over one canonical table."""
    findings = []
    sizes = dict(layout.mesh_axes)
    for name, ts in sorted(layout.items()):
        for d, (dim, axes) in enumerate(zip(ts.shape, ts.dim_axes)):
            if not axes:
                continue
            ways = math.prod(sizes.get(a, 1) for a in axes)
            if ways <= 1 or dim % ways == 0:
                continue
            per_shard = -(-dim // ways)            # ceil
            pad_elems = (per_shard * ways - dim) * max(
                1, math.prod(ts.shape) // max(dim, 1))
            pad_bytes = pad_elems * _itemsize(ts.dtype)
            findings.append(_finding(
                "SHARD004",
                f"{name} dim {d} (size {dim}) shards over "
                f"{'/'.join(axes)} ({ways} ways) without dividing: every "
                f"shard pads to {per_shard} (~{pad_bytes} padded bytes on "
                f"every transfer of this leaf); re-plan the dim or fall "
                f"back to replication like the at-rest rule",
                arg_path=name,
                data={"tensor": name, "dim": d, "size": dim,
                      "ways": ways, "padded_bytes": pad_bytes}))
    return findings


def cross_stack_findings(layouts: Dict[str, object]) -> List[Finding]:
    """SHARD003 over two or more stacks' canonical tables: every logical
    tensor present in a pair of tables carries the same spec after
    restriction to the axes both tables know."""
    findings = []
    names = sorted(layouts)
    for i, a_name in enumerate(names):
        for b_name in names[i + 1:]:
            a, b = layouts[a_name], layouts[b_name]
            shared = a.active_axes() & b.active_axes()
            for key in sorted(set(a.entries) & set(b.entries)):
                ta = a[key].restrict(shared)
                tb = b[key].restrict(shared)
                diffs = []
                if ta.shape != tb.shape:
                    diffs.append(f"shape {ta.shape} vs {tb.shape}")
                if ta.dim_axes != tb.dim_axes:
                    diffs.append(f"dims ({ta.describe()}) vs "
                                 f"({tb.describe()})")
                if ta.memory_kind != tb.memory_kind:
                    diffs.append(f"memory {ta.memory_kind} vs "
                                 f"{tb.memory_kind}")
                if not diffs:
                    continue
                findings.append(_finding(
                    "SHARD003",
                    f"{key}: stacks '{a_name}' and '{b_name}' map the same "
                    f"logical parameter to different canonical specs over "
                    f"shared axes {sorted(shared)}: {'; '.join(diffs)}.  "
                    f"Every handoff between the stacks (checkpoint "
                    f"restore, replica delivery, the unified schedule) "
                    f"pays a silent reshard",
                    arg_path=key,
                    data={"tensor": key, "stacks": [a_name, b_name],
                          "shared_axes": sorted(shared),
                          a_name: a[key].describe(),
                          b_name: b[key].describe()}))
    return findings


# ---------------------------------------------------------------------------
# the registered pass (the step-level SHARD001/SHARD005 and the tables)
# ---------------------------------------------------------------------------


def reshard_counts(cap, region=frozenset()) -> Dict[str, Dict[str, int]]:
    """{kind: {"planned", "unplanned"}} of the reshard-class collectives of
    one rank's capture (a permute counts once)."""
    from .collective_budget import attribution

    out = {k: {"planned": 0, "unplanned": 0} for k in RESHARD_KINDS}
    seen = set()
    for c in cap.collectives:
        if c.kind not in out:
            continue
        if c.is_p2p:
            if c.permute in seen:
                continue
            seen.add(c.permute)
        who = attribution(c, region)
        out[c.kind]["unplanned" if who == "outside" else "planned"] += 1
    return out


@register_pass
class ShardingConsistencyPass(AnalysisPass):
    name = "sharding_consistency"
    # SCHED001 is table-level only (analysis/sharding.py)
    codes = ("SHARD001", "SHARD002", "SHARD003", "SHARD004", "SHARD005",
             "SCHED001")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        opts = ctx.options.get(self.name, {}) if ctx.options else {}
        findings: List[Finding] = []
        ran = False
        if opts.get("audit_resharding") or "declared" in opts:
            ran = True
            findings.extend(self._check_resharding(
                ctx, opts.get("declared", {})))
        if "layout" in opts:
            ran = True
            mb = opts.get("replicated_min_bytes", REPLICATED_MIN_BYTES)
            findings.extend(replication_waste_findings(
                opts["layout"], mb,
                ignore_axes=opts.get("replication_ignore_axes", ())))
            findings.extend(shard_padding_findings(opts["layout"]))
        if "layouts" in opts:
            ran = True
            findings.extend(cross_stack_findings(opts["layouts"]))
        if opts.get("expect_update_pin"):
            ran = True
            findings.extend(self._check_update_pin(
                ctx, opts.get("flat_layout"),
                opts.get("update_min_bytes", UPDATE_MIN_BYTES),
                opts.get("flat_local_sizes")))
        if not ran:
            raise SkipPass(
                "no sharding contract declared (audit_resharding / "
                "declared / layout / layouts / expect_update_pin): a "
                "partition contract is per entry point, like the "
                "collective and memory budgets")
        return findings

    # ---- SHARD001 ---------------------------------------------------------

    def _check_resharding(self, ctx, declared) -> List[Finding]:
        from .collective_budget import overlap_region_funcs

        counts = reshard_counts(ctx.graph, overlap_region_funcs())
        findings = []
        for kind in RESHARD_KINDS:
            got = counts[kind]
            total = got["planned"] + got["unplanned"]
            allowed = got["planned"] + int(declared.get(kind, 0))
            if total <= allowed:
                continue
            findings.append(self.finding(
                "SHARD001",
                f"{kind}: {total} in the step against a declared reshard "
                f"schedule of {allowed} ({got['planned']} planned by the "
                f"step's own code"
                + (f", {declared[kind]} declared" if kind in declared
                   else "")
                + f"): {got['unplanned']} layout conversion(s) the "
                  f"schedule never planned; plan them in the step or "
                  f"declare them deliberately",
                data={"kind": kind, "planned": got["planned"],
                      "unplanned": got["unplanned"], "allowed": allowed}))
        return findings

    # ---- SHARD005 ---------------------------------------------------------

    def _check_update_pin(self, ctx, flat_layout, min_bytes: int,
                          local_sizes=None) -> List[Finding]:
        cap = ctx.graph
        bufs = [(ph.path, t) for ph in cap.placeholders
                if "__flat__" in ph.path for t in node_tensors(ph.node)
                if t.dim() == 1 and str(t.dtype) == "torch.float32"
                and t.numel() * 4 >= min_bytes]
        ways = flat_layout.ways if flat_layout is not None else 1
        findings = []
        if not bufs:
            findings.append(self.finding(
                "SHARD005",
                f"the entry declares a sharded weight update "
                f"(expect_update_pin) but is given no flat fp32 optimizer "
                f"buffer of >= {min_bytes} bytes: the update runs per "
                f"tensor, replicated wherever its params are",
                data={"min_bytes": min_bytes}))
            return findings
        sig = flat_layout.signature if flat_layout is not None else None
        sizes = local_sizes or {}
        for path, t in bufs:
            group = next((g for g in sizes if repr(g) in path), None)
            if ways > 1 and sig is not None and sig in path and (
                    group is None or t.numel() == sizes[group]):
                continue
            want = f", {sizes[group]} expected" if group is not None else ""
            findings.append(self.finding(
                "SHARD005",
                f"flat update buffer {path} ({t.numel()} fp32 elements"
                f"{want}) is whole on this rank"
                + (f" where the layout cuts it {ways} ways ({sig})"
                   if ways > 1 else " (no shard-major layout)")
                + ": the optimizer's read-modify-write runs in full on "
                  "every replica instead of cut across them (2004.13336)",
                arg_path=path,
                data={"bytes": t.numel() * 4, "ways": ways,
                      "signature": sig}))
        return findings
