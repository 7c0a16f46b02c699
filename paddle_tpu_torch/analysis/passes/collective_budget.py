"""COMM - the collective count and size budget, and the overlap schedule's
conformance.

Port of ``paddle_tpu/analysis/passes/collective_budget.py``.  The overlap
engine (``parallel/overlap.py``) made the collective schedule an
engineered artifact: so many gathers a layer, reduce-scatters in buckets,
rings that rotate uniformly.  This pass keeps it so, from one rank's
capture (``core.Collective``: every collective of the port is explicit,
so the capture holds what JAX reads from the compiled HLO and the jaxpr
together).  An ``async_op=True`` issue and its wait are one node: each
collective counts once.

Codes:
- COMM001: the capture's collective COUNT or BYTES per kind exceed the
  budget the entry point declared (``options={"collective_budget":
  {"allreduce": {"count": n, "bytes": b}, ...}}``); bytes are the
  result's, as HLO's result types give them (a gather's is its input
  times the group, a scatter's its input over the group).  No declared
  budget and no collective: the pass skips.
- COMM002: a collective issued outside an overlap-engine region while the
  entry declares an engine active (``{"overlap_active": True}``): none of
  its frames is one of ``parallel.overlap.OVERLAP_REGION_FUNCS`` (or the
  entry's ``overlap_region_functions``), and the first frame past the
  collective transport (``parallel/compat.py``, ``parallel/specs.py``,
  third-party wrappers) is not the port's own step code (``attribution``).  JAX skips the
  collectives GSPMD inserts; the port's counterparts are the step's own
  planned collectives, which this rule keeps.
- COMM003: a permute of a tick loop, issued by the pipeline executor
  (``parallel/pipelining.py``) or by a function the entry names
  (``{"ring_functions": (...)}``), whose pairs on the mesh axis are not
  one uniform rotation (mixed ring steps: a stage receives from another
  relative neighbour than it sends to).  JAX checks the permutes inside
  a ``scan``.  Repeated sources and destinations are COLL002's.
- COMM004: the post-codec bytes on the wire per stage (ICI within a
  slice, DCN across) exceed the declared wire budget
  (``{"wire": {"dcn_axes": {axis: slice_map}, "dcn_bytes": n[,
  "ici_bytes": m]}}``).  Each collective is priced with the ring cost
  model on its real payload dtype (an int8 packed payload bills a byte
  an element) and staged against the declared per-axis slice maps
  (``_wire_stage``: a group whose positions span two slices crosses DCN).
  The ring cost model is ``parallel.roofline.ring_wire_cost``, the one
  copy the roofline's predicted wire table also prices with.
  ``collect_wire_table`` and ``collect_wire_by_axis`` are the reusable
  tallies (``parallel.schedule.measure_dcn_wire_bytes`` reads them).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core import (AnalysisContext, AnalysisPass, SkipPass, node_where,
                    register_pass)
from ..findings import Finding
from ...parallel.roofline import ring_wire_cost

KINDS = ("allreduce", "allgather", "reducescatter", "collectivepermute",
         "alltoall")

_PKG = os.sep + "paddle_tpu_torch" + os.sep
# the collective transport: frames there say nothing about who asked
_TRANSPORT = (os.sep + os.path.join("parallel", "compat.py"),
              os.sep + os.path.join("parallel", "specs.py"))
# third-party frames (a deprecation wrapper around a torch call)
_LIBS = (os.sep + "site-packages" + os.sep, os.sep + "dist-packages" + os.sep)
# the port's own code (all of the package but this one): a collective its
# frames reach first is planned
_ANALYSIS = _PKG + "analysis" + os.sep
_PIPELINE = os.sep + os.path.join("parallel", "pipelining.py")


def ring_steps(perm, size: int) -> List[int]:
    """Each pair's rotation step on an axis of ``size`` positions."""
    return [(int(d) - int(s)) % size for s, d in perm]


def result_bytes(c) -> int:
    """The collective's result bytes, as HLO's result type counts them."""
    g = max(len(c.group), 1)
    if c.kind == "allgather":
        return c.nbytes * g
    if c.kind == "reducescatter":
        return c.nbytes // g
    return c.nbytes


#: the frames a collective's where skips: the transport and third parties
TRANSPORT_FRAMES = _TRANSPORT + _LIBS


def _frame_names(node) -> set:
    frames = node.meta.get("pt_frames") or ()
    return {f[2] for f in frames} | {f[3] for f in frames if len(f) > 3}


def attribution(c, region=frozenset()) -> str:
    """Who issued a collective: ``"engine"`` when a frame is one of the
    region functions ``region``; ``"plan"`` when the first frame past the
    collective transport is the port's own step code (or there is none:
    autograd's backward of a planned forward); else ``"outside"``."""
    if region and _frame_names(c.node) & region:
        return "engine"
    for f in c.node.meta.get("pt_frames") or ():
        fname = f[0]
        if any(d in fname for d in TRANSPORT_FRAMES):
            continue
        return "plan" if _PKG in fname and _ANALYSIS not in fname \
            else "outside"
    return "plan"


def overlap_region_funcs(extra=()) -> frozenset:
    from ...parallel.overlap import OVERLAP_REGION_FUNCS

    return OVERLAP_REGION_FUNCS | frozenset(extra)


def _positions(mesh, ranks, axis: str) -> List[int]:
    pos = mesh.axis_names.index(axis)
    return [int(np.unravel_index(r, mesh.devices.shape)[pos])
            for r in ranks]


def _wire_stage(c, rank: int, mesh, dcn_axes: Dict) -> str:
    """"dcn" when the collective's ranks span two slices of a declared
    per-axis slice map, else "ici" (the ranks of a send or a recv are the
    rank and its peer)."""
    if mesh is None or not c.axis:
        return "ici"
    ranks = (rank, c.peer) if c.is_p2p else c.group
    for a in c.axis.split("+"):
        sm = dcn_axes.get(a)
        if sm is None:
            continue
        if len({sm[p] for p in _positions(mesh, ranks, a)}) > 1:
            return "dcn"
    return "ici"


def priced_collectives(cap, mesh, dcn_axes: Dict
                       ) -> Iterator[Tuple[str, str, str, int, int]]:
    """The one pricing walk: ``(kind, axes, stage, cost, count)`` per
    collective of a rank's capture, ring-model bytes on the payload's real
    dtype, staged against the slice maps.  A permute (the sends and recvs
    of one ``batch_isend_irecv``) counts once and costs its sends' bytes.
    ``collect_wire_table`` and ``collect_wire_by_axis`` both read it, so
    the cost model cannot fork."""
    seen = set()
    for c in cap.collectives:
        if c.is_p2p:
            if c.op != "send":
                continue
            cost = c.nbytes
            count = 0 if c.permute in seen else 1
            seen.add(c.permute)
        else:
            g = len(c.group)
            if g <= 1:
                continue
            cost, count = ring_wire_cost(c.kind, c.nbytes, g), 1
        yield (c.kind, c.axis or "", _wire_stage(c, cap.rank, mesh,
                                                 dcn_axes or {}),
               cost, count)


def collect_wire_table(cap, mesh, dcn_axes: Dict) -> Dict[str, Dict]:
    """Post-codec bytes on the wire per (stage, kind) of one rank's
    capture; ``dcn_axes`` maps an axis to the slice of each of its
    positions (``distributed.topology``'s slice maps)."""
    table = {s: {"count": 0, "bytes": 0, "kinds": {}} for s in ("ici",
                                                               "dcn")}
    for kind, _axes, stage, cost, count in priced_collectives(cap, mesh,
                                                              dcn_axes):
        ent = table[stage]
        ent["count"] += count
        ent["bytes"] += cost
        k = ent["kinds"].setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += count
        k["bytes"] += cost
    return table


def collect_wire_by_axis(cap, mesh, dcn_axes: Dict) -> Dict[str, Dict]:
    """The same walk keyed by the collective's axes (``"sharding"``,
    ``"dp+sharding"``): the per-axis table sums to the per-stage one."""
    out: Dict[str, Dict] = {}
    for kind, axes, stage, cost, count in priced_collectives(cap, mesh,
                                                             dcn_axes):
        ent = out.setdefault(axes, {"ici_bytes": 0, "dcn_bytes": 0,
                                    "count": 0, "kinds": {}})
        ent[stage + "_bytes"] += cost
        ent["count"] += count
        ent["kinds"][kind] = ent["kinds"].get(kind, 0) + count
    return out


def collective_tally(cap) -> Dict[str, Dict[str, int]]:
    """Count and result bytes per kind (COMM001's measure)."""
    out = {k: {"count": 0, "bytes": 0} for k in KINDS}
    seen = set()
    for c in cap.collectives:
        ent = out.setdefault(c.kind, {"count": 0, "bytes": 0})
        if c.is_p2p:
            if c.op == "send":
                ent["bytes"] += c.nbytes
            if c.permute not in seen:
                seen.add(c.permute)
                ent["count"] += 1
            continue
        ent["count"] += 1
        ent["bytes"] += result_bytes(c)
    return out


def tally_by_axis(cap) -> Dict[str, Dict[str, Dict[str, int]]]:
    """{axes: {kind: {count, bytes}}} of one rank's capture, payload
    bytes (the card phase's print)."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for c in cap.collectives:
        ent = out.setdefault(c.axis or "?", {}).setdefault(
            c.kind, {"count": 0, "bytes": 0})
        ent["count"] += 1
        ent["bytes"] += c.nbytes
    return out


@register_pass
class CollectiveBudgetPass(AnalysisPass):
    name = "collective_budget"
    codes = ("COMM001", "COMM002", "COMM003", "COMM004")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        opts = ctx.options.get(self.name, {}) if ctx.options else {}
        budget = {k: v for k, v in opts.items() if k in KINDS}
        overlap_active = bool(opts.get("overlap_active"))
        extra = tuple(opts.get("overlap_region_functions", ()))
        wire = opts.get("wire") or {}
        cap = ctx.graph
        if not budget and not overlap_active and not wire \
                and not cap.collectives:
            raise SkipPass("no collective budget declared, no overlap "
                           "engine active, no wire budget, and no "
                           "collective to ring-check")
        findings: List[Finding] = []
        if budget:
            findings.extend(self._check_budget(cap, budget))
        if overlap_active:
            findings.extend(self._check_regions(cap, extra))
        findings.extend(self._check_ring_order(
            ctx, frozenset(opts.get("ring_functions", ()))))
        if wire:
            findings.extend(self._check_wire(ctx, wire))
        return findings

    # ---- COMM001 ----------------------------------------------------------

    def _check_budget(self, cap, budget) -> List[Finding]:
        got_all = collective_tally(cap)
        findings = []
        for kind, lim in sorted(budget.items()):
            got = got_all.get(kind, {"count": 0, "bytes": 0})
            for dim in ("count", "bytes"):
                if dim in lim and got[dim] > lim[dim]:
                    unit = "" if dim == "count" else " bytes"
                    findings.append(self.finding(
                        "COMM001",
                        f"{kind}: {got[dim]}{unit} per step exceeds the "
                        f"declared budget of {lim[dim]}{unit} (full tally: "
                        f"{got['count']} ops, {got['bytes']} bytes): the "
                        f"collective schedule regressed past this entry "
                        f"point's contract",
                        data={"kind": kind, "dim": dim, "measured": got,
                              "budget": dict(lim)}))
        return findings

    # ---- COMM002 ----------------------------------------------------------

    def _check_regions(self, cap, extra) -> List[Finding]:
        region = overlap_region_funcs(extra)
        findings = []
        for c in cap.collectives:
            if attribution(c, region) != "outside":
                continue
            where, data = node_where(c.node, TRANSPORT_FRAMES)
            findings.append(self.finding(
                "COMM002",
                f"{c.op} over {c.axis!r} issued outside an overlap-engine "
                f"region while an overlap engine is active: collectives "
                f"the engine did not schedule run serialized against its "
                f"prefetch and bucket plan (stack: "
                f"{sorted(data.get('stack_functions') or ()) or ['?']})",
                where=where, data=data))
        return findings

    # ---- COMM003 ----------------------------------------------------------

    def _check_ring_order(self, ctx, ring_funcs) -> List[Finding]:
        from .collective_order import permutes

        mesh = ctx.mesh
        if mesh is None:
            return []
        findings = []
        for rank, cap in sorted(ctx.all_ranks().items()):
            for _, ops in sorted(permutes(cap).items()):
                frames = ops[0].node.meta.get("pt_frames") or ()
                if not any(f[0].endswith(_PIPELINE) for f in frames) \
                        and not _frame_names(ops[0].node) & ring_funcs:
                    continue        # a one-shot permute, not a tick ring
                axis = ops[0].axis
                if not axis or "+" in axis:
                    continue
                size = int(mesh.shape[axis])
                perm = [(rank, c.peer) if c.op == "send" else (c.peer, rank)
                        for c in ops]
                pos = [tuple(_positions(mesh, p, axis)) for p in perm]
                steps = set(ring_steps(pos, size))
                if len(steps) <= 1:
                    continue
                where, data = node_where(ops[0].node, TRANSPORT_FRAMES)
                findings.append(self.finding(
                    "COMM003",
                    f"pipeline exchange on rank {rank} over {axis!r} mixes "
                    f"rotation steps {sorted(steps)} (pairs {pos}): stages "
                    f"pair sends with the wrong relative neighbour across "
                    f"ticks; a static ring must rotate uniformly",
                    where=where,
                    data={**data, "perm": pos, "steps": sorted(steps),
                          "rank": rank}))
        return findings

    # ---- COMM004 ----------------------------------------------------------

    def _check_wire(self, ctx, wire) -> List[Finding]:
        table = collect_wire_table(ctx.graph, ctx.mesh,
                                   wire.get("dcn_axes", {}))
        findings = []
        for stage in ("dcn", "ici"):
            lim: Optional[int] = wire.get(f"{stage}_bytes")
            got = table[stage]["bytes"]
            if lim is not None and got > int(lim):
                findings.append(self.finding(
                    "COMM004",
                    f"{stage.upper()} stage moves {got} post-codec bytes on "
                    f"the wire per step against a declared budget of "
                    f"{int(lim)} (per kind: {table[stage]['kinds']}): the "
                    f"codec is silently off on this entry, or the schedule "
                    f"grew past its wire contract",
                    data={"stage": stage, "measured": got,
                          "budget": int(lim), "table": table}))
        return findings
