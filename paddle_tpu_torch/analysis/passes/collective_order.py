"""COLL - the collective-order checker across the ranks of a group.

Port of ``paddle_tpu/analysis/passes/collective_order.py``.  SPMD programs
hang (or pair the wrong buffers) when the ranks of a group disagree on
the next collective.  JAX finds it as a ``lax.cond`` inside a
``shard_map`` body whose branches issue different collective sequences
over a mesh axis; in eager PyTorch the branch is Python's, and the
mismatch shows only when the captures of every rank of the group are set
side by side (``core.capture_ranks``): a collective a rank drops by a
Python branch is one its peers still issue.

Codes:
- COLL001: the ranks of one group issue different sequences of group
  collectives over it (kind, op, payload shape and dtype, in program
  order), or a send of one rank has no matching recv (same bytes and
  dtype, in order) on its peer.  Needs the captures of at least two ranks
  of the group; a single capture has nothing to compare.
- COLL002: a permute whose (source, destination) pairs, assembled from
  every captured rank's sends and recvs of one ``batch_isend_irecv``,
  repeat a source or a destination: one rank sending twice, or two
  transfers racing into one rank (the ``ppermute`` contract's malformed
  perm).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core import AnalysisContext, AnalysisPass, node_where, register_pass
from ..findings import Finding
from .collective_budget import TRANSPORT_FRAMES


def _sequences(caps) -> Dict[Tuple[int, ...], Dict[int, list]]:
    """group -> rank -> that rank's sequence of group collectives on it."""
    out: Dict[Tuple[int, ...], Dict[int, list]] = {}
    for rank, cap in caps.items():
        for c in cap.collectives:
            if c.is_p2p or not c.group:
                continue
            out.setdefault(c.group, {}).setdefault(rank, []).append(c)
    return out


def _sig(c) -> tuple:
    return (c.kind, c.op, c.shape, c.dtype)


def permutes(cap) -> Dict[int, list]:
    """permute index -> the sends and recvs of one ``batch_isend_irecv``."""
    out: Dict[int, list] = {}
    for c in cap.collectives:
        if c.is_p2p:
            out.setdefault(c.permute, []).append(c)
    return out


@register_pass
class CollectiveOrderPass(AnalysisPass):
    name = "collective_order"
    codes = ("COLL001", "COLL002")

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        caps = ctx.all_ranks()
        return self._group_order(caps) + self._p2p_pairing(caps) \
            + self._perm_shape(caps)

    # ---- COLL001 ----------------------------------------------------------

    def _group_order(self, caps) -> List[Finding]:
        findings = []
        for group, per_rank in sorted(_sequences(caps).items()):
            members = {r: per_rank.get(r, []) for r in group if r in caps}
            if len(members) < 2:
                continue
            sigs = {r: [_sig(c) for c in seq] for r, seq in members.items()}
            if len({tuple(s) for s in sigs.values()}) == 1:
                continue
            # the first position where the ranks part, and a rank there
            n = min(len(s) for s in sigs.values())
            pos = next((i for i in range(n)
                        if len({s[i] for s in sigs.values()}) > 1), n)
            rank = max(members, key=lambda r: len(members[r]))
            seq = members[rank]
            node = seq[min(pos, len(seq) - 1)].node if seq else None
            where, data = (node_where(node, TRANSPORT_FRAMES)
                           if node is not None else (None, {}))
            axis = next((c.axis for s in members.values() for c in s
                         if c.axis), None)
            findings.append(self.finding(
                "COLL001",
                f"the ranks {sorted(members)} of group {list(group)} "
                f"(mesh axis {axis!r}) issue different collective "
                f"sequences over it, first apart at position {pos}: "
                + "; ".join(f"rank {r}: {len(s)} collectives"
                            for r, s in sorted(sigs.items()))
                + " - a rank that skips or adds a collective pairs its "
                  "peers' with nothing (hang) or with the wrong buffer",
                where=where,
                data={**data, "axis": axis, "group": list(group),
                      "position": pos,
                      "sequences": {r: [list(map(str, x)) for x in s]
                                    for r, s in sorted(sigs.items())}}))
        return findings

    def _p2p_pairing(self, caps) -> List[Finding]:
        sends: Dict[Tuple[int, int], list] = {}
        recvs: Dict[Tuple[int, int], list] = {}
        for rank, cap in caps.items():
            for c in cap.collectives:
                if not c.is_p2p or c.peer is None:
                    continue
                if c.op == "send":
                    sends.setdefault((rank, c.peer), []).append(c)
                else:
                    recvs.setdefault((c.peer, rank), []).append(c)
        findings = []
        for src, dst in sorted(set(sends) | set(recvs)):
            if src not in caps or dst not in caps:
                continue
            a = [(c.nbytes, c.dtype) for c in sends.get((src, dst), [])]
            b = [(c.nbytes, c.dtype) for c in recvs.get((src, dst), [])]
            if a == b:
                continue
            c = (sends.get((src, dst)) or recvs.get((src, dst)))[0]
            where, data = node_where(c.node, TRANSPORT_FRAMES)
            findings.append(self.finding(
                "COLL001",
                f"rank {src} sends {len(a)} buffer(s) to rank {dst} "
                f"(axis {c.axis!r}) and rank {dst} receives {len(b)} from "
                f"it ({a} vs {b}): an exchange one side drops hangs the "
                f"other",
                where=where,
                data={**data, "axis": c.axis, "src": src, "dst": dst,
                      "sends": a, "recvs": b}))
        return findings

    # ---- COLL002 ----------------------------------------------------------

    def _perm_shape(self, caps) -> List[Finding]:
        findings, seen = [], set()
        for rank, cap in sorted(caps.items()):
            for idx, ops in sorted(permutes(cap).items()):
                # a self-send shows as both a send and a recv of one pair
                pairs = sorted({(rank, c.peer) if c.op == "send"
                                else (c.peer, rank) for c in ops})
                srcs = [s for s, _ in pairs if s == rank]
                dsts = [d for _, d in pairs if d == rank]
                if len(srcs) <= 1 and len(dsts) <= 1:
                    continue
                key = (ops[0].axis, tuple(pairs))
                if key in seen:
                    continue
                seen.add(key)
                what = "source" if len(srcs) > 1 else "destination"
                where, data = node_where(ops[0].node, TRANSPORT_FRAMES)
                findings.append(self.finding(
                    "COLL002",
                    f"permute over axis {ops[0].axis!r} with pairs "
                    f"{pairs} repeats rank {rank} as a {what}: not "
                    f"a partial permutation (two transfers race into one "
                    f"buffer, or one rank sends twice)",
                    where=where,
                    data={**data, "perm": pairs, "rank": rank,
                          "axis": ops[0].axis}))
        return findings
