"""Pipeline schedule tables: FThenB / 1F1B / interleaved VPP / zero-bubble.

The port's own copy of ``paddle_tpu/parallel/schedules.py`` (pure numpy; the
port imports nothing of the JAX package): a schedule is a STATIC TABLE of
per-(rank, tick) opcodes, generated by simulating the dependency graph in
Python, which ``paddle_tpu_torch.parallel.pipelining.pipeline_train_step``
executes tick by tick on every pipeline rank, with one ``ppermute`` per
direction per tick.  Every table equals the JAX module's array for array
(tests/test_torch_pipeline.py).  Analog of the reference's schedule
implementations: the eager 1F1B loop
(python/paddle/distributed/fleet/meta_parallel/pipeline_parallel.py:547,
interleaved :1143) and the static scheduler passes
(passes/pipeline_scheduler_pass/pipeline_1f1b.py:39, pipeline_vpp.py:40,
pipeline_zero_bubble.py:62).

Opcode kinds: NOOP, FWD, BWD (full dx+dw), BWDX (input-grad only) and
BWDW (weight-grad only) — the X/W split is the zero-bubble trick
(ZB-H1): dx is on the inter-stage critical path, dw is not, so dw fills
what would otherwise be bubble ticks.

Each table also carries its derived properties: bubble count (idle ticks
inside the active window) and max in-flight activations (the stash size
the executor must allocate — 1F1B's memory advantage over GPipe shows up
here as ``max_inflight == min(p, m)`` vs ``m``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

NOOP, FWD, BWD, BWDX, BWDW = 0, 1, 2, 3, 4

KIND_NAMES = {NOOP: "-", FWD: "F", BWD: "B", BWDX: "Bx", BWDW: "Bw"}


# comm channels: 0 = rightward ring hop (rank i -> i+1), 1 = leftward,
# 2 = same-rank hand-off (V-placement stage p-1 -> p), 3 = no send
CH_R, CH_L, CH_LOCAL, CH_NONE = 0, 1, 2, 3


@dataclasses.dataclass
class Schedule:
    """A compiled-pipeline schedule table.

    kind/mb/chunk/slot: int32 arrays [p, ticks].  ``slot`` is the
    activation-stash slot for the op's (mb, chunk): allocated when the
    activation ARRIVES from the producing neighbour (it may wait several
    ticks before its FWD consumes it), read by FWD/BWD/BWDX/BWDW, freed
    by the op that last needs it.  The incoming upstream grad reuses the
    same slot index in a parallel grad buffer (its lifetime nests inside
    the activation's).

    placement: "interleaved" (Megatron VPP: stage = chunk*p + rank, all
    activations flow right, all grads left) or "v" (ZBV zigzag: odd
    chunks run BACKWARD across ranks, so chunk-1 activations flow left
    and the stage p-1 -> p hop stays on-rank).

    recv_slot/recv_mask/recv_isact: [3, p, ticks] — per comm channel
    (CH_R/CH_L/CH_LOCAL), where the value delivered at this tick's start
    goes: slot index, 0/1 delivery mask, and 1 = activation (stash) vs
    0 = upstream grad (grad buffer).  asend_ch/gsend_ch: [p, ticks] —
    which channel the tick's op output (activation / dx) departs on
    (CH_NONE = kept).  These are what let three carry values per tick
    implement BOTH placements without an actor runtime.
    """

    name: str
    p: int                      # pipeline ranks
    m: int                      # micro-batches
    v: int                      # virtual chunks per rank (VPP)
    kind: np.ndarray
    mb: np.ndarray
    chunk: np.ndarray
    slot: np.ndarray
    recv_slot: np.ndarray       # [3, p, ticks]
    recv_mask: np.ndarray
    recv_isact: np.ndarray
    asend_ch: np.ndarray        # [p, ticks]
    gsend_ch: np.ndarray
    num_slots: int              # activation stash size (max in-flight)
    placement: str = "interleaved"

    @property
    def ticks(self) -> int:
        return self.kind.shape[1]

    def stage_of(self, rank: int, chunk: int) -> int:
        return _global_stage(rank, chunk, self.p, self.placement)

    def rank_of_stage(self, stage: int) -> int:
        return _rank_of_stage(stage, self.p, self.placement)

    def stages_of_rank(self, rank: int):
        return [self.stage_of(rank, c) for c in range(self.v)]

    @property
    def bubbles(self) -> int:
        """Idle ticks per rank inside its active window, summed."""
        total = 0
        for r in range(self.p):
            active = np.nonzero(self.kind[r] != NOOP)[0]
            span = active[-1] - active[0] + 1
            total += int(span - len(active))
        return total

    def render(self) -> str:
        """Human-readable timetable (rank rows, tick columns)."""
        rows = []
        for r in range(self.p):
            cells = []
            for t in range(self.ticks):
                k = self.kind[r, t]
                if k == NOOP:
                    cells.append("...")
                else:
                    c = f"{KIND_NAMES[k]}{self.mb[r, t]}"
                    if self.v > 1:
                        c += f".{self.chunk[r, t]}"
                    cells.append(c.rjust(3))
            rows.append(f"r{r}: " + " ".join(c.rjust(4) for c in cells))
        return "\n".join(rows)


# --------------------------------------------------------------------------
# dependency-driven simulation
# --------------------------------------------------------------------------

def _global_stage(rank: int, chunk: int, p: int,
                  placement: str = "interleaved") -> int:
    if placement == "v":
        # ZBV zigzag: even chunks run left-to-right, odd chunks right-to-
        # left, so rank p-1 owns stages p-1 AND p (the "V" turn) and the
        # first/last global stages share rank 0 — the property that lets
        # the W-split fill every bubble (reference
        # passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:343
        # VScheduleCreator's stage placement)
        if chunk % 2 == 0:
            return chunk * p + rank
        return (chunk + 1) * p - 1 - rank
    return chunk * p + rank      # Megatron VPP: {r, r+p, r+2p, ...}


def _rank_of_stage(stage: int, p: int, placement: str = "interleaved") -> int:
    c, r = stage // p, stage % p
    if placement == "v" and c % 2 == 1:
        return p - 1 - r
    return r


def _hop_channel(r_from: int, r_to: int, p: int) -> int:
    """Which comm channel moves a value rank r_from -> r_to: CH_R for the
    +1 ring hop (incl. the p-1 -> 0 VPP chunk wrap), CH_L for -1, CH_LOCAL
    for same-rank (the V placement's turn)."""
    if r_to == r_from:
        return CH_LOCAL
    if r_to == (r_from + 1) % p:
        return CH_R
    if r_to == (r_from - 1) % p:
        return CH_L
    raise AssertionError(f"non-neighbour hop {r_from}->{r_to} (p={p})")


def _simulate(name: str, p: int, m: int, v: int, policy_cls,
              placement: str = "interleaved") -> Schedule:
    """Tick-by-tick simulation: each rank's policy picks one ready op per
    tick; readiness follows the pipeline dataflow (an op is ready only if
    its producer finished at a STRICTLY earlier tick, modelling the
    one-tick neighbour hop)."""
    last_stage = p * v - 1
    done: Dict[Tuple[int, int, int], int] = {}   # (kind, mb, stage) -> tick
    policies = [policy_cls(r, p, m, v) for r in range(p)]
    table: List[List[Tuple[int, int, int]]] = [[] for _ in range(p)]

    def ready(kind, mb, rank, chunk, t):
        s = _global_stage(rank, chunk, p, placement)
        if kind == FWD:
            return s == 0 or done.get((FWD, mb, s - 1), t) < t
        if kind in (BWD, BWDX):
            if s == last_stage:
                return done.get((FWD, mb, s), t) < t
            # upstream grad comes from stage s+1's BWD or BWDX
            return (done.get((BWD, mb, s + 1), t) < t
                    or done.get((BWDX, mb, s + 1), t) < t)
        if kind == BWDW:
            return done.get((BWDX, mb, s), t) < t
        raise AssertionError(kind)

    total_ops = sum(pol.total_ops for pol in policies)
    t = 0
    while total_ops > 0:
        for r in range(p):
            pol = policies[r]
            op = pol.pick(lambda kind, mb, chunk: ready(kind, mb, r, chunk, t))
            if op is None:
                table[r].append((NOOP, -1, -1))
            else:
                kind, mb, chunk = op
                table[r].append(op)
                done[(kind, mb, _global_stage(r, chunk, p, placement))] = t
                total_ops -= 1
        t += 1
        assert t < 10 * (m * v * 3 + p), \
            f"{name}: schedule deadlocked/runaway at tick {t}"

    ticks = max(len(row) for row in table)
    for row in table:
        row.extend([(NOOP, -1, -1)] * (ticks - len(row)))
    return _assign_slots(name, p, m, v, table, done, placement)


class _FreeList:
    """Slot allocator where a slot freed at tick t is reusable only at
    ticks > t (the executor frees at the END of an op's tick, after any
    same-tick arrival has been stored)."""

    def __init__(self):
        self.free: List[Tuple[int, int]] = []   # (slot, freed_tick)
        self.next = 0

    def alloc(self, t: int) -> int:
        for i, (s, ft) in enumerate(self.free):
            if ft < t:
                self.free.pop(i)
                return s
        s = self.next
        self.next += 1
        return s

    def release(self, s: int, t: int) -> None:
        self.free.append((s, t))


def _assign_slots(name, p, m, v, table, done,
                  placement: str = "interleaved") -> Schedule:
    """Activation slots allocated at ARRIVAL tick (producer tick + 1 — the
    value may wait in the stash before its FWD runs), freed by the last op
    needing them.  Also derives the per-tick per-CHANNEL receive tables
    and the send-direction tables (channel = ring direction of the
    producer->consumer hop, placement-dependent).  Slot counts are
    uniform across ranks (max) so the executor's stash is SPMD-uniform."""
    ticks = len(table[0])
    kind = np.full((p, ticks), NOOP, np.int32)
    mb = np.full((p, ticks), -1, np.int32)
    chunk = np.full((p, ticks), 0, np.int32)
    slot = np.full((p, ticks), 0, np.int32)
    recv_slot = np.zeros((3, p, ticks), np.int32)
    recv_mask = np.zeros((3, p, ticks), np.int32)
    recv_isact = np.zeros((3, p, ticks), np.int32)
    asend_ch = np.full((p, ticks), CH_NONE, np.int32)
    gsend_ch = np.full((p, ticks), CH_NONE, np.int32)
    last_stage = p * v - 1
    max_slots = 1

    def _stage_rank(s):
        return _rank_of_stage(s, p, placement)

    for r in range(p):
        fl = _FreeList()
        live: Dict[Tuple[int, int], int] = {}

        # ops of this rank in tick order, with their (kind, mb, chunk)
        ops = [(t, k, b, c) for t, (k, b, c) in enumerate(table[r])
               if k != NOOP]
        # pass 1: allocate at activation-arrival (or FWD for stage 0);
        # also derive this rank's send directions
        events = []   # (tick, order, action)
        for t, k, b, c in ops:
            s_g = _global_stage(r, c, p, placement)
            if k == FWD:
                if s_g == 0:
                    events.append((t, 0, ("alloc", b, c, None, 0)))
                else:
                    ta = done[(FWD, b, s_g - 1)] + 1   # neighbour hop
                    ch = _hop_channel(_stage_rank(s_g - 1), r, p)
                    events.append((ta, 0, ("alloc", b, c, t, ch)))
                if s_g != last_stage:
                    asend_ch[r, t] = _hop_channel(r, _stage_rank(s_g + 1), p)
            if k in (BWD, BWDX):
                # upstream grad arrival (reuses the activation's slot)
                if s_g != last_stage:
                    prod = done.get((BWD, b, s_g + 1),
                                    done.get((BWDX, b, s_g + 1)))
                    ch = _hop_channel(_stage_rank(s_g + 1), r, p)
                    events.append((prod + 1, 1, ("grecv", b, c, ch)))
                if s_g != 0:
                    gsend_ch[r, t] = _hop_channel(r, _stage_rank(s_g - 1), p)
            free_kind = BWDW if any(kk == BWDW for _, kk, bb, cc in ops
                                    if bb == b and cc == c) else BWD
            if k == free_kind:
                events.append((t, 2, ("free", b, c)))
        events.sort(key=lambda e: (e[0], e[1]))
        slot_of: Dict[Tuple[int, int], int] = {}
        for t, _, act in events:
            if act[0] == "alloc":
                _, b, c, tf, ch = act
                s = fl.alloc(t)
                live[(b, c)] = s
                slot_of[(b, c)] = s
                if tf is not None:      # arrival-filled slot
                    assert recv_mask[ch, r, t] == 0, \
                        f"{name}: rank {r} tick {t} channel {ch} collision"
                    recv_slot[ch, r, t] = s
                    recv_mask[ch, r, t] = 1
                    recv_isact[ch, r, t] = 1
            elif act[0] == "grecv":
                _, b, c, ch = act
                assert recv_mask[ch, r, t] == 0, \
                    f"{name}: rank {r} tick {t} channel {ch} collision"
                recv_slot[ch, r, t] = live[(b, c)]
                recv_mask[ch, r, t] = 1
                recv_isact[ch, r, t] = 0
            else:
                _, b, c = act
                fl.release(live.pop((b, c)), t)
        for t, k, b, c in ops:
            kind[r, t] = k
            mb[r, t] = b
            chunk[r, t] = c
            slot[r, t] = slot_of[(b, c)]
        assert not live, f"{name}: rank {r} leaked stash slots {live}"
        max_slots = max(max_slots, fl.next)
    return Schedule(name, p, m, v, kind, mb, chunk, slot,
                    recv_slot, recv_mask, recv_isact, asend_ch, gsend_ch,
                    max_slots, placement)


# --------------------------------------------------------------------------
# policies
# --------------------------------------------------------------------------

class _PolicyBase:
    """Per-rank op picker.  ``pick(ready_fn)`` returns (kind, mb, chunk)
    or None (bubble)."""

    def __init__(self, rank, p, m, v):
        self.rank, self.p, self.m, self.v = rank, p, m, v
        self.f_pending = [(mb, c) for c in range(v) for mb in range(m)]
        self.b_pending = list(self.f_pending)
        self.w_pending: List[Tuple[int, int]] = []
        self.f_done = 0

    @property
    def total_ops(self):
        raise NotImplementedError

    def _try_f(self, ready):
        for i, (mb, c) in enumerate(self.f_pending):
            if ready(FWD, mb, c):
                self.f_pending.pop(i)
                self.f_done += 1
                return (FWD, mb, c)
            break  # strict program order within fwds
        return None

    def _try_b(self, ready, kind=BWD):
        for i, (mb, c) in enumerate(self.b_pending):
            if ready(kind, mb, c):
                self.b_pending.pop(i)
                if kind == BWDX:
                    self.w_pending.append((mb, c))
                return (kind, mb, c)
            break
        return None

    def _try_w(self, ready):
        for i, (mb, c) in enumerate(self.w_pending):
            if ready(BWDW, mb, c):
                self.w_pending.pop(i)
                return (BWDW, mb, c)
            break
        return None


class _FThenB(_PolicyBase):
    """All forwards, then all backwards (GPipe program order)."""

    @property
    def total_ops(self):
        return 2 * self.m * self.v

    def pick(self, ready):
        if self.f_pending:
            return self._try_f(ready)
        return self._try_b(ready)


class _OneFOneB(_PolicyBase):
    """Classic 1F1B: warmup of (p-1-rank) forwards, then strict F/B
    alternation, then cooldown backwards (reference pipeline_1f1b.py:39).
    Keeps at most min(p, m) activations in flight."""

    split_backward = False

    def __init__(self, rank, p, m, v):
        super().__init__(rank, p, m, v)
        assert v == 1, "1F1B is the v=1 schedule; use VPP for v>1"
        self.warmup = min(m, p - 1 - rank)
        self.want_f = True

    @property
    def total_ops(self):
        return 2 * self.m * self.v

    def pick(self, ready):
        bkind = BWDX if self.split_backward else BWD
        if self.f_done < self.warmup:
            op = self._try_f(ready)
            if op is None and self.split_backward:
                op = self._try_w(ready)
            return op
        # steady state: never run more than warmup+1 forwards ahead of the
        # backwards — this cap is what bounds 1F1B's in-flight activations
        # to min(p, m) (its memory advantage over FThenB)
        b_done = self.m * self.v - len(self.b_pending)
        f_ok = bool(self.f_pending) and \
            (self.f_done - b_done) <= self.warmup
        order = ([self._try_f, lambda r: self._try_b(r, bkind)]
                 if (self.want_f and f_ok)
                 else [lambda r: self._try_b(r, bkind)]
                 + ([self._try_f] if f_ok else []))
        for fn in order:
            op = fn(ready)
            if op is not None:
                if op[0] == FWD:
                    self.want_f = False
                elif op[0] in (BWD, BWDX):
                    self.want_f = True
                return op
        if self.split_backward:
            return self._try_w(ready)
        return None


class _ZBH1(_OneFOneB):
    """Zero-bubble H1: 1F1B with the backward split into BWDX (critical
    path) and BWDW (fills bubbles) — reference pipeline_zero_bubble.py:62.
    """

    split_backward = True

    @property
    def total_ops(self):
        return 3 * self.m * self.v


class _Interleaved(_PolicyBase):
    """Megatron interleaved VPP (reference pipeline_parallel.py:1143,
    pipeline_vpp.py:40): micro-batches advance in groups of p; each rank
    runs chunk 0 of a group, then chunk 1, ... — warmup covers
    (v-1)*p + (p-1-rank) forwards so all chunks enter flight."""

    def __init__(self, rank, p, m, v):
        super().__init__(rank, p, m, v)
        key = lambda mc: (mc[0] // p, mc[1], mc[0] % p)   # (group, chunk, pos)
        self.f_pending.sort(key=key)
        self.b_pending.sort(key=lambda mc: (mc[0] // p, -mc[1], mc[0] % p))
        self.warmup = min(m * v, (v - 1) * p + (p - 1 - rank))
        self.want_f = True

    @property
    def total_ops(self):
        return 2 * self.m * self.v

    def pick(self, ready):
        if self.f_done < self.warmup:
            return self._try_f(ready)
        order = ([self._try_f, self._try_b] if (self.want_f and self.f_pending)
                 else [self._try_b, self._try_f])
        for fn in order:
            op = fn(ready)
            if op is not None:
                if op[0] == FWD:
                    self.want_f = False
                elif op[0] == BWD:
                    self.want_f = True
                return op
        return None


class _ZBV(_PolicyBase):
    """Zero-bubble V schedule (reference VScheduleCreator,
    passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:343): v=2
    chunks in the zigzag placement, backward split into BWDX/BWDW.  The
    policy is dependency-greedy: dx first (critical path, later chunk
    first so grads flow down the V), then forwards under the 1F1B-like
    in-flight cap, then dw fills what would otherwise be bubbles —
    with t_f = t_x = t_w this converges to the paper's zero steady-state
    bubble (asserted against ZBH1 in tests)."""

    def __init__(self, rank, p, m, v):
        super().__init__(rank, p, m, v)
        assert v == 2, "ZBV is defined for v=2 chunks per rank"
        # per-chunk arrival order: chunk 0 mb i arrives before chunk 1
        # mb i; scan order (mb, chunk) with chunk 1's dx preferred
        self.f_pending.sort(key=lambda mc: (mc[0], mc[1]))
        self.b_pending.sort(key=lambda mc: (mc[0], -mc[1]))
        # slot-debt cap: at most 2p live half-size chunk activations
        # (== 1F1B's p full-layer ones — the ZBV memory claim).  A slot
        # lives from FWD until its BWDW frees it, so the debt is
        # f_done - w_done; capping INFLIGHT (f - bx) instead either
        # deadlocks the V's bottom rank (< 2p) or lets deferred Ws pile
        # up unboundedly (measured: slots ~2m).  Swept 2p/2.25p/2.5p/3p:
        # 2p already reaches the best bubble fraction at every config.
        self.cap = 2 * p

    @property
    def total_ops(self):
        return 3 * self.m * self.v

    def _scan(self, pending, kinds, ready, pop_to_w=False):
        for i, (mb, c) in enumerate(pending):
            if ready(kinds, mb, c):
                pending.pop(i)
                if pop_to_w:
                    self.w_pending.append((mb, c))
                return (kinds, mb, c)
        return None

    def _try_fwd(self, ready):
        op = self._scan(self.f_pending, FWD, ready)
        if op is not None:
            self.f_done += 1
        return op

    def pick(self, ready):
        op = self._scan(self.b_pending, BWDX, ready, pop_to_w=True)
        if op is not None:
            return op
        w_done = (self.m * self.v - len(self.b_pending)) - len(self.w_pending)
        debt = self.f_done - w_done
        if self.f_pending and debt < self.cap:
            op = self._try_fwd(ready)
            if op is not None:
                return op
        if self.w_pending:
            mb, c = self.w_pending.pop(0)
            return (BWDW, mb, c)
        # nothing else to do: a forward beats a bubble (debt cap only
        # defers forwards while dw work exists to fill the tick)
        if self.f_pending:
            return self._try_fwd(ready)
        return None


_POLICIES = {
    "FThenB": (_FThenB, 1, "interleaved"),
    "1F1B": (_OneFOneB, 1, "interleaved"),
    "ZBH1": (_ZBH1, 1, "interleaved"),
    "VPP": (_Interleaved, None, "interleaved"),   # v chosen by caller (>1)
    "ZBV": (_ZBV, 2, "v"),
}


def build_schedule(name: str, p: int, m: int, v: int = 1) -> Schedule:
    """Build a schedule table for ``p`` ranks, ``m`` micro-batches and
    ``v`` virtual chunks per rank.  name in {FThenB, 1F1B, VPP, ZBH1,
    ZBV} (ZBV implies v=2 and the zigzag placement)."""
    if name not in _POLICIES:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"choose from {sorted(_POLICIES)}")
    cls, fixed_v, placement = _POLICIES[name]
    if name == "ZBV" and v == 1:
        v = 2                      # ZBV's chunking is intrinsic
    if fixed_v is not None and v != fixed_v:
        raise ValueError(f"{name} schedule requires v={fixed_v}, got {v}")
    if name == "VPP" and v < 2:
        raise ValueError("VPP needs v >= 2 virtual chunks")
    sched = _simulate(name, p, m, v, cls, placement)
    _validate(sched)
    return sched


def _validate(s: Schedule) -> None:
    """Every op must appear exactly once and respect dataflow order."""
    seen = {}
    for r in range(s.p):
        for t in range(s.ticks):
            k = int(s.kind[r, t])
            if k == NOOP:
                continue
            key = (k, int(s.mb[r, t]),
                   _global_stage(r, int(s.chunk[r, t]), s.p, s.placement))
            assert key not in seen, f"{s.name}: duplicate op {key}"
            seen[key] = t
    expect_b = BWDX if (s.kind == BWDX).any() else BWD
    for c in range(s.v):
        for mb in range(s.m):
            for r in range(s.p):
                st = _global_stage(r, c, s.p, s.placement)
                assert (FWD, mb, st) in seen, f"{s.name}: missing F{mb} st{st}"
                assert (expect_b, mb, st) in seen, \
                    f"{s.name}: missing B{mb} st{st}"


# --------------------------------------------------------------------------
# cost model: per-tick costs x table simulation -> makespan / bubble frac
# (reference analog: the zero-bubble scheduler's cost reasoning,
#  passes/pipeline_scheduler_pass/pipeline_zero_bubble.py:62)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ScheduleCost:
    """Event-driven makespan of a schedule table under per-op costs.

    ``bubble_frac`` is idle time inside the span: 1 - work / (p * span).
    """
    name: str
    makespan: float
    work_per_rank: float
    bubble_frac: float


def simulate_cost(sched: "Schedule", t_f: float = 1.0,
                  t_b: Optional[float] = None,
                  t_w: Optional[float] = None,
                  t_p2p: float = 0.0) -> ScheduleCost:
    """Replay the schedule's per-rank op ORDER with real durations.

    t_f: forward tick; t_b: full backward (default 2*t_f — dx+dw);
    t_w: weight-grad part for the X/W split (default t_b/2; the dx part
    is then t_b - t_w); t_p2p: inter-stage hop latency.

    Each op starts at max(rank free, producer finish + p2p hop); the
    result is the wall-clock the table would take on hardware with those
    per-op times — the quantity the unit-tick ``bubbles()`` count only
    approximates.
    """
    if t_b is None:
        t_b = 2.0 * t_f
    if t_w is None:
        t_w = t_b / 2.0
    t_x = t_b - t_w
    cost_of = {FWD: t_f, BWD: t_b, BWDX: t_x, BWDW: t_w}
    p, v = sched.p, sched.v
    done: Dict[Tuple[int, int, int], float] = {}
    rank_time = [0.0] * p
    work = [0.0] * p
    for t in range(sched.ticks):
        for r in range(p):
            k = int(sched.kind[r, t])
            if k == NOOP:
                continue
            mb = int(sched.mb[r, t])
            s = _global_stage(r, int(sched.chunk[r, t]), p, sched.placement)
            dep = 0.0
            if k == FWD and s > 0:
                dep = done.get((FWD, mb, s - 1), 0.0) + t_p2p
            elif k in (BWD, BWDX):
                if s < p * v - 1:
                    up = done.get((BWD, mb, s + 1),
                                  done.get((BWDX, mb, s + 1), 0.0))
                    dep = up + t_p2p
                else:
                    dep = done.get((FWD, mb, s), 0.0)
            elif k == BWDW:
                dep = done.get((BWDX, mb, s), 0.0)
            start = max(rank_time[r], dep)
            finish = start + cost_of[k]
            rank_time[r] = finish
            work[r] += cost_of[k]
            done[(BWD if k == BWDX else k, mb, s)] = finish
            if k == BWDX:
                done[(BWDX, mb, s)] = finish
    span = max(rank_time)
    total_work = sum(work)
    return ScheduleCost(sched.name, span, total_work / p,
                        1.0 - total_work / (p * span) if span else 0.0)


def rank_schedules(p: int, m: int, t_f: float = 1.0,
                   t_b: Optional[float] = None,
                   t_w: Optional[float] = None, t_p2p: float = 0.0,
                   v: int = 2,
                   names: Tuple[str, ...] = ("FThenB", "1F1B", "VPP",
                                             "ZBH1", "ZBV")) -> List[ScheduleCost]:
    """Rank the schedule library by modelled makespan for a given
    (p, m, stage-time, p2p-time) — consumed by the auto_tuner's
    schedule dimension.  VPP/ZBV use ``v``/2 chunks (skipped when layers
    can't split, i.e. v < 2)."""
    out = []
    for name in names:
        use_v = v if name == "VPP" else (2 if name == "ZBV" else 1)
        if name == "VPP" and v < 2:
            # ZBV is NOT gated on the caller's v: its two-chunk zigzag is
            # intrinsic (layer-divisibility is checked by the tuner prune)
            continue
        sched = build_schedule(name, p=p, m=m, v=use_v)
        # a VPP chunk holds L/(p*v) layers vs L/p for v=1 schedules:
        # per-op times scale by 1/v so total modelled work is constant
        sc = 1.0 / use_v
        out.append(simulate_cost(
            sched, t_f=t_f * sc, t_b=None if t_b is None else t_b * sc,
            t_w=None if t_w is None else t_w * sc, t_p2p=t_p2p))
    out.sort(key=lambda c: c.makespan)
    return out
