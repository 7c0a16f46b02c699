"""Training health guardian: the fused probe, the in-step guard and the
response ladder.

Port of ``paddle_tpu/distributed/health.py``.  Machine faults are the
resilient loop's (``resilience.py``); this module survives numeric ones
(a NaN batch, a loss spike, a silent bit flip) in three layers:

1. **The probe** (``make_probe``): per-leaf reductions folded into a few
   scalars and a small bucket vector: the global gradient norm, the
   non-finite count per bucket of leaves, the loss, and the update/param
   norm ratio.  No leaf is copied, concatenated or materialised in another
   dtype for the gradient terms: each is one fp32 reduction
   (``torch.linalg.vector_norm(g, dtype=torch.float32)``, the reduction's
   own accumulator, not ``g.float()``); a leaf's non-finite elements are
   counted only when its norm is non-finite.  The update ratio needs
   ``new - old`` leaf by leaf: a transient of one fp32 leaf.  On a mesh
   the terms of a ``ShardedTensor`` reduce over its block axes (a partial
   gradient is completed first).  The scalars reach the host in one
   transfer; ``ok`` combines them with the ``gates`` cutoffs ([loss,
   grad_norm, update_ratio], +inf = open) on the host, in fp32 as JAX
   compares them on the device.
2. **The guard**: a fired probe hands back the OLD params and optimizer
   state, bit-identical.  Llama's train step updates in place in two
   passes (``parallel.memory.apply_flat_in_place`` / ``apply_in_place``):
   the first computes the update's norm and writes nothing, the probe
   reads it, and only a passing gate runs the second pass, which writes;
   no copy of the state is made.  Steps that return new tensors (the
   hybrid and GPT-MoE steps) pick references by the host ``ok``
   (``guard_tree``).  The host-resident state's update streams through
   the card in the same two passes (``apply_flat_offloaded``: the first
   copies each bucket in and nothing back).
3. **The ladder** (``HealthMonitor``): skip and quarantine the batch ->
   an lr-backoff window -> rollback to the last checkpoint (the resilient
   loop's recovery, quarantined offsets force-skipped on replay) ->
   ``HealthExhausted``; and ``ParamSpotChecker``, a rotating crc32 of a
   slice of the params compared with a peer replica's.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.specs import ShardedTensor
from .resilience import FaultError

# probe gate vector layout: [loss_cutoff, grad_norm_cutoff,
# update_ratio_cutoff], fp32; +inf disables a gate (warmup)
GATE_FIELDS = ("loss", "grad_norm", "update_ratio")
NUM_GATES = len(GATE_FIELDS)


class NumericFault(FaultError):
    """A numeric fault the ladder escalated to rollback: the in-memory
    state is suspect, so recovery reuses the last complete checkpoint."""

    state_intact = False


class SDCError(NumericFault):
    """Silent data corruption: a cross-replica param crc mismatch."""


class HealthExhausted(RuntimeError):
    """The rollback budget is spent and the anomaly persists."""


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector and ladder knobs (as JAX's).

    Detection: an EMA/z-score spike detector on loss and grad norm
    (``ema_alpha``); the gates stay +inf for the first ``warmup_steps``
    clean steps, then sit at ``mean + z * std`` (std floored at
    ``gate_rel_floor * |mean| + gate_abs_floor``).  ``update_ratio_max``
    caps ||update|| / ||params||.  Fired steps never fold into the EMA.

    Ladder: a fired step skips; a second fire within
    ``escalation_window`` steps of the last one escalates to the lr
    backoff (``lr_backoff`` x lr for ``lr_backoff_steps`` steps, gates
    relaxed ``backoff_gate_relax`` x); a third to rollback.
    ``max_rollbacks`` bounds the restore-diverge loop;
    ``hysteresis_steps`` clean steps return to level 0.

    SDC: ``spot_check_every`` > 0 crc32s one of ``spot_check_slices``
    rotating leaf groups every K steps against a peer's crc."""

    nonfinite_buckets: int = 8
    ema_alpha: float = 0.2
    warmup_steps: int = 6
    loss_zscore: float = 6.0
    grad_zscore: float = 6.0
    gate_rel_floor: float = 0.25
    gate_abs_floor: float = 1e-3
    update_ratio_max: float = math.inf
    escalation_window: int = 3
    hysteresis_steps: int = 8
    lr_backoff: float = 0.1
    lr_backoff_steps: int = 4
    backoff_gate_relax: float = 4.0
    max_rollbacks: int = 2
    spot_check_every: int = 0
    spot_check_slices: int = 8


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------


def default_gates() -> np.ndarray:
    """The all-open gate vector (warmup / no monitor)."""
    return np.full((NUM_GATES,), np.inf, np.float32)


def _leaves(tree) -> List[Any]:
    from ..parallel.reshard import path_leaves

    return [v for _, v in path_leaves(tree)[0]]


def _is_float(x) -> bool:
    return isinstance(x, (torch.Tensor, ShardedTensor)) \
        and x.is_floating_point()


def _block_sum(value: torch.Tensor, x) -> torch.Tensor:
    """A per-block fp32 sum reduced over ``x``'s block axes (the ranks of a
    line hold distinct blocks; the other ranks hold copies)."""
    if isinstance(x, ShardedTensor):
        from ..parallel import compat

        for a in sorted(x.axes_at_rest(), key=x.mesh.axis_names.index):
            value = compat.all_reduce_raw(value, a, x.mesh)
    return value


def _sq_norm(x) -> torch.Tensor:
    """The global sum of squares of a leaf, in fp32, by one reduction."""
    if isinstance(x, ShardedTensor):
        if x.partial:
            x = x.complete()
        n = torch.linalg.vector_norm(x.local, dtype=torch.float32)
        return _block_sum(n * n, x)
    n = torch.linalg.vector_norm(x, dtype=torch.float32)
    return n * n


def _sq_diff(new, old) -> torch.Tensor:
    """The global sum of squares of ``new - old`` in fp32 (a transient of
    one fp32 leaf)."""
    n = new.local if isinstance(new, ShardedTensor) else new
    o = old.local if isinstance(old, ShardedTensor) else old
    d = n.to(torch.float32, copy=True)
    d.sub_(o)
    s = torch.linalg.vector_norm(d, dtype=torch.float32)
    del d
    return _block_sum(s * s, old)


def _count_nonfinite(x) -> int:
    """The exact non-finite count of a leaf whose norm was non-finite (the
    rare path: a transient bool leaf)."""
    if isinstance(x, ShardedTensor):
        if x.partial:
            x = x.complete()
        c = (~torch.isfinite(x.local)).sum().to(torch.float32)
        return int(_block_sum(c, x).item())
    return int((~torch.isfinite(x)).sum().item())


def _host_read(t: torch.Tensor) -> np.ndarray:
    """The probe's one device-to-host transfer.  A capture's fake tensor
    holds no values: the copy is still made (the graph records it) and the
    read gives zeros, so the guard takes the passing branch, the one whose
    memory the Graph Doctor prices (a fired gate drops the new tree)."""
    from torch._subclasses.fake_tensor import is_fake

    host = t.cpu()
    if is_fake(host):
        return np.zeros(tuple(host.shape), np.float32)
    return host.numpy()


def make_probe(loss, grads, params, new_params, gates=None, *,
               buckets: int = 8, update_sq=None) -> Dict[str, Any]:
    """The fused health probe (module docstring): ``{"loss",
    "grad_norm", "nonfinite"[buckets], "update_ratio", "ok"}`` as host
    values.  ``ok`` is False when any leaf holds a non-finite value, or
    the loss or the grad norm is non-finite or above its gate, or the
    update ratio is above its gate (a NaN passes no gate).  The update's
    squared norm is ``update_sq`` when given (a 0-d fp32 tensor: an
    in-place step's first pass computes it before writing anything),
    else summed leaf by leaf from ``new_params`` against ``params``."""
    gleaves = [g for g in _leaves(grads) if _is_float(g)]
    ref = gleaves[0] if gleaves else None
    dev = (ref.local if isinstance(ref, ShardedTensor) else ref).device \
        if ref is not None else torch.device("cpu")
    sq = [_sq_norm(g) for g in gleaves]
    terms = [torch.as_tensor(loss, dtype=torch.float32,
                             device=dev).reshape(())]
    upd = pn = None
    if params is not None and update_sq is not None:
        upd = [update_sq.to(dev).reshape(())]
        pn = [_sq_norm(o) for o in _leaves(params) if _is_float(o)]
    elif params is not None and new_params is not None:
        olds, news = _leaves(params), _leaves(new_params)
        pairs = [(o, n) for o, n in zip(olds, news) if _is_float(o)]
        upd = [_sq_diff(n, o) for o, n in pairs]
        pn = [_sq_norm(o) for o, _ in pairs]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gsq = torch.stack(sq).sum() if sq else zero
    ratio = zero
    if upd:
        ratio = torch.sqrt(torch.stack(upd).sum()) / (
            torch.sqrt(torch.stack(pn).sum()) + 1e-12)
    terms += [torch.sqrt(gsq), ratio]
    # the one transfer: the scalars and each leaf's squared norm
    host = _host_read(torch.stack(terms + [s.to(dev) for s in sq]))
    loss32, gnorm, ratio32 = (np.float32(v) for v in host[:3])
    counts = np.zeros(int(buckets), np.int64)
    for i, s in enumerate(host[3:]):
        if not np.isfinite(s):
            counts[i % int(buckets)] += _count_nonfinite(gleaves[i])
    g = default_gates() if gates is None \
        else np.asarray(gates, np.float32).reshape(NUM_GATES)
    ok = bool(counts.sum() == 0
              and np.isfinite(loss32) and loss32 <= g[0]
              and np.isfinite(gnorm) and gnorm <= g[1]
              and ratio32 <= g[2])
    return {"loss": float(loss32), "grad_norm": float(gnorm),
            "nonfinite": counts, "update_ratio": float(ratio32), "ok": ok}


def guard_tree(ok, new_tree, old_tree):
    """The in-step no-op guard: ``new_tree`` where the probe passed, the
    untouched ``old_tree`` where it fired, by reference (``ok`` a host
    bool, or a tensor read once)."""
    return new_tree if bool(ok) else old_tree


def normalize_gates(health_gates) -> np.ndarray:
    """Always an fp32[3] array, all-open when no monitor supplies
    cutoffs."""
    return np.asarray(default_gates() if health_gates is None
                      else health_gates, np.float32).reshape(NUM_GATES)


def probe_and_guard(loss, grads, params, opt_state, new_params,
                    new_opt_state, health_gates, cfg: HealthConfig):
    """The fused probe and the guard of a step whose update returns new
    tensors: ``(loss, guarded_params, guarded_opt_state, probe)``; a fired
    gate passes the old params and optimizer state through
    bit-identically."""
    probe = make_probe(loss, grads, params, new_params,
                       normalize_gates(health_gates),
                       buckets=cfg.nonfinite_buckets)
    return (loss, guard_tree(probe["ok"], new_params, params),
            guard_tree(probe["ok"], new_opt_state, opt_state), probe)


def summarize_probe(probe) -> Dict[str, Any]:
    """A probe as host floats."""
    nf = np.asarray(probe["nonfinite"])
    return {"loss": float(probe["loss"]),
            "grad_norm": float(probe["grad_norm"]),
            "update_ratio": float(probe["update_ratio"]),
            "nonfinite": nf.tolist(),
            "nonfinite_total": int(nf.sum()),
            "ok": bool(probe["ok"])}


# ---------------------------------------------------------------------------
# the host monitor: EMA/z-score detection and the response ladder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuarantineRecord:
    """One quarantined batch: what a standalone replay needs."""

    step: int
    data_offset: int
    rule: str                   # nonfinite | loss_spike | grad_spike |
    #                             update_ratio | forced_replay_skip
    response: str               # skip | backoff | rollback
    probe: Dict[str, Any] = dataclasses.field(default_factory=dict)
    gates: List[float] = dataclasses.field(default_factory=list)


class HealthMonitor:
    """Takes one probe a step, keeps the EMA spike detector and walks the
    response ladder (``HealthConfig``).  Deterministic and replay-aware:
    offsets quarantined before a rollback are force-skipped when the
    restored loop replays them."""

    def __init__(self, cfg: HealthConfig):
        self.cfg = cfg
        self._ema: Dict[str, Tuple[float, float]] = {}
        self._clean = 0
        self._streak = 0
        self.level = 0
        self.last_fire_step: Optional[int] = None
        self.backoff_until = -1
        self.rollbacks = 0
        self.quarantined: Dict[int, QuarantineRecord] = {}
        self.events: List[Dict[str, Any]] = []
        self.stage_counts = {"skip": 0, "backoff": 0, "rollback": 0,
                             "forced_skip": 0}
        self.detection_latency_steps: List[int] = []

    def _cutoff(self, key: str, z: float) -> float:
        mv = self._ema.get(key)
        if mv is None or self._clean < self.cfg.warmup_steps:
            return math.inf
        m, v = mv
        std = max(math.sqrt(max(v, 0.0)),
                  self.cfg.gate_rel_floor * abs(m)
                  + self.cfg.gate_abs_floor)
        return m + z * std

    def gates(self, step: Optional[int] = None) -> np.ndarray:
        """The [loss, grad_norm, update_ratio] cutoffs the step runs under
        now (relaxed inside an lr-backoff window)."""
        relax = (self.cfg.backoff_gate_relax
                 if step is not None and step < self.backoff_until
                 else 1.0)
        ratio_cut = min(self._cutoff("update_ratio", self.cfg.grad_zscore),
                        self.cfg.update_ratio_max)
        return np.asarray(
            [self._cutoff("loss", self.cfg.loss_zscore) * relax,
             self._cutoff("grad_norm", self.cfg.grad_zscore) * relax,
             ratio_cut * relax], np.float32)

    def lr_scale(self, step: int) -> float:
        return self.cfg.lr_backoff if step < self.backoff_until else 1.0

    def is_quarantined(self, offset: int) -> bool:
        return offset in self.quarantined

    def note_forced_skip(self, offset: int) -> None:
        self.stage_counts["forced_skip"] += 1
        self.events.append({"step": offset, "kind": "forced_skip"})

    def _ema_update(self, key: str, x: float) -> None:
        mv = self._ema.get(key)
        if mv is None:
            self._ema[key] = (x, 0.0)
            return
        m, v = mv
        a = self.cfg.ema_alpha
        d = x - m
        self._ema[key] = (m + a * d, (1.0 - a) * (v + a * d * d))

    def _rule(self, p: Dict[str, Any], gates: np.ndarray) -> str:
        if p["nonfinite_total"] > 0 or not math.isfinite(p["loss"]) \
                or not math.isfinite(p["grad_norm"]):
            return "nonfinite"
        if p["loss"] > gates[0]:
            return "loss_spike"
        if p["grad_norm"] > gates[1]:
            return "grad_spike"
        return "update_ratio"

    def observe(self, step: int, probe, *,
                data_offset: Optional[int] = None) -> str:
        """Fold one step's probe in: ``"ok"`` | ``"skip"`` | ``"backoff"``
        | ``"rollback"``; ``HealthExhausted`` past the rollback budget.
        The step ran under this monitor's gates, so a non-ok verdict means
        its update was already a no-op."""
        p = probe if isinstance(probe, dict) and "nonfinite_total" in probe \
            else summarize_probe(probe)
        gates = self.gates(step)
        if p["ok"]:
            self._ema_update("loss", p["loss"])
            self._ema_update("grad_norm", p["grad_norm"])
            self._ema_update("update_ratio", p["update_ratio"])
            self._clean += 1
            self._streak += 1
            if self._streak >= self.cfg.hysteresis_steps:
                self.level = 0
            return "ok"

        rule = self._rule(p, gates)
        # escalate only when fires cluster: an isolated bad batch stays at
        # the cheapest response
        if (self.last_fire_step is not None
                and step - self.last_fire_step
                <= self.cfg.escalation_window):
            self.level = min(self.level + 1, 2)
        else:
            self.level = 0
        self.detection_latency_steps.append(
            0 if self.last_fire_step is None
            else max(0, step - self.last_fire_step - 1))
        self.last_fire_step = step
        self._streak = 0

        response = ("skip", "backoff", "rollback")[self.level]
        rec = QuarantineRecord(
            step=step,
            data_offset=step if data_offset is None else data_offset,
            rule=rule, response=response, probe=dict(p),
            gates=[float(g) for g in gates])
        self.quarantined[rec.data_offset] = rec
        self.events.append({"step": step, "kind": response, "rule": rule,
                            "probe": dict(p)})
        self.stage_counts[response] += 1
        if response == "backoff":
            self.backoff_until = step + 1 + self.cfg.lr_backoff_steps
        elif response == "rollback":
            # the restore replaces the state this window was nursing: a
            # live window would rescale the replayed steps' lr
            self.backoff_until = -1
            self.rollbacks += 1
            if self.rollbacks > self.cfg.max_rollbacks:
                raise HealthExhausted(
                    f"rollback budget {self.cfg.max_rollbacks} exhausted "
                    f"at step {step} (rule {rule}: loss={p['loss']:.4g}, "
                    f"grad_norm={p['grad_norm']:.4g}, "
                    f"nonfinite={p['nonfinite_total']})")
        return response

    def report(self) -> Dict[str, Any]:
        return {
            "stage_counts": dict(self.stage_counts),
            "rollbacks": self.rollbacks,
            "level": self.level,
            "quarantined": [dataclasses.asdict(r)
                            for r in self.quarantined.values()],
            "detection_latency_steps": list(self.detection_latency_steps),
            "events": list(self.events),
        }


def _copy_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, ShardedTensor):
        return tree.with_local(tree.local.clone(), tree.partial)
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    return copy.copy(tree)


def replay_quarantined(record: QuarantineRecord, step_fn, state,
                       data_fn: Callable[[int], Any]) -> Dict[str, Any]:
    """Re-run one quarantined batch standalone: its recorded data offset,
    the health-enabled step under all-open gates, on a throwaway copy of
    ``state`` (the caller's state is never touched); the fresh probe
    beside the recorded one."""
    batch = data_fn(record.data_offset)
    out = step_fn(_copy_tree(state), batch, health_gates=default_gates(),
                  lr_scale=1.0)
    return {"recorded": dict(record.probe),
            "replayed": summarize_probe(out[-1]),
            "rule": record.rule, "data_offset": record.data_offset}


# ---------------------------------------------------------------------------
# SDC: rotating cross-replica param crc spot-check
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpotCheck:
    step: int
    slice_index: int
    paths: List[str]
    crc: int


def _flat_paths(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat_paths(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flat_paths(v, f"{prefix}{i}."))
        return out
    return [(prefix.rstrip("."), tree)]


def _leaf_host(leaf) -> np.ndarray:
    from .checkpoint.save_state_dict import host_bytes

    if isinstance(leaf, ShardedTensor):
        leaf = leaf.local
    if isinstance(leaf, torch.Tensor):
        return host_bytes(leaf)
    return np.ascontiguousarray(np.asarray(leaf))


class ParamSpotChecker:
    """crc32 over a rotating slice of the param tree every ``every``
    steps: leaves (sorted by dotted path) are dealt round-robin into
    ``slices`` groups and step t checks group ``(t // every) % slices``;
    a full rotation covers every leaf.  A ``ShardedTensor`` contributes
    this rank's block (the peer replica holds the same block)."""

    def __init__(self, every: int, slices: int = 8):
        self.every = max(1, int(every))
        self.slices = max(1, int(slices))

    def due(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def slice_index(self, step: int) -> int:
        return (step // self.every) % self.slices

    def check(self, tree, step: int) -> SpotCheck:
        from .checkpoint.save_state_dict import _crc

        idx = self.slice_index(step)
        paths = []
        crc = 0
        for i, (path, leaf) in enumerate(_flat_paths(tree)):
            if i % self.slices != idx:
                continue
            if not hasattr(leaf, "dtype"):
                continue
            paths.append(path)
            crc = _crc(_leaf_host(leaf), crc)
            crc = zlib.crc32(path.encode(), crc)
        return SpotCheck(step=step, slice_index=idx, paths=paths,
                         crc=crc & 0xFFFFFFFF)

    @staticmethod
    def compare(local: SpotCheck, peer_crc: Optional[int]) -> None:
        """Raise SDCError when a peer's crc for the same rotation diverges
        (None: no peer answered, not a fault)."""
        if peer_crc is None:
            return
        if int(peer_crc) & 0xFFFFFFFF != local.crc:
            raise SDCError(
                f"param spot-check diverged at step {local.step} "
                f"(slice {local.slice_index}, {len(local.paths)} leaves: "
                f"local crc {local.crc:#010x} != peer "
                f"{int(peer_crc) & 0xFFFFFFFF:#010x}) - silent data "
                f"corruption; rolling back to the last checkpoint")


__all__ = ["GATE_FIELDS", "HealthConfig", "HealthExhausted", "HealthMonitor",
           "NUM_GATES", "NumericFault", "ParamSpotChecker",
           "QuarantineRecord", "SDCError", "SpotCheck", "default_gates",
           "guard_tree", "make_probe", "normalize_gates", "probe_and_guard",
           "replay_quarantined", "summarize_probe"]
