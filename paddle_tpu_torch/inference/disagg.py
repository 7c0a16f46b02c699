"""Disaggregated prefill/decode serving over a tiered KV plane.

Port of ``paddle_tpu/inference/disagg.py``.  Dedicated prefill replicas
absorb prompt bursts while decode replicas keep per-token latency flat; it
composes what the fleet and the engine already have:

- split pools: ``ReplicaSet`` replicas carry a ``role`` (``prefill |
  decode | unified``); prefill replicas run prompt-only ragged steps
  (``ContinuousBatchingEngine(prefill_only=True)``), decode replicas
  receive their prompt KV by handoff.  Either pool empty falls back to
  unified replicas.
- the KV handoff as a reshard route: a finished prefill's pages
  (``engine.export_handoff``: host-staged ``{"k", "v"}`` of shape
  ``[L, npages, kvh, page, d]`` in the cache dtype) become a
  ``plan_reshard`` tree.  ``KVHandoffPlanner`` plans once per
  (destination, payload signature) and streams per handoff, through
  ``reshard.execute_encoded`` when a handoff codec is configured.  int8
  pages are integer leaves, so they travel bit-exact on either path and
  move a byte an element: the int8-KV fleet's handoff is the cheap one.
  ``check_handoff_budget``'s MEM001 half is the graph doctor's (ROADMAP
  A7) and raises; its wire half is ``reshard.plan_wire_bytes``.
- the tiered prefix cache: the host tier of ``serving.PrefixCache``
  (``host_tier_pages``); ``DisaggRouter`` probes every prefill replica's
  trie, device and host tier, and prefers the longest cached prefix.
- two-pool scheduling: prefill admission by outstanding tokens, decode
  admission by free slots (``engine.can_adopt``), a degradation ladder per
  pool and a load-driven autoscale of ``FleetConfig.pool_targets`` with
  hysteresis.

Fault tolerance is the fleet's: a decode replica dying mid-stream
migrates its requests through the replay path, which prefills again on
the prefill pool and hands off again (the mid-decode handoff).  An int8
fleet shares one frozen K/V calibration: the first engine's scales are
copied into every engine that has not calibrated, never aliased.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .fleet import FleetRouter, Replica, RouterConfig

logger = logging.getLogger(__name__)

DEFAULT_HANDOFF_TRANSIENT = 8 << 20


# ---------------------------------------------------------------------------
# KV handoff: plan once, stream per handoff, over the reshard planner
# ---------------------------------------------------------------------------


class KVHandoffPlanner:
    """The KV handoff stream: ``plan_reshard`` over a finished prefill's
    page tree, cached per (destination topology, payload signature) (pages
    quantize prompt lengths, so few signatures recur) and re-executed per
    handoff.  The destination is ``dst_mesh`` or a one-rank mesh on
    ``device`` (the card unless the caller passes ``device="cpu"``).
    ``codec`` (a ``parallel/codec.CollectiveCodec``) routes delivery
    through ``execute_encoded``: float pages would be block-scale
    quantized (lossy, opt-in), int8 pages stay bit-exact."""

    def __init__(self, *, dst_mesh=None, codec=None,
                 max_transient_bytes: Optional[int] =
                 DEFAULT_HANDOFF_TRANSIENT,
                 device: DeviceLike = None):
        self.dst_mesh = dst_mesh
        self.device = (resolve_device(device) if dst_mesh is None
                       or device is not None else None)
        self.codec = codec
        self.max_transient_bytes = max_transient_bytes
        self._plans: Dict[Any, Any] = {}
        self.last_tree = None          # the latest payload
        self.telemetry: Dict[str, Any] = {
            "plans_built": 0, "handoffs": 0,
            "bytes_raw": 0, "bytes_wire": 0}

    def _mesh(self):
        if self.dst_mesh is not None:
            return self.dst_mesh
        from ..parallel.specs import Mesh

        return Mesh((1,), ("replica",), device_type=self.device.type)

    def _key(self, tree):
        from ..parallel.reshard import path_leaves
        from ..parallel.specs import mesh_device_ids

        mesh = self._mesh()
        sig = tuple((p, tuple(np.shape(v)), str(v.dtype))
                    for p, v in path_leaves(tree)[0])
        return (tuple(mesh.axis_names),
                tuple(int(mesh.shape[a]) for a in mesh.axis_names),
                mesh_device_ids(mesh), mesh.device_type, sig)

    def plan_for(self, tree):
        """The cached redistribution plan for this payload signature."""
        key = self._key(tree)
        plan = self._plans.get(key)
        if plan is None:
            from ..parallel.reshard import plan_reshard

            plan = plan_reshard(
                tree, self._mesh(), None,
                max_transient_bytes=self.max_transient_bytes)
            self._plans[key] = plan
            self.telemetry["plans_built"] += 1
        return plan

    def deliver(self, tree):
        """Stream one handoff: execute the cached plan (codec-routed when
        configured) and account its wire bytes."""
        from ..parallel.reshard import execute_encoded, plan_wire_bytes

        plan = self.plan_for(tree)
        wb = plan_wire_bytes(plan, codec=self.codec)
        self.telemetry["handoffs"] += 1
        self.telemetry["bytes_raw"] += wb["raw_bytes"]
        self.telemetry["bytes_wire"] += wb["wire_bytes"]
        self.last_tree = tree
        if self.codec is not None:
            return execute_encoded(plan, tree, self.codec,
                                   device=self.device)
        return plan.execute(tree, device=self.device)

    def uncount(self, tree):
        """Reverse one ``deliver``'s accounting: a payload whose adoption
        was refused never landed, and telemetry counts delivered
        handoffs."""
        from ..parallel.reshard import plan_wire_bytes

        wb = plan_wire_bytes(self.plan_for(tree), codec=self.codec)
        self.telemetry["handoffs"] -= 1
        self.telemetry["bytes_raw"] -= wb["raw_bytes"]
        self.telemetry["bytes_wire"] -= wb["wire_bytes"]

    def check_handoff_budget(self, tree, *, budget_bytes: int,
                             exemptions=(), target: str = "kv_handoff"):
        """Price one handoff payload's worst plan step against
        ``budget_bytes`` through the Graph Doctor's MEM001 pass
        (``check_reshard_budget``).  That pass is ROADMAP A7's, so this
        raises as ``check_reshard_budget`` does.  The handoff's wire bytes
        are ``reshard.plan_wire_bytes(self.plan_for(tree), self.codec)``."""
        from ..parallel.reshard import check_reshard_budget

        return check_reshard_budget(self.plan_for(tree), tree,
                                    budget_bytes=budget_bytes,
                                    exemptions=exemptions, target=target,
                                    codec=self.codec)


# ---------------------------------------------------------------------------
# load-driven autoscale
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutoscaleConfig:
    """Per-pool load-driven autoscale over ``FleetConfig.pool_targets``
    (or ``target_replicas`` for the single-pool router).

    Scale up after ``up_sustain_ticks`` consecutive ticks of admission
    pressure (prefill: the queue could not fully dispatch; decode:
    handoffs parked for want of slots); scale down through the drain path
    after ``down_idle_ticks`` idle ticks; after any action no action
    either way for ``cooldown_ticks`` (hysteresis: an oscillating load
    cannot flap the fleet)."""

    enabled: bool = True
    min_replicas: int = 1
    max_replicas: int = 4
    up_sustain_ticks: int = 3
    down_idle_ticks: int = 8
    cooldown_ticks: int = 6


# ---------------------------------------------------------------------------
# the two-pool router
# ---------------------------------------------------------------------------


class DisaggRouter(FleetRouter):
    """FleetRouter over a role-split ReplicaSet (see the module
    docstring).  One tick: ladders -> dispatch (prefill pool) -> replica
    steps -> KV handoffs (decode pool) -> harvest -> deadlines ->
    autoscale -> reap/respawn.  Without a ``planner`` the handoffs go to
    the replica set's own destination."""

    def __init__(self, replica_set, config: Optional[RouterConfig] = None,
                 *, planner: Optional[KVHandoffPlanner] = None,
                 autoscale: Optional[AutoscaleConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        # per-pool ladder state must exist before the base constructor
        # applies stage knobs to the freshly spawned fleet
        self.stage_prefill = 0
        self.stage_decode = 0
        self.planner = planner or KVHandoffPlanner(
            dst_mesh=replica_set.dst_mesh, device=replica_set.device)
        self.autoscale_cfg = autoscale or AutoscaleConfig(enabled=False)
        self._as_up_streak = {"prefill": 0, "decode": 0}
        self._as_idle_streak = {"prefill": 0, "decode": 0}
        self._as_cooldown_until = {"prefill": 0, "decode": 0}
        self._pressure = {"prefill": False, "decode": False}
        # the fleet's one frozen int8 K/V calibration (host copies of the
        # first engine's kv_scales), installed in every engine that has
        # not calibrated yet
        self._fleet_kv_scales: Optional[Dict[str, np.ndarray]] = None
        super().__init__(replica_set, config, clock=clock)
        self.telemetry.update({
            "handoffs": 0, "handoffs_mid_decode": 0,
            "handoff_backlog_ticks": 0, "completed_at_prefill": 0,
            "autoscale_log": []})

    # -- pools -------------------------------------------------------------

    def _prefill_pool(self) -> List[Replica]:
        return self.set.serving("prefill") or self.set.serving("unified")

    def _decode_pool(self, exclude: Optional[int] = None) -> List[Replica]:
        pool = self.set.serving("decode") or self.set.serving("unified")
        return [r for r in pool if r.id != exclude]

    # -- dispatch: prefill admission by token budget -----------------------

    def _pick_replica(self, req) -> Optional[Replica]:
        """Prefill-pool pick under the outstanding-token budget: the
        replica whose trie (device or host tier) holds the longest
        full-page prefix of the prompt, else the affinity pin, else the
        least loaded.  Sampled requests ride the same pools: the slot's
        sampling stream travels in the handoff's meta."""
        cands = self._prefill_pool()
        if not cands:
            return None
        cap = self.cfg.admission_token_cap
        fits = [r for r in cands
                if self._outstanding(r) + req.footprint() <= cap]
        if not fits:
            return None
        best, best_m = None, 0
        for r in fits:
            pc = getattr(r.engine, "prefix_cache", None)
            if pc is None:
                continue
            m = pc.probe(req.prompt)
            if m > best_m:
                best, best_m = r, m
        if best is not None:
            return best
        key = self._affinity_key(req)
        if key is not None:
            pin = self._affinity.get(key)
            rep = next((r for r in fits if r.id == pin), None)
            if rep is not None:
                self._pin(key, rep.id)
                return rep
        rep = min(fits, key=lambda r: (self._outstanding(r), r.id))
        if key is not None:
            self._pin(key, rep.id)
        return rep

    # -- one fleet, one int8 calibration -----------------------------------

    def _share_calibration(self, eng) -> None:
        """Install a copy of the fleet calibration on an int8 engine that
        has not calibrated (a new prefill prompt, a respawned replica, an
        adoption target) before it could calibrate its own."""
        if (self._fleet_kv_scales is not None
                and getattr(eng, "kv_scales", None) is None
                and eng.cache_dtype == torch.int8):
            eng._set_kv_scales({k: torch.from_numpy(np.array(v))
                                for k, v in self._fleet_kv_scales.items()})

    def _capture_calibration(self, eng) -> None:
        if (self._fleet_kv_scales is None
                and getattr(eng, "kv_scales", None) is not None):
            self._fleet_kv_scales = {
                k: v.detach().cpu().numpy().copy()
                for k, v in eng.kv_scales.items()}

    def _assign(self, req, rep) -> None:
        """Every engine add_request routes through here, where a first
        real prompt would freeze an engine's own calibration: share the
        fleet's (or capture it)."""
        self._share_calibration(rep.engine)
        super()._assign(req, rep)
        self._capture_calibration(rep.engine)

    # -- the KV handoff phase: decode admission by slot occupancy ----------

    def _pick_decode_replica(self, seq_len: int, remaining: int,
                             exclude: Optional[int] = None
                             ) -> Optional[Replica]:
        """The least-occupied decode replica that can adopt this handoff
        (free slot and pages, ``engine.can_adopt``), checked before the
        page export, so backpressure costs a parked prefill slot and never
        a delivered payload."""
        best = None
        for r in self._decode_pool(exclude):
            eng = r.engine
            if not eng.can_adopt(seq_len, remaining):
                continue
            occ = int(np.count_nonzero(eng.active))
            if best is None or occ < best[0]:
                best = (occ, r)
        return best[1] if best else None

    def _do_handoffs(self) -> int:
        """Stream every handoff-ready prefill slot to a decode replica
        through the cached plan.  Without decode capacity the slot stays
        parked (its pages reserved; counted and retried next tick)."""
        moved = 0
        backlog = 0
        for rep in list(self.set.live()):
            eng = rep.engine
            if eng is None or not getattr(eng, "handoff_ready", None):
                continue
            amap = self._assigned.get(rep.id, {})
            for slot in list(eng.handoff_ready):
                info = eng.handoff_ready[slot]
                req = amap.get(info["rid"])
                if req is None:
                    # canceled or migrated since parking
                    eng.release_handoff(slot)
                    continue
                first = int(info["first_token"])
                if req.remaining <= 1 or first == eng.eos_id:
                    # the first token completes the request: commit it
                    # router-side, moving no KV
                    req.emitted.append(first)
                    del amap[info["rid"]]
                    eng.release_handoff(slot)
                    self._complete(req)
                    self.telemetry["completed_at_prefill"] += 1
                    continue
                dst = self._pick_decode_replica(
                    int(info["seq_len"]), req.remaining, exclude=rep.id)
                if dst is None:
                    backlog += 1
                    continue
                tree, meta = eng.export_handoff(slot)
                placed = self.planner.deliver(tree)
                mid_decode = bool(np.count_nonzero(dst.engine.active))
                new_rid = dst.engine.adopt_request(
                    placed, meta, max_new_tokens=req.remaining)
                if new_rid is None:
                    # can_adopt was optimistic: the payload did not land
                    self.planner.uncount(tree)
                    backlog += 1
                    continue
                eng.release_handoff(slot)
                del amap[info["rid"]]
                req.replica, req.engine_rid = dst.id, new_rid
                req.harvested = 0
                req.dispatched_at = self.clock()
                self._assigned.setdefault(dst.id, {})[new_rid] = req
                self.telemetry["handoffs"] += 1
                if req.emitted or mid_decode:
                    # a replayed migration, or a handoff into a live
                    # decode batch: the mid-decode shape
                    self.telemetry["handoffs_mid_decode"] += 1
                moved += 1
        self._pressure["decode"] = backlog > 0
        if backlog:
            self.telemetry["handoff_backlog_ticks"] += 1
        return moved

    # -- per-pool degradation ladders --------------------------------------

    def _update_ladder(self) -> None:
        """Two pressures, two ladders, one stage move per tick each;
        ``self.stage`` stays the larger, so the base submit() reject gate
        keeps its meaning."""
        prefill_cap = max(1, len(self._prefill_pool())) \
            * self.cfg.admission_token_cap
        p_prefill = self._queued_tokens() / prefill_cap
        slots = sum(r.engine.max_slots for r in self._decode_pool()) or 1
        occ = sum(int(np.count_nonzero(r.engine.active))
                  for r in self._decode_pool())
        parked = sum(len(getattr(r.engine, "handoff_ready", ()))
                     for r in self.set.live())
        p_decode = (occ + parked) / slots
        for pool, pressure in (("prefill", p_prefill),
                               ("decode", p_decode)):
            stage = getattr(self, f"stage_{pool}")
            if pressure > self.cfg.overload_high and stage < 3:
                self._set_pool_stage(pool, stage + 1, pressure)
            elif pressure < self.cfg.overload_low and stage > 0:
                self._set_pool_stage(pool, stage - 1, pressure)
        self._pressure["prefill"] = p_prefill > self.cfg.overload_high

    def _set_pool_stage(self, pool: str, stage: int, pressure: float):
        prev = getattr(self, f"stage_{pool}")
        setattr(self, f"stage_{pool}", stage)
        self.stage = max(self.stage_prefill, self.stage_decode)
        self.telemetry["ladder_log"].append(
            {"tick": self._tick, "pool": pool, "from": prev,
             "to": stage, "pressure": round(float(pressure), 3)})
        logger.warning("[disagg] %s ladder %d -> %d (pressure %.2f)",
                       pool, prev, stage, pressure)
        self._apply_stage_knobs()

    def _apply_stage_knobs(self, replicas=None) -> None:
        """Per-pool throttles: the prefill ladder shrinks the chunk budget
        (halve, then floor), the decode ladder sheds speculation; stage 3
        of either rejects at submit."""
        for rep in (replicas if replicas is not None else self.set.live()):
            eng = rep.engine
            if eng is None:
                continue
            if rep.role in ("prefill", "unified"):
                floor = min(self.cfg.min_prefill_budget,
                            eng._init_prefill_budget)
                if self.stage_prefill >= 2:
                    budget = floor
                elif self.stage_prefill >= 1:
                    budget = max(floor, eng._init_prefill_budget // 2)
                else:
                    budget = eng._init_prefill_budget
                eng.throttle(prefill_token_budget=budget)
            if rep.role in ("decode", "unified"):
                eng.throttle(speculative_k=(
                    0 if self.stage_decode >= 1 else eng._init_spec_k))

    # -- load-driven autoscale ---------------------------------------------

    def _pool_idle(self, pool: str) -> bool:
        if pool == "prefill":
            busy = any(self._assigned.get(r.id)
                       for r in self.set.live("prefill"))
            return not self.queue and not busy
        busy = any(self._assigned.get(r.id)
                   for r in self.set.live("decode"))
        return not busy

    def _autoscale(self) -> None:
        """Move ``FleetConfig.pool_targets`` per pool from the router's
        own pressure signals, with hysteresis (AutoscaleConfig)."""
        cfg = self.autoscale_cfg
        targets = self.set.config.pool_targets
        if not cfg.enabled or targets is None:
            return
        for pool in ("prefill", "decode"):
            if pool not in targets:
                continue
            pressured = self._pressure[pool] or (
                pool == "prefill" and bool(self.queue))
            self._as_up_streak[pool] = \
                self._as_up_streak[pool] + 1 if pressured else 0
            self._as_idle_streak[pool] = \
                self._as_idle_streak[pool] + 1 \
                if self._pool_idle(pool) else 0
            if self._tick < self._as_cooldown_until[pool]:
                continue
            if (self._as_up_streak[pool] >= cfg.up_sustain_ticks
                    and targets[pool] < cfg.max_replicas):
                targets[pool] += 1
                self._as_cooldown_until[pool] = \
                    self._tick + cfg.cooldown_ticks
                self._as_up_streak[pool] = 0
                self.telemetry["autoscale_log"].append(
                    {"tick": self._tick, "pool": pool, "dir": "up",
                     "target": targets[pool]})
            elif (self._as_idle_streak[pool] >= cfg.down_idle_ticks
                    and targets[pool] > cfg.min_replicas):
                targets[pool] -= 1
                self._as_cooldown_until[pool] = \
                    self._tick + cfg.cooldown_ticks
                self._as_idle_streak[pool] = 0
                victim = next(
                    (r for r in self.set.serving(pool)
                     if not self._assigned.get(r.id)), None)
                if victim is not None:
                    self.drain(victim.id)   # scale-down is the drain path
                self.telemetry["autoscale_log"].append(
                    {"tick": self._tick, "pool": pool, "dir": "down",
                     "target": targets[pool]})

    # -- the tick ----------------------------------------------------------

    def step(self) -> int:
        """One disaggregated router tick."""
        self._tick += 1
        self._update_ladder()
        self._dispatch()
        self._step_replicas()
        self._do_handoffs()
        produced = self._harvest()
        self._check_deadlines()
        self._autoscale()
        self._reap_and_respawn()
        return produced

    def stats(self) -> Dict[str, Any]:
        t = super().stats()
        t["stage_prefill"] = self.stage_prefill
        t["stage_decode"] = self.stage_decode
        t["handoff"] = dict(self.planner.telemetry)
        t["pool_targets"] = dict(self.set.pool_targets())
        return t


__all__ = ["DEFAULT_HANDOFF_TRANSIENT", "AutoscaleConfig", "DisaggRouter",
           "KVHandoffPlanner"]
