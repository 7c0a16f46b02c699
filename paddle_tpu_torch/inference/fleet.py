"""Serving fleet: replica manager, SLO-aware router, request-level fault
tolerance.

Port of ``paddle_tpu/inference/fleet.py``: a fleet of
``ContinuousBatchingEngine`` replicas whose weights arrive through the
reshard planner and whose requests ride a router that survives the loss of
a replica without losing or repeating a token.

Three layers:

- ``ReplicaSet``: replica lifecycle (spawn -> warm -> serve -> drain ->
  remove).  Weight delivery is plan once, stream per replica: the
  redistribution of the source weights onto the serving topology is
  planned by ``parallel.reshard.plan_reshard`` once per topology
  (size-capped steps, so the delivery's transient stays bounded however
  large the model) and every spawn re-executes the cached plan, through
  ``execute_encoded`` when ``FleetConfig.delivery_codec`` is set (the
  packed int8 bytes cross to the card and decode there).  The serving
  topology is ``dst_mesh`` or a one-rank ``Mesh((1,), ("replica",))`` on
  ``device`` (the card unless the caller passes ``device="cpu"``; it
  raises without one).  Which route a source leaf takes: host values
  (numpy, CPU tensors: a checkpoint's) take the host route, one real copy
  per spawn through the pinned staging buffer; a tensor already on the
  destination card is a ``noop`` leaf on a one-rank mesh, so every replica
  would share that one weight set.  The delivery counters count either
  way.  Health is the comm watchdog: every replica step runs inside a
  ``comm_watch`` window, and a flagged step raises ``ReplicaHung``.  A
  replica reports SERVING only after ``_warmup`` ran its first steps, so
  the lazily built kernels, cuBLAS handles and allocator growth fall
  outside every heartbeat.  ``remove`` gives a dead replica's device
  memory back at once: it drops the engine's pools and weights and the
  fault's traceback (whose frames would otherwise hold the engine in a
  reference cycle until a garbage collection).

- ``FleetRouter``: continuous batching across replicas.  Dispatch is
  prefix-cache affine (the first full prompt page is hashed and pinned to
  a replica), admission is capped by outstanding prompt + generation
  tokens per replica, a request that outlives its deadline is withdrawn
  (``engine.cancel``) and retried after a jittered backoff with its
  committed tokens kept, and under pressure the router degrades along an
  ordered ladder (shed speculation, shrink the prefill chunk, reject), one
  stage per tick, through the engine's ``throttle``.

- request migration: when a replica dies or hangs mid-decode, its
  in-flight requests re-enqueue at the head of the queue and replay on a
  survivor from the prompt plus the tokens the router already committed.
  On the CPU in fp32 the replayed greedy streams equal an unfaulted run's;
  on the card the library GEMMs may pick another algorithm for another row
  count, so a position can round differently as prefill than as decode.

The scripted fault harness is ``tests/torch_fault_injection.py``
(``FakeReplica``, ``build_serving_fleet``, ``run_fleet_trace``).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..distributed.resilience import ReplicaHung, ServingRecoveryEvent
from ..distributed.store import jittered_backoff
from ..distributed.watchdog import comm_watch

logger = logging.getLogger(__name__)

# lifecycle states (spawn -> warm -> serve -> drain -> remove; dead is the
# involuntary exit)
SPAWNING = "spawning"
WARMING = "warming"
SERVING = "serving"
DRAINING = "draining"
DEAD = "dead"
REMOVED = "removed"


class OverloadRejected(RuntimeError):
    """Admission rejected at the ladder's top stage: the explicit overload
    signal (a typed error and a telemetry counter, never silent queue
    growth)."""


# ---------------------------------------------------------------------------
# replica
# ---------------------------------------------------------------------------


class Replica:
    """One serving replica: an engine, its lifecycle and the watchdog
    heartbeat.

    ``engine_factory(params) -> ContinuousBatchingEngine`` builds the
    replica's engine from its delivered weights; page pools, prefix trie
    and scheduler state are per replica.  ``step()`` wraps the engine step
    in a ``comm_watch`` window, and a flagged step raises ``ReplicaHung``
    so the router treats its output as suspect and migrates.  ``role`` is
    the pool the replica serves: ``prefill`` (prompt-only engine, its KV
    handed off), ``decode`` or ``unified``."""

    def __init__(self, replica_id: int, engine_factory: Callable,
                 step_timeout_s: float = 0.0, role: str = "unified"):
        self.id = int(replica_id)
        self._factory = engine_factory
        self.step_timeout_s = float(step_timeout_s)
        self.role = role
        self.state = SPAWNING
        self.engine = None
        self.fault: Optional[BaseException] = None
        self.steps = 0                      # completed engine steps
        self.last_beat: Optional[float] = None
        self.spawned_at = time.monotonic()

    def warm(self, params) -> None:
        """Build the engine from the delivered weights, run its first
        steps, then report SERVING."""
        self.state = WARMING
        self.engine = self._factory(params)
        if not getattr(self.engine, "unified", False):
            raise ValueError(
                "fleet replicas require the unified engine "
                "(prefill_token_budget > 0): migration replays and the "
                "shed ladder ride the ragged step's runtime knobs")
        self._warmup()
        self.state = SERVING

    def _warmup(self) -> None:
        """Run the unified step before the replica reports SERVING: the
        heartbeat must time the steady step, not the first one, which on
        the card builds the kernels' library (``ops/_build.py``), creates
        the cuBLAS handles and grows the caching allocator.  One throwaway
        2-token request, too short to commit a prefix-cache page,
        generates three tokens (under speculative decoding that leaves
        room for one proposal round); a prefill-only engine's parked dummy
        goes through the export path the real handoffs use.  Its records
        are scrubbed afterwards, and an int8 engine drops the dummy's
        scales so that the first real prompt calibrates (at
        ``add_request``, outside any heartbeat)."""
        eng = self.engine
        rid = eng.add_request(np.asarray([1, 2], np.int32),
                              max_new_tokens=3)
        for _ in range(64):
            eng.step()
            for slot in list(getattr(eng, "handoff_ready", ())):
                eng.export_handoff(slot)
                eng.release_handoff(slot)
            if not eng.active.any() and not eng.queue:
                break
        eng.finished.clear()
        eng.prefill_stats.pop(rid, None)
        if eng.cache_dtype == torch.int8:
            eng.kv_scales = None
            eng._fold = None
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)

    def step(self) -> int:
        """One engine step under the watchdog heartbeat.  Any exception out
        of the engine propagates to the router, which treats it as this
        replica's death, never the fleet's; a step the watchdog flagged
        raises ``ReplicaHung`` after the late result arrived (the scanner
        decides the timed-out state under the manager lock, so a late
        completion never retracts it)."""
        with comm_watch(f"replica[{self.id}].step",
                        timeout_s=self.step_timeout_s) as task:
            produced = self._engine_step()
        self.steps += 1
        self.last_beat = time.monotonic()
        if task.timed_out:
            raise ReplicaHung(
                f"replica {self.id} step flagged by the watchdog after "
                f"{task.elapsed():.2f}s > {task.timeout_s:.2f}s")
        return produced

    def _engine_step(self) -> int:
        """The injection point ``FakeReplica`` overrides (kill or stall
        inside the watch window)."""
        return self.engine.step()

    @property
    def alive(self) -> bool:
        return self.state in (SPAWNING, WARMING, SERVING, DRAINING)

    def __repr__(self):
        return f"Replica(id={self.id}, state={self.state}, steps={self.steps})"


def _release_engine(eng) -> None:
    """Drop a dead engine's device state (pools, weights, draft model,
    prefix trie) so that its memory returns now, whatever still holds the
    engine object."""
    for name in ("k_pages", "v_pages", "params", "w", "draft",
                 "prefix_cache", "cos_tab", "sin_tab", "kv_scales",
                 "_fold", "_dev_tok"):
        if hasattr(eng, name):
            setattr(eng, name, None)
    if hasattr(eng, "_inflight"):
        eng._inflight.clear()


def _without_traceback(fault: BaseException) -> BaseException:
    """The fault with its traceback chain dropped: its frames hold the
    replica and the engine that raised it."""
    seen = set()
    e: Optional[BaseException] = fault
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
    return fault


# ---------------------------------------------------------------------------
# fleet manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetConfig:
    target_replicas: int = 2
    # role -> target replica count for a disaggregated fleet (None keeps
    # the single unified pool at ``target_replicas``); the disaggregated
    # router's autoscale mutates it, and ensure_target respawns per pool
    pool_targets: Optional[Dict[str, int]] = None
    step_timeout_s: float = 0.0            # 0 = heartbeat watchdog off
    # the delivery plan's transient cap (the reshard planner's size-capped
    # steps)
    max_transient_bytes: Optional[int] = 64 << 20
    # the weight-delivery codec (parallel/codec.CollectiveCodec, weight
    # profile): host-route float leaves stream as block-scaled packed int8
    # and decode on the replica's device.  Lossy; None keeps delivery
    # bit-exact
    delivery_codec: Optional[Any] = None


class ReplicaSet:
    """Replica fleet manager: lifecycle and plan-once, stream-per-replica
    weight delivery.

    ``params``: the source weight tree (host values from a checkpoint, or
    tensors of a co-located trainer).  ``dst_mesh``/``dst_specs``: the
    per-replica serving layout (None: a one-rank mesh on ``device``, the
    single-card replica).  ``engine_factories`` maps a role to its engine
    factory (a prefill pool builds prompt-only engines); a role without
    one takes ``engine_factory``.  ``delivery_log`` keeps each delivery's
    seconds and staged bytes."""

    def __init__(self, params, engine_factory: Callable,
                 config: Optional[FleetConfig] = None, *,
                 dst_mesh=None, dst_specs=None,
                 replica_factory: Optional[Callable] = None,
                 engine_factories: Optional[Dict[str, Callable]] = None,
                 device: DeviceLike = None):
        self.params = params
        self.engine_factory = engine_factory
        self.engine_factories = engine_factories or {}
        self.config = config or FleetConfig()
        self.dst_mesh = dst_mesh
        self.dst_specs = dst_specs
        # the default one-rank mesh's device; raises without a GPU unless
        # the caller asks for the CPU
        self.device = (resolve_device(device) if dst_mesh is None
                       or device is not None else None)
        self.replica_factory = replica_factory or Replica
        self.replicas: Dict[int, Replica] = {}
        self._next_id = 0
        self._plans: Dict[Any, Any] = {}     # topology key -> ReshardPlan
        self.telemetry: Dict[str, Any] = {
            "plans_built": 0, "deliveries": 0, "spawns": 0,
            "removed": 0, "deaths": {}}
        self.delivery_log: Deque[Dict[str, Any]] = deque(maxlen=1024)

    # -- weight delivery ---------------------------------------------------

    def _mesh(self):
        if self.dst_mesh is not None:
            return self.dst_mesh
        from ..parallel.specs import Mesh

        return Mesh((1,), ("replica",), device_type=self.device.type)

    def _topology_key(self):
        from ..parallel.specs import mesh_device_ids

        mesh = self._mesh()
        return (tuple(mesh.axis_names),
                tuple(int(mesh.shape[a]) for a in mesh.axis_names),
                mesh_device_ids(mesh), mesh.device_type)

    def delivery_plan(self):
        """The cached redistribution plan for the current topology: plan
        once, stream per replica."""
        key = self._topology_key()
        plan = self._plans.get(key)
        if plan is None:
            from ..parallel.reshard import plan_reshard

            plan = plan_reshard(
                self.params, self._mesh(), self.dst_specs,
                max_transient_bytes=self.config.max_transient_bytes)
            self._plans[key] = plan
            self.telemetry["plans_built"] += 1
        return plan

    def _deliver(self):
        """Execute the cached plan, through the coded path when a delivery
        codec is configured."""
        plan = self.delivery_plan()
        codec = self.config.delivery_codec
        t0 = time.perf_counter()
        if codec is None:
            out = plan.execute(self.params, device=self.device)
        else:
            from ..parallel.reshard import execute_encoded

            out = execute_encoded(plan, self.params, codec,
                                  device=self.device)
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.delivery_log.append({
            "s": time.perf_counter() - t0,
            "staged_bytes": plan.telemetry["last_staged_bytes"],
            "moved_bytes": plan.moved_bytes, "coded": codec is not None})
        return out

    def check_delivery_budget(self, budget_bytes: int, exemptions=(),
                              target: Optional[str] = None):
        """Price the delivery plan's worst step against ``budget_bytes``
        through the Graph Doctor's MEM001 pass (``check_reshard_budget``):
        that pass is ROADMAP A7's, so this raises as it does."""
        from ..parallel.reshard import check_reshard_budget

        return check_reshard_budget(self.delivery_plan(), self.params,
                                    budget_bytes=budget_bytes,
                                    exemptions=exemptions,
                                    target=target or "replica_delivery",
                                    codec=self.config.delivery_codec)

    # -- lifecycle ---------------------------------------------------------

    def spawn(self, role: str = "unified") -> Replica:
        """spawn -> deliver weights (cached plan) -> warm -> SERVING.  A
        delivery or warmup failure marks the half-spawned replica DEAD and
        re-raises; ``ensure_target`` catches and retries."""
        factory = self.engine_factories.get(role, self.engine_factory)
        rep = self.replica_factory(self._next_id, factory,
                                   step_timeout_s=self.config.step_timeout_s)
        rep.role = role
        self._next_id += 1
        self.replicas[rep.id] = rep
        try:
            delivered = self._deliver()
            self.telemetry["deliveries"] += 1
            rep.warm(delivered)
        except Exception:
            if rep.engine is not None:
                _release_engine(rep.engine)
            rep.engine = None
            self.note_death(rep, "SpawnFailed")
            raise
        self.telemetry["spawns"] += 1
        return rep

    def note_death(self, rep: Replica, kind: str) -> None:
        rep.state = DEAD
        d = self.telemetry["deaths"]
        d[kind] = d.get(kind, 0) + 1

    def remove(self, rep: Replica) -> None:
        """drain/dead -> REMOVED.  A drained replica's engine passes the
        teardown leak check (its slots are empty by the drain contract); a
        dead replica's engine state is suspect and is released without the
        shutdown assertions.  Either way its device memory returns now.
        The corpse leaves the replica table; telemetry keeps the counts."""
        eng = rep.engine
        if eng is not None:
            if rep.state == DRAINING:
                eng.shutdown()
            _release_engine(eng)
        if rep.fault is not None:
            _without_traceback(rep.fault)
        rep.engine = None
        rep.state = REMOVED
        self.replicas.pop(rep.id, None)
        self.telemetry["removed"] += 1

    def serving(self, role: Optional[str] = None) -> List[Replica]:
        return [r for r in self.replicas.values() if r.state == SERVING
                and (role is None or r.role == role)]

    def live(self, role: Optional[str] = None) -> List[Replica]:
        return [r for r in self.replicas.values()
                if r.state in (SERVING, DRAINING)
                and (role is None or r.role == role)]

    def pool_targets(self) -> Dict[str, int]:
        """The per-role target map (the single-pool fleet is
        {"unified": target_replicas})."""
        if self.config.pool_targets is not None:
            return self.config.pool_targets
        return {"unified": self.config.target_replicas}

    def ensure_target(self) -> List[Replica]:
        """Spawn until each pool's SPAWNING + WARMING + SERVING count meets
        its target (DRAINING replicas do not count).  A spawn failure is a
        replica death, never the caller's: it is logged, counted and
        retried on the next call, and a failing pool never blocks the
        others' healing."""
        spawned = []
        for role, target in self.pool_targets().items():
            while len([r for r in self.replicas.values()
                       if r.state in (SPAWNING, WARMING, SERVING)
                       and r.role == role]) < int(target):
                try:
                    spawned.append(self.spawn(role))
                except Exception:  # noqa: BLE001 - logged and retried
                    logger.exception("[fleet] %s replica spawn failed; "
                                     "will retry next tick", role)
                    break
        return spawned


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RouterRequest:
    """One request as the router owns it.  ``emitted`` is the committed
    output: tokens harvested from a replica are appended exactly once and
    survive migration and retry (a replay can only extend it)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    timeout_s: Optional[float] = None      # per-assignment SLO deadline
    submitted_at: float = 0.0
    emitted: List[int] = dataclasses.field(default_factory=list)
    replica: Optional[int] = None
    engine_rid: Optional[int] = None
    harvested: int = 0                     # continuation tokens pulled
    tries: int = 0                         # timeout retries consumed
    migrations: int = 0
    not_before: float = 0.0                # backoff gate
    dispatched_at: Optional[float] = None
    done: bool = False
    failed: Optional[str] = None
    finished_at: Optional[float] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.emitted)

    def footprint(self) -> int:
        """Admission currency: prompt + full generation budget (a replay's
        prompt ++ emitted plus its remaining budget sums to the same)."""
        return len(self.prompt) + self.max_new_tokens


@dataclasses.dataclass
class RouterConfig:
    admission_token_cap: int = 256         # outstanding tokens / replica
    affinity: bool = True                  # pin by first-full-page hash
    default_timeout_s: Optional[float] = None
    max_retries: int = 3
    backoff_base_s: float = 0.01
    backoff_max_s: float = 0.25
    backoff_jitter: float = 0.25
    seed: int = 0
    # degradation ladder: pressure = queued tokens / fleet capacity, one
    # stage per tick each way, with hysteresis
    overload_high: float = 1.0
    overload_low: float = 0.5
    min_prefill_budget: int = 4
    # bounded retention for a long-running server
    max_done_retained: int = 4096
    max_affinity_pins: int = 4096
    max_recovery_events: int = 1024


class FleetRouter:
    """SLO-aware request router over a ReplicaSet (see the module
    docstring).  Single-threaded and deterministic: ``step()`` is one tick
    (ladder -> dispatch -> replica steps -> harvest -> deadlines ->
    autoscale -> reap -> respawn), ``run()`` drains.  ``clock`` is the
    deadline and backoff clock (injectable for tests)."""

    def __init__(self, replica_set: ReplicaSet,
                 config: Optional[RouterConfig] = None, *,
                 autoscale=None,
                 clock: Callable[[], float] = time.monotonic):
        self.set = replica_set
        self.cfg = config or RouterConfig()
        self.clock = clock
        # the single-pool autoscale (an inference/disagg.py
        # AutoscaleConfig pointed at FleetConfig.target_replicas); the
        # disaggregated router sets its own per-pool config first
        if autoscale is not None or not hasattr(self, "autoscale_cfg"):
            self.autoscale_cfg = autoscale
        self._uas_up_streak = 0
        self._uas_idle_streak = 0
        self._uas_cooldown_until = 0
        self.queue: Deque[RouterRequest] = deque()
        self.requests: Dict[int, RouterRequest] = {}
        self._done_order: Deque[int] = deque()   # retirement FIFO
        self._pending_recoveries: List[ServingRecoveryEvent] = []
        self._assigned: Dict[int, Dict[int, RouterRequest]] = {}
        self._affinity: Dict[int, int] = {}      # prefix hash -> replica
        self._next_rid = 0
        self._tick = 0
        self.stage = 0
        self._rng = random.Random(self.cfg.seed)
        self.telemetry: Dict[str, Any] = {
            "submitted": 0, "completed": 0, "rejected": 0,
            "retries": 0, "migrations": 0, "timeouts_failed": 0,
            "ladder_log": [],
            "recoveries": deque(maxlen=self.cfg.max_recovery_events)}
        self.set.ensure_target()
        self._apply_stage_knobs()

    # -- submission --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32, *,
               temperature: float = 0.0, seed: int = 0,
               timeout_s: Optional[float] = None) -> int:
        """Enqueue a request.  At the ladder's top stage admission is
        rejected with a typed error, the explicit overload signal."""
        if self.stage >= 3:
            self.telemetry["rejected"] += 1
            raise OverloadRejected(
                f"fleet at degradation stage {self.stage}: "
                f"{self._queued_tokens()} queued tokens over "
                f"{self._fleet_capacity()} capacity - retry later")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        footprint = len(prompt) + int(max_new_tokens)
        if footprint > self.cfg.admission_token_cap:
            raise ValueError(
                f"request footprint {footprint} tokens exceeds "
                f"admission_token_cap {self.cfg.admission_token_cap}: it "
                f"could never be dispatched (head-of-queue livelock)")
        rid = self._next_rid
        self._next_rid += 1
        req = RouterRequest(
            rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            temperature=float(temperature), seed=int(seed),
            timeout_s=(timeout_s if timeout_s is not None
                       else self.cfg.default_timeout_s),
            submitted_at=self.clock())
        self.queue.append(req)
        self.requests[rid] = req
        self.telemetry["submitted"] += 1
        return rid

    # -- pressure + ladder -------------------------------------------------

    def _queued_tokens(self) -> int:
        return sum(r.footprint() for r in self.queue)

    def _fleet_capacity(self) -> int:
        return max(1, len(self.set.serving())) * self.cfg.admission_token_cap

    def _update_ladder(self) -> None:
        pressure = self._queued_tokens() / self._fleet_capacity()
        if pressure > self.cfg.overload_high and self.stage < 3:
            self._set_stage(self.stage + 1, pressure)
        elif pressure < self.cfg.overload_low and self.stage > 0:
            self._set_stage(self.stage - 1, pressure)

    def _set_stage(self, stage: int, pressure: float) -> None:
        prev, self.stage = self.stage, stage
        self.telemetry["ladder_log"].append(
            {"tick": self._tick, "from": prev, "to": stage,
             "pressure": round(float(pressure), 3)})
        logger.warning("[fleet] degradation stage %d -> %d "
                       "(pressure %.2f)", prev, stage, pressure)
        self._apply_stage_knobs()

    def _apply_stage_knobs(self, replicas=None) -> None:
        """The current stage as engine throttles: stage 1 sheds
        speculative decoding, stage 2 also halves the prefill chunk budget
        (floored, and never past the engine's own static budget), stage 3
        also rejects at submit().  De-escalation restores the
        constructor's shapes."""
        for rep in (replicas if replicas is not None else self.set.live()):
            eng = rep.engine
            if eng is None:
                continue
            floor = min(self.cfg.min_prefill_budget,
                        eng._init_prefill_budget)
            eng.throttle(
                speculative_k=(0 if self.stage >= 1 else eng._init_spec_k),
                prefill_token_budget=(
                    max(floor, eng._init_prefill_budget // 2)
                    if self.stage >= 2 else eng._init_prefill_budget))

    # -- dispatch ----------------------------------------------------------

    def _affinity_key(self, req: RouterRequest) -> Optional[int]:
        """Hash of the first full prompt page, the prefix trie's sharing
        granularity; exactly one page, so that bodies of different lengths
        behind one system prompt share a pin."""
        live = self.set.serving()
        if not self.cfg.affinity or not live:
            return None
        ps = live[0].engine.page_size
        if len(req.prompt) <= ps:          # no full page to share
            return None
        return hash(tuple(int(t) for t in req.prompt[:ps]))

    def _outstanding(self, rep: Replica) -> int:
        return sum(r.footprint()
                   for r in self._assigned.get(rep.id, {}).values())

    def _pick_replica(self, req: RouterRequest) -> Optional[Replica]:
        """The pinned replica when it exists and fits, else the
        least-loaded serving replica that fits (the pin moves with the
        pick)."""
        serving = self.set.serving()
        if not serving:
            return None
        key = self._affinity_key(req)
        if key is not None:
            pin = self._affinity.get(key)
            rep = next((r for r in serving if r.id == pin), None)
            if rep is not None and (self._outstanding(rep)
                                    + req.footprint()
                                    <= self.cfg.admission_token_cap):
                self._pin(key, rep.id)      # refresh LRU recency
                return rep
        fits = [r for r in serving
                if self._outstanding(r) + req.footprint()
                <= self.cfg.admission_token_cap]
        if not fits:
            return None
        rep = min(fits, key=lambda r: (self._outstanding(r), r.id))
        if key is not None:
            self._pin(key, rep.id)
        return rep

    def _pin(self, key: int, replica_id: int) -> None:
        """LRU-bounded affinity pin: re-insertion refreshes recency, the
        cap evicts the coldest prefix."""
        self._affinity.pop(key, None)
        self._affinity[key] = replica_id
        while len(self._affinity) > self.cfg.max_affinity_pins:
            self._affinity.pop(next(iter(self._affinity)))

    def _assign(self, req: RouterRequest, rep: Replica) -> None:
        """Hand the request (or its post-migration remainder) to a
        replica: the replay prompt is prompt ++ committed tokens, the
        budget what the committed tokens left."""
        engine_prompt = (np.concatenate(
            [req.prompt, np.asarray(req.emitted, np.int32)])
            if req.emitted else req.prompt)
        erid = rep.engine.add_request(
            engine_prompt, max_new_tokens=req.remaining,
            temperature=req.temperature, seed=req.seed)
        req.replica, req.engine_rid = rep.id, erid
        req.harvested = 0
        req.dispatched_at = self.clock()
        self._assigned.setdefault(rep.id, {})[erid] = req

    def _dispatch(self) -> None:
        now = self.clock()
        still: Deque[RouterRequest] = deque()
        while self.queue:
            req = self.queue.popleft()
            if req.not_before > now:
                still.append(req)
                continue
            rep = self._pick_replica(req)
            if rep is None:
                still.append(req)
                continue
            self._assign(req, rep)
        self.queue = still

    # -- harvest + completion ----------------------------------------------

    def _retire(self, req: RouterRequest) -> None:
        """Terminal bookkeeping of completed and failed requests: both
        enter the bounded retention window."""
        req.done = True
        req.replica = req.engine_rid = None
        req.finished_at = self.clock()
        self._done_order.append(req.rid)
        while len(self._done_order) > self.cfg.max_done_retained:
            self.requests.pop(self._done_order.popleft(), None)

    def _complete(self, req: RouterRequest) -> None:
        self._retire(req)
        self.telemetry["completed"] += 1

    def _harvest(self) -> int:
        """Commit every replica's new tokens to the router's ``emitted``
        lists (exactly once) and retire finished requests.  Dead and hung
        replicas were unmapped by migration, so a suspect step's output is
        never committed."""
        produced = 0
        for rep in self.set.live():
            amap = self._assigned.get(rep.id)
            if not amap:
                continue
            eng = rep.engine
            for erid, req in list(amap.items()):
                toks = eng.out_tokens.get(erid)
                if toks is not None and len(toks) > req.harvested:
                    new = toks[req.harvested:]
                    req.emitted.extend(int(t) for t in new)
                    req.harvested = len(toks)
                    produced += len(new)
            keep = []
            for f in eng.finished:
                req = amap.pop(f.rid, None)
                if req is None:
                    keep.append(f)
                    continue
                if len(f.tokens) > req.harvested:
                    new = f.tokens[req.harvested:]
                    req.emitted.extend(int(t) for t in new)
                    produced += len(new)
                self._complete(req)
            eng.finished[:] = keep
        return produced

    # -- fault handling ----------------------------------------------------

    def _migrate_from(self, rep: Replica) -> int:
        """Re-enqueue a dead or hung replica's in-flight requests at the
        head of the queue; committed tokens stay and the replay conditions
        on them.  Nothing is canceled on the corpse."""
        amap = self._assigned.pop(rep.id, {})
        moved = 0
        for erid, req in amap.items():
            req.replica = req.engine_rid = None
            req.harvested = 0
            req.migrations += 1
            if (req.remaining <= 0
                    or (req.emitted and self._hit_eos(rep, req))):
                self._complete(req)
            else:
                self.queue.appendleft(req)
            moved += 1
        self.telemetry["migrations"] += moved
        return moved

    @staticmethod
    def _hit_eos(rep: Replica, req: RouterRequest) -> bool:
        eos = getattr(rep.engine, "eos_id", -1) if rep.engine else -1
        return bool(req.emitted) and req.emitted[-1] == eos

    def _check_deadlines(self) -> None:
        """Per-request SLO timeout: an assignment that outlived its
        deadline is withdrawn (``engine.cancel``, committed tokens kept)
        and retried after a jittered exponential backoff; an exhausted
        retry budget fails the request loudly."""
        now = self.clock()
        for rep in self.set.live():
            amap = self._assigned.get(rep.id)
            if not amap:
                continue
            for erid, req in list(amap.items()):
                if (req.timeout_s is None or req.dispatched_at is None
                        or now - req.dispatched_at <= req.timeout_s):
                    continue
                rep.engine.cancel(erid)
                del amap[erid]
                req.replica = req.engine_rid = None
                req.harvested = 0
                req.tries += 1
                self.telemetry["retries"] += 1
                if req.tries > self.cfg.max_retries:
                    req.failed = (f"timeout after {req.tries} tries "
                                  f"({req.timeout_s}s each)")
                    self._retire(req)
                    self.telemetry["timeouts_failed"] += 1
                    continue
                req.not_before = now + jittered_backoff(
                    req.tries - 1, base=self.cfg.backoff_base_s,
                    max_s=self.cfg.backoff_max_s,
                    jitter=self.cfg.backoff_jitter,
                    rand=self._rng.random)
                self.queue.append(req)

    def _reap_and_respawn(self) -> None:
        """Remove drained replicas with no in-flight requests and dead
        ones, then respawn to target and complete the pending recovery
        events' timing."""
        for rep in list(self.set.replicas.values()):
            if rep.state == DRAINING and not self._assigned.get(rep.id):
                self.set.remove(rep)
            elif rep.state == DEAD:
                self.set.remove(rep)
        spawned = self.set.ensure_target()
        if spawned:
            self._apply_stage_knobs(spawned)
            matched = list(zip(self._pending_recoveries, spawned))
            del self._pending_recoveries[:len(matched)]
            for ev, rep in matched:
                ev.replacement_id = rep.id
                ev.serving_at_tick = self._tick
                ev.recovery_ticks = self._tick - ev.died_at_tick
                ev.wall_s = time.monotonic() - rep.spawned_at

    def _autoscale(self) -> None:
        """Single-pool autoscale of ``FleetConfig.target_replicas``: up
        after ``up_sustain_ticks`` ticks of admission pressure (a queue
        left undispatched or an engaged ladder), down through the drain
        path after ``down_idle_ticks`` idle ticks, ``cooldown_ticks`` of
        hysteresis after any action."""
        cfg = self.autoscale_cfg
        if cfg is None or not getattr(cfg, "enabled", False) \
                or self.set.config.pool_targets is not None:
            return
        pressured = bool(self.queue) or self.stage >= 1
        idle = not self.queue and not any(
            self._assigned.get(r.id) for r in self.set.live())
        self._uas_up_streak = self._uas_up_streak + 1 if pressured else 0
        self._uas_idle_streak = self._uas_idle_streak + 1 if idle else 0
        if self._tick < self._uas_cooldown_until:
            return
        log = self.telemetry.setdefault("autoscale_log", [])
        target = int(self.set.config.target_replicas)
        if (self._uas_up_streak >= cfg.up_sustain_ticks
                and target < cfg.max_replicas):
            self.set.config.target_replicas = target + 1
            self._uas_cooldown_until = self._tick + cfg.cooldown_ticks
            self._uas_up_streak = 0
            log.append({"tick": self._tick, "pool": "unified",
                        "dir": "up", "target": target + 1})
        elif (self._uas_idle_streak >= cfg.down_idle_ticks
                and target > cfg.min_replicas):
            self.set.config.target_replicas = target - 1
            self._uas_cooldown_until = self._tick + cfg.cooldown_ticks
            self._uas_idle_streak = 0
            victim = next((r for r in self.set.serving()
                           if not self._assigned.get(r.id)), None)
            if victim is not None:
                self.drain(victim.id)   # scale-down is the drain path
            log.append({"tick": self._tick, "pool": "unified",
                        "dir": "down", "target": target - 1})

    def drain(self, replica_id: int) -> None:
        """Graceful removal: stop routing to the replica; its in-flight
        requests complete there before removal.  (The fleet respawns to
        ``target_replicas``: for a real scale-down lower the target
        first.)"""
        rep = self.set.replicas[replica_id]
        if rep.state == SERVING:
            rep.state = DRAINING
        self._affinity = {k: v for k, v in self._affinity.items()
                          if v != replica_id}

    # -- the tick ----------------------------------------------------------

    def _step_replicas(self) -> None:
        """Step every live replica; any engine exception is that replica's
        death (migrate and heal), never the fleet's."""
        for rep in list(self.set.live()):
            try:
                rep.step()
            except Exception as fault:  # noqa: BLE001 - any engine death
                kind = type(fault).__name__
                rep.fault = _without_traceback(fault)
                self.set.note_death(rep, kind)
                self._affinity = {k: v for k, v in self._affinity.items()
                                  if v != rep.id}
                moved = self._migrate_from(rep)
                ev = ServingRecoveryEvent(
                    replica_id=rep.id, fault=kind,
                    died_at_tick=self._tick, migrated_requests=moved)
                self.telemetry["recoveries"].append(ev)
                self._pending_recoveries.append(ev)
                logger.warning("[fleet] replica %d %s at tick %d; "
                               "migrated %d in-flight requests",
                               rep.id, kind, self._tick, moved)

    def step(self) -> int:
        """One router tick; returns the tokens committed in it."""
        self._tick += 1
        self._update_ladder()
        self._dispatch()
        self._step_replicas()
        produced = self._harvest()
        self._check_deadlines()
        self._autoscale()
        self._reap_and_respawn()
        return produced

    def pending(self) -> int:
        return (len(self.queue)
                + sum(len(m) for m in self._assigned.values()))

    def run(self, max_iters: int = 10_000):
        """Drive until every submitted request completed (or failed its
        retry budget); {rid: emitted tokens} of the completed set."""
        it = 0
        while self.pending() and it < max_iters:
            self.step()
            it += 1
        if self.pending():
            left = {k: len(v) for k, v in self._assigned.items() if v}
            raise RuntimeError(
                f"fleet router did not drain: queue={len(self.queue)}, "
                f"assigned={left}")
        return self.results()

    def results(self) -> Dict[int, np.ndarray]:
        return {rid: np.asarray(req.emitted, np.int32)
                for rid, req in sorted(self.requests.items())
                if req.done and req.failed is None}

    def stats(self) -> Dict[str, Any]:
        t = dict(self.telemetry)
        offered = t["submitted"] + t["rejected"]
        t["shed_rate"] = t["rejected"] / offered if offered else 0.0
        t["stage"] = self.stage
        t["recoveries"] = [dataclasses.asdict(ev)
                           for ev in self.telemetry["recoveries"]]
        return t


__all__ = ["DEAD", "DRAINING", "REMOVED", "SERVING", "SPAWNING", "WARMING",
           "FleetConfig", "FleetRouter", "OverloadRejected", "Replica",
           "ReplicaSet", "RouterConfig", "RouterRequest"]
