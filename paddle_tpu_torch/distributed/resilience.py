"""Preemption-tolerant training loop.

Port of ``paddle_tpu/distributed/resilience.py``.  ``resilient_train_loop``
composes the comm watchdog (``watchdog.comm_watch``), the elastic restart
policy (``fleet.elastic.ElasticManager``), the store rendezvous
(``store.py``), the checkpoint manager (``checkpoint.CheckpointManager``)
and the reshard planner (``parallel.reshard``) into one recovery pipeline:

    detect -> drain -> checkpoint-or-reuse-last -> re-rendezvous (retry,
    exponential backoff, jitter) -> re-derive the mesh -> reshard -> resume

Detection: a fault raised by the cluster view at a step boundary
(preemption notice, worker loss, membership change), the watchdog flagging
a hung step (``float(loss)`` sits inside the watch window: a hung NCCL
call blocks the host there), and the step itself raising.  A preemption
drains and checkpoints the live state; a kill or a hang distrusts it and
restores the newest verified checkpoint (a corrupt one degrades to its
predecessor).

What the port adds to JAX's loop: a live ``parallel.specs.Mesh`` spans
its whole ``torch.distributed`` world, so a change of membership is a new
process group.  The cluster view owns it (``ClusterView.regroup``; the
multi-process view is ``StoreCluster``): the members re-rendezvous under
generation G on a ``PrefixStore(f"resilience/gen{G}", store)``, the old
group is destroyed and a new one starts with the new world size and a rank
map; ranks outside the new membership park at the store until a later
generation takes them back.  A graceful shrink reshards the live state
over the OLD group before it is torn down (the planner's ``host`` route;
``reshard_bytes`` is the plan's ``moved_bytes``, nothing is replayed); a
graceful grow (ranks joining, which hold nothing) resumes from the
checkpoint the grace window just wrote, laid out on the new mesh by
reshard-on-load (``reshard_bytes`` is that plan's ``moved_bytes``, nothing
is replayed).  ``mesh_builder`` returns a mesh that may be abstract; the
cluster makes it live (``ClusterView.live_mesh``) before ``init_fn`` and
``step_builder`` see it.
"""

from __future__ import annotations

import json
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .checkpoint.manager import CheckpointManager
from .fleet.elastic import ElasticManager
from .watchdog import comm_watch

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# fault taxonomy
# ---------------------------------------------------------------------------


class FaultError(RuntimeError):
    """Base of recoverable training faults.  ``state_intact`` says whether
    the in-memory state can be trusted for a drain-checkpoint (graceful
    preemption) or must be discarded for the last complete checkpoint
    (kill, hang)."""

    state_intact = False


class Preemption(FaultError):
    """Advance notice (a grace window, a maintenance event, a planned
    scale change): state intact and drainable."""

    state_intact = True


class WorkerLost(FaultError):
    """A gang member died mid-step: its shards are gone."""


class StepHang(FaultError):
    """The watchdog flagged the step as hung: its results are suspect."""


class RendezvousTimeout(RuntimeError):
    """One re-rendezvous attempt expired (retried with backoff)."""


class ResilienceExhausted(RuntimeError):
    """Restart or rendezvous budget spent; the job fails for real."""


class ReplicaFault(FaultError):
    """Base of recoverable serving-replica faults (the serving fleet's
    fault model: the unit is a replica, the recovery currency its
    in-flight requests)."""


class ReplicaKilled(ReplicaFault):
    """The replica died mid-decode: its KV pages and unharvested tokens
    are gone."""


class ReplicaPreempted(ReplicaFault):
    """Advance notice: the replica's committed output is trustworthy."""

    state_intact = True


class ReplicaHung(ReplicaFault):
    """The watchdog flagged the replica's step: its results are
    suspect."""


@dataclass
class ServingRecoveryEvent:
    """One replica death and replacement, as the router records it."""

    replica_id: int
    fault: str
    died_at_tick: int
    migrated_requests: int
    replacement_id: Optional[int] = None
    serving_at_tick: Optional[int] = None
    recovery_ticks: Optional[int] = None
    wall_s: Optional[float] = None


# ---------------------------------------------------------------------------
# configuration and cluster views
# ---------------------------------------------------------------------------


@dataclass
class ResilienceConfig:
    checkpoint_dir: str
    checkpoint_every: int = 5          # steps between periodic checkpoints
    keep: int = 2                      # retention window (degrade target)
    max_restarts: int = 3              # gang-restart budget
    step_timeout_s: float = 0.0        # 0 = watchdog off for steps
    rendezvous_timeout_s: float = 5.0  # per-attempt gate budget
    rendezvous_attempts: int = 5
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    backoff_jitter: float = 0.25       # +- fraction of the delay
    max_transient_bytes: Optional[int] = 64 << 20   # reshard step cap
    seed: int = 0                      # jitter determinism
    # a health.HealthConfig arms the numeric-fault detector and ladder;
    # the step contract then is step_fn(state, batch, health_gates=...,
    # lr_scale=...) -> (loss, new_state, probe)
    health: Optional[Any] = None


def backoff_delay(cfg: ResilienceConfig, attempt: int,
                  rng: random.Random) -> float:
    """``store.jittered_backoff`` with this config's shape and a seeded
    rng."""
    from .store import jittered_backoff

    return jittered_backoff(attempt, base=cfg.backoff_base_s,
                            max_s=cfg.backoff_max_s,
                            jitter=cfg.backoff_jitter, rand=rng.random)


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ClusterView:
    """What the loop needs to know about the fleet: the member ranks and
    the gates of a recovery.  The defaults are those of a fixed world."""

    def devices(self) -> List[Any]:
        raise NotImplementedError

    def before_step(self, step: int) -> float:
        """Called at each step boundary.  May raise a FaultError and
        returns an in-step stall in seconds that the loop injects inside
        the watchdog window (0.0: none)."""
        return 0.0

    def rendezvous(self, generation: int, timeout_s: float) -> None:
        """Gate a recovery generation; raise RendezvousTimeout when the
        gang does not assemble within ``timeout_s``."""

    def peer_spot_crc(self, step: int, slice_index: int,
                      crc: int) -> Optional[int]:
        """Publish this rank's rotating param-slice crc and return a peer
        replica's crc for the same (step, slice), or None (no peer)."""
        return None

    # -- process groups (the port's part) ------------------------------------

    def rank_in(self, devices) -> Optional[int]:
        """This process's rank on a mesh over ``devices`` (None: not a
        member)."""
        return _world()[0] if len(devices) > 1 else 0

    def joins(self, devices) -> bool:
        """True when ``devices`` holds a rank outside the live group (a
        grow: the new rank holds no state)."""
        return False

    def regroup(self, generation: int, devices, step: int) -> bool:
        """Make the process group of ``devices`` for ``generation`` (a
        recovery at ``step``); True when this process is a member."""
        return True

    def park(self, generation: int):
        """Wait (a non-member) until a later generation takes this process
        back: (that generation's number, the step of its recovery), or
        None when the job finished."""
        raise RuntimeError("this cluster view never parks a rank")

    def finish(self, generation: int, final_step: int) -> None:
        """The job is done: release parked ranks."""

    def live_mesh(self, mesh):
        """``mesh`` made live over the current process group (a mesh of
        one rank is live already)."""
        if mesh.live:
            return mesh
        from ..parallel.specs import init_mesh

        return init_mesh(mesh.device_type or "cuda", tuple(mesh.shape.values()),
                         mesh.axis_names)


class LocalCluster(ClusterView):
    """A fixed world: the ranks of the ``torch.distributed`` world, or the
    one card; rendezvous is trivial."""

    def devices(self) -> List[Any]:
        return list(range(_world()[1]))

    def rendezvous(self, generation: int, timeout_s: float) -> None:
        return None


class StoreRendezvous:
    """Store-backed gang gate: every member barriers on
    ``resilience/gen<G>`` (``store.store_barrier``).  Plug into a
    ClusterView's ``rendezvous`` for the multi-process path."""

    def __init__(self, store, world_size: Optional[int] = None):
        self.store = store
        self.world_size = world_size

    def __call__(self, generation: int, timeout_s: float) -> None:
        from .store import store_barrier

        world = self.world_size or _world()[1]
        try:
            store_barrier(self.store, f"resilience/gen{generation}", world,
                          timeout=timeout_s)
        except TimeoutError as e:
            raise RendezvousTimeout(str(e)) from e


class StoreCluster(ClusterView):
    """A multi-process fleet over one ``torch.distributed`` store: the
    members are global ranks of the first world (``rank`` is this
    process's); ``members`` changes make new process groups.

    ``regroup(G, devices)``: the first surviving member publishes
    generation G's membership at ``resilience/gen<G>``; the old group is
    destroyed; the members start a new one on ``PrefixStore(
    "resilience/gen<G>/pg", store)`` with rank = their index in
    ``devices``; the others park (``park``: read ``resilience/gen<G+1>``,
    ``<G+2>``, ... until a generation lists them, or the ``done`` record
    of ``finish``)."""

    def __init__(self, store, rank: int, world_size: int,
                 device_type: str = "cuda", timeout_s: float = 300.0):
        self.store = store
        self.global_rank = int(rank)
        self.members = list(range(int(world_size)))
        self.device_type = device_type
        self.timeout_s = timeout_s
        self._rdzv = StoreRendezvous(store)

    def devices(self) -> List[int]:
        return list(self.members)

    def rendezvous(self, generation: int, timeout_s: float) -> None:
        self._rdzv(generation, timeout_s)

    def rank_in(self, devices) -> Optional[int]:
        devices = list(devices)
        return devices.index(self.global_rank) \
            if self.global_rank in devices else None

    def joins(self, devices) -> bool:
        return any(int(d) not in self.members for d in devices)

    def _publish(self, generation: int, record: Dict[str, Any]) -> None:
        self.store.set(f"resilience/gen{generation}",
                       json.dumps(record).encode())

    def regroup(self, generation: int, devices, step: int) -> bool:
        import torch.distributed as dist

        devices = [int(d) for d in devices]
        old = [int(d) for d in self.members]
        leader = min(d for d in devices if d in old) \
            if any(d in old for d in devices) else None
        if self.global_rank == leader:
            self._publish(generation, {"members": devices, "step": step})
        if dist.is_initialized():
            dist.destroy_process_group()
        self.members = devices
        if self.global_rank not in devices:
            return False
        self._init_group(generation, devices)
        return True

    def _init_group(self, generation: int, devices) -> None:
        import datetime

        import torch
        import torch.distributed as dist

        if self.device_type == "cuda":
            torch.cuda.set_device(self.global_rank % torch.cuda.device_count())
        # no device_id: an eagerly initialised NCCL group makes
        # init_device_mesh split its communicator (ncclCommSplit), which
        # crashed (SIGSEGV in split_group) in a group started after a
        # destroy_process_group on torch 2.11; a lazy group lets new_group
        # build each mesh axis's communicator
        dist.init_process_group(
            backend="nccl" if self.device_type == "cuda" else "gloo",
            store=dist.PrefixStore(f"resilience/gen{generation}/pg",
                                   self.store),
            rank=devices.index(self.global_rank), world_size=len(devices),
            timeout=datetime.timedelta(seconds=self.timeout_s))

    def park(self, generation: int):
        from .store import store_get

        g = generation + 1
        while True:
            raw = store_get(self.store, f"resilience/gen{g}", self.timeout_s)
            if raw is None:
                raise ResilienceExhausted(
                    f"rank {self.global_rank} parked past generation "
                    f"{generation}: no generation {g} within "
                    f"{self.timeout_s}s")
            rec = json.loads(raw.decode())
            if rec.get("done"):
                return None
            if self.global_rank in rec["members"]:
                self.members = list(rec["members"])
                self._init_group(g, self.members)
                return g, int(rec["step"])
            g += 1

    def finish(self, generation: int, final_step: int) -> None:
        if self.global_rank == min(self.members):
            self._publish(generation + 1, {"done": True,
                                           "final_step": final_step})

    def live_mesh(self, mesh):
        if mesh.live and mesh.size == 1:
            return mesh
        from ..parallel.specs import init_mesh

        return init_mesh(self.device_type, tuple(mesh.shape.values()),
                         mesh.axis_names)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


@dataclass
class RecoveryEvent:
    step: int                  # step the fault surfaced at
    fault: str
    resume_step: int           # where training re-entered
    steps_replayed: int
    restart_index: int
    rendezvous_attempts: int
    device_count: int          # post-recovery
    reshard_bytes: int         # live-state movement (0 = checkpoint path)
    checkpointed: bool         # drain-checkpoint happened (graceful)
    degraded_steps: List[int] = field(default_factory=list)


@dataclass
class ResilienceResult:
    state: Any
    losses: Dict[int, float]
    recoveries: List[RecoveryEvent]
    steps_run: int             # total step executions incl. replays
    final_step: int
    health: Optional[Dict[str, Any]] = None   # monitor.report() when armed
    parked: bool = False       # this rank ended outside the membership


def _planner_specs(specs):
    """The reshard planner's view of ``mesh_builder``'s second return: a
    dotted-path -> P dict passes through; a ``PartitionSchedule``'s
    at-rest rule (``reshard_spec``)."""
    if hasattr(specs, "reshard_spec"):
        return specs.reshard_spec
    return specs


def _live(cluster, mesh, specs):
    """(live mesh, specs over it): a schedule is re-derived over the live
    mesh."""
    live = cluster.live_mesh(mesh)
    if live is not mesh and hasattr(specs, "rederive"):
        specs = specs.rederive(live)
    return live, specs


def resilient_train_loop(*, mesh_builder: Callable,
                         init_fn: Callable,
                         step_builder: Callable,
                         data_fn: Callable[[int], Any],
                         num_steps: int,
                         config: ResilienceConfig,
                         cluster: Optional[ClusterView] = None,
                         sleep: Callable[[float], None] = time.sleep,
                         on_event: Optional[Callable[[str, Dict[str, Any]],
                                                     None]] = None
                         ) -> ResilienceResult:
    """Run ``num_steps`` training steps to completion through faults.

    - ``mesh_builder(devices) -> (mesh, specs)``: the mesh (abstract or
      live; the cluster makes it live) and the at-rest specs (dotted path
      -> P, or a ``PartitionSchedule``) for the current members; called at
      the start and after every recovery;
    - ``init_fn(mesh, specs) -> state``: fresh state placed per specs;
    - ``step_builder(mesh, specs) -> step_fn(state, batch) -> (loss,
      new_state)`` (with ``config.health``: ``step_fn(state, batch,
      health_gates=, lr_scale=) -> (loss, new_state, probe)``);
    - ``data_fn(step) -> batch``: deterministic per step (replays refetch
      the same batch).

    Checkpoints land every ``config.checkpoint_every`` steps and on
    graceful faults.  Losses are recorded per step; replayed steps
    overwrite (a correct resume makes them equal).  ``on_event(kind,
    info)`` sees each save (``"save"``: step, seconds, the manager's
    timings), each recovery (``"recovery"``) and each step (``"step"``)."""
    cluster = cluster or LocalCluster()
    rng = random.Random(config.seed)
    mgr = CheckpointManager(config.checkpoint_dir, keep=config.keep,
                            store=getattr(cluster, "store", None))
    elastic = ElasticManager(max_restart=config.max_restarts)
    note = on_event or (lambda kind, info: None)

    monitor = spot = None
    numeric_fault = FaultError
    if config.health is not None:
        from . import health as _health

        numeric_fault = _health.NumericFault
        monitor = _health.HealthMonitor(config.health)
        if config.health.spot_check_every > 0:
            spot = _health.ParamSpotChecker(
                config.health.spot_check_every,
                config.health.spot_check_slices)

    devices = cluster.devices()
    mesh, specs = _live(cluster, *mesh_builder(devices))
    state, start_step, _deg = _restore_or_init(mgr, mesh, specs, init_fn,
                                               config)
    step_fn = step_builder(mesh, specs)

    losses: Dict[int, float] = {}
    recoveries: List[RecoveryEvent] = []
    steps_run = 0
    step = start_step

    def save(cur: int) -> None:
        t0 = time.perf_counter()
        mgr.save(state, cur)
        note("save", {"step": cur, "s": time.perf_counter() - t0,
                      "timings": dict(mgr.timings.get(cur, {}))})

    def _consume(cur: int) -> int:
        """Advance past a consumed data offset; a boundary save is kept on
        every path (a skipped batch leaves the state unchanged since the
        last applied update)."""
        cur += 1
        if cur % config.checkpoint_every == 0 or cur == num_steps:
            save(cur)
        return cur

    while step < num_steps:
        try:
            if monitor is not None and monitor.is_quarantined(step):
                # an offset quarantined before a rollback is force-skipped
                # on replay: a deterministic replay must not re-poison
                monitor.note_forced_skip(step)
                step = _consume(step)
                continue
            stall = cluster.before_step(step) or 0.0
            batch = data_fn(step)
            t0 = time.perf_counter()
            with comm_watch(f"resilient_step[{step}]",
                            timeout_s=config.step_timeout_s or 0) as task:
                if stall:
                    # a hung or slow collective stalls inside the window,
                    # where the watchdog's scanner looks
                    sleep(stall)
                if monitor is not None:
                    loss, state, probe = step_fn(
                        state, batch,
                        health_gates=monitor.gates(step),
                        lr_scale=monitor.lr_scale(step))
                else:
                    loss, state = step_fn(state, batch)
                    probe = None
                loss = float(loss)          # blocks: the step really ran
            note("step", {"step": step, "loss": loss,
                          "s": time.perf_counter() - t0, "probe": probe})
            if task.timed_out:
                raise StepHang(
                    f"watchdog flagged step {step} after "
                    f"{task.elapsed():.2f}s > {task.timeout_s:.2f}s")
            if monitor is not None:
                verdict = monitor.observe(step, probe)
                if verdict == "rollback":
                    raise numeric_fault(
                        f"health ladder escalated to rollback at step "
                        f"{step} (see monitor.events)")
                if verdict != "ok":
                    # skip / backoff: the guard already made the update a
                    # no-op; consume the offset and move on
                    step = _consume(step)
                    continue
            if spot is not None and spot.due(step):
                sc = spot.check(state, step)
                spot.compare(sc, cluster.peer_spot_crc(
                    step, sc.slice_index, sc.crc))
            losses[step] = loss
            steps_run += 1
            step = _consume(step)
        except FaultError as fault:
            out = _recover(fault, step, state, mesh, specs, cluster, mgr,
                           elastic, config, rng, sleep, mesh_builder,
                           step_builder, init_fn, recoveries, note)
            if out is None:             # parked until the job finished
                return ResilienceResult(
                    state=None, losses=losses, recoveries=recoveries,
                    steps_run=steps_run, final_step=step, parked=True,
                    health=monitor.report() if monitor else None)
            state, step, mesh, specs, step_fn = out
            note("recovery", {"event": recoveries[-1]})
    cluster.finish(elastic.restart_count, step)
    return ResilienceResult(state=state, losses=losses,
                            recoveries=recoveries, steps_run=steps_run,
                            final_step=step,
                            health=(monitor.report()
                                    if monitor is not None else None))


def _restore_or_init(mgr, mesh, specs, init_fn, config):
    state, ck_step, degraded = mgr.restore_latest(
        mesh, _planner_specs(specs),
        max_transient_bytes=config.max_transient_bytes)
    if state is None:
        return init_fn(mesh, specs), 0, degraded
    return state, ck_step, degraded


def _recover(fault, step, state, mesh, specs, cluster, mgr, elastic,
             config, rng, sleep, mesh_builder, step_builder, init_fn,
             recoveries, note):
    """The detect -> ... -> resume pipeline of one fault: the loop's new
    (state, step, mesh, specs, step_fn), or None for a rank parked until
    the job finished."""
    from ..parallel.reshard import bind_mesh, plan_reshard

    if not elastic.register_failure():
        raise ResilienceExhausted(
            f"restart budget {elastic.max_restart} exhausted at step "
            f"{step} ({type(fault).__name__}: {fault})") from fault
    logger.warning("[resilience] step %d: %s (%s); gang restart %d/%d",
                   step, type(fault).__name__, fault,
                   elastic.restart_count, elastic.max_restart)

    # -- drain + checkpoint-or-reuse-last ------------------------------------
    mgr.drain()
    checkpointed = False
    if fault.state_intact:
        # persist the live state while the old ranks are still there
        t0 = time.perf_counter()
        mgr.save(state, step)
        note("save", {"step": step, "s": time.perf_counter() - t0,
                      "timings": dict(mgr.timings.get(step, {}))})
        checkpointed = True

    # -- re-rendezvous with retry/backoff ------------------------------------
    attempts = 0
    while True:
        try:
            cluster.rendezvous(elastic.restart_count,
                               config.rendezvous_timeout_s)
            break
        except RendezvousTimeout as e:
            attempts += 1
            if attempts >= config.rendezvous_attempts:
                raise ResilienceExhausted(
                    f"re-rendezvous failed {attempts} times after step "
                    f"{step}: {e}") from e
            delay = backoff_delay(config, attempts - 1, rng)
            logger.warning("[resilience] rendezvous attempt %d failed "
                           "(%s); backing off %.3fs", attempts, e, delay)
            sleep(delay)

    # -- re-derive the mesh from the (possibly changed) membership ----------
    devices = cluster.devices()
    new_mesh, new_specs = mesh_builder(devices)
    gen = elastic.restart_count
    joins = cluster.joins(devices)

    # -- reshard the live state / restore the checkpoint ---------------------
    reshard_bytes = 0
    degraded: list = []
    live_blocks = None
    if fault.state_intact and not joins:
        # the live reshard, over the old group before it is torn down:
        # resume moves bytes, not through disk, and replays nothing
        plan = plan_reshard(state, new_mesh, _planner_specs(new_specs),
                            max_transient_bytes=config.max_transient_bytes)
        live_blocks = plan.execute(state, rank=cluster.rank_in(devices))
        reshard_bytes = plan.moved_bytes
    del state
    member = cluster.regroup(gen, devices, step)
    if not member:
        woken = cluster.park(gen)
        if woken is None:
            return None
        elastic.restart_count, step = woken
        devices = cluster.devices()
        new_mesh, new_specs = mesh_builder(devices)
    new_mesh, new_specs = _live(cluster, new_mesh, new_specs)
    if live_blocks is not None and member:
        state, resume_step = bind_mesh(live_blocks, new_mesh), step
    else:
        state, resume_step, degraded = mgr.restore_latest(
            new_mesh, _planner_specs(new_specs),
            max_transient_bytes=config.max_transient_bytes)
        if fault.state_intact and member:
            # a grow: the grace window's checkpoint carried the state
            reshard_bytes = mgr.last_restore_moved_bytes
        if state is None:
            logger.warning("[resilience] no restorable checkpoint; "
                           "reinitializing from step 0")
            state, resume_step = init_fn(new_mesh, new_specs), 0

    step_fn = step_builder(new_mesh, new_specs)
    recoveries.append(RecoveryEvent(
        step=step, fault=type(fault).__name__, resume_step=resume_step,
        steps_replayed=step - resume_step,
        restart_index=elastic.restart_count,
        rendezvous_attempts=attempts + 1,
        device_count=len(devices), reshard_bytes=reshard_bytes,
        checkpointed=checkpointed, degraded_steps=degraded))
    logger.warning("[resilience] resumed at step %d on %d devices "
                   "(replaying %d steps)", resume_step, len(devices),
                   step - resume_step)
    return state, resume_step, new_mesh, new_specs, step_fn


__all__ = ["ClusterView", "FaultError", "LocalCluster", "Preemption",
           "RecoveryEvent", "RendezvousTimeout", "ReplicaFault",
           "ReplicaHung", "ReplicaKilled", "ReplicaPreempted",
           "ResilienceConfig", "ResilienceExhausted", "ResilienceResult",
           "ServingRecoveryEvent", "StepHang", "StoreCluster",
           "StoreRendezvous", "WorkerLost", "backoff_delay",
           "resilient_train_loop"]
