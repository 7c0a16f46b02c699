"""Fault-injection harness of the port's resilient train loop.

The port's copy of the training half of ``tests/fault_injection.py``:
``FakeCluster`` is a ``ClusterView`` whose schedule kills, preempts, hangs,
slows and rescales the job at step boundaries; the toy SGD problem and
``run_toy_loop`` drive ``paddle_tpu_torch.distributed.resilience.
resilient_train_loop`` end to end; ``NumericFaultEvent``,
``toy_numeric_data_fn``, the toy health step and ``run_toy_health_loop``
drive the health guardian; ``flip_bit`` corrupts a coded payload.  It
imports torch and the port only (the JAX twin stays in the test bodies).

At world size 1 ``FakeCluster`` is a one-process view.  Scale events run
in a gloo gang (``tests/torch_gang.py``): ``GangFakeCluster`` is the same
script over ``StoreCluster``, whose membership changes make new process
groups (ranks outside the membership park).

Fault kinds (``FaultEvent.kind``), as the JAX harness's:

- ``kill``: a gang member dies mid-step; in-memory state is lost and the
  recovery reuses the last complete checkpoint (WorkerLost);
- ``preempt``: advance notice; state intact, drain-checkpoint and live
  reshard (Preemption);
- ``scale``: a capacity change to ``device_count`` ranks, delivered as a
  graceful preemption: the loop re-derives the mesh and reshards onto it;
- ``hang``: the step stalls ``stall_s`` inside the watchdog window; past
  the step timeout the watchdog flags it (StepHang, checkpoint reuse);
- ``slow``: the same stall, meant to stay under the timeout: no recovery;
- ``sdc``: the peer replica's spot-check crc diverges at this step; the
  health guardian raises SDCError and rolls back.

Each event fires once (consumed at its step boundary), so the replay of the
same step after recovery runs clean.

The serving half (the port's copy of the JAX harness's): ``FakeReplica`` is
a fleet ``Replica`` whose script kills, preempts, hangs or slows its engine
step at its own step boundaries (a hang or slow stall sits inside the
watchdog window), ``OverloadBurst`` and ``run_fleet_trace`` drive scripted
traffic through a router, ``toy_llama`` is the port's toy Llama built from
the JAX toy's weights, and ``build_serving_fleet``/``build_disagg_fleet``
assemble routers over FakeReplicas on ``device`` (the CPU in the tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.distributed.resilience import (ClusterView, Preemption,
                                                     RendezvousTimeout,
                                                     StoreCluster, WorkerLost)
from paddle_tpu_torch.parallel.specs import Mesh, P, ShardedTensor


@dataclass
class FaultEvent:
    step: int
    kind: str                    # kill | preempt | scale | hang | slow | sdc
    device_count: Optional[int] = None   # for scale
    stall_s: float = 0.0                 # for hang/slow


class _Script:
    """The scripted schedule both cluster views share."""

    def _init_script(self, faults, rendezvous_failures):
        self._faults: Dict[int, List[FaultEvent]] = {}
        self._sdc_steps: set = set()
        for ev in faults:
            if ev.kind == "sdc":
                self._sdc_steps.add(ev.step)
                continue
            self._faults.setdefault(ev.step, []).append(ev)
        self._rendezvous_failures = rendezvous_failures
        self.rendezvous_log: List[int] = []
        self.fired: List[FaultEvent] = []
        self.spot_check_log: List[int] = []

    def before_step(self, step: int) -> float:
        stall = 0.0
        for ev in self._faults.pop(step, []):
            self.fired.append(ev)
            if ev.kind == "kill":
                raise WorkerLost(f"injected kill at step {step}")
            if ev.kind == "preempt":
                raise Preemption(f"injected preemption at step {step}")
            if ev.kind == "scale":
                assert ev.device_count, "scale event needs device_count"
                self.device_count = ev.device_count
                raise Preemption(f"injected scale to {ev.device_count} "
                                 f"devices at step {step}")
            if ev.kind in ("hang", "slow"):
                stall += ev.stall_s
                continue
            raise AssertionError(f"unknown fault kind {ev.kind!r}")
        return stall

    def _gate(self, generation: int) -> None:
        self.rendezvous_log.append(generation)
        if self._rendezvous_failures > 0:
            self._rendezvous_failures -= 1
            raise RendezvousTimeout(
                f"injected rendezvous failure (gen {generation})")

    def peer_spot_crc(self, step: int, slice_index: int, crc: int):
        """An agreeing peer, unless an ``sdc`` event makes it diverge at
        this step (once)."""
        self.spot_check_log.append(step)
        if step in self._sdc_steps:
            self._sdc_steps.discard(step)
            return (crc ^ 0x5DC5DC) & 0xFFFFFFFF
        return crc


class FakeCluster(_Script, ClusterView):
    """Scripted one-process fleet: the schedule of FaultEvents over a
    rank count (1: the one process), plus a number of rendezvous attempts
    that must fail."""

    def __init__(self, device_count: Optional[int] = None,
                 faults: List[FaultEvent] = (),
                 rendezvous_failures: int = 0):
        self.device_count = device_count or 1
        assert self.device_count == 1, "one process holds one rank"
        self._init_script(faults, rendezvous_failures)

    def devices(self):
        return list(range(self.device_count))

    def rendezvous(self, generation: int, timeout_s: float) -> None:
        self._gate(generation)


class GangFakeCluster(_Script, StoreCluster):
    """The scripted schedule over a multi-process ``StoreCluster``: a
    scale event sets the membership to the first ``device_count`` global
    ranks."""

    def __init__(self, store, rank: int, world_size: int,
                 device_count: Optional[int] = None,
                 faults: List[FaultEvent] = (),
                 rendezvous_failures: int = 0, device_type: str = "cpu",
                 timeout_s: float = 120.0):
        StoreCluster.__init__(self, store, rank, world_size,
                              device_type=device_type, timeout_s=timeout_s)
        self.device_count = device_count or world_size
        self.members = list(range(self.device_count))
        self._init_script(faults, rendezvous_failures)

    def devices(self):
        return list(range(self.device_count))

    def rendezvous(self, generation: int, timeout_s: float) -> None:
        self._gate(generation)
        StoreCluster.rendezvous(self, generation, timeout_s)

    def park(self, generation: int):
        """A parked rank wakes into the generation's membership; the events
        the members consumed while it was parked are gone."""
        woken = StoreCluster.park(self, generation)
        if woken is not None:
            self.device_count = len(self.members)
            for s in [s for s in self._faults if s <= woken[1]]:
                del self._faults[s]
        return woken


# ---------------------------------------------------------------------------
# a deterministic toy training problem
# ---------------------------------------------------------------------------
#
# SGD with momentum on sum((w - target)^2): elementwise math (bit-identical
# under any placement), a scalar loss, a closed trajectory.


def toy_mesh_builder(devices):
    """A 1-D dp mesh over the members; params sharded on dim 0."""
    n = max(1, len(devices))
    mesh = Mesh((n,), ("dp",), device_type="cpu")
    return mesh, {"w": P("dp"), "opt.m": P("dp")}


def toy_init(mesh, specs):
    from paddle_tpu_torch.parallel.reshard import plan_reshard

    w = torch.arange(64 * 4, dtype=torch.float32).reshape(64, 4) / 100.0
    state = {"w": w, "opt": {"m": torch.zeros(64, 4)}, "lr": 0.05}
    return plan_reshard(state, mesh, specs).execute(state)


def toy_target(step: int) -> np.ndarray:
    rng = np.random.RandomState(1000 + step)
    return rng.rand(64, 4).astype(np.float32)


def _local(x):
    return x.local if isinstance(x, ShardedTensor) else x


def _wrap(like, t):
    return like.with_local(t) if isinstance(like, ShardedTensor) else t


def _loss_sum(x, like):
    """sum over the global tensor: the local sum, all-reduced over the
    ranks that hold distinct blocks."""
    s = x.sum()
    if isinstance(like, ShardedTensor) and like.mesh.size > 1:
        from paddle_tpu_torch.parallel import compat

        s = compat.all_reduce_raw(s, "dp", like.mesh)
    return s


def _target_block(state, batch):
    t = torch.from_numpy(np.ascontiguousarray(batch))
    w = state["w"]
    return w.shard_like(t) if isinstance(w, ShardedTensor) else t


def _sgd(w, m, lr, target):
    grad = 2.0 * (w - target)
    m2 = 0.9 * m + grad
    w2 = w - lr * m2
    return grad, w2, m2


def toy_step_builder(mesh, specs):
    def step_fn(state, batch):
        target = _target_block(state, batch)
        lr = torch.tensor(state["lr"], dtype=torch.float32)
        w, m = _local(state["w"]), _local(state["opt"]["m"])
        _, w2, m2 = _sgd(w, m, lr, target)
        loss = _loss_sum((w2 - target) ** 2, state["w"])
        return loss, {"w": _wrap(state["w"], w2),
                      "opt": {"m": _wrap(state["opt"]["m"], m2)},
                      "lr": state["lr"]}

    return step_fn


def run_toy_loop(tmpdir: str, num_steps: int = 12, *,
                 faults: List[FaultEvent] = (),
                 device_count: Optional[int] = None,
                 rendezvous_failures: int = 0,
                 checkpoint_every: int = 4,
                 step_timeout_s: float = 0.0,
                 max_restarts: int = 3,
                 sleep=None, seed: int = 0, cluster=None):
    """One resilient run of the toy problem: (result, cluster)."""
    from paddle_tpu_torch.distributed.resilience import (ResilienceConfig,
                                                         resilient_train_loop)

    if cluster is None:
        cluster = FakeCluster(device_count=device_count, faults=list(faults),
                              rendezvous_failures=rendezvous_failures)
    cfg = ResilienceConfig(
        checkpoint_dir=tmpdir, checkpoint_every=checkpoint_every,
        max_restarts=max_restarts, step_timeout_s=step_timeout_s,
        backoff_base_s=0.01, backoff_max_s=0.05, seed=seed)
    kw = {} if sleep is None else {"sleep": sleep}
    res = resilient_train_loop(
        mesh_builder=toy_mesh_builder, init_fn=toy_init,
        step_builder=toy_step_builder, data_fn=toy_target,
        num_steps=num_steps, config=cfg, cluster=cluster, **kw)
    return res, cluster


# ---------------------------------------------------------------------------
# numeric faults (the health guardian)
# ---------------------------------------------------------------------------


@dataclass
class NumericFaultEvent:
    offset: int                  # data offset (== step) to poison
    kind: str                    # nan | inf | spike
    scale: float = 1e4           # for spike


def toy_numeric_data_fn(faults: List[NumericFaultEvent]):
    """``data_fn`` over ``toy_target`` with scripted poison: replaying an
    offset reproduces the same bad batch."""
    evs: Dict[int, NumericFaultEvent] = {e.offset: e for e in faults}

    def data_fn(step: int) -> np.ndarray:
        t = toy_target(step)
        ev = evs.get(step)
        if ev is None:
            return t
        t = t.copy()
        if ev.kind == "nan":
            t[0, 0] = np.nan
        elif ev.kind == "inf":
            t[0, 0] = np.inf
        elif ev.kind == "spike":
            t *= ev.scale
        else:
            raise AssertionError(f"unknown numeric fault {ev.kind!r}")
        return t

    return data_fn


def toy_health_step_builder(mesh, specs):
    """The toy step with the fused probe and the guard: ``step_fn(state,
    batch, health_gates=..., lr_scale=...) -> (loss, new_state, probe)``;
    with open gates and no fault the plain toy step's values."""
    from paddle_tpu_torch.distributed import health as _health

    def step_fn(state, batch, health_gates=None, lr_scale=1.0):
        target = _target_block(state, batch)
        lr = torch.tensor(np.float32(state["lr"] * float(lr_scale)))
        w_at, m_at = state["w"], state["opt"]["m"]
        grad, w2, m2 = _sgd(_local(w_at), _local(m_at), lr, target)
        loss = _loss_sum((w2 - target) ** 2, w_at)
        new_w, new_m = _wrap(w_at, w2), _wrap(m_at, m2)
        probe = _health.make_probe(
            loss, {"w": _wrap(w_at, grad)}, {"w": w_at, "m": m_at},
            {"w": new_w, "m": new_m},
            _health.normalize_gates(health_gates), buckets=4)
        new_w = _health.guard_tree(probe["ok"], new_w, w_at)
        new_m = _health.guard_tree(probe["ok"], new_m, m_at)
        return loss, {"w": new_w, "opt": {"m": new_m},
                      "lr": state["lr"]}, probe

    return step_fn


def run_toy_health_loop(tmpdir: str, num_steps: int = 16, *,
                        numeric_faults: List[NumericFaultEvent] = (),
                        faults: List[FaultEvent] = (),
                        health=None, checkpoint_every: int = 4,
                        max_restarts: int = 4, seed: int = 0):
    """One health-armed resilient run of the toy problem: (result,
    cluster)."""
    from paddle_tpu_torch.distributed.health import HealthConfig
    from paddle_tpu_torch.distributed.resilience import (ResilienceConfig,
                                                         resilient_train_loop)

    cluster = FakeCluster(faults=list(faults))
    cfg = ResilienceConfig(
        checkpoint_dir=tmpdir, checkpoint_every=checkpoint_every,
        max_restarts=max_restarts, backoff_base_s=0.01,
        backoff_max_s=0.05, seed=seed,
        health=health or HealthConfig(warmup_steps=3))
    res = resilient_train_loop(
        mesh_builder=toy_mesh_builder, init_fn=toy_init,
        step_builder=toy_health_step_builder,
        data_fn=toy_numeric_data_fn(list(numeric_faults)),
        num_steps=num_steps, config=cfg, cluster=cluster)
    return res, cluster


def flip_bit(packed: np.ndarray, byte_index: int = 0,
             bit: int = 3) -> np.ndarray:
    """Flip one bit of a coded wire payload."""
    out = np.array(packed)
    flat = out.reshape(-1)
    flat[byte_index] ^= np.int8(1 << bit)
    return out


# ===========================================================================
# the gloo gangs (tests/torch_gang.py): ranks import torch and the port only
# ===========================================================================

import json  # noqa: E402
import os  # noqa: E402

#: reshard/checkpoint pairs on a world of 4: name -> (mesh A (shape, names,
#: specs), mesh B (shape, names, specs)); tests/test_reshard.py's PAIRS cut
#: to 4 ranks (B of 2 ranks: an elastic shrink, the host route)
RESHARD_PAIRS = {
    "dp_to_sharding3": (((4,), ("dp",), {}),
                        ((4,), ("sharding",),
                         {"embed.weight": P("sharding"),
                          "layer.q_proj": P("sharding"),
                          "layer.down_proj": P("sharding"),
                          "norm.weight": P("sharding"),
                          "opt.m.embed": P("sharding"),
                          "bf.w": P("sharding")})),
    "sharding3_to_tp": (((2, 2), ("sharding", "mp"),
                         {"embed.weight": P("sharding"),
                          "layer.q_proj": P("sharding"),
                          "opt.m.embed": P("sharding"),
                          "bf.w": P(None, "mp")}),
                        ((2, 2), ("sharding", "mp"),
                         {"embed.weight": P(None, "mp"),
                          "layer.q_proj": P(None, "mp"),
                          "opt.m.embed": P(None, "mp"),
                          "bf.w": P("sharding", "mp")})),
    "shrink_4_to_2": (((2, 2), ("dp", "sharding"),
                       {"embed.weight": P("sharding"),
                        "opt.m.embed": P("sharding"),
                        "bf.w": P(("dp", "sharding"))}),
                      ((2,), ("sharding",),
                       {"embed.weight": P("sharding"),
                        "opt.m.embed": P("sharding"),
                        "bf.w": P(None, "sharding")})),
}


def pair_state():
    """A small llama-ish flat state dict (numpy fp32 values; ``bf.w`` is
    cast to bf16 on both sides) and a Python scalar."""
    rng = np.random.RandomState(0)
    return {
        "embed.weight": rng.rand(64, 16).astype(np.float32),
        "layer.q_proj": rng.rand(16, 16).astype(np.float32),
        "layer.down_proj": rng.rand(32, 16).astype(np.float32),
        "norm.weight": rng.rand(16).astype(np.float32),
        "opt.m.embed": rng.rand(64, 16).astype(np.float32),
        "bf.w": rng.randn(16, 8).astype(np.float32),
        "step": 7,
    }


def _place(host, mesh, specs):
    from paddle_tpu_torch.parallel.reshard import fit_spec

    out = {}
    for k, v in host.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(v.copy())
        if k.startswith("bf."):
            t = t.to(torch.bfloat16)
        out[k] = ShardedTensor.from_global(
            t, fit_spec(specs.get(k, P()), mesh, v.shape), mesh)
    return out


def _blocks(tree, mesh, rank):
    """{key: (start, block as numpy)} of this rank's ShardedTensor blocks
    (bf16 as its fp32 values)."""
    from paddle_tpu_torch.parallel.reshard import block_slices

    out = {}
    for k, v in tree.items():
        if isinstance(v, ShardedTensor) and rank is not None:
            box = block_slices(v.spec, v.shape, mesh, rank)
            out[k] = ([s.start for s in box], v.local.float().numpy())
    return out


def _same(a, b) -> bool:
    return all(torch.equal(a[k].local, b[k].local) for k in a
               if isinstance(a[k], ShardedTensor))


def _torn_write_save(rank, root, state):
    """A checkpoint committed at a path, then a save over it in which
    rank 1's blocks reach the disk with one byte flipped after their crc
    was taken (a fault on that rank's write path): what each rank's save
    raised, and whether the first checkpoint still verifies with its
    values."""
    import importlib

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointCorruptError, restore_arrays, save_state_dict)

    S = importlib.import_module(
        "paddle_tpu_torch.distributed.checkpoint.save_state_dict")
    path = os.path.join(root, "ckpt_torn")
    save_state_dict(state, path)
    dist.barrier()
    before = restore_arrays(path)
    for v in state.values():
        if isinstance(v, ShardedTensor):
            v.local.add_(1)
    write = S._write_file

    def torn(file, arr):
        write(file, arr)
        with open(file, "r+b") as f:
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 1]))

    if rank == 1:
        S._write_file = torn
    try:
        save_state_dict(state, path)
        raised = None
    except CheckpointCorruptError as e:
        raised = str(e)
    finally:
        S._write_file = write
    dist.barrier()
    after = restore_arrays(path)
    return {"raised": raised,
            "kept": all(torch.equal(before[k], after[k]) if
                        isinstance(before[k], torch.Tensor)
                        else before[k] == after[k] for k in before)}


def reshard_gang_rank(rank, world, root):
    """One gloo rank of the reshard/checkpoint gang: every pair of
    RESHARD_PAIRS reshards live A -> B (and back where B spans the
    world), saves on A and restores on B, and one async save is mutated
    right after it returns."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                         restore_arrays,
                                                         wait_save)
    from paddle_tpu_torch.parallel.reshard import plan_reshard, reshard
    from paddle_tpu_torch.parallel.specs import init_mesh

    from torch_gang import file_store

    store = file_store(root, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    host = pair_state()
    report = {}
    blocks = {}
    for name, ((sa, na, spa), (sb, nb, spb)) in RESHARD_PAIRS.items():
        mesh_a = init_mesh("cpu", sa, na)
        state_a = _place(host, mesh_a, spa)
        live_b = int(np.prod(sb)) == world
        mesh_b = init_mesh("cpu", sb, nb) if live_b \
            else Mesh(sb, nb, device_type="cpu")
        rank_b = rank if rank < mesh_b.size else None
        plan = plan_reshard(state_a, mesh_b, spb)
        out = plan.execute(state_a, rank=rank_b)
        rec = {"summary": plan.summary(),
               "routes": {lp.path: lp.route for lp in plan.leaf_plans}}
        for k, (start, arr) in _blocks(out, mesh_b, rank_b).items():
            blocks[f"{name}/{k}/{rank}"] = arr
            rec.setdefault("starts", {})[k] = start
        if live_b:
            back, _ = reshard(out, mesh_a, spa)
            rec["round_trip"] = _same(back, state_a)
            rec["noop_after"] = plan_reshard(back, mesh_a, spa).moved_bytes
        mgr = CheckpointManager(os.path.join(root, f"ckpt_{name}"), keep=1)
        mgr.save(state_a, 3)
        loaded, step, degraded = mgr.restore_latest(mesh_b, spb, rank=rank_b)
        rec["restore"] = [step, degraded]
        rec["load_equals_direct"] = rank_b is None or all(
            torch.equal(loaded[k].local, out[k].local) for k in out
            if isinstance(out[k], ShardedTensor))
        report[name] = rec
    # an async save over the ranks (barriers on the store), the state
    # updated in place as soon as save returns
    mesh = init_mesh("cpu", (2, 2), ("dp", "sharding"))
    state = _place(host, mesh, RESHARD_PAIRS["shrink_4_to_2"][0][2])
    mgr = CheckpointManager(os.path.join(root, "ckpt_async"), keep=1,
                            store=store)
    mgr.save(state, 5, async_save=True)
    for v in state.values():
        if isinstance(v, ShardedTensor):
            v.local.add_(1)
    wait_save()
    dist.barrier()
    got = restore_arrays(mgr.step_path(5))
    report["async"] = all(
        torch.equal(got[k].float(), torch.from_numpy(v).to(
            torch.bfloat16).float() if k.startswith("bf.")
            else torch.from_numpy(v))
        for k, v in host.items() if isinstance(v, np.ndarray))
    report["torn"] = _torn_write_save(rank, root, state)
    np.savez(os.path.join(root, f"blocks.{rank}.npz"), **blocks)
    with open(os.path.join(root, f"report.{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


#: the scale script of the resilience gang: 4 -> 2 ranks by preemption,
#: a kill on 2, back to 4 by preemption (the first 4 of the gang's ranks)
GANG_FAULTS = [("scale", 5, 2), ("kill", 7, None), ("scale", 10, 4)]
GANG_STEPS = 13


def resilience_gang_rank(rank, world, root):
    """One gloo rank of the resilience gang: the toy loop through
    GANG_FAULTS (a shrink resharded live over the old group, a kill
    restored from the world-4 checkpoint onto the 2-rank mesh, a grow
    restored by reshard-on-load), its result as JSON."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from torch_gang import file_store

    store = file_store(root, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    faults = [FaultEvent(step=s, kind=k, device_count=n)
              for k, s, n in GANG_FAULTS]
    cluster = GangFakeCluster(store, rank, world, faults=faults)
    res, _ = run_toy_loop(os.path.join(root, "ckpt"), GANG_STEPS,
                          checkpoint_every=4, cluster=cluster)
    out = {"losses": {str(k): v for k, v in res.losses.items()},
           "recoveries": [e.__dict__ for e in res.recoveries],
           "final_step": res.final_step, "parked": res.parked}
    if not res.parked:
        w = res.state["w"]
        out["w"] = w.full().tolist() if isinstance(w, ShardedTensor) \
            else w.tolist()
    with open(os.path.join(root, f"res.{rank}.json"), "w") as f:
        json.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


# ===========================================================================
# a hung collective: the watchdog's abort (two processes)
# ===========================================================================


def hung_collective_rank(rank: int, store_path: str, backend: str,
                         timeout_s: float) -> None:
    """One rank of a two-rank group: both ranks run one all_reduce, then
    rank 1 sleeps and never joins rank 0's second one.  Rank 0 runs it
    under ``comm_watch`` (with FLAGS_comm_abort_on_timeout set by the
    caller), so the watchdog aborts the group and exits with 124."""
    import time

    import torch.distributed as dist

    from paddle_tpu_torch.distributed.watchdog import comm_watch

    dev = torch.device("cpu")
    if backend == "nccl":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    x = torch.ones(4, device=dev)
    dist.all_reduce(x)
    float(x.sum())
    if rank == 1:
        time.sleep(600)
        return
    with comm_watch("hung_all_reduce", timeout_s=timeout_s):
        dist.all_reduce(x)
        float(x.sum())          # a hung NCCL all_reduce blocks here
    print("the hung all_reduce returned", flush=True)


def run_hung_collective(tmpdir: str, backend: str, timeout_s: float = 1.0,
                        limit_s: float = 180.0):
    """Run the two ranks of ``hung_collective_rank`` as processes and
    wait for rank 0: (its exit code, its stdout, its stderr).  Rank 1 is
    killed."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, FLAGS_comm_abort_on_timeout="1",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [here, os.path.dirname(here)] + ([env["PYTHONPATH"]]
                                         if env.get("PYTHONPATH") else []))
    code = ("import sys; from torch_fault_injection import "
            "hung_collective_rank as f; "
            "f(int(sys.argv[1]), sys.argv[2], sys.argv[3], "
            "float(sys.argv[4]))")
    store = os.path.join(tmpdir, "hung_store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), store, backend, str(timeout_s)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        out, err = procs[0].communicate(timeout=limit_s)
        return procs[0].returncode, out, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()


# ---------------------------------------------------------------------------
# the serving half: scripted replicas, traffic bursts, fleets
# ---------------------------------------------------------------------------
#
# ``kill`` raises before the engine step (tokens since the router's last
# harvest are lost; the router replays them from its committed prefix),
# ``preempt`` is the advance notice, ``hang``/``slow`` stall inside the
# watchdog window (past ``step_timeout_s`` the scanner flags the step and
# the replica raises ReplicaHung; under it the stall rides through).

import time as _time

from paddle_tpu_torch.distributed.resilience import (ReplicaKilled,
                                                     ReplicaPreempted)
from paddle_tpu_torch.inference.fleet import (FleetConfig, FleetRouter,
                                              OverloadRejected, Replica,
                                              ReplicaSet, RouterConfig)

TOY_LLAMA = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2,
                 inter=64, max_pos=128)
FLEET_ENGINE = dict(max_slots=2, num_pages=33, page_size=16,
                    max_seq_len=128, prefill_token_budget=16,
                    enable_prefix_cache=True)


@dataclass
class ReplicaFaultEvent:
    step: int                    # the replica's own completed-step count
    kind: str                    # kill | preempt | hang | slow
    stall_s: float = 0.0         # for hang/slow


@dataclass
class OverloadBurst:
    """``n_requests`` uniform requests submitted per router tick for
    ``duration`` ticks: sustained pressure that walks the ladder."""

    tick: int
    n_requests: int
    duration: int = 1
    prompt_len: int = 24
    max_new_tokens: int = 4


class FakeReplica(Replica):
    """A fleet replica with a fault script (see the section comment)."""

    def __init__(self, replica_id, engine_factory, step_timeout_s=0.0,
                 script=(), sleep=_time.sleep):
        super().__init__(replica_id, engine_factory,
                         step_timeout_s=step_timeout_s)
        self._script: Dict[int, List[ReplicaFaultEvent]] = {}
        for ev in script:
            self._script.setdefault(ev.step, []).append(ev)
        self._sleep = sleep
        self.fired: List[ReplicaFaultEvent] = []

    def _engine_step(self):
        stall = 0.0
        for ev in self._script.pop(self.steps, []):
            self.fired.append(ev)
            if ev.kind == "kill":
                raise ReplicaKilled(
                    f"injected kill at replica step {self.steps}")
            if ev.kind == "preempt":
                raise ReplicaPreempted(
                    f"injected preemption at replica step {self.steps}")
            if ev.kind in ("hang", "slow"):
                stall += ev.stall_s
                continue
            raise AssertionError(f"unknown replica fault kind {ev.kind!r}")
        if stall:
            self._sleep(stall)        # inside Replica.step's watch window
        return self.engine.step()


def toy_llama(jax_state, device="cpu"):
    """The port's twin of the JAX harness's toy Llama: (cfg, model, host
    params), the model on ``device`` and the params as host numpy arrays,
    built from the JAX toy's ``functional_state()`` (host numpy) through
    ``params_from_jax``, so a replica's delivery moves real bytes."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         params_from_jax)

    cfg = LlamaConfig.debug(**TOY_LLAMA)
    params = params_from_jax(jax_state, device)
    model = LlamaForCausalLM(cfg, device=device).load_functional_state(params)
    return cfg, model, {k: v.cpu().numpy() for k, v in params.items()}


def _replica_factory(scripts, sleep):
    def make(rid, engine_factory, step_timeout_s=0.0):
        return FakeReplica(rid, engine_factory,
                           step_timeout_s=step_timeout_s,
                           script=scripts.get(rid, ()), sleep=sleep)

    return make


def build_serving_fleet(cfg, params_host, *, target=2, scripts=None,
                        step_timeout_s=0.0, engine_kwargs=None,
                        router_cfg=None, clock=None, autoscale=None,
                        max_transient_bytes=64 << 20, sleep=_time.sleep,
                        device=None, delivery_codec=None):
    """A FleetRouter over FakeReplicas on ``device``.  ``scripts`` maps a
    replica id (spawn order, replacements continuing the sequence) to its
    ReplicaFaultEvents; ``engine_kwargs`` override the toy engine geometry
    (``self_draft=True``: the replica's own weights as the draft)."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    ekw = dict(FLEET_ENGINE)
    ekw.update(engine_kwargs or {})

    def engine_factory(params):
        kw = dict(ekw)
        if kw.pop("self_draft", False):
            kw["draft_params"] = params
        return ContinuousBatchingEngine(cfg, params, device=device, **kw)

    rs = ReplicaSet(
        params_host, engine_factory,
        FleetConfig(target_replicas=target, step_timeout_s=step_timeout_s,
                    max_transient_bytes=max_transient_bytes,
                    delivery_codec=delivery_codec),
        replica_factory=_replica_factory(scripts or {}, sleep),
        device=device)
    kw = {} if clock is None else {"clock": clock}
    if autoscale is not None:
        kw["autoscale"] = autoscale
    router = FleetRouter(rs, router_cfg
                         or RouterConfig(admission_token_cap=64), **kw)
    return router, rs


def build_disagg_fleet(cfg, params_host, *, prefill=1, decode=1,
                       unified=0, scripts=None, step_timeout_s=0.0,
                       engine_kwargs=None, router_cfg=None, clock=None,
                       cache_dtype=None, host_tier_pages=0,
                       autoscale=None, handoff_codec=None,
                       max_transient_bytes=64 << 20, sleep=_time.sleep,
                       device=None):
    """A DisaggRouter over FakeReplicas on ``device``: ``prefill``
    prompt-only replicas, ``decode`` full replicas fed by KV handoff,
    optional ``unified`` fallbacks.  Spawn order follows the pool map
    (prefill ids first, then decode, then unified)."""
    from paddle_tpu_torch.inference.disagg import (AutoscaleConfig,
                                                   DisaggRouter,
                                                   KVHandoffPlanner)
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    ekw = dict(FLEET_ENGINE)
    ekw.update(engine_kwargs or {})
    if cache_dtype is not None:
        ekw["cache_dtype"] = cache_dtype

    def decode_factory(params):
        return ContinuousBatchingEngine(cfg, params, device=device, **ekw)

    def prefill_factory(params):
        return ContinuousBatchingEngine(
            cfg, params, prefill_only=True,
            host_tier_pages=host_tier_pages, device=device, **ekw)

    pool_targets = {"prefill": prefill, "decode": decode}
    if unified:
        pool_targets["unified"] = unified
    rs = ReplicaSet(
        params_host, decode_factory,
        FleetConfig(pool_targets=pool_targets,
                    step_timeout_s=step_timeout_s,
                    max_transient_bytes=max_transient_bytes),
        engine_factories={"prefill": prefill_factory,
                          "decode": decode_factory,
                          "unified": decode_factory},
        replica_factory=_replica_factory(scripts or {}, sleep),
        device=device)
    planner = KVHandoffPlanner(codec=handoff_codec, device=device)
    kw = {} if clock is None else {"clock": clock}
    router = DisaggRouter(
        rs, router_cfg or RouterConfig(admission_token_cap=64),
        planner=planner,
        autoscale=autoscale or AutoscaleConfig(enabled=False), **kw)
    return router, rs


def run_fleet_trace(router, requests, bursts=(), *, seed=0,
                    max_iters=2000, vocab=64):
    """Deterministic trace runner: ``requests`` is a list of (tick,
    prompt, max_new_tokens) submitted at their tick, ``bursts`` expand into
    uniform submissions; rejected submissions (the ladder's stage 3) are
    counted, never retried.  Returns per-token latency samples, the
    rejection count and the submitted rids."""
    rng = np.random.default_rng(seed)
    by_tick: Dict[int, list] = {}
    for t, prompt, mnew in requests:
        by_tick.setdefault(int(t), []).append((prompt, mnew))
    burst_by_tick: Dict[int, list] = {}
    for b in bursts:
        for t in range(b.tick, b.tick + b.duration):
            burst_by_tick.setdefault(t, []).append(b)
    submitted, rejected, lat = [], 0, []
    tick = 0
    while True:
        for prompt, mnew in by_tick.pop(tick, []):
            try:
                submitted.append((router.submit(prompt,
                                                max_new_tokens=mnew),
                                  prompt, mnew))
            except OverloadRejected:
                rejected += 1
        for b in burst_by_tick.pop(tick, []):
            for _ in range(b.n_requests):
                p = rng.integers(1, vocab,
                                 (b.prompt_len,)).astype(np.int32)
                try:
                    submitted.append((router.submit(
                        p, max_new_tokens=b.max_new_tokens), p,
                        b.max_new_tokens))
                except OverloadRejected:
                    rejected += 1
        t0 = _time.perf_counter()
        produced = router.step()
        dt = _time.perf_counter() - t0
        if produced:
            lat.extend([dt / produced] * produced)
        tick += 1
        if not by_tick and not burst_by_tick and not router.pending():
            break
        if tick > max_iters:
            raise RuntimeError("fleet trace did not drain")
    return {"rids": [s[0] for s in submitted], "submitted": submitted,
            "rejected": rejected, "per_token_lat": lat, "ticks": tick}
