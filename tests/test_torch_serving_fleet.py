"""The port's serving fleet (paddle_tpu_torch/inference/fleet.py) against
the JAX package's (paddle_tpu/inference/fleet.py) on the CPU.

Every tier-1 leg of tests/test_serving_fleet.py runs as one script
through both fleets: the JAX toy Llama of the JAX harness
(tests/fault_injection.py) and its port twin (the same weights through
``params_from_jax``, tests/torch_fault_injection.py), both fp32 on the CPU.
Each leg returns a summary, and the port's equals JAX's: every request's
tokens, every ``ServingRecoveryEvent`` field but the wall time, the replica
set's telemetry (plans, deliveries, spawns, removals, deaths), the
router's (submissions, completions, rejections, retries, migrations, the
ladder log) and the affinity pins.  The port's tokens also equal the port's
own unfaulted greedy ``generate``.  Where JAX's leg prices the delivery
plan with the Graph Doctor (``check_delivery_budget``), the port's doctor
gives the same verdict.

Then the port's own legs: the default one-rank mesh is the card (it raises
without one), a dead replica's pools and weights are released at its
reap, a host-sourced delivery gives every replica its own weights, and the
coded delivery (``FleetConfig.delivery_codec``) stages exactly
``plan_wire_bytes``' wire bytes and decodes where the weights land, bit
for bit as a CPU decode of the same bytes, and bit for bit as JAX's
``decode_jit``.
"""

import dataclasses
import os
import sys
import time
import weakref

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import fault_injection as J  # noqa: E402
import torch_fault_injection as T  # noqa: E402
from paddle_tpu_torch.inference import fleet as tfleet  # noqa: E402

# the fault trace's heartbeat: the step timeout is STEP_TIMEOUT_X times the
# slowest measured replica step of either side (at least JAX's 0.3 s), the
# hang HANG_STALL_X timeouts (at least JAX's 0.8 s)
STEP_TIMEOUT_X = 8.0
HANG_STALL_X = 3.0


@dataclasses.dataclass
class Side:
    """One fleet implementation and its toy model."""

    name: str
    H: object                    # the fault harness module
    fleet: object                # the fleet module
    cfg: object
    model: object
    params: dict                 # host numpy weights
    kw: dict                     # the harness builders' device argument

    def build(self, **kw):
        return self.H.build_serving_fleet(self.cfg, self.params,
                                          **self.kw, **kw)

    def event(self, **kw):
        return self.H.ReplicaFaultEvent(**kw)

    def engine_factory(self):
        """The harness's toy engine over delivered weights."""
        if self.name == "jax":
            from paddle_tpu.inference.serving import \
                ContinuousBatchingEngine as E
        else:
            from paddle_tpu_torch.inference.serving import \
                ContinuousBatchingEngine as E
        return lambda p: E(self.cfg, p, **T.FLEET_ENGINE, **self.kw)


@pytest.fixture(scope="module")
def sides():
    import paddle_tpu.inference.fleet as jfleet

    jcfg, jmodel, jparams = J.toy_llama()
    tcfg, tmodel, tparams = T.toy_llama(jparams)
    return {"jax": Side("jax", J, jfleet, jcfg, jmodel, jparams, {}),
            "torch": Side("torch", T, tfleet, tcfg, tmodel, tparams,
                          {"device": "cpu"})}


def _port_refs(side, prompts, n):
    """The port's unfaulted greedy streams (``generate``)."""
    from paddle_tpu_torch.models.generation import generate

    out = []
    for p in prompts:
        full = generate(side.model, p[None], max_new_tokens=n,
                        do_sample=False)
        out.append(full[0, len(p):].tolist())
    return out


def _prompts(rng, lens, shared=None):
    out = []
    for n in lens:
        body = rng.integers(1, 64, (n,)).astype(np.int32)
        out.append(np.concatenate([shared, body])
                   if shared is not None else body)
    return out


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _summary(router, rs, out=None, **extra):
    """What the two fleets must agree on after a leg."""
    t = router.telemetry
    return dict(
        tokens={int(k): np.asarray(v).tolist()
                for k, v in (out if out is not None
                             else router.results()).items()},
        recoveries=[{k: v for k, v in dataclasses.asdict(ev).items()
                     if k != "wall_s"} for ev in t["recoveries"]],
        set_telemetry={k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in rs.telemetry.items()},
        router={k: t[k] for k in ("submitted", "completed", "rejected",
                                  "retries", "migrations",
                                  "timeouts_failed")},
        ladder_log=list(t["ladder_log"]),
        autoscale_log=list(t.get("autoscale_log", [])),
        affinity=dict(router._affinity),
        replicas=sorted((r.id, r.state, r.role)
                        for r in rs.replicas.values()),
        **extra)


def _both(sides, leg):
    """The leg through both fleets: (port summary, JAX summary)."""
    return leg(sides["torch"]), leg(sides["jax"])


def _check_refs(side, got, prompts_by_rid, n=None):
    """The port's fleet tokens equal its own unfaulted run's."""
    for rid, (prompt, mnew) in prompts_by_rid.items():
        ref = _port_refs(side, [prompt], mnew if n is None else n)[0]
        assert got["tokens"][rid] == ref[:len(got["tokens"][rid])], rid
        assert len(got["tokens"][rid]) == (mnew if n is None else n)


# =====================================================================
# fleet manager: lifecycle and weight delivery
# =====================================================================


def test_delivery_plan_once_per_topology_stream_per_replica(sides):
    def leg(side):
        router, rs = side.build(target=2)
        first = dict(rs.telemetry)
        plan = rs.delivery_plan()
        rs.spawn()
        return _summary(router, rs, first=first,
                        moved_bytes=int(plan.moved_bytes),
                        total_bytes=int(plan.total_bytes))

    got, want = _both(sides, leg)
    assert got == want
    assert got["first"]["plans_built"] == 1
    assert got["first"]["deliveries"] == 2
    assert got["moved_bytes"] > 0           # host weights really move
    assert got["set_telemetry"]["plans_built"] == 1
    assert got["set_telemetry"]["deliveries"] == 3
    # both price the plan with the Graph Doctor's MEM001 at the plan's own
    # transient cap: the cached bounded plan fits it on both sides
    verdicts = {}
    for name in ("jax", "torch"):
        _, rs = sides[name].build(target=1)
        rep = rs.check_delivery_budget()
        verdicts[name] = (rep.ok, sorted(rep.codes()))
    assert verdicts["torch"] == verdicts["jax"] == (True, [])


def test_prefix_affinity_pins_shared_prompt(sides):
    def leg(side):
        rng = np.random.default_rng(101)
        sysp = rng.integers(1, 64, (16,)).astype(np.int32)
        prompts = _prompts(rng, (5, 7, 9, 20), shared=sysp)
        router, rs = side.build(
            target=2,
            router_cfg=side.fleet.RouterConfig(admission_token_cap=256))
        rids = [router.submit(prompts[0], max_new_tokens=4)]
        for _ in range(3):
            router.step()
        rids += [router.submit(p, max_new_tokens=4) for p in prompts[1:]]
        out = router.run()
        served = sorted(len(r.engine.prefill_stats) for r in rs.live())
        hits = sorted(r.engine.prefix_cache.stats()["hits"]
                      for r in rs.live())
        return _summary(router, rs, out, rids=rids, served=served,
                        hits=hits), dict(zip(rids, prompts))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert got["served"] == [0, 4] and got["hits"] == [0, 3]
    _check_refs(sides["torch"], got, {r: (p, 4) for r, p in prompts.items()})


# =====================================================================
# request migration on failure
# =====================================================================


def test_kill_migrates_and_stays_bit_identical(sides):
    def leg(side):
        rng = np.random.default_rng(102)
        prompts = _prompts(rng, (5, 9, 17, 7))
        router, rs = side.build(
            target=2, scripts={0: [side.event(step=2, kind="kill")]})
        rids = [router.submit(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        return _summary(router, rs, out, rids=rids), dict(zip(rids, prompts))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert sorted(got["tokens"]) == sorted(got["rids"])     # none lost
    _check_refs(sides["torch"], got, {r: (p, 6) for r, p in prompts.items()})
    (ev,) = got["recoveries"]
    assert ev["fault"] == "ReplicaKilled" and ev["migrated_requests"] >= 1
    assert ev["replacement_id"] is not None and ev["recovery_ticks"] == 0
    assert got["set_telemetry"]["deaths"] == {"ReplicaKilled": 1}
    assert got["set_telemetry"]["spawns"] == 3


def test_preempt_graceful_migration(sides):
    def leg(side):
        rng = np.random.default_rng(105)
        prompts = _prompts(rng, (5, 13))
        router, rs = side.build(
            target=2, scripts={1: [side.event(step=2, kind="preempt")]})
        rids = [router.submit(p, max_new_tokens=6) for p in prompts]
        out = router.run()
        return (_summary(router, rs, out, serving=len(rs.serving())),
                dict(zip(rids, prompts)))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert [e["fault"] for e in got["recoveries"]] == ["ReplicaPreempted"]
    assert got["serving"] == 2
    _check_refs(sides["torch"], got, {r: (p, 6) for r, p in prompts.items()})


# =====================================================================
# router edge cases
# =====================================================================


def test_admission_at_exactly_full_token_budget(sides):
    def leg(side):
        rng = np.random.default_rng(106)
        p = rng.integers(1, 64, (8,)).astype(np.int32)      # footprint 16
        router, rs = side.build(
            target=1,
            router_cfg=side.fleet.RouterConfig(admission_token_cap=16))
        r0 = router.submit(p, max_new_tokens=8)
        r1 = router.submit(p.copy(), max_new_tokens=8)
        router.step()
        assigned = sum(len(m) for m in router._assigned.values())
        queued = len(router.queue)
        out = router.run()
        router2, _ = side.build(
            target=1,
            router_cfg=side.fleet.RouterConfig(admission_token_cap=15))
        with pytest.raises(ValueError, match="admission_token_cap"):
            router2.submit(p, max_new_tokens=8)
        return _summary(router, rs, out, assigned=assigned, queued=queued,
                        rids=[r0, r1], queue2=len(router2.queue))

    got, want = _both(sides, leg)
    assert got == want
    assert got["assigned"] == 1 and got["queued"] == 1
    assert sorted(got["tokens"]) == got["rids"] and got["queue2"] == 0


def test_retry_after_timeout_is_idempotent(sides):
    def leg(side):
        rng = np.random.default_rng(107)
        p = rng.integers(1, 64, (6,)).astype(np.int32)
        clock = _Clock()
        router, rs = side.build(target=2, clock=clock)
        rid = router.submit(p, max_new_tokens=6, timeout_s=50.0)
        for _ in range(3):
            clock.t += 1.0
            router.step()
        req = router.requests[rid]
        before = list(req.emitted)
        clock.t += 100.0
        router.step()
        withdrawn = dict(retries=router.telemetry["retries"],
                         replica=req.replica, done=req.done,
                         emitted=list(req.emitted))
        clock.t += 10.0
        out = router.run()
        return _summary(router, rs, out, before=before,
                        withdrawn=withdrawn), {rid: (p, 6)}

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert 0 < len(got["before"]) < 6
    w = got["withdrawn"]
    assert w["retries"] == 1 and w["replica"] is None and not w["done"]
    assert w["emitted"][:len(got["before"])] == got["before"]
    assert got["router"]["completed"] == 1
    _check_refs(sides["torch"], got, prompts)


def test_drain_with_in_flight_completes_before_removal(sides):
    def leg(side):
        rng = np.random.default_rng(108)
        prompts = _prompts(rng, (6, 9, 7, 11))
        router, rs = side.build(target=2)
        rids = [router.submit(p, max_new_tokens=6) for p in prompts]
        router.step()
        victim = next(r for r in rs.live() if router._assigned.get(r.id))
        drained = sorted(q.rid for q in router._assigned[victim.id].values())
        router.drain(victim.id)
        state_after_drain = victim.state
        out = router.run()
        return _summary(router, rs, out, drained=drained,
                        states=[state_after_drain, victim.state],
                        serving=len(rs.serving())), dict(zip(rids, prompts))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert got["drained"]
    assert got["states"] == [tfleet.DRAINING, tfleet.REMOVED]
    assert got["router"]["migrations"] == 0 and got["serving"] == 2
    _check_refs(sides["torch"], got, {r: (p, 6) for r, p in prompts.items()})


# =====================================================================
# the fault trace: kill + hang + slow + an overload burst
# =====================================================================


def _slowest_replica_step(side, steps=6):
    """The slowest of a warm replica's first ``steps`` steps under
    traffic, in seconds."""
    router, rs = side.build(target=1)
    rep = rs.serving()[0]
    times = []
    step = rep._engine_step

    def timed():
        t0 = time.perf_counter()
        out = step()
        times.append(time.perf_counter() - t0)
        return out

    rep._engine_step = timed
    rng = np.random.default_rng(0)
    for n in (5, 20):
        router.submit(rng.integers(1, 64, (n,)).astype(np.int32),
                      max_new_tokens=4)
    while router.pending() and len(times) < steps:
        router.step()
    return max(times)


def test_fault_trace_end_to_end(sides):
    # the heartbeat from this machine's measured clean steps of both sides:
    # a clean step never reaches the timeout, the hang always passes it
    timeout = max(0.3, STEP_TIMEOUT_X * max(
        _slowest_replica_step(s) for s in sides.values()))
    hang = max(0.8, HANG_STALL_X * timeout)

    def leg(side):
        rng = np.random.default_rng(110)
        sysp = rng.integers(1, 64, (16,)).astype(np.int32)
        named = _prompts(rng, (5, 9, 13), shared=sysp) \
            + _prompts(rng, (7, 11))
        requests = [(t, p, 6) for t, p in enumerate(named)]
        router, rs = side.build(
            target=2, step_timeout_s=timeout,
            scripts={0: [side.event(step=3, kind="kill")],
                     1: [side.event(step=2, kind="slow", stall_s=0.01),
                         side.event(step=5, kind="hang", stall_s=hang)]},
            router_cfg=side.fleet.RouterConfig(admission_token_cap=48))
        res = side.H.run_fleet_trace(
            router, requests,
            bursts=[side.H.OverloadBurst(tick=2, n_requests=4, duration=5,
                                         prompt_len=20, max_new_tokens=4)],
            seed=110)
        return _summary(router, rs, rids=res["rids"],
                        rejected=res["rejected"],
                        serving=len(rs.serving())), \
            {rid: (p, m) for rid, p, m in res["submitted"]}

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert sorted(got["tokens"]) == sorted(got["rids"])     # none lost
    _check_refs(sides["torch"], got, prompts)
    assert sorted(e["fault"] for e in got["recoveries"]) \
        == ["ReplicaHung", "ReplicaKilled"]
    assert got["rejected"] > 0
    ups = [(e["from"], e["to"]) for e in got["ladder_log"]
           if e["to"] > e["from"]]
    assert ups[:3] == [(0, 1), (1, 2), (2, 3)]
    assert got["serving"] == 2


def test_raw_engine_error_is_replica_death_not_fleet_death(sides):
    def leg(side):
        rng = np.random.default_rng(111)
        prompts = _prompts(rng, (6, 9))
        router, rs = side.build(target=2)
        rids = [router.submit(p, max_new_tokens=4) for p in prompts]
        router.step()
        victim = next(r for r in rs.live() if router._assigned.get(r.id))

        def boom():
            raise RuntimeError("device lost (simulated)")

        victim._engine_step = boom
        out = router.run()
        return (_summary(router, rs, out, serving=len(rs.serving())),
                dict(zip(rids, prompts)))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert [e["fault"] for e in got["recoveries"]] == ["RuntimeError"]
    assert got["serving"] == 2
    _check_refs(sides["torch"], got, {r: (p, 4) for r, p in prompts.items()})


def test_warmup_does_not_calibrate_int8(sides):
    import jax.numpy as jnp

    from paddle_tpu.inference.serving import \
        ContinuousBatchingEngine as JEngine
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    kw = dict(max_slots=2, num_pages=33, page_size=16, max_seq_len=128,
              prefill_token_budget=16)
    j, t = sides["jax"], sides["torch"]
    jrep = j.fleet.Replica(0, lambda p: JEngine(j.cfg, p, cache_dtype=jnp.int8,
                                                **kw))
    jrep.warm({k: jnp.asarray(v) for k, v in j.params.items()})
    trep = tfleet.Replica(0, lambda p: ContinuousBatchingEngine(
        t.cfg, p, cache_dtype=torch.int8, device="cpu", **kw))
    trep.warm({k: torch.from_numpy(v) for k, v in t.params.items()})
    assert jrep.engine.kv_scales is None and trep.engine.kv_scales is None
    prompt = np.random.default_rng(112).integers(1, 64, (9,)).astype(np.int32)
    done = {}
    for name, rep in (("jax", jrep), ("torch", trep)):
        rep.engine.add_request(prompt, max_new_tokens=4)
        fin = rep.engine.run()
        assert rep.engine.kv_scales is not None   # the real prompt's
        assert len(fin) == 1
        done[name] = np.asarray(fin[0].tokens).tolist()
        rep.engine.shutdown()
    assert done["torch"] == done["jax"]
    for k, v in jrep.engine.kv_scales.items():
        np.testing.assert_allclose(trep.engine.kv_scales[k].numpy(),
                                   np.asarray(v), rtol=1e-6)


def test_submit_rejects_undispatchable_footprint(sides):
    for side in sides.values():
        router, _ = side.build(
            target=1,
            router_cfg=side.fleet.RouterConfig(admission_token_cap=32))
        with pytest.raises(ValueError, match="admission_token_cap"):
            router.submit(np.arange(1, 30, dtype=np.int32),
                          max_new_tokens=8)        # footprint 37 > 32
        assert router.telemetry["submitted"] == 0 and not router.queue


def test_single_pool_autoscale_hysteresis(sides):
    import paddle_tpu.inference.disagg as jdisagg
    import paddle_tpu_torch.inference.disagg as tdisagg

    def leg(side):
        dis = jdisagg if side.name == "jax" else tdisagg
        clock = _Clock()
        asc = dis.AutoscaleConfig(min_replicas=1, max_replicas=2,
                                  up_sustain_ticks=2, down_idle_ticks=3,
                                  cooldown_ticks=4)
        router, rs = side.build(
            target=1,
            router_cfg=side.fleet.RouterConfig(admission_token_cap=32),
            autoscale=asc, clock=clock)
        rng = np.random.default_rng(114)
        prompts = _prompts(rng, (20, 22, 24, 21))
        rids = [router.submit(p, max_new_tokens=4) for p in prompts]
        up_tick = None
        for _ in range(60):
            clock.t += 1.0
            router.step()
            if up_tick is None and rs.config.target_replicas == 2:
                up_tick = router._tick
            if not router.pending():
                break
        peak = len(rs.serving())
        out = router.results()
        for _ in range(asc.down_idle_ticks + asc.cooldown_ticks + 4):
            clock.t += 1.0
            router.step()
        return _summary(router, rs, out, up_tick=up_tick, peak=peak,
                        target=rs.config.target_replicas,
                        serving=len(rs.serving())), dict(zip(rids, prompts))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert got["up_tick"] is not None and got["peak"] == 2
    assert got["target"] == 1 and got["serving"] == 1
    log = got["autoscale_log"]
    assert [e["dir"] for e in log] == ["up", "down"]
    assert log[1]["tick"] - log[0]["tick"] >= 4
    _check_refs(sides["torch"], got, {r: (p, 4) for r, p in prompts.items()})


def test_spawn_failure_is_retried_not_fatal(sides):
    def leg(side):
        fail_ids = {2}

        def replica_factory(rid, engine_factory, step_timeout_s=0.0):
            script = ([side.event(step=2, kind="kill")] if rid == 0 else ())
            rep = side.H.FakeReplica(rid, engine_factory,
                                     step_timeout_s=step_timeout_s,
                                     script=script)
            if rid in fail_ids:
                fail_ids.discard(rid)

                def bad_warm(params):
                    raise RuntimeError("replacement warm OOM (simulated)")

                rep.warm = bad_warm
            return rep

        rs2 = side.fleet.ReplicaSet(
            side.params, side.engine_factory(),
            side.fleet.FleetConfig(target_replicas=2),
            replica_factory=replica_factory, **side.kw)
        router2 = side.fleet.FleetRouter(
            rs2, side.fleet.RouterConfig(admission_token_cap=64))
        rng = np.random.default_rng(113)
        prompts = _prompts(rng, (6, 9, 7))
        rids = [router2.submit(p, max_new_tokens=4) for p in prompts]
        out = router2.run()
        return (_summary(router2, rs2, out, serving=len(rs2.serving())),
                dict(zip(rids, prompts)))

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert got["set_telemetry"]["deaths"].get("SpawnFailed") == 1
    assert got["serving"] == 2
    _check_refs(sides["torch"], got, {r: (p, 4) for r, p in prompts.items()})


# =====================================================================
# the port's own legs: placement, memory, the coded delivery
# =====================================================================


def test_default_mesh_is_the_card(sides):
    """Without ``device`` and ``dst_mesh`` a replica set delivers to the
    card, and raises where there is none (no CPU fallback)."""
    t = sides["torch"]
    if torch.cuda.is_available():
        rs = tfleet.ReplicaSet(t.params, lambda p: None)
        assert rs.device.type == "cuda"
        assert rs._mesh().device_type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tfleet.ReplicaSet(t.params, lambda p: None)
    rs = tfleet.ReplicaSet(t.params, lambda p: None, device="cpu")
    assert rs._mesh().device_type == "cpu" and rs._mesh().size == 1


def test_host_delivery_gives_each_replica_its_own_weights(sides):
    t = sides["torch"]
    router, rs = t.build(target=2)
    a, b = rs.serving()
    for k in t.params:
        assert a.engine.params[k].data_ptr() != b.engine.params[k].data_ptr()
        assert torch.equal(a.engine.params[k], torch.from_numpy(t.params[k]))
    plan = rs.delivery_plan()
    assert plan.telemetry["executions"] == 2
    assert plan.telemetry["last_staged_bytes"] == plan.moved_bytes
    assert [d["staged_bytes"] for d in rs.delivery_log] == \
        [plan.moved_bytes] * 2
    # a tensor already where the replica serves is a noop leaf: shared
    dev_params = {k: torch.from_numpy(v) for k, v in t.params.items()}
    rs2 = tfleet.ReplicaSet(dev_params, t.engine_factory(),
                            tfleet.FleetConfig(target_replicas=2),
                            device="cpu")
    assert rs2.delivery_plan().moved_bytes == 0
    delivered = rs2._deliver()
    assert all(delivered[k] is dev_params[k] for k in dev_params)


def test_dead_replica_memory_is_released_at_reap(sides):
    """A killed replica's pools and weights are freed when the router
    reaps it, though its fault (and the fault's frames) are kept."""
    t = sides["torch"]
    rng = np.random.default_rng(102)
    prompts = _prompts(rng, (5, 9, 17, 7))
    router, rs = t.build(target=2,
                         scripts={0: [T.ReplicaFaultEvent(step=2,
                                                          kind="kill")]})
    victim = rs.replicas[0]
    eng = weakref.ref(victim.engine)
    watched = [weakref.ref(victim.engine.k_pages[0]),
               weakref.ref(victim.engine.params["lm_head.weight"])]
    for p in prompts:
        router.submit(p, max_new_tokens=6)
    while victim.state != tfleet.REMOVED:
        router.step()
    assert victim.fault is not None and victim.engine is None
    assert victim.fault.__traceback__ is None
    assert all(w() is None for w in watched), "dead replica's memory kept"
    assert eng() is None or eng().k_pages is None
    router.run()
    assert len(rs.serving()) == 2


def test_coded_delivery_stages_wire_bytes_and_decodes_bit_exact(sides):
    """The int8 weight profile: every float leaf crosses as its packed
    bytes (staged bytes == ``plan_wire_bytes``' wire bytes) and decodes at
    the destination, bit for bit as a CPU decode of the same bytes and as
    JAX's ``execute_encoded``; the coded fleet still serves."""
    from paddle_tpu.parallel.codec import CollectiveCodec as JCodec
    from paddle_tpu_torch.parallel.codec import (CollectiveCodec,
                                                 decode_rows,
                                                 encode_rows_host)
    from paddle_tpu_torch.parallel.reshard import plan_wire_bytes

    t, j = sides["torch"], sides["jax"]
    codec = CollectiveCodec(weight_profile="int8", block=64)
    router, rs = t.build(target=1, delivery_codec=codec,
                         max_transient_bytes=8 << 10)
    plan = rs.delivery_plan()
    wb = plan_wire_bytes(plan, codec)
    assert wb["wire_bytes"] < wb["raw_bytes"]
    assert any(lp.chunk_axis is not None for lp in plan.leaf_plans)
    assert plan.telemetry["last_staged_bytes"] == wb["wire_bytes"]
    assert rs.delivery_log[-1]["staged_bytes"] == wb["wire_bytes"]
    got = rs.serving()[0].engine.params
    # each leaf: the CPU decode of its host encode, chunk by chunk
    for lp in plan.leaf_plans:
        src = torch.from_numpy(t.params[lp.path])
        want = torch.empty_like(src)
        spans = lp.chunks if lp.chunk_axis is not None else [(0, len(src))]
        axis = lp.chunk_axis or 0
        for a, b in spans:
            piece = src.narrow(axis, a, b - a)
            packed = encode_rows_host(piece.reshape(1, -1), codec, "int8")
            want.narrow(axis, a, b - a).copy_(decode_rows(
                torch.from_numpy(packed), piece.numel(), codec, "int8",
                out_dtype=src.dtype).reshape(piece.shape))
        assert torch.equal(got[lp.path], want), lp.path
    # JAX's coded delivery of the same plan
    jrouter, jrs = j.build(target=1, max_transient_bytes=8 << 10)
    jrs.config.delivery_codec = JCodec(weight_profile="int8", block=64)
    jgot = jrs._deliver()
    for k, v in jgot.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    rid = router.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=4)
    assert len(router.run()[rid]) == 4


@pytest.mark.parametrize("profile", ["int8", "fp8"])
@pytest.mark.parametrize("checksum", [False, True])
def test_decode_jit_out_sharding_matches_jax(profile, checksum):
    """``decode_jit(out_sharding=)``: a device or a one-rank (mesh, spec)
    placement decodes there, bit for bit as JAX's ``decode_jit`` with its
    ``out_sharding``; a multi-rank mesh is refused (a plan places
    blocks)."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.parallel import codec as jc
    from paddle_tpu_torch.parallel import codec as tc
    from paddle_tpu_torch.parallel.specs import Mesh, P

    x = np.random.default_rng(3).standard_normal((24, 40)).astype(np.float32)
    x[0, :5] = 0.0
    codec = tc.CollectiveCodec(weight_profile=profile, block=64,
                               checksum=checksum)
    jcodec = jc.CollectiveCodec(weight_profile=profile, block=64,
                                checksum=checksum)
    packed = tc.encode_rows_host(x.reshape(1, -1), codec, profile)
    assert np.array_equal(packed, jc.encode_rows_host(
        x.reshape(1, -1), jcodec, profile))
    jmesh = JMesh(np.asarray(jax.devices()[:1], dtype=object), ("replica",))
    want = np.asarray(jc.decode_jit(
        x.shape, np.float32, jcodec, profile,
        out_sharding=NamedSharding(jmesh, JP()))(packed))
    mesh = Mesh((1,), ("replica",), device_type="cpu")
    for placement in ("cpu", torch.device("cpu"), (mesh, P())):
        got = tc.decode_jit(x.shape, torch.float32, codec, profile,
                            out_sharding=placement)(packed)
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tc.decode_jit(x.shape, torch.float32, codec, profile,
                          out_sharding="cuda")
    with pytest.raises(ValueError, match="one rank"):
        tc.decode_jit(x.shape, torch.float32, codec, profile,
                      out_sharding=(Mesh((4,), ("dp",), device_type="cpu"),
                                    P("dp")))
