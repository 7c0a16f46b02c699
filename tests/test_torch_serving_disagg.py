"""The port's disaggregated serving (paddle_tpu_torch/inference/disagg.py)
against the JAX package's (paddle_tpu/inference/disagg.py) on the CPU.

Every tier-1 leg of tests/test_serving_disagg.py runs as one script
through both (the JAX harness's toy Llama and its port twin, fp32 on the
CPU), and the port's summary equals JAX's: every request's tokens, every
``ServingRecoveryEvent`` field but the wall time, the replica set's and the
router's telemetry (handoffs, mid-decode handoffs, the ladder log), the
handoff planner's (plans, handoffs, raw and wire bytes), the prefix-cache
counters the leg reads.  The port's streams also equal its own unified
engine's.  Beyond JAX's legs: ``plan_wire_bytes`` of an int8 handoff equals
JAX's and undercuts the float form of the same pages, an int8 handoff's
pages and scales arrive bit for bit, and ``check_handoff_budget`` raises
citing ROADMAP A7 (its MEM001 half is the graph doctor's).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import fault_injection as J  # noqa: E402
import torch_fault_injection as T  # noqa: E402


@dataclasses.dataclass
class Side:
    name: str
    H: object
    cfg: object
    params: dict                 # host numpy weights
    kw: dict

    def build(self, **kw):
        if "cache_dtype" in kw and kw["cache_dtype"] == "int8":
            kw["cache_dtype"] = self.int8
        return self.H.build_disagg_fleet(self.cfg, self.params,
                                         **self.kw, **kw)

    @property
    def int8(self):
        if self.name == "jax":
            import jax.numpy as jnp

            return jnp.int8
        return torch.int8

    @property
    def mods(self):
        if self.name == "jax":
            import paddle_tpu.inference.disagg as disagg
            import paddle_tpu.inference.fleet as fleet
            import paddle_tpu.inference.serving as serving
        else:
            import paddle_tpu_torch.inference.disagg as disagg
            import paddle_tpu_torch.inference.fleet as fleet
            import paddle_tpu_torch.inference.serving as serving
        return fleet, disagg, serving

    def engine(self, **kw):
        """A unified engine over the toy weights (the parity reference)."""
        serving = self.mods[2]
        if kw.get("cache_dtype") == "int8":
            kw["cache_dtype"] = self.int8
        if self.name == "jax":
            import jax.numpy as jnp

            params = {k: jnp.asarray(v) for k, v in self.params.items()}
        else:
            params = {k: torch.from_numpy(v) for k, v in self.params.items()}
        return serving.ContinuousBatchingEngine(self.cfg, params,
                                                **self.kw, **kw)


@pytest.fixture(scope="module")
def sides():
    jcfg, _, jparams = J.toy_llama()
    tcfg, _, tparams = T.toy_llama(jparams)
    return {"jax": Side("jax", J, jcfg, jparams, {}),
            "torch": Side("torch", T, tcfg, tparams, {"device": "cpu"})}


def _both(sides, leg):
    return leg(sides["torch"]), leg(sides["jax"])


def _prompts(rng, lens, shared=None):
    out = []
    for n in lens:
        body = rng.integers(1, 64, (n,)).astype(np.int32)
        out.append(np.concatenate([shared, body])
                   if shared is not None else body)
    return out


def _summary(router, rs, out, **extra):
    t = router.telemetry
    return dict(
        tokens={int(k): np.asarray(v).tolist() for k, v in out.items()},
        recoveries=[{k: v for k, v in dataclasses.asdict(ev).items()
                     if k != "wall_s"} for ev in t["recoveries"]],
        set_telemetry={k: (dict(v) if isinstance(v, dict) else v)
                       for k, v in rs.telemetry.items()},
        router={k: t[k] for k in ("submitted", "completed", "rejected",
                                  "retries", "migrations", "handoffs",
                                  "handoffs_mid_decode",
                                  "handoff_backlog_ticks",
                                  "completed_at_prefill")},
        ladder_log=list(t["ladder_log"]),
        autoscale_log=list(t["autoscale_log"]),
        planner=dict(router.planner.telemetry),
        roles=sorted((r.id, r.state, r.role) for r in rs.replicas.values()),
        **extra)


UNIFIED = dict(max_slots=2, num_pages=33, page_size=16, max_seq_len=128,
               prefill_token_budget=16, enable_prefix_cache=True)


def _unified_tokens(side, prompts, n, **kw):
    """The same prompts through one unified engine of ``side``."""
    eng = side.engine(**dict(UNIFIED, **kw))
    rids = [eng.add_request(p, max_new_tokens=n) for p in prompts]
    done = {f.rid: np.asarray(f.tokens).tolist() for f in eng.run()}
    return [done[r] for r in rids]


# =====================================================================
# the acceptance gate: parity through warm hits and a mid-decode handoff
# =====================================================================


def test_disagg_bit_parity_with_unified(sides):
    def leg(side):
        rng = np.random.default_rng(200)
        sysp = rng.integers(1, 64, (16,)).astype(np.int32)
        prompts = _prompts(rng, (5, 9, 13), shared=sysp) \
            + _prompts(rng, (7, 11))
        router, rs = side.build(
            prefill=1, decode=2,
            scripts={1: [side.H.ReplicaFaultEvent(step=4, kind="kill")]})
        rids = [router.submit(prompts[0], max_new_tokens=6)]
        for _ in range(4):
            router.step()
        rids += [router.submit(p, max_new_tokens=6) for p in prompts[1:]]
        out = router.run()
        pre = rs.serving("prefill")[0]
        return _summary(router, rs, out, rids=rids,
                        hits=pre.engine.prefix_cache.stats()["hits"],
                        decode=len(rs.serving("decode"))), prompts

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert sorted(got["tokens"]) == sorted(got["rids"])
    ref = _unified_tokens(sides["torch"], prompts, 6)
    assert [got["tokens"][r] for r in got["rids"]] == ref
    assert got["router"]["handoffs"] >= len(prompts)
    assert got["router"]["handoffs_mid_decode"] >= 1
    assert [e["fault"] for e in got["recoveries"]] == ["ReplicaKilled"]
    assert got["hits"] >= 2 and got["decode"] == 2
    assert got["planner"]["plans_built"] < got["planner"]["handoffs"]


def test_sampled_request_hands_off_with_rng_state(sides):
    def leg(side):
        rng = np.random.default_rng(209)
        filler = rng.integers(1, 64, (9,)).astype(np.int32)
        prompt = rng.integers(1, 64, (13,)).astype(np.int32)
        eng = side.engine(**UNIFIED)
        r0 = eng.add_request(filler, max_new_tokens=6)
        r1 = eng.add_request(prompt, max_new_tokens=6, temperature=0.8,
                             seed=42)
        ref = {f.rid: np.asarray(f.tokens).tolist() for f in eng.run()}
        router, rs = side.build(prefill=1, decode=1)
        d0 = router.submit(filler, max_new_tokens=6)
        d1 = router.submit(prompt, max_new_tokens=6, temperature=0.8,
                           seed=42)
        out = router.run()
        return _summary(router, rs, out, ref=[ref[r0], ref[r1]],
                        rids=[d0, d1],
                        pools=sorted(rs.pool_targets()))

    got, want = _both(sides, leg)
    assert got == want
    assert "unified" not in got["pools"]
    assert [got["tokens"][r] for r in got["rids"]] == got["ref"]
    assert got["router"]["handoffs"] >= 2
    assert got["router"]["handoffs_mid_decode"] >= 1


# =====================================================================
# tiered prefix cache
# =====================================================================


def test_host_tier_roundtrip_bit_identical(sides):
    def leg(side):
        rng = np.random.default_rng(202)
        A = rng.integers(1, 64, (33,)).astype(np.int32)
        B = rng.integers(1, 64, (40,)).astype(np.int32)
        kw = dict(max_slots=1, num_pages=6, page_size=16, max_seq_len=64,
                  prefill_token_budget=16, enable_prefix_cache=True,
                  host_tier_pages=4)
        cold = side.engine(**kw)
        cold.add_request(A, max_new_tokens=7)
        ref = np.asarray(cold.run()[0].tokens).tolist()
        eng = side.engine(**kw)
        eng.add_request(A, max_new_tokens=7)
        eng.run()
        eng.finished.clear()
        eng.add_request(B, max_new_tokens=24)
        eng.run()
        demoted = dict(eng.prefix_cache.stats())
        eng.finished.clear()
        eng.add_request(A, max_new_tokens=7)
        warm = np.asarray(eng.run()[0].tokens).tolist()
        st = dict(eng.prefix_cache.stats())
        eng.prefix_cache.clear()
        eng.alloc.assert_balanced()
        return dict(ref=ref, warm=warm, demoted=demoted, stats=st)

    got, want = _both(sides, leg)
    assert got == want
    assert got["demoted"]["demoted_pages"] > 0
    assert got["demoted"]["evicted_pages"] == 0
    assert got["stats"]["host_hits"] > 0 and got["stats"]["promoted_pages"] > 0
    assert got["warm"] == got["ref"]


def test_cross_replica_host_tier_hit(sides):
    def leg(side):
        fleet = side.mods[0]
        rng = np.random.default_rng(203)
        sysp = rng.integers(1, 64, (16,)).astype(np.int32)
        a, b = _prompts(rng, (5, 9), shared=sysp)
        router, rs = side.build(
            prefill=2, decode=1, host_tier_pages=4,
            router_cfg=fleet.RouterConfig(admission_token_cap=64,
                                          affinity=False))
        r0 = router.submit(a, max_new_tokens=4)
        router.run()
        warmed = [r for r in rs.serving("prefill")
                  if r.engine.prefix_cache.stats()["inserted_pages"] > 0]
        pre = warmed[0]
        pre.engine.prefix_cache.evict(1)
        host_pages = pre.engine.prefix_cache.stats()["host_pages"]
        r1 = router.submit(b, max_new_tokens=4)
        out = router.run()
        return _summary(router, rs, out, warmed=len(warmed),
                        host_pages=host_pages, rids=[r0, r1],
                        stats=dict(pre.engine.prefix_cache.stats()),
                        served=len(pre.engine.prefill_stats)), [a, b]

    (got, prompts), (want, _) = _both(sides, leg)
    assert got == want
    assert got["warmed"] == 1 and got["host_pages"] == 1
    assert sorted(got["tokens"]) == got["rids"]
    assert got["stats"]["host_hits"] > 0
    assert got["stats"]["promoted_pages"] > 0
    assert got["served"] == 2
    ref = _unified_tokens(sides["torch"], prompts, 4)
    assert [got["tokens"][r] for r in got["rids"]] == ref


# =====================================================================
# one int8 calibration across the fleet
# =====================================================================


def test_multi_prefill_int8_shares_one_calibration(sides):
    def leg(side):
        fleet = side.mods[0]
        rng = np.random.default_rng(208)
        prompts = _prompts(rng, (9, 13, 7))
        router, rs = side.build(
            prefill=2, decode=1, cache_dtype="int8",
            router_cfg=fleet.RouterConfig(admission_token_cap=32,
                                          affinity=False))
        rids = [router.submit(p, max_new_tokens=5) for p in prompts]
        out = router.run()
        busy = sorted(len(r.engine.prefill_stats) > 0
                      for r in rs.serving("prefill"))
        ref = router._fleet_kv_scales
        shared = all(np.array_equal(np.asarray(
            r.engine.kv_scales[k].cpu() if side.name == "torch"
            else r.engine.kv_scales[k]), v)
            for r in rs.live() for k, v in ref.items())
        aliased = side.name == "torch" and any(
            a.engine.kv_scales[k].data_ptr() == b.engine.kv_scales[k]
            .data_ptr() for a in rs.live() for b in rs.live()
            if a is not b for k in ref)
        return _summary(router, rs, out, busy=busy, shared=shared,
                        aliased=aliased, rids=rids), prompts, ref

    (got, prompts, tscales), (want, _, jscales) = _both(sides, leg)
    assert got == want
    assert got["busy"] == [True, True]
    assert got["shared"] and not got["aliased"]
    for k, v in jscales.items():
        np.testing.assert_allclose(tscales[k], v, rtol=1e-6)
    ref = _unified_tokens(sides["torch"], prompts, 5, cache_dtype="int8")
    assert [got["tokens"][r] for r in got["rids"]] == ref


def test_prefill_only_engine_guards(sides):
    for side in sides.values():
        kw = dict(max_slots=2, num_pages=17, page_size=16, max_seq_len=64)
        with pytest.raises(ValueError, match="prefill_only"):
            side.engine(prefill_only=True, **kw)
        with pytest.raises(ValueError, match="host_tier"):
            side.engine(prefill_token_budget=16, host_tier_pages=2, **kw)
        pre = side.engine(prefill_token_budget=16, prefill_only=True, **kw)
        with pytest.raises(ValueError, match="decode-capable"):
            pre.adopt_request({"k": np.zeros(1), "v": np.zeros(1)},
                              {"seq_len": 1, "first_token": 0,
                               "page_size": 16}, 4)
        dec = side.engine(prefill_token_budget=16, **kw)
        with pytest.raises(ValueError, match="page_size"):
            dec.adopt_request({"k": np.zeros(1), "v": np.zeros(1)},
                              {"seq_len": 1, "first_token": 0,
                               "page_size": 32}, 4)


# =====================================================================
# the handoff's bytes
# =====================================================================


def test_int8_handoff_wire_bytes_and_bit_exact_pages(sides):
    """An int8 handoff: ``plan_wire_bytes`` equals JAX's and undercuts the
    fp32 form of the same pages; every page and scale the decode engine
    adopts equals what the prefill engine exported; the MEM001 half of
    ``check_handoff_budget`` raises citing A7."""
    from paddle_tpu.inference.disagg import KVHandoffPlanner as JPlanner
    from paddle_tpu.parallel.reshard import plan_wire_bytes as jwire
    from paddle_tpu_torch.inference.disagg import KVHandoffPlanner
    from paddle_tpu_torch.parallel.reshard import plan_wire_bytes

    t = sides["torch"]
    router, rs = t.build(prefill=1, decode=1, cache_dtype="int8")
    dec = rs.serving("decode")[0].engine
    landed = []
    adopt = dec.adopt_request

    def spy(kv, meta, max_new_tokens, rid=None):
        landed.append((kv, meta))
        return adopt(kv, meta, max_new_tokens, rid)

    dec.adopt_request = spy
    exported = []
    pre = rs.serving("prefill")[0].engine
    export = pre.export_handoff

    def keep(slot):
        tree, meta = export(slot)
        exported.append((tree, meta))
        return tree, meta

    pre.export_handoff = keep
    rng = np.random.default_rng(201)
    for p in _prompts(rng, (9, 17)):
        router.submit(p, max_new_tokens=5)
    router.run()
    assert len(exported) == len(landed) == 2
    for (tree, meta), (kv, lmeta) in zip(exported, landed):
        assert tree["k"].dtype == np.int8
        for k in ("k", "v"):
            assert torch.equal(kv[k], torch.from_numpy(tree[k]))
        for k, v in meta["kv_scales"].items():
            assert np.array_equal(lmeta["kv_scales"][k], v)
            assert np.array_equal(dec.kv_scales[k].numpy(), v)
    tree = router.planner.last_tree
    raw_tree = {k: np.ones(v.shape, np.float32) for k, v in tree.items()}
    wire = plan_wire_bytes(router.planner.plan_for(tree))
    raw = plan_wire_bytes(KVHandoffPlanner(device="cpu").plan_for(raw_tree))
    jplanner = JPlanner()
    assert wire == jwire(jplanner.plan_for(tree))
    assert raw == jwire(jplanner.plan_for(raw_tree))
    assert raw["wire_bytes"] / wire["wire_bytes"] == 4.0
    tel = router.planner.telemetry
    assert tel["handoffs"] == 2 and tel["bytes_wire"] == tel["bytes_raw"]
    with pytest.raises(NotImplementedError, match="A7"):
        router.planner.check_handoff_budget(tree, budget_bytes=8 << 20)
