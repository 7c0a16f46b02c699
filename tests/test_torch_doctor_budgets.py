"""The Graph Doctor's MEM001/MEM002 hooks of the port against the JAX
package's, on the CPU: the reshard plan's step entry
(``check_reshard_budget``, tests/test_reshard.py's budget legs), the
memory engine's budgets (tests/test_memory_engine.py's MEM legs), the
fleet's weight delivery (``ReplicaSet.check_delivery_budget``), the KV
handoff (``KVHandoffPlanner.check_handoff_budget``,
tests/test_serving_disagg.py's budget leg) and the serving entry
(``ContinuousBatchingEngine.analysis_entry`` on both paths).

Each budget hook gives JAX's verdict (fires MEM001 or stays clean) at the
same plan caps and budgets.  The memory engine's host-transfer bytes equal
what JAX's step streams over its own bucket plan (each bucket of each
host-resident leaf in and out once): JAX's host-resident step does not
trace on this JAX version's CPU backend (a host and a device operand meet
in one ``add``), so its bucket plan is the reference.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.analysis as A
from paddle_tpu_torch.analysis.fixtures import SEEDED
from paddle_tpu_torch.analysis.self_check import (FLAGSHIP_STREAM_BUDGET,
                                                  SERVING_HBM_BUDGET,
                                                  _flagship)

CAPS = (None, 48 << 10)
BUDGETS = (64 << 10, 8 << 20)


def _verdict(rep):
    return sorted(rep.codes())


# ------------------------------------------------------------ reshard plan


def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:1], dtype=object), ("x",))


@pytest.mark.parametrize("cap", CAPS, ids=["unbounded", "capped"])
def test_reshard_budget_verdicts_equal_jax(cap):
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.parallel.reshard import (check_reshard_budget as jcheck,
                                             plan_reshard as jplan)
    from paddle_tpu_torch.parallel.reshard import (check_reshard_budget,
                                                   plan_reshard)
    from paddle_tpu_torch.parallel.specs import Mesh, P

    tree = {"w": np.random.RandomState(2).rand(512, 64).astype(np.float32),
            "b": np.ones((64,), np.float32)}
    plan = plan_reshard(tree, Mesh((1,), ("x",), device_type="cpu"),
                        {"w": P("x", None), "b": P()},
                        max_transient_bytes=cap)
    jp = jplan(tree, _jax_mesh(), {"w": JP("x", None), "b": JP()},
               max_transient_bytes=cap)
    assert len(plan.steps) == len(jp.steps)
    for budget in BUDGETS:
        for i in range(len(plan.steps)):
            got = check_reshard_budget(plan, tree, budget_bytes=budget,
                                       step_index=i, exemptions=())
            want = jcheck(jp, tree, budget_bytes=budget, step_index=i,
                          exemptions=())
            assert _verdict(got) == _verdict(want), (cap, budget, i)
    if cap is not None:
        # a bounded plan fits its own declared cap, every step of it
        for i in range(len(plan.steps)):
            assert check_reshard_budget(plan, tree, step_index=i,
                                        exemptions=()).ok


def test_unbounded_reshard_plan_fires_exactly_mem001():
    from paddle_tpu.analysis.fixtures import SEEDED as JSEEDED

    rep = SEEDED["MEM001[reshard_plan]"]()
    assert rep.codes() == ["MEM001"], rep.summary()
    assert rep.findings[0].data["peak_bytes"] == 2 * 512 * 512 * 4
    assert set(JSEEDED["MEM001[reshard_plan]"]().codes()) == {"MEM001"}


def test_reshard_entry_prices_the_coded_payload():
    """With a codec the step enters as its packed payload: the static peak
    is the payload plus the decoded chunk, below the raw two copies."""
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.reshard import (plan_reshard,
                                                   reshard_step_entry)
    from paddle_tpu_torch.parallel.specs import Mesh, P

    tree = {"w": np.ones((256, 256), np.float32)}
    plan = plan_reshard(tree, Mesh((1,), ("x",), device_type="cpu"),
                        {"w": P("x", None)}, max_transient_bytes=None)
    codec = CollectiveCodec(weight_profile="int8", block=256)
    raw = A.static_peak(A.capture(*reshard_step_entry(
        plan, plan.steps[0], tree), device="cpu"))
    coded = A.static_peak(A.capture(*reshard_step_entry(
        plan, plan.steps[0], tree, codec=codec), device="cpu"))
    assert raw["peak_bytes"] == 2 * 256 * 256 * 4
    assert coded["argument_bytes"] < 256 * 256 * 2


# ----------------------------------------------------------- memory engine


@pytest.mark.parametrize("code", ["MEM001", "MEM002"])
def test_seeded_memory_fixtures_fire_exactly(code):
    assert SEEDED[code]().codes() == [code]


def test_memory_budget_pass_clean_when_within():
    rep = A.check(lambda a: (a * 2.0).sum(), torch.ones((64, 64)),
                  passes=["memory_budget"], exemptions=(), device="cpu",
                  options={"memory_budget": {"hbm_bytes": 64 << 20,
                                             "host_transfer_bytes": 0}})
    assert rep.ok, rep.summary()


def test_memory_budget_pass_skips_without_declaration():
    rep = A.check(lambda a: a.sum(), torch.ones(8), passes=["memory_budget"],
                  exemptions=(), device="cpu")
    assert rep.ok and "memory_budget" in rep.skipped


def test_memory_engine_transfers_equal_jax_bucket_plan():
    """The host-state step's host<->device bytes: each bucket of each
    host-resident moment in and out once, as JAX's streamed apply does
    over its own (equal) bucket plan."""
    from paddle_tpu.analysis.self_check import _flagship as jflagship
    from paddle_tpu.models.llama import llama_decay_mask as jmask
    from paddle_tpu.parallel.memory import \
        init_offloaded_state as jinit
    from paddle_tpu_torch.analysis.passes.memory_budget import \
        scan_memory_transfers
    from paddle_tpu_torch.models import build_train_step
    from paddle_tpu_torch.models.llama import llama_decay_mask
    from paddle_tpu_torch.parallel.memory import (MemoryConfig,
                                                  init_offloaded_state)

    cfg, model, opt, params, ids, labels = _flagship()
    mc = MemoryConfig(remat="names", optimizer_residency="host",
                      stream_bucket_bytes=256 << 10)
    st = init_offloaded_state(opt, params, decay_mask=llama_decay_mask(model),
                              bucket_bytes=mc.stream_bucket_bytes)
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            memory=mc)
    cap = A.capture(step, (params, st, 0, 1e-4, ids, labels), device="cpu")
    got = sum(nb for nb, _, _ in scan_memory_transfers(cap))

    _, jmodel, jopt, jparams, _, _ = jflagship()
    jst = jinit(jopt, jparams, decay_mask=jmask(jmodel),
                bucket_bytes=mc.stream_bucket_bytes)
    sizes = {g: {k: [int(np.asarray(b).nbytes) for b in bs]
                 for k, bs in gs.items()}
             for g, gs in jst["__offload__"].items()}
    mine = {g: {k: [b.numel() * b.element_size() for b in bs]
                for k, bs in gs.items()}
            for g, gs in st["__offload__"].items()}
    assert mine == sizes
    want = 2 * sum(sum(v) for gs in sizes.values() for v in gs.values())
    assert got == want == 1446912
    assert got <= FLAGSHIP_STREAM_BUDGET


# -------------------------------------------------------- fleet delivery


@pytest.mark.parametrize("cap", CAPS, ids=["unbounded", "capped"])
def test_delivery_budget_verdicts_equal_jax(cap):
    from paddle_tpu.inference.fleet import (FleetConfig as JConfig,
                                            ReplicaSet as JSet)
    from paddle_tpu_torch.inference.fleet import FleetConfig, ReplicaSet

    host = {"w": np.ones((512, 512), np.float32),
            "b": np.ones((512,), np.float32)}
    rs = ReplicaSet(host, engine_factory=lambda p: None,
                    config=FleetConfig(max_transient_bytes=cap),
                    device="cpu")
    jrs = JSet(host, engine_factory=lambda p: None,
               config=JConfig(max_transient_bytes=cap))
    for budget in BUDGETS:
        got = rs.check_delivery_budget(budget_bytes=budget)
        want = jrs.check_delivery_budget(budget_bytes=budget)
        assert _verdict(got) == _verdict(want), (cap, budget)
    if cap is not None:
        assert rs.check_delivery_budget().ok       # its own cap fits


def test_unbounded_delivery_fires_exactly_mem001():
    assert SEEDED["MEM001[replica_delivery]"]().codes() == ["MEM001"]


# ------------------------------------------------------------ KV handoff


@pytest.mark.parametrize("cap", CAPS, ids=["unbounded", "capped"])
def test_handoff_budget_verdicts_equal_jax(cap):
    from paddle_tpu.inference.disagg import KVHandoffPlanner as JPlanner
    from paddle_tpu_torch.inference.disagg import KVHandoffPlanner

    tree = {"k": np.ones((2, 8, 2, 16, 64), np.float32),
            "v": np.ones((2, 8, 2, 16, 64), np.int8)}
    planner = KVHandoffPlanner(max_transient_bytes=cap, device="cpu")
    jplanner = JPlanner(max_transient_bytes=cap)
    for budget in BUDGETS:
        got = planner.check_handoff_budget(tree, budget_bytes=budget)
        want = jplanner.check_handoff_budget(tree, budget_bytes=budget,
                                             exemptions=())
        assert _verdict(got) == _verdict(want), (cap, budget)


def test_unbounded_handoff_fires_exactly_mem001():
    assert SEEDED["MEM001[kv_handoff]"]().codes() == ["MEM001"]


# ---------------------------------------------------------- serving entry


@pytest.mark.parametrize("kw", [{"decode_chunk_steps": 2},
                                {"prefill_token_budget": 8},
                                {"prefill_token_budget": 8,
                                 "cache_dtype": torch.int8}],
                         ids=["chunked", "unified", "unified_int8"])
def test_analysis_entry_sweeps_clean(kw):
    """Both paths sweep clean under every pass: the pools are written in
    place (the port's donation), the weights and rope tables persist, the
    int8 path's placeholder scales stand in before calibration."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import _registry

    cfg, model, opt, params, ids, labels = _flagship()
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, num_pages=9,
                                   page_size=16, max_seq_len=64,
                                   device="cpu", **kw)
    fn, args, kwargs, options = eng.analysis_entry()
    rep = A.check(fn, *args, kwargs=kwargs, options=options, device="cpu",
                  exemptions=())
    assert rep.ok and not rep.suppressed, rep.summary()
    cap = A.capture(fn, args, kwargs, device="cpu")
    kernel = "paged_decode" if "decode_chunk_steps" in kw \
        else "ragged_paged_decode"
    nodes = [_registry.kernel_op(n.target) for n in cap.gm.graph.nodes]
    layers = cfg.num_hidden_layers * kw.get("decode_chunk_steps", 1)
    assert nodes.count(kernel) == layers
    if "cache_dtype" not in kw:
        assert A.static_peak(cap)["peak_bytes"] <= SERVING_HBM_BUDGET


def test_prefill_chunk_bump_blows_the_serving_budget():
    assert SEEDED["MEM001[prefill_chunk]"]().codes() == ["MEM001"]
