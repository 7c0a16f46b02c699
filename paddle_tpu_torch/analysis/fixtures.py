"""The seeded fixtures of the port's analysis passes: a minimal program
per finding code that must fire exactly that code (the true-positive half
of every pass's gate).

Port of ``paddle_tpu/analysis/fixtures.py``.  The graph half builds a tiny
program seeded with one bug of the class its pass hunts and runs the pass
alone with ``exemptions=()``, so the standing table cannot mask a
regression in the pass itself: DT001-003, DON001-002, RT001-002, MEM001
(and its four entry-point variants: the serving prefill chunk, the reshard
plan, the fleet's delivery, the KV handoff), MEM002, HEALTH001-002, and
above one rank COLL001-002, COMM001-004 (COMM004 also on the EP dispatch
and the dropless dispatch), HLO002, SHARD001-005 and SCHED001: each
captured at one or every rank of a ``"fake"`` process group
(``core.fake_ranks``, ``core.check_ranks``), or, for the table codes, run
over hand-written ``SpecLayout`` tables.  Every graph fixture captures on
``device`` (the CPU by default: the self-check runs at debug shapes).  The
RACE part runs the lock-discipline pass over the same source strings as
JAX's.  ``SEEDED`` maps a code (``CODE`` or
``CODE[variant]``) to its fixture; reports are memoized per process, as
JAX's are.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import capture, check, static_peak
from .findings import Report
from .passes.retrace import retrace_sentinel


def _gen(seed: int = 20260803, device="cpu") -> torch.Generator:
    """A seeded generator on ``device``'s type (a card's draws need a card
    generator)."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


# ---------------------------------------------------------------- dtype


def seeded_fp32_matmul(device="cpu") -> Report:
    """DT001: a bf16 program whose second matmul silently upcasts."""

    def bug(a, b):
        h = a @ b                                      # bf16: declares it
        return (h.float() @ b.float()).sum()           # the silent upcast

    a = torch.ones((128, 128), dtype=torch.bfloat16, device=device)
    return check(bug, a, a, passes=["dtype_promotion"], exemptions=(),
                 target="seeded:DT001", device=device)


def seeded_f64_leak(device="cpu") -> Report:
    """DT002: a float64 input drags float64 through the program."""

    def bug(a):
        return (a * 2.0).sum()

    a = torch.ones((64, 64), dtype=torch.float64, device=device)
    return check(bug, a, passes=["dtype_promotion"], exemptions=(),
                 target="seeded:DT002", device=device)


def seeded_fp32_carry(device="cpu") -> Report:
    """DT003: a bf16 micro-step loop accumulating into a full-width fp32
    buffer in place, every micro-step (the traffic the bf16 carry with
    fp32 folds removes)."""

    def bug(w, xs):
        acc = torch.zeros((128, 128), dtype=torch.float32, device=w.device)
        for x in xs:
            acc += (x @ w).float()                     # fp32 accumulate
        return acc

    w = torch.ones((128, 128), dtype=torch.bfloat16, device=device)
    xs = torch.ones((4, 128, 128), dtype=torch.bfloat16, device=device)
    return check(bug, w, xs, passes=["dtype_promotion"], exemptions=(),
                 target="seeded:DT003", device=device)


# ------------------------------------------------------------- donation


def seeded_undonated_state(device="cpu") -> Report:
    """DON001: a functional update of a param-sized dict: the caller keeps
    the old params (and the grads) while the new ones are built."""

    def bug(params, grads):
        return {k: v - 1e-3 * grads[k] for k, v in params.items()}

    params = {"w": torch.ones((768, 768), device=device)}
    grads = {"w": torch.ones((768, 768), device=device)}
    return check(bug, params, grads, passes=["donation"], exemptions=(),
                 target="seeded:DON001", device=device)


def seeded_use_after_donate(device="cpu") -> Report:
    """DON002: one storage passed in two positions, written in place
    through one of them."""

    def bug(a, b):
        a.mul_(2.0)
        return a + b

    x = torch.ones((128, 128), device=device)     # small: below DON001's
    return check(bug, x, x, passes=["donation"], exemptions=(),
                 target="seeded:DON002", device=device)


# --------------------------------------------------------------- retrace


def seeded_weak_type_churn(device="cpu") -> Report:
    """RT001: a Python float lr alternating with a 0-dim tensor."""
    step = retrace_sentinel(lambda x, lr: x * lr, name="seeded:RT001")
    x = torch.ones(8, device=device)
    step(x, 0.1)                                   # weak scalar
    step(x, torch.tensor(0.1, device=device))      # strong 0-dim tensor
    return step.report()


def seeded_signature_churn(device="cpu") -> Report:
    """RT002: unbucketed lengths, a fresh signature every call."""
    step = retrace_sentinel(lambda x: x.sum(), max_signatures=3,
                            name="seeded:RT002")
    for n in (1, 2, 3, 4):
        step(torch.ones(n, device=device))
    return step.report()


# --------------------------------------------------------- memory budget


def seeded_peak_over_budget(device="cpu") -> Report:
    """MEM001: a program whose static peak (its inputs alone, here) blows
    through a deliberately tiny declared budget."""

    def bug(a, b):
        return (a @ b).sum()

    a = torch.ones((512, 512), device=device)          # 1 MB per operand
    return check(bug, a, a, passes=["memory_budget"], exemptions=(),
                 target="seeded:MEM001", device=device,
                 options={"memory_budget": {"hbm_bytes": 64 << 10}})


def seeded_host_round_trip(device="cpu") -> Report:
    """MEM002: a whole buffer round-tripped device -> host -> device in
    one monolithic pair of copies against a streaming budget sized for
    half of it (the full-state movement the bucketed memory engine
    prevents).  The host buffer sits where the engine keeps its host
    state, under ``__offload__``."""

    def bug(a, state):
        host = state["__offload__"]["buf"]
        host.copy_(a)                                   # all out...
        back = torch.empty_like(a)
        back.copy_(host)                                # ...all back
        return back * 2.0

    a = torch.ones((512, 512), device=device)          # 1 MB each way
    state = {"__offload__": {"buf": torch.empty((512, 512))}}
    return check(bug, a, state, passes=["memory_budget"], exemptions=(),
                 target="seeded:MEM002", device=device,
                 options={"memory_budget": {"host_transfer_bytes": 1 << 20}})


def _flagship_model(device="cpu"):
    """The self-check's debug Llama (JAX's ``_flagship`` config), its fp32
    params from a fixed seed."""
    from ..models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.debug(vocab=128, hidden=64, layers=2, heads=4,
                            kv_heads=2, inter=128, max_pos=64)
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.float32,
                             generator=_gen(device=device))
    return cfg, model


def seeded_prefill_chunk_over_budget(device="cpu") -> Report:
    """MEM001 on the serving entry: a unified ragged step whose prefill
    chunk (prefill_token_budget=48, 17 pages) blows through the budget
    declared for the decode-sized launch (``self_check.SERVING_HBM_BUDGET``
    fits the chunk-8 step): bumping the token budget must re-justify the
    declared budget, not grow the hot path silently."""
    from ..inference.serving import ContinuousBatchingEngine
    from .self_check import SERVING_HBM_BUDGET

    cfg, model = _flagship_model(device)
    eng = ContinuousBatchingEngine(cfg, model.functional_state(),
                                   max_slots=2, num_pages=17, page_size=16,
                                   max_seq_len=64, prefill_token_budget=48,
                                   device=device)
    fn, args, kwargs, _ = eng.analysis_entry()
    return check(fn, *args, kwargs=kwargs, passes=["memory_budget"],
                 exemptions=(), target="seeded:MEM001[prefill_chunk]",
                 device=device,
                 options={"memory_budget": {"hbm_bytes": SERVING_HBM_BUDGET}})


def seeded_reshard_over_budget(device="cpu") -> Report:
    """MEM001 on the reshard entry: an UNBOUNDED plan
    (``max_transient_bytes=None``: one step, whole leaves) moves a 1 MB
    host leaf through a redistribution entry whose declared transient
    budget is 64 KB (the overrun the size-capped planner prevents)."""
    from ..parallel.reshard import check_reshard_budget, plan_reshard
    from ..parallel.specs import Mesh, P

    mesh = Mesh((1,), ("x",), device_type=torch.device(device).type)
    tree = {"w": np.ones((512, 512), np.float32)}
    plan = plan_reshard(tree, mesh, {"w": P("x", None)},
                        max_transient_bytes=None)
    return check_reshard_budget(plan, tree, budget_bytes=64 << 10,
                                exemptions=(), device=device,
                                target="seeded:MEM001[reshard_plan]")


def seeded_replica_delivery_over_budget(device="cpu") -> Report:
    """MEM001 on the replica weight delivery: an UNBOUNDED delivery plan
    streams a 1 MB host weight tree against a 64 KB declared budget
    (``ReplicaSet.spawn`` streams through the size-capped cached plan;
    this proves the budget pin fires when the cap is bypassed)."""
    from ..inference.fleet import FleetConfig, ReplicaSet

    host = {"w": np.ones((512, 512), np.float32)}      # 1 MB, host-side
    rs = ReplicaSet(host, engine_factory=lambda p: None,
                    config=FleetConfig(max_transient_bytes=None),
                    device=device)
    return rs.check_delivery_budget(
        budget_bytes=64 << 10, exemptions=(),
        target="seeded:MEM001[replica_delivery]")


def seeded_kv_handoff_over_budget(device="cpu") -> Report:
    """MEM001 on the KV handoff: an UNBOUNDED handoff plan (the whole page
    tree in one step) streams a 256 KB fp32 page tree against a 64 KB
    declared budget."""
    from ..inference.disagg import KVHandoffPlanner

    # [L=2, npages=8, kvh=2, page=16, d=64] fp32 = 128 KB a pool side
    tree = {"k": np.ones((2, 8, 2, 16, 64), np.float32),
            "v": np.ones((2, 8, 2, 16, 64), np.float32)}
    planner = KVHandoffPlanner(max_transient_bytes=None, device=device)
    return planner.check_handoff_budget(
        tree, budget_bytes=64 << 10, exemptions=(),
        target="seeded:MEM001[kv_handoff]")


# ----------------------------------------------------------- health probe


def seeded_unfused_health_probe(device="cpu") -> Report:
    """HEALTH001: a "probe" whose output carries tree-sized buffers (a
    finite mask per leaf beside the scalars: the host-style detector
    ported naively), against the unprobed step's static peak plus a small
    overhead."""
    params = {f"w{i}": torch.ones((128, 128), device=device)
              for i in range(8)}
    grads = {k: v * 1e-3 for k, v in params.items()}

    def base(params, grads):
        new = {k: v - 1e-3 * grads[k] for k, v in params.items()}
        return sum(g.sum() for g in grads.values()), new

    def bug(params, grads):
        new = {k: v - 1e-3 * grads[k] for k, v in params.items()}
        loss = sum(g.sum() for g in grads.values())
        probe = {
            "grad_norm": torch.sqrt(sum(g.square().sum()
                                        for g in grads.values())),
            # the seeded bug: the probe OUTPUT is a full tree of masks
            "finite_mask": {k: torch.isfinite(g) for k, g in grads.items()},
        }
        return loss, new, probe

    baseline = static_peak(capture(base, (params, grads),
                                   device=device))["peak_bytes"]
    return check(bug, params, grads, passes=["health_probe"], exemptions=(),
                 target="seeded:HEALTH001", device=device,
                 options={"health_probe":
                          {"baseline_peak_bytes": baseline,
                           "probe_overhead_bytes": 16 << 10}})


def seeded_collective_health_probe(device="cpu") -> Report:
    """HEALTH002: a probe that all-reduces its grad norm inside an entry
    whose declared baseline carries no collective (on the one-device step
    any collective is the regression).  The capture records the
    ``c10d`` node on a process group of the ``fake`` backend (two ranks,
    in this process; nothing is sent), or on the live default group."""
    import torch.distributed as dist

    def bug(g):
        sq = (g * g).sum()
        dist.all_reduce(sq)                              # the bug
        return g * 2.0, torch.sqrt(sq)

    own = not dist.is_initialized()
    if own:
        # importing it registers the "fake" backend (collectives that
        # send nothing)
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
    try:
        return check(bug, torch.ones((8, 8), device=device),
                     passes=["health_probe"], exemptions=(),
                     target="seeded:HEALTH002", device=device,
                     options={"health_probe": {"baseline_collectives": {}}})
    finally:
        if own:
            dist.destroy_process_group()


# ------------------------------------------------------ above one rank


def _line_mesh(n: int, device):
    """A live ("x",) mesh of ``n`` ranks over the fake group."""
    from .core import fake_mesh

    return fake_mesh((n,), ("x",), torch.device(device).type)


def seeded_collective_order(device="cpu") -> Report:
    """COLL001: a two-rank program whose Python branch drops the psum on
    one rank (JAX's ``lax.cond`` with one psumming branch): rank 0 issues
    an all-reduce its peer never matches."""
    from ..parallel.compat import all_reduce_raw
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(2, device)

        def body(v):
            if mesh.axis_index("x") == 0:              # the bug
                v = all_reduce_raw(v, "x", mesh)
            return v * 2.0

        return body, (torch.ones(8, device=device),), {}, mesh

    return check_ranks(build, 2, device=device, passes=["collective_order"],
                       exemptions=(), target="seeded:COLL001")


def seeded_ppermute_race(device="cpu") -> Report:
    """COLL002: a permute with two sources targeting one destination, perm
    [(0, 1), (1, 1)]."""
    from ..parallel.compat import _ppermute_raw
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(2, device)

        def body(v):
            return _ppermute_raw(v, "x", [(0, 1), (1, 1)], mesh)

        return body, (torch.ones(4, device=device),), {}, mesh

    return check_ranks(build, 2, device=device, passes=["collective_order"],
                       exemptions=(), target="seeded:COLL002")


def seeded_collective_budget(device="cpu") -> Report:
    """COMM001: two all-reduces a step against a declared budget of one
    (the per-leaf collective regression the bucketed engine prevents)."""
    from ..parallel.compat import all_reduce_raw
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(2, device)

        def body(a, b):
            return all_reduce_raw(a, "x", mesh) \
                + all_reduce_raw(b * 2.0, "x", mesh)

        x = torch.ones((4, 8), device=device)
        return body, (x, x + 1.0), {}, mesh

    return check_ranks(build, 2, ranks=[0], device=device,
                       passes=["collective_budget"], exemptions=(),
                       target="seeded:COMM001",
                       options={"collective_budget":
                                {"allreduce": {"count": 1}}})


def seeded_unscheduled_collective(device="cpu") -> Report:
    """COMM002: with an overlap engine declared active, a helper outside
    the engine and outside the step's code issues a bare psum: traffic
    the engine never scheduled."""
    from ..parallel.compat import all_reduce_raw
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(2, device)

        def rogue_reduce(v):
            return all_reduce_raw(v, "x", mesh)

        return rogue_reduce, (torch.ones(8, device=device),), {}, mesh

    return check_ranks(build, 2, ranks=[0], device=device,
                       passes=["collective_budget"], exemptions=(),
                       target="seeded:COMM002",
                       options={"collective_budget": {"overlap_active": True}})


def seeded_ppermute_ring_order(device="cpu") -> Report:
    """COMM003: a tick loop whose ring mixes rotation steps (perm [(0, 1),
    (1, 2), (2, 0), (3, 3)]: +1, +1, +2, 0), so stage pairings drift
    across ticks."""
    from ..parallel.compat import _ppermute_raw
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(4, device)

        def tick(c):
            return _ppermute_raw(c, "x", [(0, 1), (1, 2), (2, 0), (3, 3)],
                                 mesh)

        def body(v):
            for _ in range(2):
                v = tick(v)
            return v

        return body, (torch.ones(2, device=device),), {}, mesh

    return check_ranks(build, 4, ranks=[0], device=device,
                       passes=["collective_budget"], exemptions=(),
                       target="seeded:COMM003",
                       options={"collective_budget":
                                {"ring_functions": ("tick",)}})


def _codec_wire_fixture(coded, uncoded, args, target, device) -> Report:
    """COMM004 on a fake 2-slice axis of 4 (slice map (0, 0, 1, 1)): the
    declared DCN budget is the coded program's measured bytes, and the
    program checked is the same one with its codec dropped."""
    from ..distributed.topology import hierarchical_axis
    from ..parallel.codec import CollectiveCodec
    from ..parallel.overlap import register_hier
    from .core import capture, fake_ranks
    from .passes.collective_budget import collect_wire_table

    sm = (0, 0, 1, 1)
    with fake_ranks(4, 0):
        mesh = _line_mesh(4, device)
        hier = hierarchical_axis(mesh, "x", slice_map=sm)
        register_hier(mesh, "x", hier)
        codec = CollectiveCodec(block=64)
        good = coded(mesh, hier, codec)
        budget = collect_wire_table(capture(good, args, device=device,
                                            mesh=mesh),
                                    mesh, {"x": list(sm)})["dcn"]["bytes"]
        return check(uncoded(mesh, hier), *args,
                     passes=["collective_budget"], exemptions=(),
                     target=target, device=device, mesh=mesh,
                     options={"collective_budget":
                              {"wire": {"dcn_axes": {"x": list(sm)},
                                        "dcn_bytes": budget}}})


def seeded_codec_disabled(device="cpu") -> Report:
    """COMM004: a two-stage reduce-scatter whose codec is silently
    dropped, against the DCN budget its coded schedule honours (the packed
    int8 payload prices at about a quarter of the fp32 bytes)."""
    from ..parallel.overlap import hier_psum_scatter

    def coded(mesh, hier, codec):
        return lambda v: hier_psum_scatter(v, "x", hier, codec=codec,
                                           mesh=mesh)

    def uncoded(mesh, hier):                 # the seeded bug: no codec
        return lambda v: hier_psum_scatter(v, "x", hier, mesh=mesh)

    return _codec_wire_fixture(coded, uncoded,
                               (torch.ones((16, 64), device=device),),
                               "seeded:COMM004", device)


def seeded_moe_dispatch_codec_off(device="cpu") -> Report:
    """COMM004 on the EP dispatch: the expert all-to-all with its codec
    dropped against the coded dispatch's DCN budget."""
    from ..parallel.expert import make_ep_all_to_all

    def coded(mesh, hier, codec):
        return make_ep_all_to_all("x", hier=hier, codec=codec, mesh=mesh)

    def uncoded(mesh, hier):
        return make_ep_all_to_all("x", hier=hier, mesh=mesh)

    return _codec_wire_fixture(coded, uncoded,
                               (torch.ones((16, 64), device=device),),
                               "seeded:COMM004[moe_dispatch]", device)


def seeded_moe_dropless_codec_off(device="cpu") -> Report:
    """COMM004 on the dropless dispatch: the uncoded int32 count exchange
    then the payload windows, the codec dropped on the payload leg only,
    against the coded composite's DCN budget."""
    from ..parallel.expert import make_ep_all_to_all

    def dispatch(mesh, hier, codec):
        counts = make_ep_all_to_all("x", hier=hier, mesh=mesh)
        pay = make_ep_all_to_all("x", hier=hier, codec=codec, mesh=mesh)
        return lambda c, v: (counts(c), pay(v))

    return _codec_wire_fixture(
        dispatch, lambda mesh, hier: dispatch(mesh, hier, None),
        (torch.ones((4, 4), dtype=torch.int32, device=device),
         torch.ones((16, 64), device=device)),
        "seeded:COMM004[moe_dropless]", device)


def seeded_full_param_allgather(device="cpu") -> Report:
    """HLO002: a stage-3-sharded param gathered wholesale inside the step,
    against the stage-3 gate of half the param (no gather may exceed the
    largest per-layer parameter)."""
    from ..parallel.specs import NamedSharding, P
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(2, device)
        p = NamedSharding(mesh, P("x", None)).shard(
            torch.ones((1024, 64), device=device))

        def bug(a):
            return a.full() * 2.0             # gathers the whole param

        return bug, (p,), {}, mesh

    return check_ranks(build, 2, ranks=[0], device=device,
                       passes=["hlo_post_checks"], exemptions=(),
                       target="seeded:HLO002",
                       options={"hlo_post_checks": {
                           "max_allgather_bytes": 1024 * 64 * 4 // 2}})


def seeded_unplanned_reshard(device="cpu") -> Report:
    """SHARD001: the caller's code converts a sharded operand's layout (an
    all-gather of the whole leaf, then its transposed block) that no step
    plan issued."""
    from ..parallel.specs import NamedSharding, P
    from .core import check_ranks

    def build(rank):
        mesh = _line_mesh(2, device)
        x = NamedSharding(mesh, P("x", None)).shard(
            torch.ones((8, 8), device=device))

        def bug(a):
            full = a.full() * 2.0                      # the reshard
            return NamedSharding(mesh, P(None, "x")).shard(full).local.sum()

        return bug, (x,), {}, mesh

    return check_ranks(build, 2, ranks=[0], device=device,
                       passes=["sharding_consistency"], exemptions=(),
                       target="seeded:SHARD001",
                       options={"sharding_consistency":
                                {"audit_resharding": True}})


def seeded_replication_waste(device="cpu") -> Report:
    """SHARD002: a 1 MB leaf left replicated on a 4-way axis its dims
    divide: 0.75 MB of residency a rank the plan ignores."""
    from ..parallel.specs import SpecLayout, TensorSpec
    from .sharding import check_layout

    layout = SpecLayout(
        mesh_axes=(("x", 4),),
        entries={"model.layers.*.mlp.up_proj.weight": TensorSpec(
            shape=(512, 512), dtype="float32", dim_axes=((), ()))})
    return check_layout(layout, replicated_min_bytes=256 << 10,
                        exemptions=(), target="seeded:SHARD002")


def seeded_cross_stack_divergence(device="cpu") -> Report:
    """SHARD003: two stacks placing one logical parameter by transposed
    specs."""
    from ..parallel.specs import SpecLayout, TensorSpec
    from .sharding import check_cross_stack

    key = "model.layers.*.self_attn.q_proj.weight"
    axes = (("sharding", 2), ("mp", 2))
    a = SpecLayout(mesh_axes=axes, entries={key: TensorSpec(
        shape=(64, 64), dtype="float32", dim_axes=(("sharding",), ("mp",)))})
    b = SpecLayout(mesh_axes=axes, entries={key: TensorSpec(
        shape=(64, 64), dtype="float32", dim_axes=(("mp",), ("sharding",)))})
    return check_cross_stack({"mesh": a, "overlap": b}, exemptions=(),
                             target="seeded:SHARD003")


def seeded_shard_padding(device="cpu") -> Report:
    """SHARD004: a hand-written spec cutting a 129-row leaf 4 ways (every
    shard pads to 33 rows; the at-rest rule would have replicated it)."""
    from ..parallel.specs import SpecLayout, TensorSpec
    from .sharding import check_layout

    layout = SpecLayout(
        mesh_axes=(("x", 4),),
        entries={"lm_head.weight": TensorSpec(
            shape=(129, 64), dtype="float32", dim_axes=(("x",), ()))})
    return check_layout(layout, exemptions=(), target="seeded:SHARD004")


def seeded_unsharded_update(device="cpu") -> Report:
    """SHARD005: a flat update on a mesh of two whose state is the whole
    row-major buffer on every rank: the update runs replicated where the
    step's layout cuts it two ways."""
    from ..parallel.schedule import FlatUpdateLayout
    from ..parallel.specs import P
    from .core import fake_ranks

    n = 1 << 15

    def bug(st, g):                     # the whole buffer on every rank
        m1 = st["__flat__"]["decay|float32"]["moment1"]
        m1.mul_(0.9).add_(g, alpha=0.1)
        return m1.sum()

    state = {"__flat__": {"decay|float32": {
        "moment1": torch.zeros(n, device=device),
        "moment2": torch.zeros(n, device=device)}}}
    with fake_ranks(2, 0):
        mesh = _line_mesh(2, device)
        layout = FlatUpdateLayout(mesh, lambda name, shape: P())
        return check(bug, state, torch.ones(n, device=device), mesh=mesh,
                     device=device, passes=["sharding_consistency"],
                     exemptions=(), target="seeded:SHARD005",
                     options={"sharding_consistency": {
                         "expect_update_pin": True, "flat_layout": layout,
                         "update_min_bytes": 1 << 10}})


def seeded_schedule_divergence(device="cpu") -> Report:
    """SCHED001: a hand-written stack table whose q_proj placement is
    transposed against the schedule's derivation."""
    from ..parallel.schedule import PartitionSchedule
    from ..parallel.specs import Mesh, P, SpecLayout, TensorSpec
    from .sharding import check_schedule_derivation

    mesh = Mesh((2, 2), ("sharding", "mp"))
    key = "model.layers.*.self_attn.q_proj.weight"
    sched = PartitionSchedule.from_plan(mesh, {key: (64, 64)},
                                        lambda n: P("sharding", "mp"))
    hand = SpecLayout(
        mesh_axes=(("sharding", 2), ("mp", 2)),
        entries={key: TensorSpec(shape=(64, 64), dtype="float32",
                                 dim_axes=(("mp",), ("sharding",)))})
    return check_schedule_derivation(sched, {"mesh": hand}, exemptions=(),
                                     target="seeded:SCHED001")


# ------------------------------------------------------ lock discipline


def _race_report(code: str, src: str) -> Report:
    import textwrap

    from .passes.lock_discipline import analyze_source

    rel = f"seeded/{code.lower()}.py"
    findings = analyze_source(textwrap.dedent(src), rel)
    return Report(target=f"seeded:{code}", findings=findings,
                  passes_run=("lock_discipline",))


def seeded_unguarded_write() -> Report:
    """RACE001: a counter bumped under its lock but reset lock-free —
    the reset can interleave between the bump's read and write."""
    return _race_report("RACE001", """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.value = 0

            def bump(self):
                with self._lock:
                    self.value += 1

            def reset(self):
                self.value = 0
        """)


def seeded_lock_order_inversion() -> Report:
    """RACE002: one path nests send->recv, the other holds recv and
    reaches send THROUGH A HELPER CALL — the cross-method edge the
    analyzer must close over, and the classic two-thread deadlock."""
    return _race_report("RACE002", """
        import threading

        class Transfer:
            def __init__(self):
                self._send_lock = threading.Lock()
                self._recv_lock = threading.Lock()
                self.sent = 0
                self.received = 0

            def one(self):
                with self._send_lock:
                    with self._recv_lock:
                        self.sent += 1
                        self.received += 1

            def _locked_step(self):
                with self._send_lock:
                    self.sent += 1

            def other(self):
                with self._recv_lock:
                    self._locked_step()
                    self.received += 1
        """)


def seeded_blocking_under_lock() -> Report:
    """RACE003: a sleep inside the critical section — every other
    tick blocks on the lock for the full sleep (the serving-tick
    latency/deadlock hazard class: a kernel build, collective, recv,
    fsync under a lock)."""
    return _race_report("RACE003", """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()
                self.last = None

            def poll(self):
                with self._lock:
                    time.sleep(0.05)
                    self.last = 1
        """)


def seeded_check_then_act() -> Report:
    """RACE004: the PRE-FIX watchdog handler/flag race, minimized —
    ``complete`` checks ``task.timed_out`` OUTSIDE the lock, then
    acquires it to act, while the scanner flags ``timed_out`` under
    the same lock: the flag can flip between check and act, yielding
    a task both completed and flagged hung (the bug the watchdog fixed;
    the pass must catch the bug we actually shipped)."""
    return _race_report("RACE004", """
        import threading

        class Manager:
            def __init__(self):
                self._lock = threading.Lock()
                self.tasks = {}

            def complete(self, task):
                if task.timed_out:          # check OUTSIDE the lock
                    return
                with self._lock:            # act UNDER it
                    task.done = True
                    self.tasks.pop(task.seq, None)

            def _scan(self):
                with self._lock:
                    for t in list(self.tasks.values()):
                        t.timed_out = True
        """)


GRAPH_SEEDED = {
    "DT001": seeded_fp32_matmul,
    "DT002": seeded_f64_leak,
    "DT003": seeded_fp32_carry,
    "DON001": seeded_undonated_state,
    "DON002": seeded_use_after_donate,
    "RT001": seeded_weak_type_churn,
    "RT002": seeded_signature_churn,
    "HEALTH001": seeded_unfused_health_probe,
    "HEALTH002": seeded_collective_health_probe,
    "MEM001": seeded_peak_over_budget,
    # registry keys carry a [variant] suffix: the report holds the BARE code
    "MEM001[prefill_chunk]": seeded_prefill_chunk_over_budget,
    "MEM001[reshard_plan]": seeded_reshard_over_budget,
    "MEM001[replica_delivery]": seeded_replica_delivery_over_budget,
    "MEM001[kv_handoff]": seeded_kv_handoff_over_budget,
    "MEM002": seeded_host_round_trip,
    "COLL001": seeded_collective_order,
    "COLL002": seeded_ppermute_race,
    "COMM001": seeded_collective_budget,
    "COMM002": seeded_unscheduled_collective,
    "COMM003": seeded_ppermute_ring_order,
    "COMM004": seeded_codec_disabled,
    "COMM004[moe_dispatch]": seeded_moe_dispatch_codec_off,
    "COMM004[moe_dropless]": seeded_moe_dropless_codec_off,
    "HLO002": seeded_full_param_allgather,
    "SHARD001": seeded_unplanned_reshard,
    "SHARD002": seeded_replication_waste,
    "SHARD003": seeded_cross_stack_divergence,
    "SHARD004": seeded_shard_padding,
    "SHARD005": seeded_unsharded_update,
    "SCHED001": seeded_schedule_divergence,
}

RACE_SEEDED = {
    "RACE001": seeded_unguarded_write,
    "RACE002": seeded_lock_order_inversion,
    "RACE003": seeded_blocking_under_lock,
    # the minimized pre-fix watchdog race
    "RACE004": seeded_check_then_act,
}

# Every graph fixture captures a small program, and one test process
# reaches the registry from several consumers (the parametrised fixture
# test, the self-check, the budget tests): reports are read-only and the
# programs deterministic, so each is paid once per (code, device).
_REPORT_MEMO: dict = {}


def _memoized_fixture(code, fn):
    def run(device="cpu") -> Report:
        key = (code, str(torch.device(device)))
        rep = _REPORT_MEMO.get(key)
        if rep is None:
            rep = fn(device) if code in GRAPH_SEEDED else fn()
            _REPORT_MEMO[key] = rep
        return rep

    run.__name__ = fn.__name__
    run.__doc__ = fn.__doc__
    run.__wrapped__ = fn
    return run


SEEDED = {code: _memoized_fixture(code, fn)
          for code, fn in {**GRAPH_SEEDED, **RACE_SEEDED}.items()}

__all__ = ["GRAPH_SEEDED", "RACE_SEEDED", "SEEDED"] + sorted(
    fn.__name__ for fn in {**GRAPH_SEEDED, **RACE_SEEDED}.values())
