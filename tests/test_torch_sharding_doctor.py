"""The port's Sharding Doctor (paddle_tpu_torch/analysis/sharding.py and
passes/sharding_consistency.py) against the JAX package's, on the CPU.

- the canonical tables: each stack's table (the mesh step's, the overlap
  stack's, the hybrid stack's, the EP stack's) equals the one JAX's
  extractor gives for the same debug flagship and mesh shape;
- the table verdicts: SHARD002, SHARD003 and SHARD004 on the same tables
  equal JAX's ``replication_waste_findings``, ``cross_stack_findings`` and
  ``shard_padding_findings`` (code, tensor, bytes);
- the step-level codes, where JAX's own legs are red on this JAX version
  (SHARD001 and SHARD005 read XLA's output): the seeded fixtures fire
  exactly their code, the flagship steps captured at rank 0 of a fake
  group of 8 are clean, a reshard from the caller's code is counted as
  unplanned, and a whole flat state on a cut layout fires SHARD005;
- the schedule: its derivation, stack plan and table round trip against
  the stacks (SCHED001).

Every test leaves no process group behind.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import Mesh as JMesh

from paddle_tpu.analysis import sharding as JS
from paddle_tpu.analysis.passes import sharding_consistency as JSC
from paddle_tpu.analysis.self_check import _flagship as _jax_flagship
from paddle_tpu.parallel.specs import SpecLayout as JSpecLayout
from paddle_tpu.parallel.specs import TensorSpec as JTensorSpec

import paddle_tpu_torch.analysis as A
from paddle_tpu_torch.analysis import sharding as S
from paddle_tpu_torch.analysis.core import check_ranks, fake_ranks
from paddle_tpu_torch.analysis.fixtures import SEEDED
from paddle_tpu_torch.analysis.passes import sharding_consistency as SC
from paddle_tpu_torch.analysis.self_check import (
    SHARDING_DATA_AXES, SHARDING_REPLICATED_MIN_BYTES, WORLD, _flagship,
    _llama_build, _moe_ep_cfg, flat_local_sizes, sharding_section)
from paddle_tpu_torch.models.llama import llama_decay_mask
from paddle_tpu_torch.models.llama_hybrid import HYBRID_AXES
from paddle_tpu_torch.parallel.specs import Mesh, SpecLayout, TensorSpec

SHARD_CODES = ("SHARD001", "SHARD002", "SHARD003", "SHARD004", "SHARD005",
               "SCHED001")


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


def _jmesh(shape, names):
    devs = np.asarray(jax.devices()[:int(np.prod(shape))], dtype=object)
    return JMesh(devs.reshape(shape), names)


def _to_jax(layout: SpecLayout) -> JSpecLayout:
    return JSpecLayout(mesh_axes=tuple(layout.mesh_axes), entries={
        k: JTensorSpec(shape=ts.shape, dtype=ts.dtype,
                       dim_axes=ts.dim_axes, memory_kind=ts.memory_kind)
        for k, ts in layout.items()})


def _verdicts(findings):
    return sorted((f.code, f.arg_path, f.data.get("bytes"),
                   f.data.get("wasted_bytes"), f.data.get("padded_bytes"))
                  for f in findings)


# ------------------------------------------------------------ true positives


@pytest.mark.parametrize("code", SHARD_CODES)
def test_seeded_fixture_fires_exactly_its_code(code):
    rep = SEEDED[code]()
    assert rep.findings, rep.summary()
    assert set(rep.codes()) == {code}, rep.summary()


# ------------------------------------------------------ tables against JAX


@pytest.mark.parametrize("stack", ["mesh", "overlap", "hybrid"])
def test_stack_table_equals_jax(stack):
    """The port's table of each training stack equals JAX's extractor's on
    the same debug flagship (the mesh step's is JAX's GSPMD table)."""
    _, model, _, _, _, _ = _flagship()
    _, jmodel, _, _, _, _ = _jax_flagship()
    if stack == "hybrid":
        shape = (2, 1, 2, 1, 2)
        got = S.extract_hybrid_layout(model, Mesh(shape, HYBRID_AXES))
        want = JS.extract_hybrid_layout(jmodel, _jmesh(shape, HYBRID_AXES))
    else:
        names = ("dp", "sharding", "mp")
        mesh, jmesh = Mesh((2, 2, 2), names), _jmesh((2, 2, 2), names)
        if stack == "mesh":
            got = S.extract_mesh_layout(model, mesh)
            want = JS.extract_gspmd_layout(jmodel, jmesh)
        else:
            got = S.extract_overlap_layout(model, mesh)
            want = JS.extract_overlap_layout(jmodel, jmesh)
            assert got.buckets == want.buckets
            assert got.sync_suffixes == want.sync_suffixes
    assert got.to_table() == want.to_table()


def test_moe_ep_table_equals_jax():
    from paddle_tpu.parallel.expert import MoEEPConfig as JCfg
    from paddle_tpu.parallel.expert import moe_ep_layout as jlayout

    cfg = _moe_ep_cfg()
    jcfg = JCfg(d_model=16, d_hidden=32, num_expert=8, top_k=2,
                capacity_factor=2.0, aux_weight=0.01)
    names = ("dp", "sharding", "ep")
    got = S.extract_moe_ep_layout(cfg, Mesh((1, 2, 4), names))
    want = jlayout(jcfg, _jmesh((1, 2, 4), names))
    assert got.to_table() == want.to_table()


def _tables():
    _, model, _, _, _, _ = _flagship()
    mesh = Mesh((2, 2, 2), ("dp", "sharding", "mp"))
    return {"mesh": S.extract_mesh_layout(model, mesh),
            "overlap": S.extract_overlap_layout(model, mesh),
            "hybrid": S.extract_hybrid_layout(
                model, Mesh((2, 1, 2, 1, 2), HYBRID_AXES))}


def _planted():
    """Tables with verdicts to give: the flagship's own, its mesh table
    with every projection replicated, and a padded leaf."""
    tabs = _tables()
    rep = SpecLayout(tabs["mesh"].mesh_axes, {
        k: TensorSpec(ts.shape, ts.dtype, tuple(() for _ in ts.shape))
        for k, ts in tabs["mesh"].items()})
    pad = SpecLayout((("x", 4),), {"lm_head.weight": TensorSpec(
        (129, 64), "float32", (("x",), ()))})
    return {**tabs, "replicated": rep, "padded": pad}


@pytest.mark.parametrize("name", ["mesh", "overlap", "hybrid", "replicated",
                                  "padded"])
def test_table_verdicts_equal_jax(name):
    """SHARD002 and SHARD004 over one table: the port's verdicts are
    JAX's, finding for finding (the replicated table has many)."""
    layout = _planted()[name]
    for floor, ignore in ((SHARDING_REPLICATED_MIN_BYTES,
                           SHARDING_DATA_AXES), (1 << 10, ())):
        got = SC.replication_waste_findings(layout, floor, ignore)
        want = JSC.replication_waste_findings(_to_jax(layout), floor, ignore)
        assert _verdicts(got) == _verdicts(want)
    got = SC.shard_padding_findings(layout)
    want = JSC.shard_padding_findings(_to_jax(layout))
    assert _verdicts(got) == _verdicts(want)
    if name == "replicated":
        assert len(SC.replication_waste_findings(layout, 1 << 10)) > 5
    if name == "padded":
        assert [f.code for f in got] == ["SHARD004"]


def test_cross_stack_verdicts_equal_jax():
    tabs = _planted()
    for pick in (("mesh", "overlap", "hybrid"), ("mesh", "replicated")):
        sub = {k: tabs[k] for k in pick}
        got = SC.cross_stack_findings(sub)
        want = JSC.cross_stack_findings({k: _to_jax(v)
                                         for k, v in sub.items()})
        assert [(f.arg_path, f.data["stacks"]) for f in got] == \
            [(f.arg_path, f.data["stacks"]) for f in want]
    assert not SC.cross_stack_findings({k: tabs[k] for k in
                                        ("mesh", "overlap", "hybrid")})


# ------------------------------------------------------------ clean sweeps


def test_flagship_sharding_sweeps_are_clean():
    section = sharding_section()
    for name in ("mesh_train_step[accum1]", "mesh_train_step[accum4]",
                 "overlap_train_step", "hybrid_train_step[gpipe]",
                 "hybrid_train_step[1F1B]", "serving_param_layout",
                 "cross_stack", "schedule_derivation", "schedule_stack_plan",
                 "schedule_table_roundtrip", "moe_ep_layout",
                 "moe_ep_cross_stack"):
        assert section[name]["ok"], (name, section[name])


def test_planned_gathers_count_as_declared():
    """The overlap step's bucket gathers are planned (SHARD001 counts none
    against it); the same reshard from the caller's code is unplanned, and
    a declared allowance admits it."""
    from paddle_tpu_torch.parallel.overlap import OverlapConfig
    from paddle_tpu_torch.analysis.passes.collective_budget import \
        overlap_region_funcs

    with fake_ranks(WORLD, 0):
        fn, args, kw, mesh = _llama_build((2, 2, 2),
                                          overlap=OverlapConfig())(0)
        cap = A.capture(fn, args, kw, device="cpu", mesh=mesh)
    counts = SC.reshard_counts(cap, overlap_region_funcs())
    assert counts["allgather"]["planned"] > 0
    assert all(c["unplanned"] == 0 for c in counts.values()), counts
    rep = SEEDED["SHARD001"]()
    assert rep.findings[0].data["unplanned"] == 1
    # the seeded reshard declared deliberately passes
    from paddle_tpu_torch.analysis.fixtures import _line_mesh
    from paddle_tpu_torch.parallel.specs import NamedSharding, P

    def build(rank):
        m = _line_mesh(2, "cpu")
        x = NamedSharding(m, P("x", None)).shard(torch.ones((8, 8)))
        return (lambda a: a.full().sum()), (x,), {}, m

    rep = check_ranks(build, 2, ranks=[0], device="cpu",
                      passes=["sharding_consistency"], exemptions=(),
                      options={"sharding_consistency":
                               {"declared": {"allgather": 1}}})
    assert rep.ok, rep.summary()


def test_whole_flat_state_fires_shard005():
    """The accum-4 mesh step given the row-major flat state (whole on every
    rank) where its layout cuts the update 8 ways fires SHARD005; its own
    shard-major state is clean."""
    def report(flat_layout_given):
        build = _llama_build((2, 2, 2), accum_steps=4, flat=True)

        def built(rank):
            fn, args, kw, mesh = build(rank)
            if not flat_layout_given:
                cfg, model, opt, _, _, _ = _flagship()
                args = (args[0], opt.init_flat_state(
                    args[0], decay_mask=llama_decay_mask(model)),) + args[2:]
            return fn, args, kw, mesh

        _, model, opt, _, _, _ = _flagship()
        return check_ranks(
            built, WORLD, ranks=[0], device="cpu",
            passes=["sharding_consistency"], exemptions=(),
            options=lambda fn, args, mesh: {"sharding_consistency": {
                "expect_update_pin": True, "flat_layout": fn.flat_layout,
                "update_min_bytes": 4 << 10,
                "flat_local_sizes": flat_local_sizes(
                    opt, args[0], llama_decay_mask(model),
                    fn.flat_layout)}})

    assert report(True).ok
    bad = report(False)
    assert set(bad.codes()) == {"SHARD005"}, bad.summary()


def test_schedule_round_trip_and_stack_plan():
    from paddle_tpu_torch.parallel.schedule import PartitionSchedule

    _, model, _, _, _, _ = _flagship()
    mesh = Mesh((2, 2, 2), ("dp", "sharding", "mp"))
    sched = PartitionSchedule.from_model(model, mesh)
    assert S.check_schedule_derivation(
        sched, {"mesh": S.extract_mesh_layout(model, mesh)}).ok
    assert S.check_stack_plan_derivation(sched, model, mesh).ok
    rt = PartitionSchedule.from_table(sched.table.to_table(), mesh=mesh)
    assert S.check_schedule_derivation(rt.rederive(mesh),
                                       {"declared": sched.table}).ok
    # a moved placement is SCHED001
    moved = S.extract_mesh_layout(model, mesh)
    key = "model.layers.*.self_attn.q_proj.weight"
    ts = moved.entries[key]
    moved.entries[key] = TensorSpec(ts.shape, ts.dtype, ts.dim_axes[::-1])
    rep = S.check_schedule_derivation(sched, {"mesh": moved})
    assert rep.codes() == ["SCHED001"], rep.summary()


def test_collapse_layers_rejects_intra_stack_divergence():
    a = TensorSpec((4, 4), "float32", (("mp",), ()))
    b = TensorSpec((4, 4), "float32", ((), ("mp",)))
    with pytest.raises(ValueError, match="layers disagree"):
        S.collapse_layers(SpecLayout((("mp", 2),), {
            "model.layers.0.mlp.up_proj.weight": a,
            "model.layers.1.mlp.up_proj.weight": b}))


def test_tensor_spec_restrict_and_active_axes():
    ts = TensorSpec((8, 8), "float32", (("pp", "sharding"), ("mp",)))
    assert ts.restrict(frozenset({"sharding"})).dim_axes == (("sharding",),
                                                             ())
    assert ts.axes_used == {"pp", "sharding", "mp"}
    lo = SpecLayout((("dp", 1), ("sharding", 2), ("mp", 2)), {})
    assert lo.active_axes() == {"sharding", "mp"}
