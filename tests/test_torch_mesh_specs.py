"""The partitioning vocabulary of the port (parallel/specs.py,
parallel/schedule.py, models/llama.py's sharding plan) against the JAX
package, on abstract meshes in one process.

The port's schedule table, leaf plans and shard-major transforms are plan
math over shapes and axis sizes, so they are held against JAX's on the
conftest's 8 virtual CPU devices with no process group: tables equal as
JSON, leaf plans field for field, flattened and packed buffers element for
element (exact: both are permutations of the same fp32 values).  The
twins of tests/test_schedule.py's unit tests carry its names.
"""

import json

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import llama as jllama
from paddle_tpu.parallel import schedule as jsched
from paddle_tpu.parallel import specs as jspecs
from paddle_tpu_torch.models import (LLAMA_SHARDING_PLAN, LlamaConfig,
                                     LlamaForCausalLM, plan_spec_for)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import compat
from paddle_tpu_torch.parallel import schedule as tsched
from paddle_tpu_torch.parallel import specs as tspecs
from paddle_tpu_torch.parallel.specs import Mesh, P

AXES = ("dp", "sharding", "mp")
SHAPES = [(2, 2, 2), (1, 2, 2), (2, 2, 1), (1, 4, 1), (1, 1, 4), (1, 1, 1)]


def _jmesh(shape, names=AXES):
    n = int(np.prod(shape))
    return JaxMesh(np.asarray(jax.devices()[:n], dtype=object).reshape(shape),
                   names)


def _tuple(spec):
    return tuple(spec)


@pytest.fixture(scope="module")
def models():
    state = paddle.get_rng_state()
    paddle.seed(7)
    jm = JaxModel(JaxConfig.debug())
    paddle.set_rng_state(state)
    return jm, LlamaForCausalLM(LlamaConfig.debug(), device="cpu")


# ------------------------------------------------------------- the plan

def test_plan_equals_jax():
    assert set(LLAMA_SHARDING_PLAN) == set(jllama.LLAMA_SHARDING_PLAN)
    for k, v in jllama.LLAMA_SHARDING_PLAN.items():
        assert _tuple(LLAMA_SHARDING_PLAN[k]) == _tuple(v), k
    for name in ("model.layers.3.self_attn.k_proj.weight", "lm_head.weight",
                 "model.norm.weight", "unknown.bias"):
        assert _tuple(plan_spec_for(name)) == _tuple(jllama.plan_spec_for(
            name)), name


def test_llama_sharding_plan_applied(models):
    """Twin of tests/test_llama.py::test_llama_sharding_plan_applied: the
    at-rest specs on the (2, 2, 2) mesh."""
    _, model = models
    sched = tsched.PartitionSchedule.from_model(model, Mesh((2, 2, 2), AXES))
    specs = {n: _tuple(sched.spec_for(n, p.shape))
             for n, p in model.named_parameters()}
    assert specs["model.embed_tokens.weight"] == (("mp", "sharding"), None)
    assert specs["model.layers.0.self_attn.q_proj.weight"] == ("sharding",
                                                               "mp")
    assert specs["model.layers.0.mlp.down_proj.weight"] == ("mp", "sharding")
    assert specs["model.norm.weight"] in ((), (None,))


# ------------------------------------------------------------ the table

@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_schedule_table_equals_jax(models, shape):
    jm, model = models
    want = jsched.PartitionSchedule.from_model(jm, _jmesh(shape))
    got = tsched.PartitionSchedule.from_model(model, Mesh(shape, AXES))
    assert json.dumps(got.table.to_table(), sort_keys=True) \
        == json.dumps(want.table.to_table(), sort_keys=True)
    assert got.tactic_names() == want.tactic_names()
    assert got.describe() == want.describe()
    for name, p in model.named_parameters():
        assert _tuple(got.spec_for(name, p.shape)) \
            == _tuple(want.spec_for(name, p.shape)), name
    lo_t, lo_j = got.flat_update_layout(), want.flat_update_layout()
    assert lo_t.signature == lo_j.signature and lo_t.ways == lo_j.ways
    assert _tuple(lo_t.flat_spec()) == _tuple(lo_j.flat_spec())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_leaf_plans_equal_jax(models, shape):
    jm, model = models
    lo_j = jsched.PartitionSchedule.from_model(
        jm, _jmesh(shape)).flat_update_layout()
    lo_t = tsched.PartitionSchedule.from_model(
        model, Mesh(shape, AXES)).flat_update_layout()
    for name, p in model.named_parameters():
        a, b = lo_t.leaf_plan(name, p.shape), lo_j.leaf_plan(name, p.shape)
        if b is None:
            assert a is None, name
            continue
        assert (a.shape, a.pre, a.perm, a.local) \
            == (b.shape, b.pre, b.perm, b.local), name
        assert _tuple(a.spec) == _tuple(b.spec), name


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 2), (1, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flatten_and_pack_equal_jax(models, shape):
    """flatten_leaf and pack_group on the same numpy values give JAX's
    buffers element for element, and unpack_group gives the values back
    bit for bit."""
    jm, model = models
    lo_j = jsched.PartitionSchedule.from_model(
        jm, _jmesh(shape)).flat_update_layout()
    lo_t = tsched.PartitionSchedule.from_model(
        model, Mesh(shape, AXES)).flat_update_layout()
    rng = np.random.default_rng(3)
    vals = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
            for n, p in model.named_parameters()}
    keys = sorted(vals)
    plans_t = {k: lo_t.leaf_plan(k, vals[k].shape) for k in keys}
    plans_j = {k: lo_j.leaf_plan(k, vals[k].shape) for k in keys}
    for k in keys:
        np.testing.assert_array_equal(
            lo_t.flatten_leaf(plans_t[k], vals[k]).numpy(),
            np.asarray(lo_j.flatten_leaf(plans_j[k], vals[k])), err_msg=k)
    packed = lo_t.pack_group(plans_t, keys, vals)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(lo_j.pack_group(plans_j, keys, vals)))
    back = lo_t.unpack_group(plans_t, keys, packed)
    for k in keys:
        np.testing.assert_array_equal(back[k].numpy(), vals[k], err_msg=k)


# ------------------------------------------------ the placement rules

def test_placement_rules_equal_jax():
    for shape in SHAPES:
        tm, jmesh = Mesh(shape, AXES), _jmesh(shape)
        assert tspecs.mesh_axis_sizes(tm) == jspecs.mesh_axis_sizes(jmesh)
        assert _tuple(tspecs.batch_partition_spec(tm)) \
            == _tuple(jspecs.batch_partition_spec(jmesh))
        for spec, dims in (((("mp", "sharding"), None), (256, 64)),
                           (("sharding", "mp"), (64, 32)),
                           (("sharding", "mp"), (6, 10)),
                           (("mp", "sharding"), (64, 7)), ((None,), (64,))):
            assert _tuple(tspecs.filter_divisible_spec(P(*spec), dims, tm)) \
                == _tuple(jspecs.filter_divisible_spec(JP(*spec), dims,
                                                       jmesh))
            assert _tuple(tspecs.filter_spec_to_mesh(P(*spec), tm)) \
                == _tuple(jspecs.filter_spec_to_mesh(JP(*spec), jmesh))
            assert tspecs.axis_dim_picks(P(*spec), dims, tm) \
                == jspecs.axis_dim_picks(JP(*spec), dims, jmesh)
        for size in (1, 2, 3, 4, 8):
            assert tspecs.pick_batch_axes(tm, ("dp", "sharding"), size) \
                == jspecs.pick_batch_axes(jmesh, ("dp", "sharding"), size)
    spec = P(("dp", "sharding"), None)
    assert _tuple(tspecs.lead_batch_spec(spec, 3)) \
        == _tuple(jspecs.lead_batch_spec(JP(("dp", "sharding"), None), 3))
    assert _tuple(tspecs.microbatched("dp", None)) \
        == _tuple(jspecs.microbatched("dp", None))
    assert _tuple(tspecs.token_batch_spec("dp", "sep")) \
        == _tuple(jspecs.token_batch_spec("dp", "sep"))
    assert _tuple(tspecs.activation_spec("dp")) \
        == _tuple(jspecs.activation_spec("dp"))
    assert tspecs.batch_entry(("dp",)) == jspecs.batch_entry(("dp",))
    assert tspecs.is_expert_leaf("blocks.0.mlp.w_up") \
        and not tspecs.is_expert_leaf("q_proj.weight")
    assert _tuple(tspecs.expert_leaf_spec(P(None, "mp"))) \
        == _tuple(jspecs.expert_leaf_spec(JP(None, "mp")))
    assert tsched.canonical_key("model.layers.11.mlp.up_proj.weight") \
        == jsched.canonical_key("model.layers.11.mlp.up_proj.weight")


def test_hybrid_leaf_spec_equals_jax():
    names = ("pp", "dp", "sharding", "sep", "mp")
    tm, jmesh = Mesh((2, 1, 2, 1, 2), names), _jmesh((2, 1, 2, 1, 2), names)
    for name, shape in (("model.layers.self_attn.q_proj.weight", (2, 64, 64)),
                        ("model.norm.weight", (64,)),
                        ("lm_head.weight", (64, 128))):
        assert _tuple(tsched.hybrid_leaf_spec(name, shape, tm, plan_spec_for)) \
            == _tuple(jsched.hybrid_leaf_spec(name, shape, jmesh,
                                              jllama.plan_spec_for)), name


def test_tensor_specs_of_blocks(models):
    """layout_from_plan equals JAX's; a ShardedTensor's spec is its
    placement's (tensor_spec_from_array, layout_from_arrays)."""
    jm, model = models
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    got = tspecs.layout_from_plan(shapes, Mesh((1, 2, 2), AXES),
                                  plan_spec_for, "float32")
    want = jspecs.layout_from_plan(shapes, _jmesh((1, 2, 2)),
                                   jllama.plan_spec_for, "float32")
    assert got.to_table() == want.to_table()
    st = tspecs.ShardedTensor(torch.zeros(32, 32), (64, 64),
                              P("sharding", "mp"), Mesh((1, 2, 2), AXES))
    ts = tspecs.tensor_spec_from_array(st)
    assert ts.dim_axes == (("sharding",), ("mp",)) and ts.shape == (64, 64)
    assert ts.nbytes == 64 * 64 * 4 and ts.memory_kind == "device"
    table = tspecs.layout_from_arrays({"w": st, "b": torch.zeros(3)})
    assert table.mesh_axes == (("dp", 1), ("sharding", 2), ("mp", 2))
    assert table["b"].dim_axes == ((),)


# --------------------------------------- the tests/test_schedule.py twins

def test_tactics_for_mesh_names_composition():
    assert [t.name for t in tsched.tactics_for_mesh(Mesh((2, 2, 2), AXES))] \
        == ["dp", "sharding3", "tp"]
    hmesh = Mesh((2, 1, 2, 1, 2), ("pp", "dp", "sharding", "sep", "mp"))
    assert [t.name for t in tsched.tactics_for_mesh(hmesh)] \
        == ["pp", "sharding3", "tp"]


def test_from_table_roundtrip_and_rederive():
    mesh = Mesh((2, 2, 2), AXES)
    sched = tsched.PartitionSchedule.from_plan(
        mesh, {"model.layers.0.w": (64, 64), "norm": (64,)},
        lambda n: P("sharding", "mp") if n.endswith("w") else P())
    rt = tsched.PartitionSchedule.from_table(sched.table.to_table(),
                                             mesh=mesh)
    assert rt.table.entries == sched.table.entries
    assert rt.table.mesh_axes == sched.table.mesh_axes
    assert rt.rederive(mesh).table.entries == sched.table.entries
    r2 = sched.rederive(Mesh((1, 2, 2), AXES))
    assert dict(r2.table.mesh_axes)["sharding"] == 2
    assert r2.table["model.layers.*.w"].dim_axes == (("sharding",), ("mp",))
    # no mesh: an abstract one of the table's axes
    assert dict(tsched.PartitionSchedule.from_table(
        sched.table.to_table()).mesh.shape) == {"dp": 2, "sharding": 2,
                                                "mp": 2}


def _layout222():
    specs = {"q": P("sharding", "mp"), "o": P("mp", "sharding"),
             "embed": P(("mp", "sharding"), None), "norm": P()}
    mesh = Mesh((2, 2, 2), AXES)
    return tsched.FlatUpdateLayout(mesh, lambda n, s: specs[n]), mesh


def test_flat_layout_flatten_unflatten_exact_inverse():
    lo, _ = _layout222()
    rng = np.random.default_rng(0)
    for name, shape in (("q", (64, 64)), ("o", (64, 64)),
                        ("embed", (128, 64)), ("norm", (64,))):
        plan = lo.leaf_plan(name, shape)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        f2 = lo.flatten_leaf(plan, x)
        assert tuple(f2.shape) == (lo.ways, plan.local)
        assert torch.equal(lo.unflatten_leaf(plan, f2), x)


def test_flat_layout_leaf_plan_fallback_on_indivisible():
    lo, mesh = _layout222()
    lo2 = tsched.FlatUpdateLayout(mesh, lambda n, s: P())
    assert lo2.leaf_plan("tiny", (7,)) is None
    assert lo2.leaf_plan("scalar", ()) is None


def test_flat_groups_fall_back_rowmajor_when_any_leaf_fails():
    _, mesh = _layout222()
    lo2 = tsched.FlatUpdateLayout(mesh, lambda n, s: P())
    opt = AdamW(learning_rate=1e-3)
    (g,) = opt._flat_groups({"a": torch.zeros(64), "tiny": torch.zeros(7)},
                            None, lo2)
    assert "layout" not in g and "|sm[" not in g["name"]
    (g2,) = opt._flat_groups({"a": torch.zeros(64), "b": torch.zeros(128)},
                             None, lo2)
    assert g2["name"].endswith(lo2.signature) and "plans" in g2


def test_empty_axes_layout_degrades_to_rowmajor_naming():
    lo = tsched.FlatUpdateLayout(Mesh((1, 1, 1), AXES), lambda n, s: P())
    assert lo.axes == () and lo.signature == "sm[]"
    opt = AdamW(learning_rate=1e-3)
    params = {"a": torch.ones(64)}
    st = opt.init_flat_state(params, flat_layout=lo)
    assert sorted(st["__flat__"]) == ["decay|float32"]
    new_p, _ = opt.apply_flat(params, {"a": torch.ones(64)}, st, 1e-3, 1,
                              flat_layout=lo)
    assert torch.isfinite(new_p["a"]).all()


def test_apply_flat_rejects_mismatched_wire_format():
    _, mesh = _layout222()
    lo2 = tsched.FlatUpdateLayout(mesh, lambda n, s: P())
    opt = AdamW(learning_rate=1e-3)
    params = {"a": torch.ones(64)}
    st = opt.init_flat_state(params, flat_layout=lo2)
    assert any("|sm[" in k for k in st["__flat__"])
    bad = {"__flat__": {k.replace("sm[", "sm[pp4."): v
                        for k, v in st["__flat__"].items()}}
    with pytest.raises(ValueError, match="different flat layout"):
        opt.apply_flat(params, {"a": torch.ones(64)}, bad, 1e-3, 1,
                       flat_layout=lo2)


def test_global_flat_state_equals_jax_init():
    """init_flat_state under a layout, from plain (global) tensors, gives
    JAX's shard-major buffers: bf16 params, fp32 masters, decay mask."""
    import jax.numpy as jnp
    from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW

    rng = np.random.default_rng(4)
    vals = {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "norm.weight": rng.standard_normal(64).astype(np.float32)}
    specs = {"w": P("sharding", "mp"), "norm.weight": P()}
    jspec = {"w": JP("sharding", "mp"), "norm.weight": JP()}
    lo = tsched.FlatUpdateLayout(Mesh((2, 2, 2), AXES),
                                 lambda n, s: specs[n])
    jlo = jsched.FlatUpdateLayout(_jmesh((2, 2, 2)), lambda n, s: jspec[n])
    mask = {"w": True, "norm.weight": False}
    got = AdamW(1e-3).init_flat_state(
        {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in vals.items()},
        decay_mask=mask, flat_layout=lo,
        master_from={k: torch.from_numpy(v) for k, v in vals.items()})
    want = JaxAdamW(1e-3, parameters=[]).init_flat_state(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in vals.items()},
        decay_mask=mask, flat_layout=jlo,
        master_from={k: jnp.asarray(v) for k, v in vals.items()})
    assert sorted(got["__flat__"]) == sorted(want["__flat__"])
    for g, gs in want["__flat__"].items():
        for key, v in gs.items():
            np.testing.assert_array_equal(got["__flat__"][g][key].numpy(),
                                          np.asarray(v), err_msg=g + key)


# --------------------------------------------- what waits for later A5

# the names A5.1 left raising; since A5.2 the overlap engine's are ported
# (item None: the call returns) and what still raises cites its item
@pytest.mark.parametrize("call,item", [
    (lambda s: s.stack_plan(), None),
    (lambda s: tsched.StackSchedule({}, [], [], 1, ()), None),
    (lambda s: tsched.PartitionSchedule.from_moe_ep(None, s.mesh), "A5.3"),
    (lambda s: tsched.PartitionPoint("x", ()), None),
    (lambda s: tsched.JointScheduleConfig(
        tsched.PartitionPoint("x", ()), None), None),
    (lambda s: tsched.joint_schedule_lattice(()), None),
    (lambda s: tsched.choose_joint_config([]), None),
    (lambda s: tsched.measure_dcn_wire_bytes(None, None, ()), "A7"),
    (lambda s: tsched.tune_schedule_config(None, 0, (),
                                           dcn_wire_bytes=1), "A7"),
], ids=["stack_plan", "StackSchedule", "from_moe_ep", "PartitionPoint",
        "JointScheduleConfig", "joint_schedule_lattice", "choose_joint_config",
        "measure_dcn_wire_bytes", "tune_schedule_config"])
def test_later_parts_raise_citing_a5(models, call, item):
    _, model = models
    sched = tsched.PartitionSchedule.from_model(model, Mesh((1, 2, 2), AXES))
    if item is None:
        call(sched)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue {item}"):
        call(sched)


def test_abstract_mesh_has_no_groups():
    mesh = Mesh((2, 2, 2), AXES)
    assert not mesh.live and mesh.size == 8
    assert tspecs.mesh_device_ids(mesh) == frozenset(range(8))
    with pytest.raises(ValueError, match="abstract"):
        mesh.group("mp")
    with pytest.raises(ValueError, match="abstract"):
        mesh.rank
    with pytest.raises(ValueError, match="init_mesh"):
        tspecs.init_mesh("tpu", (1,), ("dp",))


def test_one_rank_mesh_needs_no_group():
    """A mesh of one rank is rank 0 and live without a process group: every
    collective over its size-1 axes is a no-op (the one-device train step
    runs on it)."""
    mesh = Mesh((1, 1, 1), AXES)
    assert mesh.live and mesh.rank == 0
    assert mesh.coords == {"dp": 0, "sharding": 0, "mp": 0}
    x = torch.arange(6.0).reshape(2, 3)
    assert compat.psum(x, "mp", mesh=mesh) is x
    assert compat.all_gather(x, "sharding", axis=1, mesh=mesh) is x
    with pytest.raises(ValueError, match="process group"):
        mesh.group("mp")
