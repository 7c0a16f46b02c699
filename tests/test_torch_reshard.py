"""The reshard planner and executor of the port (paddle_tpu_torch/parallel/
reshard.py) against the JAX package's ``parallel/reshard.py`` on the CPU.

- Plan math: ``ReshardPlan.summary()`` (leaves, moved, steps, total /
  moved / dcn bytes, max step transient, budget, destination mesh) equal
  to JAX's for the cases of tests/test_reshard.py:100-277 (the round-trip
  pairs, chunking granules, an unchunkable overrun, ``fit_spec``
  degradation, scalars and host arrays, DCN bytes under a declared
  ``slice_map``, empty and noop plans), with the leaf chunk spans equal
  too.  The port plans over abstract meshes of 8 ranks; its leaves carry
  the same global shapes, dtypes and placements as JAX's arrays.
- Execution: bit-equal on one rank (host values chunked under a cap, every
  assembled chunk within the plan's transient) and in the ``reshard4``
  gloo gang of 4 ranks (tests/torch_fault_injection.py
  ``reshard_gang_rank``): each pair of ``RESHARD_PAIRS`` live A -> B (the
  device route on the same ranks, the host route for the 4 -> 2 shrink)
  assembled from the ranks' blocks equals the host values bit for bit,
  B -> A gives back A's blocks, and the plan summaries equal JAX's on its
  first 4 devices.
- ``plan_wire_bytes`` equal to JAX's; ``execute_encoded`` within 1e-6 of
  JAX's decoded values (the same packed bytes); ``check_reshard_budget``
  of an empty plan is clean (the Graph Doctor's budget legs are
  tests/test_torch_doctor_budgets.py).
"""

import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu_torch.parallel import reshard as R  # noqa: E402
from paddle_tpu_torch.parallel.specs import Mesh, P, ShardedTensor  # noqa
from torch_gang import run_gang  # noqa: E402


def _jax():
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    jr = importlib.import_module("paddle_tpu.parallel.reshard")
    return jax, JMesh, NamedSharding, JP, jr


def _jp(spec):
    from jax.sharding import PartitionSpec as JP

    return JP(*tuple(spec))


def _jmesh(shape, names):
    import jax
    from jax.sharding import Mesh as JMesh

    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n], dtype=object).reshape(shape),
                 names)


def _stub(shape, spec, mesh, dtype=torch.float32):
    """A planning-only leaf: the placement of a global ``shape`` on an
    abstract mesh (no rank holds it here)."""
    return ShardedTensor(torch.empty((), dtype=dtype), tuple(shape),
                         R.fit_spec(spec, mesh, shape), mesh)


def _same_plan(tplan, jplan):
    ts, js = tplan.summary(), jplan.summary()
    assert ts == js, (ts, js)
    tl = {lp.path: lp for lp in tplan.leaf_plans}
    for jl in jplan.leaf_plans:
        t = tl[jl.path]
        assert (t.route == "noop") == (jl.route == "noop"), jl.path
        assert (t.chunk_axis, t.chunks, t.nbytes, t.transient_bytes,
                t.dcn) == (jl.chunk_axis, jl.chunks, jl.nbytes,
                           jl.transient_bytes, jl.dcn), jl.path


# ---------------------------------------------------------------------------
# plan math against JAX, on 8 ranks
# ---------------------------------------------------------------------------

HOST = {
    "embed.weight": (64, 16), "layer.q_proj": (16, 16),
    "layer.down_proj": (32, 16), "norm.weight": (16,),
    "opt.m.embed": (64, 16),
}

PAIRS8 = [
    ("dp_to_sharding3", ((8,), ("dp",), {}),
     ((8,), ("sharding",), {k: P("sharding") for k in HOST})),
    ("sharding3_to_tp",
     ((4, 2), ("sharding", "mp"), {"embed.weight": P("sharding"),
                                   "layer.q_proj": P("sharding"),
                                   "opt.m.embed": P("sharding")}),
     ((4, 2), ("sharding", "mp"), {"embed.weight": P(None, "mp"),
                                   "layer.q_proj": P(None, "mp"),
                                   "opt.m.embed": P(None, "mp")})),
    ("shrink_8_to_4",
     ((2, 4), ("dp", "sharding"), {"embed.weight": P("sharding"),
                                   "opt.m.embed": P("sharding")}),
     ((2, 2), ("dp", "sharding"), {"embed.weight": P("sharding"),
                                   "opt.m.embed": P("sharding")})),
    ("grow_2_to_8", ((2,), ("dp",), {"embed.weight": P("dp")}),
     ((8,), ("dp",), {"embed.weight": P("dp"),
                      "layer.down_proj": P("dp")})),
]


@pytest.mark.parametrize("name,a,b", PAIRS8, ids=[p[0] for p in PAIRS8])
@pytest.mark.parametrize("cap", [R.DEFAULT_TRANSIENT_BYTES, 1 << 10, None])
def test_pair_plan_matches_jax(name, a, b, cap):
    jax, JMesh, NamedSharding, JP, jr = _jax()
    ma, mb = Mesh(a[0], a[1]), Mesh(b[0], b[1])
    jma, jmb = _jmesh(a[0], a[1]), _jmesh(b[0], b[1])
    tstate = {k: _stub(s, a[2].get(k, P()), ma) for k, s in HOST.items()}
    tstate["step"] = 7
    jstate = {k: jax.device_put(
        np.zeros(s, np.float32),
        NamedSharding(jma, jr.fit_spec(_jp(a[2].get(k, P())), jma, s)))
        for k, s in HOST.items()}
    jstate["step"] = 7
    kw = {"max_transient_bytes": cap}
    _same_plan(R.plan_reshard(tstate, mb, b[2], **kw),
               jr.plan_reshard(jstate, jmb, {k: _jp(v)
                                             for k, v in b[2].items()},
                               **kw))
    # the reverse direction, and A onto A (a pure noop plan)
    tb = {k: _stub(s, b[2].get(k, P()), mb) for k, s in HOST.items()}
    jb = {k: jax.device_put(
        np.zeros(s, np.float32),
        NamedSharding(jmb, jr.fit_spec(_jp(b[2].get(k, P())), jmb, s)))
        for k, s in HOST.items()}
    _same_plan(R.plan_reshard(tb, ma, a[2], **kw),
               jr.plan_reshard(jb, jma, {k: _jp(v) for k, v in a[2].items()},
                               **kw))
    noop = R.plan_reshard(tstate, ma, a[2], **kw)
    assert noop.moved_bytes == 0 and not noop.steps


def test_cap_chunks_and_buckets_match_jax():
    jax, JMesh, NamedSharding, JP, jr = _jax()
    mesh, jmesh = Mesh((8,), ("dp",)), _jmesh((8,), ("dp",))
    tree = {f"w{i}": _stub((64, 32), P(), mesh) for i in range(6)}
    jtree = {f"w{i}": jax.device_put(np.zeros((64, 32), np.float32),
                                     NamedSharding(jmesh, JP()))
             for i in range(6)}
    cap = 4 << 10
    tplan = R.plan_reshard(tree, mesh, P("dp"), max_transient_bytes=cap)
    _same_plan(tplan, jr.plan_reshard(jtree, jmesh, JP("dp"),
                                      max_transient_bytes=cap))
    assert tplan.max_step_transient <= cap and len(tplan.steps) >= 6


@pytest.mark.parametrize("shape,spec,cap", [((64, 1), P("dp", None), 96),
                                            ((8,), P("dp"), 16),
                                            ((64, 4), P(None, "dp"), 256),
                                            ((80, 24), P("dp"), 1000)])
def test_granules_and_overruns_match_jax(shape, spec, cap):
    """Chunk boundaries on a destination-sharded axis respect its
    granule; an unchunkable leaf keeps its own over-cap step."""
    jax, JMesh, NamedSharding, JP, jr = _jax()
    mesh, jmesh = Mesh((8,), ("dp",)), _jmesh((8,), ("dp",))
    _same_plan(
        R.plan_reshard({"x": _stub(shape, P(), mesh)}, mesh, {"x": spec},
                       max_transient_bytes=cap),
        jr.plan_reshard({"x": jax.device_put(np.zeros(shape, np.float32),
                                             NamedSharding(jmesh, JP()))},
                        jmesh, {"x": _jp(spec)}, max_transient_bytes=cap))


def test_fit_spec_matches_jax():
    jax, JMesh, NamedSharding, JP, jr = _jax()
    mesh, jmesh = Mesh((8,), ("dp",)), _jmesh((8,), ("dp",))
    for spec, shape in [(P("dp"), (10,)), (P("mp"), (16,)),
                        (P("dp"), (16,)), (P(), (16, 4)),
                        (P(("dp", "mp"), None), (16, 4))]:
        assert tuple(R.fit_spec(spec, mesh, shape)) == \
            tuple(jr.fit_spec(_jp(spec), jmesh, shape)), (spec, shape)


def test_scalars_host_arrays_and_dcn_match_jax():
    jax, JMesh, NamedSharding, JP, jr = _jax()
    mesh, jmesh = Mesh((8,), ("dp",)), _jmesh((8,), ("dp",))
    host = {"w": np.arange(64, dtype=np.float32), "step": 3, "lr": 0.1}
    for dst, sm in [({"w": P("dp")}, {"dp": [0, 0, 0, 0, 1, 1, 1, 1]}),
                    ({"w": P("dp")}, {"dp": [0] * 8}),
                    ({"w": P()}, {"dp": [0, 0, 0, 0, 1, 1, 1, 1]}),
                    ({"w": P("dp")}, None)]:
        tplan = R.plan_reshard(host, mesh, dst, slice_map=sm)
        _same_plan(tplan, jr.plan_reshard(
            host, jmesh, {k: _jp(v) for k, v in dst.items()},
            slice_map=sm))
        (wlp,) = [lp for lp in tplan.leaf_plans if lp.moved]
        assert wlp.route == "host"


def test_empty_and_noop_plans():
    mesh = Mesh((4,), ("dp",))
    x = _stub((16,), P("dp"), mesh)
    plan = R.plan_reshard({"x": x}, mesh, {"x": P("dp")})
    assert not plan.steps and plan.moved_bytes == 0
    assert R.plan_reshard({}, mesh).summary()["leaves"] == 0
    rep = R.check_reshard_budget(plan, {"x": x}, budget_bytes=1,
                                 exemptions=())
    assert rep.ok and rep.passes_run == ("memory_budget",)


# ---------------------------------------------------------------------------
# execution on one rank
# ---------------------------------------------------------------------------


def test_execute_on_one_rank_is_bit_equal_within_the_transient(monkeypatch):
    """Host values onto a one-rank mesh under a cap small enough to chunk
    every leaf: bit-equal, and no assembled chunk larger than half the
    leaf's planned transient (the staging copy is the other half)."""
    mesh = Mesh((1,), ("dp",), device_type="cpu")
    rng = np.random.RandomState(1)
    tree = {"a": rng.rand(64, 32).astype(np.float32),
            "b": torch.from_numpy(rng.rand(40, 8).astype(np.float32))
            .to(torch.bfloat16), "s": 3}
    seen = []
    orig = R._assemble

    def spy(lp, val, box):
        piece = orig(lp, val, box)
        seen.append((lp.path, piece.numel() * piece.element_size(),
                     lp.transient_bytes))
        return piece

    monkeypatch.setattr(R, "_assemble", spy)
    plan = R.plan_reshard(tree, mesh, P("dp"), max_transient_bytes=1 << 11)
    out = plan.execute(tree)
    assert np.array_equal(out["a"].numpy(), tree["a"])
    assert torch.equal(out["b"], tree["b"]) and out["s"] == 3
    assert len(seen) > 4
    assert all(2 * n <= t for _, n, t in seen), seen
    # a plain tensor already on the one rank is a noop leaf
    again = R.plan_reshard(out, mesh, P("dp"))
    assert again.moved_bytes == 0 and again.execute(out)["a"] is out["a"]


def test_plan_wire_bytes_and_encoded_execution_match_jax():
    jax, JMesh, NamedSharding, JP, jr = _jax()
    from paddle_tpu.parallel.codec import CollectiveCodec as JCodec
    from paddle_tpu_torch.parallel.codec import CollectiveCodec

    host = {"w": np.random.RandomState(0).randn(64, 32).astype(np.float32),
            "i": np.arange(12, dtype=np.int32)}
    mesh, jmesh = Mesh((1,), ("r",), device_type="cpu"), _jmesh((1,), ("r",))
    for cap in (None, 2 << 10):
        codec = CollectiveCodec(block=64, weight_profile="int8",
                                checksum=True)
        jcodec = JCodec(block=64, weight_profile="int8", checksum=True)
        tplan = R.plan_reshard(host, mesh, None, max_transient_bytes=cap)
        jplan = jr.plan_reshard(host, jmesh, None, max_transient_bytes=cap)
        assert R.plan_wire_bytes(tplan, codec) == \
            jr.plan_wire_bytes(jplan, jcodec)
        assert R.plan_wire_bytes(tplan) == jr.plan_wire_bytes(jplan)
        got = R.execute_encoded(tplan, host, codec)
        want = jr.execute_encoded(jplan, host, jcodec)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=0, atol=1e-6)
        assert np.array_equal(got["i"].numpy(), host["i"])


# ---------------------------------------------------------------------------
# the reshard4 gang
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reshard4(tmp_path_factory):
    from torch_fault_injection import reshard_gang_rank

    root = run_gang("reshard4", reshard_gang_rank, 4, tmp_path_factory)
    reports = [json.loads((root / f"report.{r}.json").read_text())
               for r in range(4)]
    blocks = [dict(np.load(root / f"blocks.{r}.npz")) for r in range(4)]
    return root, reports, blocks


def _assembled(name, key, shape, reports, blocks):
    full = np.full(shape, np.nan, np.float32)
    for r, (rep, blk) in enumerate(zip(reports, blocks)):
        tag = f"{name}/{key}/{r}"
        if tag not in blk:
            continue
        start = rep[name]["starts"][key]
        arr = blk[tag]
        full[tuple(slice(s, s + n) for s, n in zip(start, arr.shape))] = arr
    return full


def _host_f32(v, key):
    if key.startswith("bf."):
        return torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    return v


@pytest.mark.parametrize("name", ["dp_to_sharding3", "sharding3_to_tp",
                                  "shrink_4_to_2"])
def test_gang_reshard_is_bit_equal_and_plans_match_jax(name, reshard4):
    from torch_fault_injection import RESHARD_PAIRS, pair_state

    jax, JMesh, NamedSharding, JP, jr = _jax()
    import jax.numpy as jnp

    _, reports, blocks = reshard4
    host = pair_state()
    (sa, na, spa), (sb, nb, spb) = RESHARD_PAIRS[name]
    for k, v in host.items():
        if isinstance(v, np.ndarray):
            got = _assembled(name, k, v.shape, reports, blocks)
            assert np.array_equal(got, _host_f32(v, k)), k
    rep = reports[0][name]
    assert all(r[name]["summary"] == rep["summary"] for r in reports)
    want_route = "device" if int(np.prod(sb)) == 4 else "host"
    assert {r for r in rep["routes"].values()} <= {want_route, "noop"}
    if "round_trip" in rep:
        assert all(r[name]["round_trip"] for r in reports)
        assert rep["noop_after"] == 0
    jma, jmb = _jmesh(sa, na), _jmesh(sb, nb)
    jstate = {}
    for k, v in host.items():
        if not isinstance(v, np.ndarray):
            jstate[k] = v
            continue
        arr = jnp.asarray(v, jnp.bfloat16 if k.startswith("bf.")
                          else jnp.float32)
        jstate[k] = jax.device_put(arr, NamedSharding(
            jma, jr.fit_spec(_jp(spa.get(k, P())), jma, v.shape)))
    jplan = jr.plan_reshard(jstate, jmb, {k: _jp(v) for k, v in spb.items()})
    assert rep["summary"] == json.loads(json.dumps(jplan.summary()))
