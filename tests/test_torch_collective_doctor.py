"""The port's Graph Doctor above one rank (capture on fake process groups,
COLL001-002, COMM001-004, HLO002) against the JAX package's, on the CPU.

- the capture: ``fake_ranks`` always tears its group down, ``fake_mesh``
  needs it, ``init_mesh`` still refuses the fake backend, and every
  collective node of a rank's capture carries its group's global ranks,
  its mesh axis, a send's or a recv's global peer, and its payload;
- counts from the step's structure: the overlap step gathers each bucket
  once a layer and reduce-scatters it once a layer, the pipeline executor
  exchanges once right and once left a tick;
- COLL001 on real Python branches: a rank that drops a psum fires, a
  symmetric program is clean, and a dropped send fires;
- where JAX's legs are red on this JAX version (COLL, COMM and HLO002
  read jaxprs and HLO text it no longer gives), the port's seeded
  fixtures fire exactly their code (tests/test_torch_graph_doctor.py),
  and here their readings are checked against what JAX still computes:
  the ring cost model and ring steps (``_ring_wire_cost``,
  ``_ring_steps``) and the codec's packed bytes (``encode_rows``);
- the wire tables: the flagship's DCN bytes fall with the codec, and
  ``measure_dcn_wire_bytes`` / ``tune_schedule_config(dcn_wire_bytes=)``
  read the same capture.

Every test leaves no process group behind.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from paddle_tpu.analysis.passes.collective_budget import (_ring_steps,
                                                          _ring_wire_cost)

import paddle_tpu_torch.analysis as A
from paddle_tpu_torch.analysis.core import (capture, capture_ranks,
                                            check_ranks, fake_mesh,
                                            fake_ranks)
from paddle_tpu_torch.analysis.fixtures import SEEDED, _line_mesh
from paddle_tpu_torch.analysis.passes.collective_budget import (
    collect_wire_by_axis, collect_wire_table, collective_tally,
    ring_steps, ring_wire_cost)
from paddle_tpu_torch.analysis.self_check import (
    FLAGSHIP_DCN_WIRE_BUDGET, WORLD, _hybrid_build, _llama_build,
    flagship_wire_table, moe_ep_section, overlap_section)
from paddle_tpu_torch.parallel.compat import _ppermute_raw, all_reduce_raw

PART_THREE_GRAPH = ("COLL001", "COLL002", "COMM001", "COMM002", "COMM003",
                    "COMM004", "COMM004[moe_dispatch]",
                    "COMM004[moe_dropless]", "HLO002")


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


# ------------------------------------------------------------------ capture


def test_fake_ranks_tears_down_on_error():
    with pytest.raises(RuntimeError, match="boom"):
        with fake_ranks(4, 1):
            assert dist.get_world_size() == 4 and dist.get_rank() == 1
            raise RuntimeError("boom")
    assert not dist.is_initialized()
    with fake_ranks(2, 0):
        with pytest.raises(RuntimeError, match="already live"):
            with fake_ranks(2, 1):
                pass
    with pytest.raises(RuntimeError, match="fake_ranks"):
        fake_mesh((2,), ("x",))


def test_init_mesh_still_refuses_other_backends():
    from paddle_tpu_torch.parallel.specs import init_mesh

    with fake_ranks(2, 0):
        with pytest.raises(RuntimeError, match="gloo backend"):
            init_mesh("cpu", (2,), ("x",))


def test_collective_nodes_carry_group_axis_peer_and_payload():
    """The mesh step at rank 5 of (dp2, sharding2, mp2): every group is the
    line of its axis through rank 5; the pipeline step's sends and recvs
    name global peers one pp stage away."""
    caps = capture_ranks(_llama_build((2, 2, 2)), WORLD, ranks=[5],
                         device="cpu")
    cap = caps[5]
    assert cap.rank == 5 and cap.world_size == 8
    lines = {"dp": (1, 5), "sharding": (5, 7), "mp": (4, 5)}
    assert cap.collectives
    for c in cap.collectives:
        assert c.axis in lines, c
        assert c.group == lines[c.axis], c
        assert c.nbytes > 0 and c.dtype in ("float32", "bfloat16"), c
        assert c.node.meta["pt_coll"] is c
    hyb = capture_ranks(_hybrid_build("1F1B"), WORLD, ranks=[3],
                        device="cpu")[3]
    p2p = [c for c in hyb.collectives if c.is_p2p]
    assert p2p and {c.kind for c in p2p} == {"collectivepermute"}
    # rank 3 = (pp 0, sharding 1, mp 1): its pp peer is rank 7
    assert {c.peer for c in p2p} == {7} and {c.axis for c in p2p} == {"pp"}


def test_overlap_schedule_counts_follow_the_bucket_plan():
    """One gather per bucket a layer (prefetched), one reduce-scatter per
    bucket a layer, both over sharding, and both engine-attributed."""
    from paddle_tpu_torch.analysis.passes.collective_budget import (
        attribution, overlap_region_funcs)
    from paddle_tpu_torch.parallel.overlap import OverlapConfig
    from paddle_tpu_torch.analysis.self_check import _flagship
    from paddle_tpu_torch.analysis.sharding import extract_overlap_layout
    from paddle_tpu_torch.parallel.specs import Mesh

    _, model, _, _, _, _ = _flagship()
    buckets = extract_overlap_layout(
        model, Mesh((2, 2, 2), ("dp", "sharding", "mp"))).buckets
    L = model.cfg.num_hidden_layers
    cap = capture_ranks(_llama_build((2, 2, 2), overlap=OverlapConfig()),
                        WORLD, ranks=[0], device="cpu")[0]
    region = overlap_region_funcs()
    engine = [c for c in cap.collectives
              if attribution(c, region) == "engine" and c.axis == "sharding"]
    gathers = [c for c in engine if c.kind == "allgather"]
    scatters = [c for c in engine if c.kind == "reducescatter"]
    assert len(buckets) >= 1
    assert len(gathers) == len(buckets) * L
    assert len(scatters) == len(buckets) * L
    assert all(attribution(c, region) != "outside" for c in cap.collectives)


def test_pipeline_exchanges_one_right_one_left_a_tick():
    from paddle_tpu_torch.analysis.passes.collective_order import permutes

    cap = capture_ranks(_hybrid_build("1F1B"), WORLD, ranks=[0],
                        device="cpu")[0]
    perms = permutes(cap)
    assert perms and len(perms) % 2 == 0
    rep = A.check(lambda: None, graph=cap, device="cpu",
                  passes=["collective_budget"], exemptions=(),
                  mesh=_hybrid_mesh())
    assert rep.ok, rep.summary()            # COMM003: a uniform ring


def _hybrid_mesh():
    from paddle_tpu_torch.models.llama_hybrid import HYBRID_AXES
    from paddle_tpu_torch.parallel.specs import Mesh

    return Mesh((2, 1, 2, 1, 2), HYBRID_AXES)


# ------------------------------------------------------------ COLL001/002


def _branchy(dropped):
    def build(rank):
        mesh = _line_mesh(2, "cpu")

        def body(v):
            if not dropped or mesh.axis_index("x") == 0:
                v = all_reduce_raw(v, "x", mesh)
            return v + 1.0

        return body, (torch.ones(8),), {}, mesh
    return build


@pytest.mark.parametrize("dropped", [True, False])
def test_coll001_on_python_branches(dropped):
    rep = check_ranks(_branchy(dropped), 2, device="cpu",
                      passes=["collective_order"], exemptions=())
    assert rep.codes() == (["COLL001"] if dropped else []), rep.summary()
    if dropped:
        assert rep.findings[0].data["group"] == [0, 1]
        # one rank alone has nothing to compare with
        one = check_ranks(_branchy(True), 2, ranks=[0], device="cpu",
                          passes=["collective_order"], exemptions=())
        assert one.ok


def test_coll001_on_a_dropped_send():
    def build(rank):
        mesh = _line_mesh(2, "cpu")

        def body(v):
            perm = [(0, 1), (1, 0)] if mesh.axis_index("x") == 1 \
                else [(1, 0)]                          # rank 0 drops its send
            return _ppermute_raw(v, "x", perm, mesh)

        return body, (torch.ones(4),), {}, mesh

    rep = check_ranks(build, 2, device="cpu", passes=["collective_order"],
                      exemptions=())
    assert set(rep.codes()) == {"COLL001"}, rep.summary()
    assert rep.findings[0].data["src"] == 0


def test_coll002_perm_is_assembled_from_every_rank():
    rep = SEEDED["COLL002"]()
    assert rep.findings[0].data["perm"] == [(0, 1), (1, 1)]


# ----------------------------------------------- readings against JAX's math


@pytest.mark.parametrize("kind", ["allgather", "reducescatter", "allreduce",
                                  "alltoall", "collectivepermute"])
def test_ring_wire_cost_equals_jax(kind):
    for nbytes, g in itertools.product((0, 1, 7, 4096, 123457), (1, 2, 3, 8)):
        assert ring_wire_cost(kind, nbytes, g) == \
            _ring_wire_cost(kind, nbytes, g), (nbytes, g)


def test_ring_steps_equal_jax():
    for n in (2, 4, 8):
        for perm in ([(i, (i + 1) % n) for i in range(n)],
                     [(i, (i - 1) % n) for i in range(n)],
                     [(0, 1), (1, 2), (2, 0), (n - 1, n - 1)]):
            assert ring_steps(perm, n) == _ring_steps(perm, n)


def test_coded_dcn_payload_prices_jax_packed_bytes():
    """The COMM004 fixture's coded inter-slice exchange: its payload is the
    bytes JAX's ``encode_rows`` packs the residue rows into (two rows of
    [4, 64] fp32, block 64), priced by JAX's ring cost."""
    import jax.numpy as jnp
    from paddle_tpu.parallel.codec import CollectiveCodec as JCodec
    from paddle_tpu.parallel.codec import encode_rows as jencode

    from paddle_tpu_torch.distributed.topology import hierarchical_axis
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import (hier_psum_scatter,
                                                   register_hier)

    sm = (0, 0, 1, 1)
    with fake_ranks(4, 0):
        mesh = _line_mesh(4, "cpu")
        hier = hierarchical_axis(mesh, "x", slice_map=sm)
        register_hier(mesh, "x", hier)
        codec = CollectiveCodec(block=64)
        cap = capture(lambda v: hier_psum_scatter(v, "x", hier, codec=codec,
                                                  mesh=mesh),
                      (torch.ones((16, 64)),), device="cpu", mesh=mesh)
        table = collect_wire_table(cap, mesh, {"x": list(sm)})
    coded = [c for c in cap.collectives if c.kind == "alltoall"]
    assert len(coded) == 1 and coded[0].dtype in ("int8", "uint8")
    jc = JCodec(block=64)
    profile, stoch = jc.resolve("grad")
    packed = jencode(jnp.ones((2, 256), jnp.float32), jc, profile,
                     stochastic=stoch)
    want = int(np.prod(packed.shape)) * packed.dtype.itemsize
    assert coded[0].nbytes == want
    assert table["dcn"]["kinds"]["alltoall"]["bytes"] == \
        _ring_wire_cost("alltoall", want, 2)


# ------------------------------------------------------------- wire tables


def test_flagship_wire_table_drops_with_the_codec():
    t = flagship_wire_table()
    assert t["ok"]
    off, on = t["codec_off"]["dcn"], t["codec_on"]["dcn"]
    assert off["bytes"] > FLAGSHIP_DCN_WIRE_BUDGET >= on["bytes"]
    assert t["reducescatter_ratio"] > 3.0
    # the coded gradient stage is an int8 all-to-all, the plain one fp32
    assert "alltoall" in on["kinds"] and "alltoall" not in off["kinds"]


def test_wire_by_axis_sums_to_the_stage_table():
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1),
                       codec=CollectiveCodec())
    with fake_ranks(WORLD, 0):
        fn, args, kw, mesh = _llama_build((1, 4, 2), overlap=oc)(0)
        cap = capture(fn, args, kw, device="cpu", mesh=mesh)
    dcn = {"sharding": [0, 0, 1, 1]}
    by_axis = collect_wire_by_axis(cap, mesh, dcn)
    table = collect_wire_table(cap, mesh, dcn)
    for stage in ("ici", "dcn"):
        assert sum(e[stage + "_bytes"] for e in by_axis.values()) == \
            table[stage]["bytes"]
    assert sum(e["count"] for e in by_axis.values()) == \
        table["ici"]["count"] + table["dcn"]["count"]
    assert set(by_axis) <= {"dp", "sharding", "mp"}
    tally = collective_tally(cap)
    assert tally["alltoall"]["count"] == \
        table["dcn"]["kinds"]["alltoall"]["count"]


def test_measure_dcn_wire_bytes_and_the_joint_walk():
    from paddle_tpu_torch.parallel.memory import MemoryConfig
    from paddle_tpu_torch.parallel.schedule import (JointScheduleConfig,
                                                    PartitionPoint,
                                                    measure_dcn_wire_bytes,
                                                    tune_schedule_config)
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    pt = PartitionPoint("tp8", (("dp", 1), ("sharding", 4), ("mp", 2)),
                        slice_map=(0, 0, 1, 1))
    oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1),
                       codec=CollectiveCodec())
    jc = JointScheduleConfig(pt, MemoryConfig(remat="none"), oc)
    with fake_ranks(WORLD, 0):
        fn, args, kw, mesh = _llama_build((1, 4, 2), overlap=oc)(0)
        got = measure_dcn_wire_bytes(jc, fn, args)
        want = collect_wire_table(capture(fn, args, device="cpu",
                                          mesh=mesh), mesh,
                                  pt.dcn_axes())["dcn"]["bytes"]
    assert got == want > 0
    with pytest.raises(ValueError, match="estimator"):
        tune_schedule_config(None, 1, (jc,), predict=True)


def test_joint_walk_lands_on_three_points():
    from paddle_tpu_torch.analysis.self_check import joint_schedule_section

    sec = joint_schedule_section()
    assert sec["ok"], sec
    picks = sec["picked"]
    assert len(set(picks.values())) == 3
    assert picks["joint"].startswith("tp8") and "codec-off" not in \
        picks["joint"]


# ----------------------------------------------------------------- sweeps


def test_overlap_and_moe_ep_sweeps_are_clean():
    for section in (overlap_section(), moe_ep_section()):
        for name, rep in section.items():
            assert rep["ok"], (name, rep)
            assert not rep["suppressed"], (name, rep)
    assert set(moe_ep_section()) == {
        "moe_ep_train_step[hier2slice,codec]",
        "moe_ep_dropless_train_step[hier2slice,codec]"}


@pytest.mark.parametrize("code", PART_THREE_GRAPH)
def test_seeded_readings(code):
    """Each seeded fixture's reading: the COMM004 ones exceed their coded
    budget by the codec's factor, the others name their group."""
    rep = SEEDED[code]()
    f = rep.findings[0]
    if code.startswith("COMM004"):
        assert f.data["measured"] > 2 * f.data["budget"], f.data
    elif code == "COMM001":
        assert f.data["measured"]["count"] == 2
    elif code == "HLO002":
        assert f.data["bytes"] == 1024 * 64 * 4 == 2 * f.data["limit"]
    elif code == "COMM003":
        assert all(set(x.data["steps"]) == {1, 2} for x in rep.findings)
    else:
        assert f.where and "fixtures.py" in f.where, f.where


# --------------------------------------- the capture against real collectives


def test_capture_equals_real_collectives_on_a_gloo_gang(tmp_path_factory):
    """Four gloo ranks: each rank's capture on a fake group of 4 lists the
    collectives (op, group, peer, payload bytes, in order) that the same
    step then issues on the real group, for the mesh step and the dropless
    EP step (the card version: test_capture_parity_on_four_cards in
    tests/test_torch_cuda_kernels.py)."""
    from torch_gang import capture_parity_rank, parity_captures, run_gang

    root = run_gang("capture_parity", capture_parity_rank, 4,
                    tmp_path_factory, args=("cpu",),
                    prepare=lambda r: parity_captures(str(r), 4, "cpu"))
    for rank in range(4):
        out = torch.load(root / f"parity.{rank}.pt")
        for name, rec in out.items():
            assert rec["want"], (rank, name)
            assert rec["got"] == rec["want"], (rank, name)
