"""The port's roofline estimator (``paddle_tpu_torch/parallel/roofline.py``),
its predicted walk and drift gate, against the JAX package's, on the CPU;
and the two repairs that come before it (ROADMAP C.9, C.10).

- The analytic legs of tests/test_roofline.py, from
  ``test_matmul_crossover_closed_form`` to
  ``test_predict_walk_dropless_ep_lattice``, each with JAX's function and
  the port's called on the same inputs: floats within 1e-12 relative,
  byte counts and peaks exactly.  Where the port's engine moves other
  bytes than JAX's, JAX's side gets the port's terms added, each written
  out here in closed form (``jax_port``: three wire terms and the
  stochastic encode's working set), so the port's estimator is held to
  JAX's own; the parity legs pass the reference's chip on the port's
  side.  Two legs have no counterpart: ``test_cost_model_delegates_to_roofline``
  (``cost_model`` is ROADMAP A8.7 and reads JAX's op registry) and
  ``test_predict_walk_real_compile`` (a compile).
- The port's own: the ``"h100"`` row and its sources, the refusal of an
  estimate that needs the unmeasured DCN rate, ``LlamaConfig.cost_sheet``,
  the wire model against the port's captures, the predicted walk over the
  port's meter, the drift section.
- C.9: the guarded step over a host-resident state.  C.10: ``check_ranks``
  in this process before a gloo step, and in a spawned child while that
  group is live.
"""

import dataclasses
import importlib
import math
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import paddle_tpu.parallel.roofline as jrf
from paddle_tpu.parallel.codec import CollectiveCodec as JCodec
from paddle_tpu.parallel.memory import MemoryConfig as JMemoryConfig
from paddle_tpu.parallel.schedule import (
    joint_schedule_lattice as j_lattice,
    tune_schedule_config as j_tune)

import paddle_tpu_torch.parallel.roofline as rf
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_train_step, llama_decay_mask)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel.codec import CollectiveCodec
from paddle_tpu_torch.parallel.memory import MemoryConfig
from paddle_tpu_torch.parallel.schedule import (joint_schedule_lattice,
                                                tune_schedule_config)

JS = importlib.import_module("paddle_tpu.analysis.self_check")


def _close(a, b, rel=1e-12):
    assert isinstance(a, float) and isinstance(b, float), (a, b)
    assert a == b or abs(a - b) <= rel * max(abs(a), abs(b)), (a, b)


def _same_estimate(p, j):
    """A port StepTimeEstimate against JAX's: floats to 1e-12, ints and
    verdicts exactly, the wire tables equal."""
    for f in ("total_s", "compute_s", "hbm_s", "ici_s", "dcn_s",
              "exposed_comm_s"):
        _close(getattr(p, f), getattr(j, f))
    for f in ("peak_bytes", "dcn_wire_bytes", "ici_wire_bytes", "fits",
              "label"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.breakdown["wire"] == j.breakdown["wire"]
    assert p.breakdown["recompute_factor"] == j.breakdown["recompute_factor"]


def _flagship_cfg():
    return LlamaConfig.debug(vocab=512, hidden=128, layers=2, heads=8,
                             kv_heads=4, inter=256, max_pos=64)


def _sheets():
    """(port sheet, JAX sheet) of the joint flagship."""
    return (rf.llama_cost_sheet(_flagship_cfg()),
            jrf.llama_cost_sheet(JS.joint_flagship_config()))


#: bytes the port's stochastic int8 encode holds per element at its peak:
#: the fp32 rows and their scaled copy (4 + 4), the int64 payload bits and
#: hash state (8 + 8), three int64 temporaries of its 32-bit multiply (24)
_PORT_ENCODE_BYTES_PER_ELEM = 48


def _port_wire(wire, axes, slice_map, sheet, codec, isz):
    """JAX's wire table ``wire`` with the port's three other terms, each
    in closed form:

    1. the uncoded bucket reduce-scatter across slices moves this rank's
       ``mp`` share of the bucket (JAX's payload: the whole bucket);
    2. the norm gradients sync in the compute dtype (JAX's: fp32), at
       every site of the sync;
    3. the non-layer collectives run over the sharding axis: the
       embedding's gather and its gradient's reduce-scatter, the lm head's
       two gathers and one reduce-scatter, the final norm's fp32
       completion and the loss's fp32 psum, in place of JAX's two fp32
       all-reduces of the final norm over every device."""
    ring = jrf.ring_wire_cost
    ax = {str(a): int(n) for a, n in dict(axes).items()}
    dp, sh, mp = (ax.get(k, 1) for k in ("dp", "sharding", "mp"))
    ndev = math.prod(ax.values())
    S = len(set(slice_map)) if slice_map else 1
    K = max(1, sh // S) if slice_map else sh
    L = sheet.num_layers
    tabs = {k: dict(wire[k]["by_part"]) for k in ("dcn", "ici")}

    def shift(tab, key, delta):
        v = tabs[tab].get(key, 0) + delta
        if v > 0:
            tabs[tab][key] = v
        else:
            tabs[tab].pop(key, None)

    if S > 1 and codec is None:                                     # 1
        g = sheet.layer_gathered_elems * isz
        shift("dcn", "bucket_reducescatter",
              L * (ring("reducescatter", g // mp // K, S)
                   - ring("reducescatter", g // K, S)))
    sync = sheet.layer_sync_elems                                   # 2
    sites = [("ici", "norm_sync_dp", dp)] if dp > 1 else []
    if S > 1 and codec is None:
        sites.append(("dcn", "norm_sync", sh))
    elif S > 1 and K > 1:
        sites.append(("ici", "norm_sync", K))
    elif S == 1 and sh > 1:
        sites.append(("ici", "norm_sync", sh))
    for tab, key, n in sites:
        shift(tab, key, L * (ring("allreduce", sync * isz, n)
                             - ring("allreduce", sync * 4, n)))
    stage = "dcn" if S > 1 else "ici"                               # 3
    misc = sheet.misc_sync_elems * 4
    shift(stage, "misc_sync", -2 * ring("allreduce", misc, ndev))
    for key, elems, gathers in (("embed", sheet.embed_elems, 1),
                                ("head", sheet.head_elems, 2)):
        block = elems * isz // mp
        shift(stage, key + "_allgather",
              gathers * ring("allgather", block // sh, sh))
        shift(stage, key + "_reducescatter",
              ring("reducescatter", block, sh))
    shift(stage, "misc_sync", ring("allreduce", misc, sh))
    shift(stage, "loss_psum", ring("allreduce", 4, sh))
    return {k: {"bytes": sum(t.values()), "by_part": t}
            for k, t in tabs.items()}


def _port_encode_bytes(axes, slice_map, sheet, codec):
    """The port's stochastic gradient encode across slices: it encodes
    this rank's [S, local] rows of a bucket at once."""
    ax = dict(axes)
    sh, mp = ax.get("sharding", 1), ax.get("mp", 1)
    S = len(set(slice_map)) if slice_map else 1
    if codec is None or S == 1 or not (codec.resolve("grad") or
                                       (None, False))[1]:
        return 0
    K = max(1, sh // S)
    return _PORT_ENCODE_BYTES_PER_ELEM * (sheet.layer_gathered_elems
                                          // (mp * K))


@pytest.fixture
def jax_port(monkeypatch):
    """JAX's roofline module with the port's terms added to its wire table
    (``_port_wire``) and its peak (``_port_encode_bytes``), through every
    caller of the two (the estimate, the calibration, the search); JAX's
    own two functions stay in ``real``."""
    real = {n: getattr(jrf, n) for n in (
        "estimate_step_time", "calibration_offset_from",
        "predict_wire_table", "predict_peak_bytes")}
    slices = []                 # the slice map of the estimate in flight

    def estimate_step_time(axes, slice_map, sheet, **kw):
        slices.append(slice_map)
        try:
            return real["estimate_step_time"](axes, slice_map, sheet, **kw)
        finally:
            slices.pop()

    def calibration_offset_from(record, jc, sheet, **kw):
        slices.append(jc.partition.slice_map)
        try:
            return real["calibration_offset_from"](record, jc, sheet, **kw)
        finally:
            slices.pop()

    def predict_wire_table(axes, slice_map, sheet, *, codec=None,
                           compute_itemsize=2, **kw):
        return _port_wire(real["predict_wire_table"](
            axes, slice_map, sheet, codec=codec,
            compute_itemsize=compute_itemsize, **kw),
            axes, slice_map, sheet, codec, compute_itemsize)

    def predict_peak_bytes(axes, sheet, memory=None, *, codec=None, **kw):
        return real["predict_peak_bytes"](axes, sheet, memory, codec=codec,
                                          **kw) \
            + _port_encode_bytes(axes, slices[-1] if slices else None,
                                 sheet, codec)

    for name, fn in (("estimate_step_time", estimate_step_time),
                     ("calibration_offset_from", calibration_offset_from),
                     ("predict_wire_table", predict_wire_table),
                     ("predict_peak_bytes", predict_peak_bytes)):
        monkeypatch.setattr(jrf, name, fn)
    return types.SimpleNamespace(real=real)


def _lattices():
    """The joint flagship lattice on both sides, in the same order."""
    from paddle_tpu_torch.analysis.self_check import joint_schedule_points

    p = joint_schedule_lattice(joint_schedule_points(),
                               memory_lattice=(MemoryConfig(remat="none"),),
                               codec_points=(None, CollectiveCodec()))
    j = j_lattice(JS.joint_schedule_points(),
                  memory_lattice=(JMemoryConfig(remat="none"),),
                  codec_points=(None, JCodec()))
    assert [a.label() for a in p] == [b.label() for b in j]
    return p, j


# ---------------------------------------------------------------------------
# closed-form rooflines
# ---------------------------------------------------------------------------


def test_matmul_crossover_closed_form():
    P, B = 100e12, 1e12
    for m, n, k in ((128, 128, 1), (4096, 4096, 4096), (32, 32, 32),
                    (8192, 8192, 8192)):
        _close(rf.matmul_time(m, n, k, peak_flops=P, hbm_bytes_per_s=B),
               jrf.matmul_time(m, n, k, peak_flops=P, hbm_bytes_per_s=B))
    for chip in ("v4", "v5e", "v5p", "v6e"):
        _close(rf.matmul_time(512, 512, 512, chip=chip),
               jrf.matmul_time(512, 512, 512, chip=chip))
        _close(rf.elementwise_time(1 << 20, chip=chip),
               jrf.elementwise_time(1 << 20, chip=chip))
    # the max-of rule, on the port's side too
    assert rf.matmul_time(128, 128, 1, peak_flops=P, hbm_bytes_per_s=B) \
        == 2 * (128 + 128 + 128 * 128) / B


@pytest.mark.parametrize("kind", ["all_reduce", "all_gather",
                                  "reduce_scatter", "all_to_all",
                                  "collective_permute"])
def test_collective_time_ring_fractions(kind):
    nb = 1 << 20
    for g in (1, 2, 8):
        _close(rf.collective_time(nb, g, link_bytes_per_s=1e9, kind=kind),
               jrf.collective_time(nb, g, link_bytes_per_s=1e9, kind=kind))
        for link in ("ici", "dcn"):
            _close(rf.collective_time(nb, g, kind=kind, chip="v5e",
                                      link=link),
                   jrf.collective_time(nb, g, kind=kind, chip="v5e",
                                       link=link))


def test_ring_wire_cost_single_copy():
    """One ring_wire_cost in the port (the COMM004 pass imports the
    roofline's), equal to JAX's on every kind."""
    import paddle_tpu_torch
    from paddle_tpu_torch.analysis.passes import collective_budget as cb

    assert cb.ring_wire_cost is rf.ring_wire_cost
    for kind in ("allgather", "reducescatter", "allreduce", "alltoall",
                 "collectivepermute"):
        for nb, g in ((1024, 8), (12345, 4), (7, 2), (100, 1)):
            assert rf.ring_wire_cost(kind, nb, g) == \
                jrf.ring_wire_cost(kind, nb, g)
    root = __import__("pathlib").Path(paddle_tpu_torch.__file__).parent
    defs = [p for p in root.rglob("*.py")
            if "def ring_wire_cost(" in p.read_text()]
    assert [p.name for p in defs] == ["roofline.py"]


# ---------------------------------------------------------------------------
# the codec and remat terms
# ---------------------------------------------------------------------------

_TP8_AXES = (("dp", 1), ("sharding", 4), ("mp", 2))
_TP8_SLICES = (0, 0, 1, 1)


@pytest.mark.parametrize("codec", [False, True], ids=["off", "on"])
def test_codec_shrinks_predicted_dcn(codec, jax_port):
    ps, js = _sheets()
    kw = dict(batch=8, seq=16, chip="v5e")
    p = rf.estimate_step_time(_TP8_AXES, _TP8_SLICES, ps,
                              codec=CollectiveCodec() if codec else None,
                              **kw)
    j = jrf.estimate_step_time(_TP8_AXES, _TP8_SLICES, js,
                               codec=JCodec() if codec else None, **kw)
    _same_estimate(p, j)


@pytest.mark.parametrize("remat", ["none", "dots", "names", "full"])
def test_remat_recompute_term(remat, jax_port):
    ps, js = _sheets()
    kw = dict(batch=8, seq=16, chip="v5e")
    _same_estimate(
        rf.estimate_step_time(_TP8_AXES, _TP8_SLICES, ps,
                              memory=MemoryConfig(remat=remat), **kw),
        jrf.estimate_step_time(_TP8_AXES, _TP8_SLICES, js,
                               memory=JMemoryConfig(remat=remat), **kw))
    assert rf.REMAT_RECOMPUTE_FACTOR == jrf.REMAT_RECOMPUTE_FACTOR


# ---------------------------------------------------------------------------
# pin parity
# ---------------------------------------------------------------------------


def test_wire_model_matches_recorded_pins_exactly(jax_port):
    """JAX's DCN model gives its four recorded pins byte for byte; the
    port's gives JAX's plus the port's three wire terms, which are the
    port's own recorded captures (RECORDED_JOINT_RECORDS), not JAX's
    pins."""
    from paddle_tpu_torch.analysis.self_check import RECORDED_JOINT_RECORDS

    ps, js = _sheets()
    pl, jl = _lattices()
    pins = {r["label"]: r["dcn_wire_bytes"]
            for r in JS.RECORDED_JOINT_RECORDS}
    ours = {r["label"]: r["dcn_wire_bytes"] for r in RECORDED_JOINT_RECORDS}
    for pc, jc in zip(pl, jl):
        raw = jax_port.real["predict_wire_table"](
            jc.partition.axes, jc.partition.slice_map, js,
            codec=getattr(jc.overlap, "codec", None), batch=8, seq=16)
        assert raw["dcn"]["bytes"] == pins[jc.label()]
        p = rf.estimate_joint_config(pc, ps, batch=8, seq=16, chip="v5e")
        j = jrf.estimate_joint_config(jc, js, batch=8, seq=16)
        _same_estimate(p, j)
        assert p.dcn_wire_bytes == ours[pc.label()] != pins[pc.label()]


def test_peak_calibration_and_frontier_parity(jax_port):
    ps, js = _sheets()
    pl, jl = _lattices()
    anchor = JS.RECORDED_JOINT_RECORDS[0]
    pcal = rf.calibration_offset_from(anchor, pl[0], ps, batch=8, seq=16)
    jcal = jrf.calibration_offset_from(anchor, jl[0], js, batch=8, seq=16)
    assert pcal == jcal
    for pc, jc in zip(pl, jl):
        kw = dict(batch=8, seq=16, hbm_budget=JS.JOINT_HBM_BUDGET,
                  dcn_budget=JS.JOINT_DCN_WIRE_BUDGET)
        _same_estimate(
            rf.estimate_joint_config(pc, ps, chip="v5e",
                                     calibration_offset=pcal, **kw),
            jrf.estimate_joint_config(jc, js, calibration_offset=jcal,
                                      **kw))
    assert rf.estimate_joint_config(pl[0], ps, batch=8, seq=16,
                                    chip="v5e").fits is None


# ---------------------------------------------------------------------------
# the enumerated search
# ---------------------------------------------------------------------------


def _points(pts):
    return [(p.name, p.axes, p.slice_map) for p in pts]


def test_enumerate_v5p_pod_candidates():
    from paddle_tpu.models import LlamaConfig as JLlamaConfig

    p = rf.enumerate_partitionings((2, 32), rf.llama_cost_sheet(
        LlamaConfig.llama3_8b()), batch=16, seq=4096, chip="v5p")
    j = jrf.enumerate_partitionings((2, 32), JLlamaConfig.llama3_8b(),
                                    batch=16, seq=4096, chip="v5p")
    assert _points(p) == _points(j) and len(p) >= 20


def test_enumerate_hbm_pruning_bites():
    from paddle_tpu.models import LlamaConfig as JLlamaConfig

    tiny_p = rf.CHIP_SPECS["v5p"].replace(hbm_bytes=2 << 30)
    tiny_j = jrf.CHIP_SPECS["v5p"].replace(hbm_bytes=2 << 30)
    p = rf.enumerate_partitionings((2, 32), LlamaConfig.llama3_8b(),
                                   batch=16, seq=4096, chip=tiny_p)
    j = jrf.enumerate_partitionings((2, 32), JLlamaConfig.llama3_8b(),
                                    batch=16, seq=4096, chip=tiny_j)
    assert _points(p) == _points(j)


def _moe_sheets(**kw):
    base = dict(name="moe_debug", num_layers=4, hidden=256,
                intermediate=512, num_heads=8, num_kv_heads=4, head_dim=32,
                vocab=1024, num_experts=8, **kw)
    return rf.ModelCostSheet(**base), jrf.ModelCostSheet(**base)


def test_enumerate_emits_ep_points(jax_port):
    ps, js = _moe_sheets()
    p = rf.enumerate_partitionings((2, 32), ps, batch=16, seq=4096,
                                   chip="v5p")
    j = jrf.enumerate_partitionings((2, 32), js, batch=16, seq=4096,
                                    chip="v5p")
    assert _points(p) == _points(j)
    assert any(dict(x.axes).get("ep", 1) > 1 for x in p)


def test_rank_partitionings_monotone(jax_port):
    from paddle_tpu.models import LlamaConfig as JLlamaConfig

    cfg = LlamaConfig.llama3_8b()
    ps = rf.llama_cost_sheet(cfg)
    js = jrf.llama_cost_sheet(JLlamaConfig.llama3_8b())
    pts = rf.enumerate_partitionings((2, 32), ps, batch=16, seq=4096,
                                     chip="v5p")
    jpts = jrf.enumerate_partitionings((2, 32), js, batch=16, seq=4096,
                                       chip="v5p")
    p = rf.rank_partitionings(pts, ps, batch=16, seq=4096, chip="v5p")
    j = jrf.rank_partitionings(jpts, js, batch=16, seq=4096, chip="v5p")
    assert [x.label() for _, x in p] == [x.label() for _, x in j]
    for (pe, _), (je, _) in zip(p, j):
        _same_estimate(pe, je)


def test_moe_ep_schedule_constructor():
    """The EP constructor's table against JAX's: ep leads the expert
    leaves, the gate is replicated (abstract meshes on both sides)."""
    from jax.sharding import AbstractMesh

    from paddle_tpu.parallel.expert import MoEEPConfig as JMoEEPConfig
    from paddle_tpu.parallel.schedule import \
        PartitionSchedule as JPartitionSchedule

    from paddle_tpu_torch.parallel.expert import MoEEPConfig
    from paddle_tpu_torch.parallel.schedule import PartitionSchedule
    from paddle_tpu_torch.parallel.specs import Mesh

    kw = dict(d_model=32, d_hidden=64, num_expert=4, top_k=2)
    p = PartitionSchedule.from_moe_ep(MoEEPConfig(**kw),
                                      Mesh((2, 4), ("dp", "ep")))
    try:
        jmesh = AbstractMesh((2, 4), ("dp", "ep"))
    except TypeError:
        jmesh = AbstractMesh((("dp", 2), ("ep", 4)))
    j = JPartitionSchedule.from_moe_ep(JMoEEPConfig(**kw), jmesh)
    for name in ("w_up", "w_down", "gate_w"):
        assert p.table[name].dim_axes == j.table[name].dim_axes, name
    assert p.table["w_up"].dim_axes[0] == ("ep",)


# ---------------------------------------------------------------------------
# the predicted walk
# ---------------------------------------------------------------------------


def _count_builder(labels):
    """A builder whose step is a stand-in the meter reads: it records the
    labels it built."""
    def builder(jc):
        labels.append(jc.label())
        return (lambda x: x + 1), (torch.ones(4),)
    return builder


def _meter(peak):
    def meter(fn, *args):
        return {"peak_bytes": peak, "argument_bytes": 0, "temp_bytes": 0,
                "output_bytes": 0}
    return meter


def test_predict_walk_requires_estimator():
    pl, _ = _lattices()
    with pytest.raises(ValueError, match="estimator"):
        tune_schedule_config(lambda jc: None, 1 << 30, pl, predict=True)
    with pytest.raises(ValueError, match="estimator"):
        j_tune(lambda jc: None, 1 << 30, _lattices()[1], predict=True)


@pytest.mark.parametrize("case", ["top_ranked", "predicted_misfit",
                                  "measured_gate"])
def test_predict_walk_equals_jax(case, monkeypatch):
    """The walk's choice, what it builds and every record's predicted
    fields, rank and verdicts equal JAX's on the same hand-scripted
    estimates (JAX's measured peak faked to the port meter's figure)."""
    import paddle_tpu.parallel.memory as jmem

    pl, jl = _lattices()
    costs = {"top_ranked": (4e-3, 2e-3, 1e-3, 3e-3),
             "predicted_misfit": (1e-3, 2e-3, 3e-3, 4e-3),
             "measured_gate": (1e-3, 2e-3, 3e-3, 4e-3)}[case]
    cost = {a.label(): t for a, t in zip(pl, costs)}
    misfit = pl[0].label() if case == "predicted_misfit" else None
    budget = 0 if case == "measured_gate" else 1 << 30
    top_k = 2 if case == "measured_gate" else 1

    def estimator(jc):
        return {"total_s": cost[jc.label()], "fits": jc.label() != misfit}

    monkeypatch.setattr(jmem, "measure_step_memory",
                        lambda fn, *a, **k: {"peak_bytes": 1000})
    built_p, built_j = [], []
    pc, prec = tune_schedule_config(_count_builder(built_p), budget, pl,
                                    predict=True, estimator=estimator,
                                    top_k=top_k, meter=_meter(1000))

    def jbuilder(jc):
        built_j.append(jc.label())
        return (lambda x: x), (np.ones(4),)

    jc_, jrec = j_tune(jbuilder, budget, jl, predict=True,
                       estimator=estimator, top_k=top_k)
    assert built_p == built_j
    assert (pc.label() if pc else None) == (jc_.label() if jc_ else None)
    keys = ("label", "predicted", "predicted_rank", "compiled", "fits",
            "peak_bytes")
    assert [{k: r.get(k) for k in keys} for r in prec] == \
        [{k: r.get(k) for k in keys} for r in jrec]


def test_predict_walk_dropless_ep_lattice(jax_port):
    """The dropless sheet's ep lattice: the same enumerated points, the
    same estimates and the same predicted order as JAX's
    ``joint_estimator``; the walk builds only the predicted winner, an ep
    point, and its measured record passes."""
    ps, js = _moe_sheets(moe_dropless=True, moe_balance=1.25)
    pts = rf.enumerate_partitionings(8, ps, batch=16, seq=4096, chip="v5p")
    jpts = jrf.enumerate_partitionings(8, js, batch=16, seq=4096,
                                       chip="v5p")
    assert _points(pts) == _points(jpts)

    def ep_only(points):
        return [p for p in points if dict(p.axes).get("ep", 1) > 1
                and all(dict(p.axes).get(a, 1) == 1
                        for a in ("pp", "sep", "mp"))]

    lat = joint_schedule_lattice(ep_only(pts),
                                 memory_lattice=(MemoryConfig(remat="none"),),
                                 codec_points=(None,))
    jlat = j_lattice(ep_only(jpts),
                     memory_lattice=(JMemoryConfig(remat="none"),),
                     codec_points=(None,))
    assert len(lat) >= 3
    pe = rf.joint_estimator(ps, batch=16, seq=4096, chip="v5p")
    je = jrf.joint_estimator(js, batch=16, seq=4096, chip="v5p")
    for a, b in zip(lat, jlat):
        _same_estimate(pe(a), je(b))
    built = []
    chosen, records = tune_schedule_config(
        _count_builder(built), 1 << 40, lat, predict=True, estimator=pe,
        top_k=1, meter=_meter(1 << 20))
    assert built == [chosen.label()] and dict(chosen.partition.axes)["ep"] > 1
    rec = next(r for r in records if r["label"] == chosen.label())
    assert rec["predicted_rank"] == 0 and rec["fits"] and rec["compiled"]


def test_dropless_sheet_pricing(jax_port):
    for kw in ({}, {"moe_dropless": True, "moe_balance": 1.25},
               {"moe_capacity_factor": 2.0}, {"moe_dropless": True}):
        ps, js = _moe_sheets(**kw)
        assert ps.moe_eff_rows_per_token == js.moe_eff_rows_per_token
        assert ps.fwd_flops(16, 4096) == js.fwd_flops(16, 4096)
        axes = (("dp", 2), ("ep", 4))
        assert rf.predict_wire_table(axes, None, ps, batch=16, seq=4096) \
            == jrf.predict_wire_table(axes, None, js, batch=16, seq=4096)
    ns = types.SimpleNamespace(
        num_hidden_layers=4, hidden_size=256, intermediate_size=512,
        num_attention_heads=8, num_key_value_heads=4, vocab_size=1024,
        num_experts=8, moe_top_k=2, moe_dropless=True,
        moe_balance=1.25, moe_capacity_factor=2.0)
    p, j = rf.llama_cost_sheet(ns), jrf.llama_cost_sheet(ns)
    assert {f.name: getattr(p, f.name) for f in dataclasses.fields(j)} == \
        dataclasses.asdict(j)


# ---------------------------------------------------------------------------
# the port's own: the h100 row, the cost sheet, its captures
# ---------------------------------------------------------------------------


def test_chip_sources_cover_every_constant():
    fields = [f.name for f in dataclasses.fields(rf.ChipSpec)
              if f.name != "name"]
    assert set(rf.CHIP_SOURCES) == set(rf.CHIP_SPECS)
    for name, spec in rf.CHIP_SPECS.items():
        assert spec.name == name
        assert set(rf.CHIP_SOURCES[name]) == set(fields), name
        assert all(rf.CHIP_SOURCES[name].values()), name
    for name in ("v4", "v5e", "v5p", "v6e"):
        assert dataclasses.astuple(rf.CHIP_SPECS[name]) == \
            dataclasses.astuple(jrf.CHIP_SPECS[name])
    h100 = rf.CHIP_SPECS["h100"]
    for f in ("peak_bf16_flops", "hbm_bytes_per_s", "hbm_bytes",
              "ici_bytes_per_s"):
        assert getattr(h100, f) > 0 and "PERF.md" in \
            rf.CHIP_SOURCES["h100"][f], f
    assert math.isnan(h100.dcn_bytes_per_s)
    assert rf.CHIP_SOURCES["h100"]["dcn_bytes_per_s"].startswith(
        "unmeasured")
    assert set(rf.__all__) == set(jrf.__all__) | {"CHIP_SOURCES"}


def test_h100_estimates_that_need_dcn_raise():
    """On the h100 row an estimate with DCN bytes raises naming the
    unmeasured constant; one without (one slice) is finite; the defaults
    are the h100's."""
    sheet = rf.llama_cost_sheet(_flagship_cfg())
    with pytest.raises(ValueError, match="dcn_bytes_per_s"):
        rf.estimate_step_time(_TP8_AXES, _TP8_SLICES, sheet, batch=8,
                              seq=16)
    with pytest.raises(ValueError, match="dcn_bytes_per_s"):
        rf.collective_time(1 << 20, 4, link="dcn")
    est = rf.estimate_step_time(_TP8_AXES, None, sheet, batch=8, seq=16)
    assert math.isfinite(est.total_s) and est.dcn_s == 0.0
    assert est.ici_s > 0
    assert rf.matmul_time(4096, 4096, 4096) == rf.matmul_time(
        4096, 4096, 4096, chip="h100")


@pytest.mark.parametrize("cfg", ["debug", "llama3_8b"])
def test_cost_sheet_equals_jax(cfg):
    from paddle_tpu.models import LlamaConfig as JLlamaConfig

    p = getattr(LlamaConfig, cfg)().cost_sheet()
    j = getattr(JLlamaConfig, cfg)().cost_sheet()
    for f in dataclasses.fields(j):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.params_total == j.params_total


def test_port_wire_model_matches_its_captures():
    """The port's predicted DCN bytes equal its measured
    ones (each point's step captured at rank 0 of a fake group of 8,
    ``joint_schedule_section``), and its calibrated peaks put every record
    on the measured side of both budgets; RECORDED_JOINT_RECORDS are those
    records."""
    from paddle_tpu_torch.analysis.self_check import joint_schedule_section

    from paddle_tpu_torch.analysis.self_check import RECORDED_JOINT_RECORDS

    sec = joint_schedule_section()
    assert sec["ok"], sec
    pl, _ = _lattices()
    sheet = rf.llama_cost_sheet(_flagship_cfg())
    recs = sec["records"]
    # the drift section's paper trail is this capture's, to the byte
    assert [{k: r[k] for k in ("label", "peak_bytes", "dcn_wire_bytes")}
            for r in recs] == list(RECORDED_JOINT_RECORDS)
    cal = rf.calibration_offset_from(recs[0], pl[0], sheet, batch=8,
                                     seq=16)
    for jc, rec in zip(pl, recs):
        est = rf.estimate_joint_config(
            jc, sheet, batch=8, seq=16, chip="v5e",
            hbm_budget=sec["hbm_budget"], dcn_budget=sec["dcn_wire_budget"],
            calibration_offset=cal)
        assert est.dcn_wire_bytes == rec["dcn_wire_bytes"], rec["label"]
        assert est.fits == (rec["peak_bytes"] <= sec["hbm_budget"]
                            and rec["dcn_wire_bytes"]
                            <= sec["dcn_wire_budget"]), rec["label"]


def test_drift_section_predicted_winner_matches_pick():
    """The drift gate over the port's own records: the predicted winner is
    the joint walk's pick, the frontier agrees, and the wire drift is 0;
    the records' DCN bytes are the port's captures, not JAX's four
    pins."""
    from paddle_tpu_torch.analysis.self_check import (
        joint_schedule_section, roofline_drift_section)

    assert joint_schedule_section()["ok"]       # memoized per process
    sec = roofline_drift_section()
    assert sec["ok"], sec
    assert sec["predicted_winner"] == sec["measured_pick"]
    assert sec["predicted_winner"].startswith("tp8(")
    assert "codec[" in sec["predicted_winner"]
    assert sec["frontier_parity"] and sec["max_dcn_wire_rel_err"] == 0.0
    assert sec["chip"] == "v5e" and len(sec["table"]) == 4
    pins = {r["label"]: r["dcn_wire_bytes"]
            for r in JS.RECORDED_JOINT_RECORDS}
    for r in sec["table"]:
        assert r["predicted"]["dcn_wire_bytes"] == \
            r["measured"]["dcn_wire_bytes"] != pins[r["label"]]
    assert sec["measured_source"].startswith("the port's capture")


def test_predict_walk_over_the_port_meter():
    """``tune_schedule_config(predict=True)`` over the joint lattice with
    the port's static-peak meter and the capture's DCN bytes: the
    estimator (calibrated on the joint section's first
    record) ranks tp8 with the codec first and the walk builds and
    measures only it, which passes both budgets."""
    from paddle_tpu_torch.analysis.self_check import predicted_joint_walk

    out = predicted_joint_walk()
    assert out["ok"], out
    assert out["built"] == [out["chosen_label"]]
    assert out["chosen_label"] == out["joint_pick"]


# ---------------------------------------------------------------------------
# C.9: the guard over a host-resident state
# ---------------------------------------------------------------------------

# small buckets whose edges fall inside the debug model's leaves
_SMALL_BUCKET_BYTES = 4 * 997
_OPEN = None
_FIRED = np.array([-1.0, np.inf, np.inf])


def _c9_case():
    from paddle_tpu_torch.distributed.health import HealthConfig

    model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu",
                             dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(7))
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01, multi_precision=True)
    mask = llama_decay_mask(model)
    hstep = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             health=HealthConfig())
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 16)))
    lab = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 16)))
    params = {k: v.detach().clone()
              for k, v in model.functional_state().items()}
    return opt, mask, hstep, ids, lab, params


def _host_flat(state):
    """A host-resident state's buckets, concatenated per group and key."""
    return {g: {k: torch.cat(list(b)) for k, b in gs.items()}
            for g, gs in state["__offload__"].items()}


@pytest.mark.parametrize("bucket_bytes", [4 << 20, _SMALL_BUCKET_BYTES],
                         ids=["one_bucket", "bucket_edges"])
def test_guarded_step_over_host_state(bucket_bytes, monkeypatch):
    """C.9: ``build_train_step(health=)`` over ``init_offloaded_state``
    against the same guarded step over the device-resident flat state
    (its in-place buckets shrunk alike): three open steps with losses,
    params and every moment and master bit-equal, the probes' loss and
    gradient norm equal and the update ratio to 1e-6 (the first passes sum
    the same squares in buckets of their own); then a fired gate that
    leaves the host buckets and the params bit-identical."""
    from paddle_tpu_torch.parallel import memory as M

    monkeypatch.setattr(M, "IN_PLACE_BUCKET_BYTES", bucket_bytes)
    opt, mask, hstep, ids, lab, params = _c9_case()
    dp = {k: v.clone() for k, v in params.items()}
    dst = opt.init_flat_state(dp, decay_mask=mask)
    hp = params
    hst = M.init_offloaded_state(opt, hp, decay_mask=mask,
                                 bucket_bytes=bucket_bytes)
    if bucket_bytes == _SMALL_BUCKET_BYTES:
        assert sum(len(gs["moment1"]) for gs in
                   hst["__offload__"].values()) > 10
    for i in range(3):
        dl, _, _, dprobe = hstep(dp, dst, i, 1e-3, ids, lab)
        hl, hp2, hst2, hprobe = hstep(hp, hst, i, 1e-3, ids, lab)
        assert hp2 is hp and hst2 is hst
        assert dprobe["ok"] and hprobe["ok"]
        assert torch.equal(dl, hl), i
        assert hprobe["loss"] == dprobe["loss"]
        assert hprobe["grad_norm"] == dprobe["grad_norm"]
        np.testing.assert_allclose(hprobe["update_ratio"],
                                   dprobe["update_ratio"], rtol=1e-6)
        for k in dp:
            assert torch.equal(dp[k], hp[k]), (i, k)
        host = _host_flat(hst)
        for g, gs in dst["__flat__"].items():
            for key, t in gs.items():
                assert torch.equal(t, host[g][key]), (i, g, key)
    before_p = {k: v.clone() for k, v in hp.items()}
    before_s = {g: {k: [b.clone() for b in bs] for k, bs in gs.items()}
                for g, gs in hst["__offload__"].items()}
    _, p2, s2, probe = hstep(hp, hst, 3, 1e-3, ids, lab,
                             health_gates=_FIRED)
    assert not probe["ok"] and p2 is hp and s2 is hst
    for k in hp:
        assert torch.equal(hp[k], before_p[k]), k
    for g, gs in hst["__offload__"].items():
        for key, bs in gs.items():
            assert all(torch.equal(a, b)
                       for a, b in zip(bs, before_s[g][key])), (g, key)


def test_host_state_probe_equals_jax_make_probe():
    """C.9's probe: the port's ``make_probe`` over the read-only pass's
    update sum of squares equals JAX's ``make_probe`` on the same loss,
    gradients, params and updated params."""
    import jax.numpy as jnp

    from paddle_tpu.distributed import health as jh

    from paddle_tpu_torch.distributed import health as th
    from paddle_tpu_torch.parallel import memory as M

    opt, mask, hstep, ids, lab, params = _c9_case()
    hst = M.init_offloaded_state(opt, params, decay_mask=mask,
                                 bucket_bytes=_SMALL_BUCKET_BYTES)
    loss, grads = hstep.accumulate(params, ids, lab)
    fp = {k: v.clone() for k, v in params.items()}
    fst = opt.init_flat_state(fp, decay_mask=mask)
    new_p, _ = opt.apply_flat(fp, grads, fst, 1e-3, 1, decay_mask=mask)
    usq = M.apply_flat_offloaded(opt, params, grads, hst, 1e-3, 1,
                                 decay_mask=mask, write=False)
    tp = th.make_probe(loss, grads, params, None, update_sq=usq)

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    jp = jh.make_probe(jnp.float32(loss.item()),
                       {k: jx(v) for k, v in grads.items()},
                       {k: jx(v) for k, v in params.items()},
                       {k: jx(v) for k, v in new_p.items()})
    assert tp["ok"] == bool(jp["ok"])
    for f in ("loss", "grad_norm", "update_ratio"):
        np.testing.assert_allclose(tp[f], float(jp[f]), rtol=1e-5,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# C.10: check_ranks beside a live group
# ---------------------------------------------------------------------------


def _report_view(rep):
    return (rep.target, [f.format() for f in rep.findings],
            [f.format() for f in rep.suppressed], rep.passes_run,
            rep.skipped)


def test_check_ranks_beside_a_gloo_step(tmp_path):
    """C.10: ``check_ranks`` captures in this process when no group is
    live here, and a gloo step then runs in the same process; with that
    group live, ``check_ranks`` captures in a spawned child and returns
    the same report (findings, suppressed, passes, skips), and the live
    group is untouched by it."""
    from paddle_tpu_torch.analysis.core import check_ranks
    from paddle_tpu_torch.analysis.self_check import _llama_build
    from paddle_tpu_torch.parallel import init_mesh
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    build = _llama_build((2, 2, 2), overlap=OverlapConfig())
    kw = dict(ranks=[0, 1, 2, 4], device="cpu",
              passes=["collective_order", "collective_budget"],
              options={"collective_budget": {"overlap_active": True}})
    here = check_ranks(build, 8, **kw)
    assert here.ok and not dist.is_initialized()
    store = dist.FileStore(str(tmp_path / "store"), 1)
    mesh = init_mesh("cpu", (1, 1, 1), ("dp", "sharding", "mp"),
                     store=store, rank=0, world_size=1)
    try:
        model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu",
                                 generator=torch.Generator().manual_seed(3))
        opt = AdamW(learning_rate=1e-3)
        step = build_train_step(model, opt, mesh=mesh)
        params = model.functional_state()
        ids = torch.randint(0, model.cfg.vocab_size, (2, 16),
                            generator=torch.Generator().manual_seed(4))
        loss = step(params, opt.init_state(params), 0, 1e-3, ids, ids)[0]
        assert torch.isfinite(loss)
        group = dist.group.WORLD
        live = check_ranks(build, 8, **kw)
        assert _report_view(live) == _report_view(here)
        assert dist.is_initialized() and dist.group.WORLD is group
        loss = step(params, opt.init_state(params), 0, 1e-3, ids, ids)[0]
        assert torch.isfinite(loss)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
