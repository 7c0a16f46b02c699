"""Graph Doctor self-check: the doctor proving it can still detect.

Port of the one-device layers of ``paddle_tpu/analysis/self_check.py``,
all required green:

1. every seeded fixture (``fixtures.py``) fires EXACTLY its code
   (true-positive coverage per pass);
2. the clean sweeps of the one-device flagships at the debug shapes
   (``build_train_step`` bf16 accum 1 and accum 4, the health-probed step,
   the memory-engine step with host state, llama forward/backward, the
   serving decode chunk, the unified step) report no active finding, or
   only findings a tracked exemption suppresses (false-positive coverage);
3. every standing exemption still matches a live suppressed finding in
   its own liveness probe (stale exemptions rot loudly).

Plus the Concurrency Doctor's block (the control-plane sweep and the
sanitizer self-test), and the layers above one rank, each captured on a
``"fake"`` process group (``core.fake_ranks``) at JAX's world sizes:

4. the overlap sweeps (the dp2 x sharding2 x mp2 engine step under its
   collective budget, collective order over the ranks of rank 0's groups,
   and the donation audit; the fake two-slice step with the codec on,
   pinned to its DCN wire budget);
5. the expert-parallel sweeps (capacity and dropless steps on the fake
   two-slice dp1 x sharding2 x ep4 mesh, codec on, pinned to their wire
   budgets, every collective engine-attributed);
6. the Sharding Doctor's section (the mesh step at accum 1 and 4, the
   overlap and hybrid steps, each audited for unplanned reshards and its
   stack's table; the serving table; the cross-stack gate; the schedule's
   derivation, stack plan and table round trip; the EP tables);
7. the wire table of the flagship two-slice step with the codec off and
   on, the canonical tables, and the joint partition x memory x codec walk
   (``unified_schedule``), with the Graph Doctor's static peak as its
   meter;
8. the roofline's drift gate (``roofline_drift``): the estimator's
   predicted winner of that walk, its fit frontier and its DCN bytes
   against the walk's measured records.

Nothing is left out (``left_out`` is empty).

Every budget below is the port's own, measured by ``static_peak`` on the
CPU capture of its target (the CPU counts every storage, unrounded) and
pinned with the headroom its comment gives.

``python -m paddle_tpu_torch.analysis --self-check`` runs it.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

# the capture-level passes of the quick sweeps
FAST_PASSES = ("dtype_promotion", "donation")
ALL_PASSES = None

# the sweeps run debug-shaped models (~0.36 MB of fp32 params), far below
# the donation pass's 1 MB default: at the default the gate would be
# vacuous (an out-of-place pool write in the serving step would pass).
# The same debug-scale bar as JAX's.
DONATION_MIN_BYTES = 4 << 10

# The accum-4 flat-state flagship (debug Llama, fp32 params, bf16
# compute, [4, 1, 16] batch) has a static peak of 4 004 868 B on the CPU
# capture: 1 118 976 B of caller-held params, flat state and batch, the
# gradients the step's Python frame holds through the update and the
# transients of the in-place update's one bucket (at these shapes a flat
# group is one 16 MB bucket; the functional update it replaced peaked at
# 4 008 708 B with a second params and state).  The memory-engine step
# peaks at 4 111 364 B (its two 256 KB bucket slots, gradient and param
# staging dominate at these shapes).  4.5 MB pins both: a second copy of
# the flat state (+0.72 MB) fails MEM001 here.
FLAGSHIP_HBM_BUDGET = 4608 << 10
# The memory-engine step (remat "names", host-resident AdamW streamed in
# 256 KB buckets) moves 1 446 912 B between host and device a step over
# 12 copies: each bucket of both fp32 moments in and out once (the master
# is the fp32 params themselves).  2 MB pins it with ~0.6 MB of headroom:
# one unbucketed full-state round trip (+1.45 MB) fails MEM002.
FLAGSHIP_STREAM_BUDGET = 2 << 20
# The health-probed accum-1 step's static peak equals the unprobed step's
# (1 724 556 B both, in place; 2 607 876 B when the update was
# functional): the first pass's transients are one leaf's, as the second
# pass's are, and the probe's reductions are scalars.  64 KB allows a
# handful of probe buffers; a tree-sized probe output (fp32 masks or a
# concatenated fp32 gradient, ~0.36 MB at these shapes) fails HEALTH001.
HEALTH_PROBE_OVERHEAD = 64 << 10
# The unified serving step of the self-check's engine (2 slots, 9 pages of
# 16, prefill chunk 8) has a static peak of 481 336 B: the fp32 weights and
# pools it holds (443 896 B) plus the ragged step's rows.  512 KB pins it;
# the seeded MEM001[prefill_chunk] engine (chunk 48, 17 pages) measures
# 697 432 B and fails it: a prefill-budget bump has to re-justify the
# declared budget.
SERVING_HBM_BUDGET = 512 << 10


# ----------------------------------------------------------- above one rank
#
# Every budget below is the port's own, read on the CPU capture of rank 0
# of a fake group of 8 (``collective_budget.collective_tally`` and
# ``collect_wire_table``), and pinned with the headroom its comment gives.

# The overlap engine's step on dp2 x sharding2 x mp2 (the debug flagship,
# L = 2): 25 all-reduces, 5 all-gathers (4 bucket gathers and the
# embedding's), 4 reduce-scatters a step.  A per-leaf collective
# regression (9 leaves x L x forward and backward) blows straight through.
OVERLAP_COLLECTIVE_BUDGET = {"allreduce": {"count": 28},
                             "allgather": {"count": 6},
                             "reducescatter": {"count": 5}}
# The fake two-slice overlap step (dp1 x sharding4 x mp2, slice map
# (0, 0, 1, 1) on sharding): 50 202 DCN bytes a step with the codec on,
# 68 742 with it off.  56 KB pins the coded schedule: a dropped codec fails
# COMM004.
FLAGSHIP_SLICE_MAP = (0, 0, 1, 1)
FLAGSHIP_DCN_WIRE_BUDGET = 56 << 10
# The EP steps on dp1 x sharding2 x ep4, slice map (0, 0, 1, 1) on ep:
# the capacity step moves 1 974 DCN bytes coded and 4 824 uncoded, the
# dropless step 2 584 and 7 144 (its int32 count exchange stays uncoded by
# design).  The pins sit between each pair.
MOE_SLICE_MAP = (0, 0, 1, 1)
MOE_DCN_WIRE_BUDGET = 2304
MOE_DROPLESS_DCN_WIRE_BUDGET = 3072
# SHARD002's floor for the debug tables (the production default is 1 MB;
# debug leaves top out at ~64 KB): a replicated projection leaf (16 KB)
# fails the sweep.
SHARDING_REPLICATED_MIN_BYTES = 4 << 10
# params replicate over the pure data axes by design
SHARDING_DATA_AXES = ("dp", "pp", "sep")
# SHARD005's floor for the debug flat state (the production default is
# 64 KB): a rank's block of the 8-way shard-major moments is ~45 KB here
SHARDING_UPDATE_MIN_BYTES = 4 << 10
# the world size of the sweeps and rank 0's group lines on (2, 2, 2): its
# mp, sharding and dp peers, so every group rank 0 is in is captured whole
WORLD = 8
RANK0_LINES = (0, 1, 2, 4)

def _flagship(device="cpu"):
    """The debug flagship shared by the sweeps (JAX's ``_flagship``): the
    fp32 debug Llama, AdamW, a seeded [4, 16] batch."""
    from ..optimizer import AdamW
    from .fixtures import _flagship_model

    cfg, model = _flagship_model(device)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    params = {k: v.detach().clone() for k, v in
              model.functional_state().items()}
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int64)
    return cfg, model, opt, params, ids, labels


def _health_target(model, opt, params, ids, labels, donation, device):
    """The health-probed accum-1 step against the same step built without
    ``health=`` (its static peak as the baseline), no collective."""
    from ..distributed.health import HealthConfig, default_gates
    from ..models import build_train_step
    from .core import capture, check, static_peak

    step1 = build_train_step(model, opt, compute_dtype=torch.bfloat16)
    state = opt.init_state(params)
    base = static_peak(capture(step1, (params, state, 0, 1e-4, ids, labels),
                               device=device))["peak_bytes"]
    hstep = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             health=HealthConfig())
    return check(hstep, params, state, 0, 1e-4, ids, labels,
                 kwargs={"health_gates": default_gates()},
                 passes=["health_probe", "dtype_promotion", "donation"],
                 options={**donation,
                          "health_probe": {
                              "baseline_peak_bytes": base,
                              "probe_overhead_bytes": HEALTH_PROBE_OVERHEAD,
                              "baseline_collectives": {}}},
                 declared_dtype=torch.bfloat16, device=device,
                 target="health_probed_step[bf16]")


def _memory_target(model, opt, params, ids, labels, donation, device):
    """The memory engine's step: named-saveable remat and the AdamW state
    in host memory, streamed in buckets, under both capacity contracts,
    the donation audit (the params and host state update in place) and
    the dtype audit."""
    from ..models import build_train_step
    from ..models.llama import llama_decay_mask
    from ..parallel.memory import MemoryConfig, init_offloaded_state
    from .core import check

    mc = MemoryConfig(remat="names", optimizer_residency="host",
                      stream_bucket_bytes=256 << 10)
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            memory=mc)
    st = init_offloaded_state(opt, params, decay_mask=llama_decay_mask(model),
                              bucket_bytes=mc.stream_bucket_bytes)
    return check(step, params, st, 0, 1e-4, ids, labels,
                 passes=["dtype_promotion", "donation", "memory_budget"],
                 options={**donation,
                          "memory_budget": {
                              "hbm_bytes": FLAGSHIP_HBM_BUDGET,
                              "host_transfer_bytes": FLAGSHIP_STREAM_BUDGET}},
                 declared_dtype=torch.bfloat16, device=device,
                 target="memory_train_step[names,host]")


def _clean_targets(device="cpu"):
    """Yield (name, report) for the flagship clean sweeps."""
    from ..inference.serving import ContinuousBatchingEngine
    from ..models import build_train_step
    from ..models.llama import _gold_logit, llama_decay_mask, llama_forward
    from .core import check

    cfg, model, opt, params, ids, labels = _flagship(device)
    donation = {"donation": {"min_bytes": DONATION_MIN_BYTES}}
    # declared_dtype is pinned, not inferred: a regression that upcasts
    # every matmul to fp32 also removes the bf16 matmuls the inference
    # keys on, and the audit would stand down exactly when needed
    step1 = build_train_step(model, opt, compute_dtype=torch.bfloat16)
    yield "build_train_step[bf16]", check(
        step1, params, opt.init_state(params), 0, 1e-4, ids, labels,
        passes=list(FAST_PASSES), options=donation,
        declared_dtype=torch.bfloat16, device=device,
        target="build_train_step[bf16]")

    # the headline training config: the bf16 carry over 4 micro-steps and
    # the fused flat optimizer, every pass, under the peak contract
    step4 = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             accum_steps=4)
    yield "build_train_step[bf16,accum4]", check(
        step4, params,
        opt.init_flat_state(params, decay_mask=llama_decay_mask(model)), 0,
        1e-4, ids.reshape(4, 1, 16), labels.reshape(4, 1, 16),
        passes=ALL_PASSES,
        options={**donation,
                 "memory_budget": {"hbm_bytes": FLAGSHIP_HBM_BUDGET}},
        declared_dtype=torch.bfloat16, device=device,
        target="build_train_step[bf16,accum4]")

    yield "health_probed_step[bf16]", _health_target(
        model, opt, params, ids, labels, donation, device)
    yield "memory_train_step[names,host]", _memory_target(
        model, opt, params, ids, labels, donation, device)

    # llama forward/backward alone: the params are read-only here, so they
    # are declared persistent for the donation audit
    def fwd_bwd(p, ids_, labels_):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        cast = {k: v.to(torch.bfloat16) for k, v in leaves.items()}
        with torch.enable_grad():
            lv = llama_forward(cfg, cast, ids_)
            loss = (torch.logsumexp(lv.float(), dim=-1)
                    - _gold_logit(lv, labels_)).mean()
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    t_ids = torch.from_numpy(ids).to(device)
    t_labels = torch.from_numpy(labels).to(device)
    yield "llama_fwd_bwd[bf16]", check(
        fwd_bwd, params, t_ids, t_labels, passes=list(FAST_PASSES),
        options={"donation": {"persistent": (0,),
                              "min_bytes": DONATION_MIN_BYTES}},
        declared_dtype=torch.bfloat16, device=device,
        target="llama_fwd_bwd[bf16]")

    # the serving decode chunk (paged pipelined engine), every pass
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, num_pages=9,
                                   page_size=16, max_seq_len=64,
                                   decode_chunk_steps=2, device=device)
    fn, args, kwargs, options = eng.analysis_entry()
    yield "serving_decode_chunk", check(
        fn, *args, kwargs=kwargs, options=options, passes=ALL_PASSES,
        device=device, target="serving_decode_chunk")

    # the unified step (chunked prefill rows mixed into the decode launch)
    # under the pinned peak contract
    ueng = ContinuousBatchingEngine(cfg, params, max_slots=2, num_pages=9,
                                    page_size=16, max_seq_len=64,
                                    prefill_token_budget=8, device=device)
    ufn, uargs, ukwargs, uoptions = ueng.analysis_entry()
    yield "serving_unified_step", check(
        ufn, *uargs, kwargs=ukwargs, passes=ALL_PASSES,
        options={**uoptions,
                 "memory_budget": {"hbm_bytes": SERVING_HBM_BUDGET}},
        device=device, target="serving_unified_step")


def _probe_masked_grad_accum(device="cpu"):
    """Liveness probe for EX-DT003-masked-grad-accum: the masked accum
    branch still carries its fp32 accumulator and the audit still sees
    (and suppresses) it."""
    from ..models import build_train_step
    from .core import check

    cfg, model, opt, params, ids, labels = _flagship(device)
    stepm = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             accum_steps=4)
    amask = np.ones((4, 1, 16), np.int32)
    amask[:, :, -4:] = 0
    return check(stepm, params, opt.init_state(params), 0, 1e-4,
                 ids.reshape(4, 1, 16), labels.reshape(4, 1, 16), amask,
                 passes=["dtype_promotion"], declared_dtype=torch.bfloat16,
                 device=device, target="build_train_step[bf16,accum4,masked]")


# every standing exemption needs a probe that reproduces its finding: an
# Exemption without one FAILS the self-check
_LIVENESS_PROBES = {
    "EX-DT003-masked-grad-accum": _probe_masked_grad_accum,
}


def exemption_liveness(device="cpu", exemptions=None) -> Dict[str, dict]:
    """Each standing exemption must still match a live suppressed finding
    in its own probe's report; ``exemptions`` (default the standing table)
    lets a test hand in a stale entry."""
    from .core import check  # noqa: F401 - the probes' import
    from .exemptions import EXEMPTIONS, apply_exemptions

    table = EXEMPTIONS if exemptions is None else exemptions
    out = {}
    for ex in table:
        probe = _LIVENESS_PROBES.get(ex.id)
        if probe is None:
            out[ex.id] = {"ok": False,
                          "error": f"no liveness probe registered for "
                                   f"{ex.id}: add one to _LIVENESS_PROBES"}
            continue
        rep = probe(device)
        # re-apply this table to the probe's findings
        findings = list(rep.findings) + list(rep.suppressed)
        for f in findings:
            f.exemption_id = None
        active, suppressed = apply_exemptions(findings, table)
        hit = [f for f in suppressed if f.exemption_id == ex.id]
        out[ex.id] = {"ok": bool(hit) and not active,
                      "matched": len(hit),
                      "unsuppressed": [f.format() for f in active]}
    return out


# ----------------------------------------------------------- above one rank


def _llama_build(shape, device="cpu", overlap=None, accum_steps=1,
                 flat=False):
    """``build(rank)`` of the debug flagship's mesh step on a fake mesh of
    ``shape`` (dp, sharding, mp): the model sharded over it, the step
    (``overlap`` the engine's config), a per-tensor state or, with
    ``flat``, the flat state in the step's shard-major layout.  A
    ``functools.partial`` of a module-level function, so that
    ``check_ranks`` can send it to a spawned child (a group live)."""
    return functools.partial(_llama_rank, shape, device, overlap,
                             accum_steps, flat)


def _llama_rank(shape, device, overlap, accum_steps, flat, rank):
    from ..models import build_train_step
    from ..models.llama import apply_llama_sharding, llama_decay_mask
    from .core import fake_mesh

    cfg, model, opt, _, ids, labels = _flagship(device)
    mesh = fake_mesh(shape, ("dp", "sharding", "mp"),
                     torch.device(device).type)
    apply_llama_sharding(model, mesh)
    step = build_train_step(model, opt, mesh=mesh,
                            compute_dtype=torch.bfloat16,
                            accum_steps=accum_steps, overlap=overlap)
    params = model.functional_state()
    state = opt.init_flat_state(
        params, decay_mask=llama_decay_mask(model),
        flat_layout=step.flat_layout) if flat \
        else opt.init_state(params)
    if accum_steps > 1:
        ids = ids.reshape(accum_steps, -1, ids.shape[-1])
        labels = labels.reshape(accum_steps, -1, labels.shape[-1])
    return step, (params, state, 0, 1e-4, ids, labels), {}, mesh


def _hybrid_build(schedule, device="cpu"):
    """``build(rank)`` of the hybrid step (pp2 x sharding2 x mp2) over the
    debug flagship's stacked state."""
    return functools.partial(_hybrid_rank, schedule, device)


def _hybrid_rank(schedule, device, rank):
    from ..models.llama_hybrid import (HYBRID_AXES, build_hybrid_train_step,
                                       init_hybrid_state)
    from .core import fake_mesh

    cfg, model, opt, _, ids, labels = _flagship(device)
    mesh = fake_mesh((2, 1, 2, 1, 2), HYBRID_AXES, torch.device(device).type)
    state = init_hybrid_state(model, mesh)
    step = build_hybrid_train_step(cfg, opt, mesh, num_microbatches=2,
                                   compute_dtype=torch.float32,
                                   schedule=schedule)
    return step, (state, opt.init_state(state), 0, 1e-4, ids, labels), {}, \
        mesh


def _moe_ep_cfg():
    from ..parallel.expert import MoEEPConfig

    return MoEEPConfig(d_model=16, d_hidden=32, num_expert=8, top_k=2,
                       capacity_factor=2.0, aux_weight=0.01)


def _moe_ep_build(dropless, device="cpu", codec=True):
    """``build(rank)`` of the EP train step (JAX's ``_moe_ep_flagship``):
    dp1 x sharding2 x ep4, the fake two-slice map on ep, the codec on."""
    return functools.partial(_moe_ep_rank, dropless, device, codec)


def _moe_ep_rank(dropless, device, codec, rank):
    from ..parallel.codec import CollectiveCodec
    from ..parallel.expert import (build_moe_ep_dropless_train_step,
                                   build_moe_ep_train_step,
                                   init_moe_ep_params)
    from ..parallel.overlap import OverlapConfig
    from .core import fake_mesh

    cfg = _moe_ep_cfg()
    mesh = fake_mesh((1, 2, 4), ("dp", "sharding", "ep"),
                     torch.device(device).type)
    params = init_moe_ep_params(cfg, mesh, device=device)
    oc = OverlapConfig(hierarchical="on", slice_map=MOE_SLICE_MAP,
                       codec=CollectiveCodec(block=64) if codec else None)
    make_step = build_moe_ep_dropless_train_step if dropless \
        else build_moe_ep_train_step
    rng = np.random.default_rng(7)
    x2d = torch.from_numpy(rng.standard_normal((64, 16),
                                               np.float32)).to(device)
    tgt = torch.from_numpy(rng.standard_normal((64, 16),
                                               np.float32)).to(device)
    return make_step(cfg, mesh, oc=oc), (params, x2d, tgt), {}, mesh


def _overlap_targets(device="cpu"):
    """The overlap engine's clean sweeps (JAX's ``_overlap_target``)."""
    from ..parallel.codec import CollectiveCodec
    from ..parallel.overlap import OverlapConfig
    from .core import check_ranks

    yield "overlap_train_step[dp2,sharding2,mp2]", check_ranks(
        _llama_build((2, 2, 2), device, overlap=OverlapConfig()), WORLD,
        ranks=RANK0_LINES, device=device,
        passes=["collective_budget", "collective_order", "donation"],
        options={"donation": {"min_bytes": DONATION_MIN_BYTES},
                 "collective_budget": {"overlap_active": True,
                                       **OVERLAP_COLLECTIVE_BUDGET}},
        declared_dtype=torch.bfloat16,
        target="overlap_train_step[dp2,sharding2,mp2]")
    hoc = OverlapConfig(hierarchical="on", slice_map=FLAGSHIP_SLICE_MAP,
                        codec=CollectiveCodec())
    yield "overlap_train_step[hier2slice,codec]", check_ranks(
        _llama_build((1, 4, 2), device, overlap=hoc), WORLD, ranks=(0,),
        device=device, passes=["collective_budget"],
        options={"collective_budget": {
            "overlap_active": True,
            "wire": {"dcn_axes": {"sharding": list(FLAGSHIP_SLICE_MAP)},
                     "dcn_bytes": FLAGSHIP_DCN_WIRE_BUDGET}}},
        declared_dtype=torch.bfloat16,
        target="overlap_train_step[hier2slice,codec]")


def _moe_ep_targets(device="cpu"):
    """The EP clean sweeps (JAX's ``_moe_ep_target`` and
    ``_moe_ep_dropless_target``)."""
    from .core import check_ranks

    for dropless, budget in ((False, MOE_DCN_WIRE_BUDGET),
                             (True, MOE_DROPLESS_DCN_WIRE_BUDGET)):
        name = ("moe_ep_dropless_train_step" if dropless
                else "moe_ep_train_step") + "[hier2slice,codec]"
        yield name, check_ranks(
            _moe_ep_build(dropless, device), WORLD, ranks=(0,),
            device=device, passes=["collective_budget"],
            options={"collective_budget": {
                "overlap_active": True,
                "wire": {"dcn_axes": {"ep": list(MOE_SLICE_MAP)},
                         "dcn_bytes": budget}}},
            target=name)


def _sharding_targets(device="cpu"):
    """The Sharding Doctor's sweeps (JAX's ``_sharding_targets``): every
    stack's step audited for reshards its plan never issued (SHARD001)
    and its table (SHARD002/004), the flat update's cut (SHARD005), the
    serving table, the cross-stack gate (SHARD003), the schedule's
    derivations (SCHED001) and the EP tables."""
    from ..inference.serving import ContinuousBatchingEngine
    from ..models.llama import llama_decay_mask
    from ..models.llama_hybrid import HYBRID_AXES
    from ..parallel.expert import init_moe_ep_params, moe_ep_layout
    from ..parallel.overlap import OverlapConfig
    from ..parallel.schedule import PartitionSchedule
    from ..parallel.specs import Mesh, layout_from_arrays
    from .core import check_ranks, fake_mesh, fake_ranks
    from .sharding import (check_cross_stack, check_layout,
                           check_schedule_derivation,
                           check_stack_plan_derivation,
                           extract_hybrid_layout, extract_mesh_layout,
                           extract_overlap_layout)

    cfg, model, opt, params0, ids, labels = _flagship(device)
    mesh = Mesh((2, 2, 2), ("dp", "sharding", "mp"))
    hmesh = Mesh((2, 1, 2, 1, 2), HYBRID_AXES)
    mlayout = extract_mesh_layout(model, mesh)
    olayout = extract_overlap_layout(model, mesh)
    hlayout = extract_hybrid_layout(model, hmesh)

    def table(layout, **extra):
        return {"sharding_consistency": {
            "layout": layout, "declared": {},
            "replicated_min_bytes": SHARDING_REPLICATED_MIN_BYTES,
            "replication_ignore_axes": SHARDING_DATA_AXES, **extra}}

    def audit(name, build, layout, **extra):
        return name, check_ranks(
            build, WORLD, ranks=(0,), device=device,
            passes=["sharding_consistency"],
            options=extra.pop("options", None) or table(layout, **extra),
            target=f"sharding:{name}")

    yield audit("mesh_train_step[accum1]", _llama_build((2, 2, 2), device),
                mlayout)
    # the flat update in the step's shard-major layout must be cut across
    # the replicas (SHARD005 reads the state's buffers against it)
    yield audit("mesh_train_step[accum4]",
                _llama_build((2, 2, 2), device, accum_steps=4, flat=True),
                mlayout, options=lambda fn, args, m: table(
                    mlayout, expect_update_pin=True,
                    flat_layout=fn.flat_layout,
                    flat_local_sizes=flat_local_sizes(
                        opt, args[0], llama_decay_mask(model),
                        fn.flat_layout),
                    update_min_bytes=SHARDING_UPDATE_MIN_BYTES))
    yield audit("overlap_train_step",
                _llama_build((2, 2, 2), device, overlap=OverlapConfig()),
                olayout)
    for sched in ("gpipe", "1F1B"):
        yield audit(f"hybrid_train_step[{sched}]",
                    _hybrid_build(sched, device), hlayout)
    eng = ContinuousBatchingEngine(cfg, params0, max_slots=2, num_pages=9,
                                   page_size=16, max_seq_len=64,
                                   prefill_token_budget=8, device=device)
    yield "serving_param_layout", check_layout(
        eng.param_layout(),
        replicated_min_bytes=SHARDING_REPLICATED_MIN_BYTES,
        target="sharding:serving_param_layout")
    yield "cross_stack", check_cross_stack(
        {"mesh": mlayout, "overlap": olayout, "hybrid": hlayout},
        target="sharding:cross_stack")
    psched = PartitionSchedule.from_model(model, mesh)
    yield "schedule_derivation", check_schedule_derivation(
        psched, {"mesh": mlayout}, target="sharding:schedule_derivation")
    yield "schedule_stack_plan", check_stack_plan_derivation(
        psched, model, mesh, target="sharding:schedule_stack_plan")
    rt = PartitionSchedule.from_table(psched.table.to_table(), mesh=mesh)
    yield "schedule_table_roundtrip", check_schedule_derivation(
        rt.rederive(mesh), {"declared": psched.table},
        target="sharding:schedule_table_roundtrip")
    mcfg = _moe_ep_cfg()
    with fake_ranks(WORLD, 0):
        mmesh = fake_mesh((1, 2, 4), ("dp", "sharding", "ep"),
                          torch.device(device).type)
        mplan = moe_ep_layout(mcfg, mmesh)
        mrest = layout_from_arrays(init_moe_ep_params(mcfg, mmesh,
                                                      device=device),
                                   mesh=mmesh)
    # in the EP stack sharding is a pure batch axis: expert weights
    # replicate over it by design, as over dp
    yield "moe_ep_layout", check_layout(
        mplan, replicated_min_bytes=SHARDING_REPLICATED_MIN_BYTES,
        ignore_axes=SHARDING_DATA_AXES + ("sharding",),
        target="sharding:moe_ep_layout")
    yield "moe_ep_cross_stack", check_cross_stack(
        {"moe_ep_plan": mplan, "moe_ep_at_rest": mrest},
        target="sharding:moe_ep_cross_stack")


def flat_local_sizes(opt, params, decay_mask, flat_layout
                     ) -> Dict[str, int]:
    """{group name: this rank's elements} of the shard-major flat groups
    the optimizer builds for ``params`` under ``flat_layout`` (SHARD005's
    expected buffer sizes)."""
    return {g["name"]: sum(g["plans"][k].local for k in g["keys"])
            for g in opt._flat_groups(params, decay_mask, flat_layout)
            if "layout" in g}


def _run_section(targets, memo, key) -> Dict[str, dict]:
    """(name, report) pairs as a JSON-able section, memoized when green."""
    if key in memo:
        return memo[key]
    out = {}
    try:
        for name, rep in targets:
            out[name] = {"ok": rep.ok,
                         "findings": [f.format() for f in rep.findings],
                         "suppressed": [f.format() for f in rep.suppressed],
                         "skipped_passes": dict(rep.skipped)}
    except Exception as e:  # noqa: BLE001 - a structured failure
        out["_sweep_error"] = {"ok": False, "error": repr(e)[:500]}
        return out
    if all(v.get("ok") for v in out.values()):
        memo[key] = out
    return out


_OVERLAP_MEMO: Dict = {}
_MOE_MEMO: Dict = {}
_SHARDING_MEMO: Dict = {}
_WIRE_MEMO: Dict = {}
_JOINT_MEMO: Dict = {}


def overlap_section(device="cpu") -> Dict[str, dict]:
    return _run_section(_overlap_targets(device), _OVERLAP_MEMO,
                        str(torch.device(device)))


def moe_ep_section(device="cpu") -> Dict[str, dict]:
    return _run_section(_moe_ep_targets(device), _MOE_MEMO,
                        str(torch.device(device)))


def sharding_section(device="cpu") -> Dict[str, dict]:
    return _run_section(_sharding_targets(device), _SHARDING_MEMO,
                        str(torch.device(device)))


def flagship_wire_table(device="cpu") -> dict:
    """The ICI/DCN wire tables of the flagship overlap step on the fake
    two-slice mesh (dp1 x sharding4 x mp2), codec off and on, from rank 0's
    capture: the DCN bytes' ratio and the gradient reduce-scatter's (its
    fp32 reduce-scatter off, its packed int8 all-to-all on)."""
    from ..parallel.codec import CollectiveCodec
    from ..parallel.overlap import OverlapConfig
    from .core import capture, fake_ranks
    from .passes.collective_budget import collect_wire_table

    key = str(torch.device(device))
    if key in _WIRE_MEMO:
        return _WIRE_MEMO[key]
    dcn_axes = {"sharding": list(FLAGSHIP_SLICE_MAP)}
    out: Dict = {"slice_map": list(FLAGSHIP_SLICE_MAP),
                 "dcn_budget": FLAGSHIP_DCN_WIRE_BUDGET}
    for name, codec in (("codec_off", None), ("codec_on", CollectiveCodec())):
        oc = OverlapConfig(hierarchical="on", slice_map=FLAGSHIP_SLICE_MAP,
                           codec=codec)
        with fake_ranks(WORLD, 0):
            fn, args, kwargs, mesh = _llama_build((1, 4, 2), device,
                                                  overlap=oc)(0)
            cap = capture(fn, args, kwargs, device, mesh=mesh)
        out[name] = collect_wire_table(cap, mesh, dcn_axes)
    off, on = out["codec_off"]["dcn"], out["codec_on"]["dcn"]
    out["dcn_ratio"] = off["bytes"] / on["bytes"] if on["bytes"] else None
    rs_off = off["kinds"].get("reducescatter", {}).get("bytes", 0)
    rs_on = on["kinds"].get("alltoall", {}).get("bytes", 0)
    out["reducescatter_ratio"] = rs_off / rs_on if rs_on else None
    out["ok"] = bool(off["bytes"] > FLAGSHIP_DCN_WIRE_BUDGET >= on["bytes"])
    _WIRE_MEMO[key] = out
    return out


def flagship_sharding_table(device="cpu") -> dict:
    """The mesh step's canonical table of the debug flagship on dp2 x
    sharding2 x mp2."""
    from ..parallel.specs import Mesh
    from .sharding import extract_mesh_layout

    _, model, _, _, _, _ = _flagship(device)
    return extract_mesh_layout(
        model, Mesh((2, 2, 2), ("dp", "sharding", "mp"))).to_table()


def moe_ep_sharding_table() -> dict:
    """The EP stack's canonical table on dp1 x sharding2 x ep4."""
    from ..parallel.specs import Mesh
    from .sharding import extract_moe_ep_layout

    return extract_moe_ep_layout(
        _moe_ep_cfg(), Mesh((1, 2, 4), ("dp", "sharding", "ep"))).to_table()


# The joint walk's debug flagship (JAX's ``joint_flagship_config``: vocab
# 512, hidden 128, so that partitioning moves real bytes) on the two
# partition points of JAX's ``joint_schedule_points``, remat "none", codec
# off and on; each point's step captured at rank 0 of a fake group of 8,
# its static peak and DCN bytes read from that one capture.  Measured on
# the CPU capture:
#   hybrid4 (dp2 x sharding2 x mp2, slice map (0, 1) on sharding)
#       codec off: peak 2 235 232, DCN 460 292; on: 5 784 520 / 313 480
#   tp8 (dp1 x sharding4 x mp2, slice map (0, 0, 1, 1))
#       codec off: peak 1 531 176, DCN 395 526; on: 3 252 408 / 321 354
# (the codec's encode transients dominate the CPU peak, so the coded
# points are the big ones).  The budgets sit between the points' peaks and
# between their wire bytes, so the three walks land on three points: HBM
# alone on hybrid4/codec-off, DCN alone on hybrid4/codec-on, both on
# tp8/codec-on, a point neither budget alone forces and no hand point
# (codec off, or the hand partition hybrid4) fits.  Margins: 942 KB and
# 1.59 MB on the peak, 39 KB and 35 KB on the wire.
JOINT_HBM_BUDGET = 4 << 20
JOINT_DCN_WIRE_BUDGET = 352 << 10
JOINT_SLICE_MAPS = {"hybrid4": (0, 1), "tp8": (0, 0, 1, 1)}


def joint_schedule_points():
    from ..parallel.schedule import PartitionPoint

    return (PartitionPoint("hybrid4", (("dp", 2), ("sharding", 2),
                                       ("mp", 2)),
                           slice_map=JOINT_SLICE_MAPS["hybrid4"]),
            PartitionPoint("tp8", (("dp", 1), ("sharding", 4), ("mp", 2)),
                           slice_map=JOINT_SLICE_MAPS["tp8"]))


def joint_flagship_config():
    """The joint walk's debug flagship (JAX's ``joint_flagship_config``):
    vocab 512, hidden 128, so that partitioning moves real bytes."""
    from ..models import LlamaConfig

    return LlamaConfig.debug(vocab=512, hidden=128, layers=2, heads=8,
                             kv_heads=4, inter=256, max_pos=64)


JOINT_FLAGSHIP_BATCH, JOINT_FLAGSHIP_SEQ = 8, 16


def joint_lattice():
    """The joint lattice: JAX's two partition points, remat "none", the
    codec off and on."""
    from ..parallel.codec import CollectiveCodec
    from ..parallel.memory import MemoryConfig
    from ..parallel.schedule import joint_schedule_lattice

    return joint_schedule_lattice(
        joint_schedule_points(), memory_lattice=(MemoryConfig(remat="none"),),
        codec_points=(None, CollectiveCodec()))


def _joint_walk(device="cpu", **walk_kw):
    """``tune_schedule_config`` over ``joint_lattice`` (``walk_kw``: the
    budgets, ``predict``, ``estimator``, ``top_k``), each point's step
    built and captured at rank 0 of a fake group of 8: the meter is the
    capture's static peak, the DCN bytes are read from the same capture.
    Returns ``(chosen, records, built)``, ``built`` the labels in the
    order they were built."""
    import contextlib

    from ..models import LlamaForCausalLM, build_train_step
    from ..models.llama import apply_llama_sharding
    from ..optimizer import AdamW
    from ..parallel.schedule import tune_schedule_config
    from .core import capture, fake_mesh, fake_ranks, static_peak
    from .fixtures import _gen
    from .passes.collective_budget import collect_wire_table

    cfg = joint_flagship_config()
    rng = np.random.default_rng(5)
    shape = (JOINT_FLAGSHIP_BATCH, JOINT_FLAGSHIP_SEQ)
    ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
    labels = rng.integers(0, cfg.vocab_size, shape).astype(np.int64)
    group = contextlib.ExitStack()
    caps, built = {}, []

    def build_point(jc):
        group.close()                   # the previous point's group
        group.enter_context(fake_ranks(WORLD, 0))
        built.append(jc.label())
        pt = jc.partition
        mesh = fake_mesh([n for _, n in pt.axes], [a for a, _ in pt.axes],
                         torch.device(device).type)
        model = LlamaForCausalLM(cfg, device=device, dtype=torch.float32,
                                 generator=_gen(20260804, device))
        apply_llama_sharding(model, mesh)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        step = build_train_step(model, opt, mesh=mesh,
                                compute_dtype=torch.bfloat16,
                                overlap=jc.overlap, memory=jc.memory)
        params = model.functional_state()
        return step, (params, opt.init_state(params), 0, 1e-4, ids, labels)

    def meter(fn, *args):
        cap = capture(fn, args, device=device, mesh=fn.schedule.mesh)
        caps[id(fn)] = cap
        return static_peak(cap)

    def dcn_bytes(jc, fn, args):
        return collect_wire_table(caps.pop(id(fn)), fn.schedule.mesh,
                                  jc.partition.dcn_axes())["dcn"]["bytes"]

    try:
        chosen, records = tune_schedule_config(
            build_point, walk_kw.pop("hbm_bytes"), joint_lattice(),
            meter=meter, dcn_bytes_fn=dcn_bytes, **walk_kw)
    finally:
        group.close()
    return chosen, records, built


def joint_schedule_section(device="cpu", hbm_bytes=None,
                           dcn_wire_bytes=None) -> dict:
    """The joint partition x memory x codec walk
    (``parallel.schedule.tune_schedule_config``) over the fake two-slice
    lattice under the pinned budgets, each point's step captured at rank 0
    of a fake group of 8 (JAX's ``joint_schedule_section``)."""
    from ..parallel.schedule import choose_joint_config

    hbm = JOINT_HBM_BUDGET if hbm_bytes is None else hbm_bytes
    dcn = JOINT_DCN_WIRE_BUDGET if dcn_wire_bytes is None else dcn_wire_bytes
    key = (str(torch.device(device)), hbm, dcn)
    if key in _JOINT_MEMO:
        return _JOINT_MEMO[key]
    chosen, records, _ = _joint_walk(
        device, hbm_bytes=hbm if hbm is not None else 1 << 62,
        dcn_wire_bytes=dcn if dcn is not None else 1 << 62)
    hbm_only = choose_joint_config(records, hbm_bytes=hbm)
    dcn_only = choose_joint_config(records, dcn_wire_bytes=dcn)
    joint = choose_joint_config(records, hbm_bytes=hbm, dcn_wire_bytes=dcn)
    # the hand points (codec off, or the hand partition hybrid4) must not
    # fit both budgets, or the partitioning axis added nothing
    hand_fits = [r["label"] for r in records
                 if (r["label"].startswith("hybrid4")
                     or r["label"].endswith("codec-off")) and r["fits"]]
    ok = (chosen is not None and joint is not None
          and records[joint]["label"] == chosen.label()
          and None not in (hbm_only, dcn_only)
          and len({hbm_only, dcn_only, joint}) == 3
          and joint > max(hbm_only, dcn_only) and not hand_fits)

    def label(i):
        return records[i]["label"] if i is not None else None

    out = {"ok": bool(ok), "hbm_budget": hbm, "dcn_wire_budget": dcn,
           "records": [{"label": r["label"], "peak_bytes": r["peak_bytes"],
                        "dcn_wire_bytes": r.get("dcn_wire_bytes"),
                        "config": r["config"]} for r in records],
           "picked": {"hbm_only": label(hbm_only),
                      "dcn_only": label(dcn_only), "joint": label(joint)},
           "chosen_label": chosen.label() if chosen is not None else None}
    if ok:
        _JOINT_MEMO[key] = out
    return out


def _joint_fits(rec) -> bool:
    """One record against both pinned joint budgets."""
    return (rec["peak_bytes"] <= JOINT_HBM_BUDGET
            and (rec.get("dcn_wire_bytes") or 0) <= JOINT_DCN_WIRE_BUDGET)


#: The joint walk's records as the port's capture measures them (the CPU
#: capture of rank 0 of a fake group of 8: static peaks and the capture's
#: DCN bytes), in lattice order: the drift section's paper trail when no
#: memoized joint section is at hand.  They must track
#: ``joint_schedule_section``'s records (tests/test_torch_roofline.py
#: holds them to it).  JAX's XLA peaks are not these.
RECORDED_JOINT_RECORDS = (
    {"label": "hybrid4(dp2xsharding2xmp2)[2slice]/none/device/codec-off",
     "peak_bytes": 2_235_232, "dcn_wire_bytes": 460_292},
    {"label": "hybrid4(dp2xsharding2xmp2)[2slice]/none/device/"
              "codec[g=int8/sr,w=fp8,b=256]",
     "peak_bytes": 5_784_520, "dcn_wire_bytes": 313_480},
    {"label": "tp8(sharding4xmp2)[2slice]/none/device/codec-off",
     "peak_bytes": 1_531_176, "dcn_wire_bytes": 395_526},
    {"label": "tp8(sharding4xmp2)[2slice]/none/device/"
              "codec[g=int8/sr,w=fp8,b=256]",
     "peak_bytes": 3_252_408, "dcn_wire_bytes": 321_354},
)

#: The chip the drift gate prices the lattice on: the reference's v5e row,
#: because the h100 row has no measured DCN rate and an estimate with
#: inter-slice bytes refuses it.
DRIFT_CHIP = "v5e"


def _drift_estimator(records):
    """(sheet, calibration offset, estimator) of the drift gate and the
    predicted walk: the cost sheet of the joint flagship, the
    peak calibrated on ``records[0]``, the pinned budgets, DRIFT_CHIP."""
    from ..parallel import roofline as rf

    sheet = rf.llama_cost_sheet(joint_flagship_config())
    cal = rf.calibration_offset_from(
        records[0], joint_lattice()[0], sheet, batch=JOINT_FLAGSHIP_BATCH,
        seq=JOINT_FLAGSHIP_SEQ)
    return sheet, cal, rf.joint_estimator(
        sheet, batch=JOINT_FLAGSHIP_BATCH, seq=JOINT_FLAGSHIP_SEQ,
        chip=DRIFT_CHIP, hbm_budget=JOINT_HBM_BUDGET,
        dcn_budget=JOINT_DCN_WIRE_BUDGET, calibration_offset=cal)


def roofline_drift_section(joint=None, device="cpu") -> dict:
    """The estimator-against-measurement drift gate (JAX's
    ``roofline_drift_section``): the roofline re-ranks the joint lattice,
    and its predicted winner (the cheapest point whose predicted peak and
    DCN bytes fit the pinned budgets, the peak calibrated on the first
    measured record) must be the joint walk's pick; each record's predicted
    fit must agree with the measured one; the predicted DCN bytes must be
    within 10 % of the measured.  The estimate prices the collectives the
    port's capture counts, some of which JAX's four pins never saw
    (``roofline.predict_wire_table``): drift means the engine's schedule
    and the estimator's terms parted.

    The measured records are the memoized ``joint_schedule_section``'s (or
    ``joint``'s), else RECORDED_JOINT_RECORDS, named in
    ``measured_source``.  Priced on DRIFT_CHIP."""
    if joint is None:
        joint = _JOINT_MEMO.get((str(torch.device(device)), JOINT_HBM_BUDGET,
                                 JOINT_DCN_WIRE_BUDGET))
    records = (joint or {}).get("records")
    source = "the port's capture (joint_schedule_section: static peaks)"
    if not records:
        records = [dict(r) for r in RECORDED_JOINT_RECORDS]
        source = ("the port's recorded capture "
                  "(self_check.RECORDED_JOINT_RECORDS: static peaks)")
    measured_pick = next((r["label"] for r in records if _joint_fits(r)),
                         None)
    by_label = {jc.label(): jc for jc in joint_lattice()}
    if set(by_label) != {r["label"] for r in records}:
        return {"ok": False, "target": "roofline:drift",
                "error": "lattice/record label mismatch",
                "lattice": sorted(by_label),
                "records": [r["label"] for r in records]}
    _, cal, estimate = _drift_estimator(records)
    ests = {r["label"]: estimate(by_label[r["label"]]) for r in records}
    order = sorted(records, key=lambda r: ests[r["label"]].total_s)
    predicted_pick = next((r["label"] for r in order
                           if ests[r["label"]].fits), None)
    table, frontier_ok, max_wire_err = [], True, 0.0
    for rec in records:
        e = ests[rec["label"]]
        meas_fit = _joint_fits(rec)
        frontier_ok = frontier_ok and e.fits == meas_fit
        md = rec.get("dcn_wire_bytes") or 0
        if md:
            max_wire_err = max(max_wire_err,
                               abs(e.dcn_wire_bytes - md) / md)
        table.append({"label": rec["label"], "predicted": e.to_json(),
                      "measured": {"peak_bytes": rec["peak_bytes"],
                                   "dcn_wire_bytes": md,
                                   "fits": meas_fit}})
    ok = (predicted_pick is not None and predicted_pick == measured_pick
          and frontier_ok and max_wire_err <= 0.10)
    return {"ok": bool(ok), "target": "roofline:drift",
            "chip": DRIFT_CHIP,
            "chip_note": "priced on the reference's v5e row: the h100 row "
                         "has no measured DCN rate, and this lattice puts "
                         "bytes across slices",
            "measured_source": source,
            "predicted_winner": predicted_pick,
            "measured_pick": measured_pick,
            "frontier_parity": bool(frontier_ok),
            "max_dcn_wire_rel_err": max_wire_err,
            "calibration_offset": cal,
            "predicted_order": [r["label"] for r in order],
            "table": table}


def predicted_joint_walk(device="cpu", top_k=1) -> dict:
    """``tune_schedule_config(predict=True)`` over the joint lattice: the
    drift gate's estimator (calibrated on the joint section's first
    record) orders the points, and the walk builds, captures and measures
    at most ``top_k`` of them under the pinned budgets (the static-peak
    meter and the capture's DCN bytes).  Green when it built only its
    choice and chose the joint walk's pick."""
    joint = joint_schedule_section(device)
    _, cal, estimate = _drift_estimator(joint["records"])
    chosen, records, built = _joint_walk(
        device, hbm_bytes=JOINT_HBM_BUDGET,
        dcn_wire_bytes=JOINT_DCN_WIRE_BUDGET, predict=True,
        estimator=estimate, top_k=top_k)
    label = chosen.label() if chosen is not None else None
    return {"ok": bool(chosen is not None and built == [label]
                       and label == joint["chosen_label"]),
            "built": built, "chosen_label": label,
            "joint_pick": joint["chosen_label"], "calibration_offset": cal,
            "records": [{k: r.get(k) for k in (
                "label", "predicted_rank", "compiled", "fits", "peak_bytes",
                "dcn_wire_bytes")} for r in records]}


_SEEDED_MEMO: Dict = {}
_CLEAN_MEMO: Dict = {}


def seeded_section(device="cpu") -> Dict[str, dict]:
    """Every fixture, its report's codes against its key's bare code."""
    from .fixtures import SEEDED

    key = str(torch.device(device))
    if key in _SEEDED_MEMO:
        return _SEEDED_MEMO[key]
    seeded, ok_all = {}, True
    for code, fx in SEEDED.items():
        try:
            rep = fx(device)
        except Exception as e:  # noqa: BLE001 - report, don't crash the CLI
            seeded[code] = {"ok": False, "error": repr(e)[:500]}
            ok_all = False
            continue
        codes = set(rep.codes())
        expect = code.split("[", 1)[0]
        seeded[code] = {"ok": codes == {expect}, "codes": sorted(codes),
                        "n": len(rep.findings)}
        ok_all = ok_all and seeded[code]["ok"]
    if ok_all:          # never memoize a red sweep
        _SEEDED_MEMO[key] = seeded
    return seeded


def clean_section(device="cpu") -> Dict[str, dict]:
    """The clean sweeps as a JSON-able dict, memoized per device."""
    return _run_section(_clean_targets(device), _CLEAN_MEMO,
                        str(torch.device(device)))


def self_check(clean: bool = True, device="cpu") -> dict:
    """Run the self-check; returns a JSON-able dict with ``ok``.
    ``clean=False`` runs the seeded fixtures and the concurrency block
    only."""
    from .concurrency import concurrency_section

    result = {"seeded": seeded_section(device)}
    try:
        result["concurrency"] = concurrency_section()
    except Exception as e:  # noqa: BLE001
        result["concurrency"] = {"_section_error": {"ok": False,
                                                    "error": repr(e)}}
    if clean:
        result["clean"] = clean_section(device)
        try:
            result["exemptions"] = exemption_liveness(device)
        except Exception as e:  # noqa: BLE001
            result["exemptions"] = {"_liveness_error": {"ok": False,
                                                        "error": repr(e)}}
        result["overlap"] = overlap_section(device)
        result["moe_ep"] = moe_ep_section(device)
        result["sharding"] = sharding_section(device)
        for key, fn in (("comm_wire", lambda: flagship_wire_table(device)),
                        ("sharding_canonical_table",
                         lambda: flagship_sharding_table(device)),
                        ("moe_ep_canonical_table", moe_ep_sharding_table),
                        ("unified_schedule",
                         lambda: joint_schedule_section(device)),
                        ("roofline_drift",
                         lambda: roofline_drift_section(device=device))):
            try:
                result[key] = fn()
            except Exception as e:  # noqa: BLE001
                result[key] = {"ok": False, "error": repr(e)[:500]}

    def _all_ok(d):
        return all(v.get("ok") for v in d.values()) if d else True

    result["ok"] = all(_all_ok(result.get(k, {}))
                       for k in ("seeded", "clean", "exemptions",
                                 "concurrency", "overlap", "moe_ep",
                                 "sharding")) \
        and all(result[k].get("ok", True) for k in
                ("comm_wire", "unified_schedule", "roofline_drift")
                if k in result)
    result["left_out"] = {}
    result["device"] = str(torch.device(device))
    return result


__all__ = ["ALL_PASSES", "DONATION_MIN_BYTES", "FAST_PASSES",
           "FLAGSHIP_HBM_BUDGET", "FLAGSHIP_STREAM_BUDGET",
           "HEALTH_PROBE_OVERHEAD", "RECORDED_JOINT_RECORDS",
           "SERVING_HBM_BUDGET", "clean_section", "exemption_liveness",
           "predicted_joint_walk", "roofline_drift_section",
           "seeded_section", "self_check"]
