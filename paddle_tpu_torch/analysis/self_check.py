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
sanitizer self-test).  Left out, with the JAX self-check's targets they
need: the overlap, EP and sharding sweeps, the wire tables and the joint
schedule (ROADMAP A7 part three: a capture at a world size above one) and
the roofline drift (part four).

Every budget below is the port's own, measured by ``static_peak`` on the
CPU capture of its target (the CPU counts every storage, unrounded) and
pinned with the headroom its comment gives.

``python -m paddle_tpu_torch.analysis --self-check`` runs it.
"""

from __future__ import annotations

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
# compute, [4, 1, 16] batch) has a static peak of 4 008 708 B on the CPU
# capture: 1 118 976 B of caller-held params, flat state and batch, the
# new params and state beside them (DON001's double residency; 2 923 524 B
# if both were donated), the micro-steps' activations and the gradients
# the step's Python frame holds through the update.  The memory-engine
# step peaks at 4 111 364 B (its two 256 KB bucket slots, gradient and
# param staging dominate at these shapes).  4.5 MB pins both: a second
# copy of the flat state (+0.72 MB) fails MEM001 here.
FLAGSHIP_HBM_BUDGET = 4608 << 10
# The memory-engine step (remat "names", host-resident AdamW streamed in
# 256 KB buckets) moves 1 446 912 B between host and device a step over
# 12 copies: each bucket of both fp32 moments in and out once (the master
# is the fp32 params themselves).  2 MB pins it with ~0.6 MB of headroom:
# one unbucketed full-state round trip (+1.45 MB) fails MEM002.
FLAGSHIP_STREAM_BUDGET = 2 << 20
# The health-probed accum-1 step's static peak equals the unprobed step's
# (2 607 876 B both): the eager step holds its gradients through the update
# either way, and the probe's reductions are scalars.  64 KB allows a
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


def _probe_functional_step(device="cpu"):
    """Liveness probe for EX-DON001-functional-train-step: the flat-state
    step still builds new params and state beside the caller's (ROADMAP
    C.7) and the audit still sees (and suppresses) it."""
    from ..models import build_train_step
    from ..models.llama import llama_decay_mask
    from .core import check

    cfg, model, opt, params, ids, labels = _flagship(device)
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16)
    return check(step, params,
                 opt.init_flat_state(params,
                                     decay_mask=llama_decay_mask(model)),
                 0, 1e-4, ids, labels, passes=["donation"],
                 options={"donation": {"min_bytes": DONATION_MIN_BYTES}},
                 device=device, target="build_train_step[bf16,flat]")


# every standing exemption needs a probe that reproduces its finding: an
# Exemption without one FAILS the self-check
_LIVENESS_PROBES = {
    "EX-DT003-masked-grad-accum": _probe_masked_grad_accum,
    "EX-DON001-functional-train-step": _probe_functional_step,
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
    key = str(torch.device(device))
    if key in _CLEAN_MEMO:
        return _CLEAN_MEMO[key]
    out = {}
    try:
        for name, rep in _clean_targets(device):
            out[name] = {"ok": rep.ok,
                         "findings": [f.format() for f in rep.findings],
                         "suppressed": [f.format() for f in rep.suppressed],
                         "skipped_passes": dict(rep.skipped)}
    except Exception as e:  # noqa: BLE001
        out["_sweep_error"] = {"ok": False, "error": repr(e)[:500]}
        return out
    if all(v.get("ok") for v in out.values()):
        _CLEAN_MEMO[key] = out
    return out


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

    def _all_ok(d):
        return all(v.get("ok") for v in d.values()) if d else True

    result["ok"] = all(_all_ok(result.get(k, {}))
                       for k in ("seeded", "clean", "exemptions",
                                 "concurrency"))
    result["left_out"] = {
        "overlap, moe_ep, moe_ep_dropless, sharding, comm_wire, "
        "unified_schedule": "ROADMAP A7 part three (a capture at a world "
                            "size above one)",
        "roofline_drift": "ROADMAP A7 part four"}
    result["device"] = str(torch.device(device))
    return result


__all__ = ["ALL_PASSES", "DONATION_MIN_BYTES", "FAST_PASSES",
           "FLAGSHIP_HBM_BUDGET", "FLAGSHIP_STREAM_BUDGET",
           "HEALTH_PROBE_OVERHEAD", "SERVING_HBM_BUDGET", "clean_section",
           "exemption_liveness", "seeded_section", "self_check"]
