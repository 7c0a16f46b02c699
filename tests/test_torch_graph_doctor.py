"""The port's Graph Doctor on one device (paddle_tpu_torch/analysis/) against
the JAX package's (paddle_tpu/analysis/), on the CPU.  Mirror of
tests/test_analysis_passes.py for the one-rank codes:

- true positives: every seeded fixture fires exactly its code, and the
  port's ``SEEDED`` holds every one-rank code of JAX's;
- clean runs: the one-device flagships sweep clean (the train steps update
  in place: no DON001, active or suppressed);
- exemptions: the masked grad-accum fp32 carry is detected without the
  table and suppressed with it; a stale or probe-less entry fails the
  liveness check;
- plumbing: an unknown pass raises, ``raise_if_findings`` carries the
  summary, ``persistent`` silences DON001, the sweeps' donation gates are
  live, the sentinel stays quiet on stable signatures, a capture that
  fails is the error finding MEM000 and not a skip;
- parity with JAX on the same seeded inputs: DON001's per-argument bytes
  and leaf counts, the retrace sentinel's codes and signature counts, the
  kernels captured as one node each.

JAX runs at the trace or lowering level only; every capture is a debug
shape on the CPU.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.analysis as A
from paddle_tpu_torch.analysis.fixtures import GRAPH_SEEDED, SEEDED
from paddle_tpu_torch.analysis.self_check import (DONATION_MIN_BYTES,
                                                  _flagship,
                                                  exemption_liveness)

# the JAX registry's codes above one rank or over XLA's compiled HLO
# (tests/test_torch_collective_doctor.py and test_torch_sharding_doctor.py)
PART_THREE = ("COLL", "COMM", "HLO", "SHARD", "SCHED")


# ------------------------------------------------------------ true positives


@pytest.mark.parametrize("code", sorted(GRAPH_SEEDED))
def test_seeded_fixture_fires_exactly_its_code(code):
    rep = SEEDED[code]()
    assert rep.findings, f"{code}: no finding\n" + rep.summary()
    assert set(rep.codes()) == {code.split("[", 1)[0]}, rep.summary()


def test_seeded_set_holds_every_one_rank_code_of_jax():
    from paddle_tpu.analysis.fixtures import SEEDED as JSEEDED

    one_rank = {c for c in JSEEDED if not c.startswith(PART_THREE)}
    assert one_rank <= set(SEEDED), sorted(one_rank - set(SEEDED))
    assert set(SEEDED) - set(JSEEDED) == set()


# ------------------------------------------------------------- clean sweeps


def test_flagship_entry_points_are_clean():
    from paddle_tpu_torch.analysis.self_check import clean_section

    section = clean_section()
    assert set(section) == {
        "build_train_step[bf16]", "build_train_step[bf16,accum4]",
        "health_probed_step[bf16]", "memory_train_step[names,host]",
        "llama_fwd_bwd[bf16]", "serving_decode_chunk",
        "serving_unified_step"}
    for name, rep in section.items():
        assert rep.get("ok"), (name, rep)
    # the train steps update in place: no DON001, active or suppressed
    for name, rep in section.items():
        assert not rep["suppressed"], (name, rep)
        assert not any("DON001" in f for f in rep["findings"]), (name, rep)


def test_self_check_cli_is_green():
    from paddle_tpu_torch.analysis.__main__ import main
    from paddle_tpu_torch.analysis.self_check import self_check

    res = self_check()
    assert res["ok"], {k: v for k, v in res.items() if k != "left_out"}
    # nothing is left out: the sections above one rank run on fake process
    # groups, and the roofline's drift gate is in
    assert res["left_out"] == {}
    assert res["roofline_drift"]["ok"], res["roofline_drift"]
    for key in ("overlap", "moe_ep", "sharding"):
        assert res[key] and all(v["ok"] for v in res[key].values()), key
    assert res["comm_wire"]["ok"] and res["unified_schedule"]["ok"]
    assert main([]) == 2


# --------------------------------------------------------------- exemptions


def _masked_accum_report(exemptions):
    from paddle_tpu_torch.models import build_train_step

    cfg, model, opt, params, ids, labels = _flagship()
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=4)
    amask = np.ones((4, 1, 16), np.int32)
    amask[:, :, -4:] = 0
    return A.check(step, params, opt.init_state(params), 0, 1e-4,
                   ids.reshape(4, 1, 16), labels.reshape(4, 1, 16), amask,
                   passes=["dtype_promotion"], exemptions=exemptions,
                   declared_dtype=torch.bfloat16, device="cpu",
                   target="masked-accum")


def test_masked_accum_fp32_carry_detected_without_exemptions():
    rep = _masked_accum_report(exemptions=())
    assert rep.codes() == ["DT003"], rep.summary()
    assert "micro_steps_masked" in rep.findings[0].data["stack_functions"]


def test_masked_accum_fp32_carry_suppressed_by_tracked_entry():
    rep = _masked_accum_report(exemptions=None)     # the standing table
    assert rep.ok, rep.summary()
    assert [f.exemption_id for f in rep.suppressed] == [
        "EX-DT003-masked-grad-accum"]


def test_unmasked_accum_folds_are_not_dt003():
    """The bf16 carry folded into fp32 every 8 micro-steps (accum 16: two
    chunks) is the fold JAX's innermost rule exempts."""
    from paddle_tpu_torch.models import build_train_step

    cfg, model, opt, params, ids, labels = _flagship()
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=16)
    big = np.tile(ids[:1], (16, 1)).reshape(16, 1, 16)
    rep = A.check(step, params, opt.init_state(params), 0, 1e-4, big, big,
                  passes=["dtype_promotion"], exemptions=(),
                  declared_dtype=torch.bfloat16, device="cpu")
    assert rep.ok, rep.summary()


def test_stale_or_probe_less_exemption_fails_self_check(monkeypatch):
    import paddle_tpu_torch.analysis.self_check as sc

    orphan = A.Exemption(id="EX-TEST-orphan", code="DT001",
                         file_pattern="nowhere.py", reason="test")
    out = exemption_liveness(exemptions=(orphan,))
    assert out["EX-TEST-orphan"]["ok"] is False
    assert "no liveness probe" in out["EX-TEST-orphan"]["error"]
    # a registered probe whose finding is gone: the entry is stale
    stale = A.Exemption(id="EX-TEST-stale", code="DT003",
                        file_pattern="models/llama.py", reason="test")
    monkeypatch.setitem(sc._LIVENESS_PROBES, "EX-TEST-stale",
                        lambda device: SEEDED["DT001"](device))
    out = exemption_liveness(exemptions=(stale,))
    assert out["EX-TEST-stale"]["ok"] is False
    assert out["EX-TEST-stale"]["matched"] == 0


# --------------------------------------------------------------- plumbing


def test_unknown_pass_name_raises():
    with pytest.raises(KeyError):
        A.check(lambda x: x, torch.ones(3), passes=["no_such_pass"],
                device="cpu")


def test_report_raise_if_findings_carries_summary():
    rep = A.Report(target="t", findings=[A.Finding(code="DT001",
                                                   message="boom")])
    with pytest.raises(A.AnalysisError) as ei:
        rep.raise_if_findings()
    assert "DT001" in str(ei.value) and "doctor report for t" in str(
        ei.value)


def test_donation_persistent_option_silences_don001():
    def served(weights, x):
        return weights - 1e-3 * (x.T @ x)

    w = torch.ones((768, 768))
    x = torch.ones((8, 768))
    noisy = A.check(served, w, x, passes=["donation"], exemptions=(),
                    device="cpu")
    assert noisy.codes() == ["DON001"], noisy.summary()
    assert noisy.findings[0].arg_path == "arg0"
    quiet = A.check(served, w, x, passes=["donation"], exemptions=(),
                    options={"donation": {"persistent": (0,)}},
                    device="cpu")
    assert quiet.ok, quiet.summary()


def test_in_place_update_is_the_ports_donation():
    def donated(weights, x):
        weights.sub_(1e-3 * (x.T @ x))
        return weights

    rep = A.check(donated, torch.ones((768, 768)), torch.ones((8, 768)),
                  passes=["donation"], exemptions=(), device="cpu")
    assert rep.ok, rep.summary()


def test_clean_sweep_donation_gate_is_live():
    """At the sweeps' DONATION_MIN_BYTES an updated copy of the flagship's
    params, not written in place, trips DON001 (the gate is not
    vacuous at the debug shapes)."""
    cfg, model, opt, params, ids, labels = _flagship()

    def undonated_step(p, g):
        return {k: v - 1e-3 * g[k] for k, v in p.items()}

    rep = A.check(undonated_step, params, params, passes=["donation"],
                  exemptions=(), device="cpu",
                  options={"donation": {"min_bytes": DONATION_MIN_BYTES}})
    assert rep.by_code("DON001"), rep.summary()


def test_serving_donation_gate_is_live():
    """The serving entry's floor is sized to the pools: a pool-shaped
    program that builds new pools instead of writing in place fails."""
    from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine

    cfg, model, opt, params, ids, labels = _flagship()
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, num_pages=9,
                                   page_size=16, max_seq_len=64,
                                   decode_chunk_steps=2, device="cpu")
    fn, args, kwargs, options = eng.analysis_entry()

    def undonated_pools(k_pages, v_pages):
        return [k * 2 for k in k_pages], [v * 2 for v in v_pages]

    rep = A.check(undonated_pools, args[1], args[2], passes=["donation"],
                  exemptions=(), device="cpu",
                  options={"donation": {
                      "min_bytes": options["donation"]["min_bytes"]}})
    assert rep.by_code("DON001"), rep.summary()


def test_retrace_sentinel_stable_signature_is_quiet():
    step = A.retrace_sentinel(lambda x, lr: x * lr)
    x = torch.ones(4)
    for _ in range(3):
        step(x, torch.tensor(0.1))
    rep = step.report()
    assert rep.ok and len(step.signatures) == 1, rep.summary()


def test_capture_failure_is_an_error_finding_not_a_skip():
    def host_read(x):
        return torch.from_numpy(x.numpy() * 2)   # no values in a capture

    rep = A.check(host_read, torch.ones(4), passes=["dtype_promotion"],
                  exemptions=(), device="cpu")
    assert rep.codes() == ["MEM000"] and not rep.ok, rep.summary()
    assert rep.skipped == {"dtype_promotion": "capture failed"}


def test_cuda_capture_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda capture runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        A.capture(lambda x: x * 2, (torch.ones(2),))


def test_capture_allocates_and_runs_nothing():
    """A capture runs on fake tensors: the caller's tensors are untouched
    (an in-place op does not reach them) and no plain kernel twin runs."""
    from paddle_tpu_torch.ops import flash_attention as fa

    calls = []
    real = fa.hb_flash_forward_plain
    w = torch.zeros(4)

    def f(w, q, k, v):
        w.add_(1.0)
        return fa.hb_flash_forward(q, k, v)

    q = torch.randn(2, 2, 16, 16)
    k = torch.randn(2, 16, 16)
    try:
        fa.hb_flash_forward_plain = lambda *a: calls.append(1) or real(*a)
        cap = A.capture(f, (w, q, k, k), device="cpu")
    finally:
        fa.hb_flash_forward_plain = real
    assert not calls and torch.equal(w, torch.zeros(4))
    ops = [n.target for n in cap.gm.graph.nodes if n.op == "call_function"]
    assert torch.ops.paddle_tpu_torch.hb_flash_fwd.default in ops


def test_provenance_names_the_issuing_frame():
    rep = SEEDED["DT001"]()
    f = rep.findings[0]
    assert "analysis/fixtures.py" in f.where and f.data["function"] == "bug"
    assert "seeded_fp32_matmul" in f.data["stack_functions"]


# ------------------------------------------------------- kernels as nodes


def test_every_kernel_is_one_node_forward_and_backward():
    """B1/B2 (HB), B5/B6 (masked) and B7/B8 (grouped) each appear as one
    node of the joint forward-backward graph, gradients included."""
    from paddle_tpu_torch.ops import _registry
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm

    def attn(q, k, v, seg):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o = fa.flash_attention(*leaves, causal=True)
            o2 = fa.flash_attention(*leaves, causal=True, q_segment_ids=seg,
                                    kv_segment_ids=seg)
            return torch.autograd.grad((o.float() + o2.float()).sum(),
                                       leaves)

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 4, 16, generator=g)
    k = torch.randn(1, 16, 2, 16, generator=g)
    seg = torch.ones(1, 16, dtype=torch.int32)
    cap = A.capture(attn, (q, k, k, seg), device="cpu")

    def moe(x, w, starts, lens, wids):
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        with torch.enable_grad():
            y = gm.grouped_matmul(xl, wl, starts, lens, wids, 8)
            return torch.autograd.grad(y.sum(), [xl, wl])

    x = torch.randn(16, 8, generator=g)
    w = torch.randn(2, 8, 8, generator=g)
    starts = torch.tensor([0, 8], dtype=torch.int32)
    lens = torch.tensor([8, 8], dtype=torch.int32)
    cap2 = A.capture(moe, (x, w, starts, lens, lens.new_tensor([0, 1])),
                     device="cpu")
    seen = sorted(_registry.kernel_op(n.target)
                  for c in (cap, cap2) for n in c.gm.graph.nodes
                  if _registry.kernel_op(n.target))
    assert seen == ["grouped_matmul", "grouped_matmul", "grouped_outer",
                    "hb_flash_bwd", "hb_flash_fwd", "masked_flash_bwd",
                    "masked_flash_fwd"]


def test_registry_covers_b1_to_b8():
    from paddle_tpu_torch.ops import (_registry, decode_attention,  # noqa
                                      flash_attention, grouped_matmul)

    assert sorted(set(_registry.KERNELS.values())) == [
        "B1", "B2", "B3", "B3'", "B4", "B5", "B6", "B7", "B8"]


def test_ops_equal_their_plain_twins_on_the_cpu():
    """On a CPU tensor each operator is its plain twin, bit for bit."""
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, 4, 16, generator=g)
    kc = torch.randn(3, 2, 32, 16, generator=g)
    lens = torch.tensor([0, 5, 32], dtype=torch.int32)
    assert torch.equal(da.flash_decode(q, kc, kc, lens),
                       da.flash_decode_plain(q, kc, kc, lens))
    qh = torch.randn(2, 2, 16, 16, generator=g)
    kh = torch.randn(2, 16, 16, generator=g)
    for got, want in zip(fa.hb_flash_forward(qh, kh, kh),
                         fa.hb_flash_forward_plain(qh, kh, kh, True,
                                                   0.25)):
        assert torch.equal(got, want)


# ------------------------------------------------------ parity with JAX


def test_don001_bytes_and_leaves_equal_jax():
    from paddle_tpu.analysis.fixtures import SEEDED as JSEEDED

    def rows(rep):
        return sorted((f.arg_path, f.data["bytes"], f.data["leaves"])
                      for f in rep.by_code("DON001"))

    got, want = rows(SEEDED["DON001"]()), rows(JSEEDED["DON001"]())
    assert got == want == [("arg0", 768 * 768 * 4, 1),
                           ("arg1", 768 * 768 * 4, 1)]


def test_retrace_sentinel_equals_jax():
    import jax
    import jax.numpy as jnp

    from paddle_tpu.analysis import retrace_sentinel as jsentinel

    jstep = jsentinel(jax.jit(lambda x, lr: x * lr), max_signatures=3)
    tstep = A.retrace_sentinel(lambda x, lr: x * lr, max_signatures=3)
    for n, lr in ((4, 0.1), (4, "strong"), (4, 0.1), (5, 0.1), (6, 1),
                  (7, 0.5), (4, "strong")):
        jstep(jnp.ones((n,), jnp.float32),
              jnp.float32(0.1) if lr == "strong" else lr)
        tstep(torch.ones(n), torch.tensor(0.1) if lr == "strong" else lr)
    jrep, trep = jstep.report(), tstep.report()
    assert trep.codes() == jrep.codes() == ["RT001", "RT002"]
    assert sorted(tstep.signatures.values()) == \
        sorted(jstep.signatures.values())
    assert [f.data["leaves"] for f in trep.by_code("RT001")] == \
        [f.data["leaves"] for f in jrep.by_code("RT001")]
