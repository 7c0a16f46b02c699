"""The training health guardian of the port (paddle_tpu_torch/distributed/
health.py: the fused probe, the in-step guard, the response ladder, the
spot checker) against the JAX package's ``distributed/health.py`` on the
CPU.

- The probe: ``make_probe`` on the same gradients and params (fp32 and
  bf16 leaves, clean and poisoned): ``grad_norm``, ``update_ratio`` and
  ``loss`` within 1e-5 relative of JAX's (both reduce in fp32, in another
  order), ``nonfinite`` and ``ok`` exact.
- The monitor: ``HealthMonitor`` fed the same probe stream gives the same
  verdicts, gates and events, exactly (host float math on equal inputs).
- The toy health loop (``tests/torch_fault_injection.py`` against
  ``tests/fault_injection.py``, JAX's cluster cut to the one device the
  port's one process has): stage counts, quarantine records (rule,
  response, offsets), event kinds and recovery events equal; probe values
  within 1e-5 relative; losses within 1e-6 relative, the final params
  within 1e-6 (absolute, on values of order 1: the two sides round the
  momentum update in another order, an ulp a step).
- ``build_train_step(health=)`` and ``build_hybrid_train_step(health=)``:
  loss and params bit-equal to the unprobed step; a NaN param makes the
  probe fire and the step a bit-exact no-op (tests/test_health.py:87-165,
  436); the Llama probe within 1e-5 of JAX's on the same weights.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import fault_injection as J  # noqa: E402
import torch_fault_injection as T  # noqa: E402
from paddle_tpu.distributed import health as jh  # noqa: E402
from paddle_tpu_torch.distributed import health as th  # noqa: E402

TOL = 1e-5         # probe scalars, fp32 reductions in another order
LOSS_TOL = 1e-6    # the toy loops' losses and states


def _rel(a, b):
    if a == b or (np.isnan(a) and np.isnan(b)):
        return 0.0
    return abs(a - b) / max(abs(b), 1e-30)


def _check_probe(tp, jp):
    ts, js = th.summarize_probe(tp), jh.summarize_probe(jp)
    assert ts["nonfinite"] == js["nonfinite"]
    assert ts["ok"] == js["ok"]
    for k in ("loss", "grad_norm", "update_ratio"):
        assert _rel(ts[k], js[k]) <= TOL, (k, ts[k], js[k])


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

PROBE_CASES = ["clean", "nan", "inf", "tight_gates", "loss_gate"]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_matches_jax(case):
    rng = np.random.default_rng(PROBE_CASES.index(case))
    shapes = {"a": (16, 8), "b": (32,), "c": (4, 4, 4), "d": (8, 8)}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    new = {k: v - 1e-2 * grads[k] for k, v in params.items()}
    if case == "nan":
        grads["b"][3] = np.nan
        grads["c"][0, 1, 2] = np.nan
    if case == "inf":
        grads["d"][1, 1] = np.inf
    gates = None
    if case == "tight_gates":
        gates = np.zeros(3, np.float32)
    if case == "loss_gate":
        gates = np.array([1.0, np.inf, np.inf], np.float32)
    bf = {"d"}             # one bf16 leaf: the reduction's own fp32 dtype

    def port(x, k):
        t = torch.from_numpy(x.copy())
        return t.to(torch.bfloat16) if k in bf else t

    def jx(x, k):
        return jnp.asarray(x, jnp.bfloat16 if k in bf else jnp.float32)

    tp = th.make_probe(torch.tensor(2.5), {k: port(v, k)
                                           for k, v in grads.items()},
                       {k: port(v, k) for k, v in params.items()},
                       {k: port(v, k) for k, v in new.items()}, gates,
                       buckets=3)
    jp = jh.make_probe(jnp.float32(2.5), {k: jx(v, k)
                                          for k, v in grads.items()},
                       {k: jx(v, k) for k, v in params.items()},
                       {k: jx(v, k) for k, v in new.items()}, gates,
                       buckets=3)
    _check_probe(tp, jp)


def test_guard_picks_old_tree_by_reference():
    """A fired gate hands back the old objects (no copy); a passed one the
    new."""
    old, new = {"w": torch.ones(3)}, {"w": torch.zeros(3)}
    assert th.guard_tree(False, new, old) is old
    assert th.guard_tree(True, new, old) is new
    assert th.guard_tree(torch.tensor(False), new, old) is old


# ---------------------------------------------------------------------------
# the monitor on one probe stream
# ---------------------------------------------------------------------------


def _probe_stream(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        loss = 2.0 - 0.01 * t + 0.01 * rng.standard_normal()
        gn = 1.0 + 0.05 * rng.standard_normal()
        nf = [0, 0, 0, 0]
        if t in (9, 10, 11, 25):
            loss *= 50.0
        if t == 17:
            nf[2] = 3
            gn = float("nan")
        if t == 30:
            gn *= 40.0
        out.append({"loss": float(loss), "grad_norm": float(gn),
                    "update_ratio": 1e-3, "nonfinite": nf})
    return out


@pytest.mark.parametrize("cfg_kw", [dict(warmup_steps=3),
                                    dict(warmup_steps=3, max_rollbacks=5,
                                         escalation_window=5),
                                    dict(warmup_steps=2, lr_backoff=0.5,
                                         update_ratio_max=1.0)])
def test_monitor_matches_jax_on_probe_stream(cfg_kw):
    tm = th.HealthMonitor(th.HealthConfig(**cfg_kw))
    jm = jh.HealthMonitor(jh.HealthConfig(**cfg_kw))
    for t, p in enumerate(_probe_stream()):
        tg, jg = tm.gates(t), jm.gates(t)
        np.testing.assert_array_equal(tg, jg)
        assert tm.lr_scale(t) == jm.lr_scale(t)
        ok = bool(sum(p["nonfinite"]) == 0 and np.isfinite(p["loss"])
                  and np.float32(p["loss"]) <= tg[0]
                  and np.isfinite(p["grad_norm"])
                  and np.float32(p["grad_norm"]) <= tg[1]
                  and np.float32(p["update_ratio"]) <= tg[2])
        probe = dict(p, ok=ok)
        try:
            tv = tm.observe(t, probe)
        except th.HealthExhausted:
            with pytest.raises(jh.HealthExhausted):
                jm.observe(t, probe)
            break
        assert tv == jm.observe(t, probe)
    tr, jr = tm.report(), jm.report()
    assert tr == jr


# ---------------------------------------------------------------------------
# the toy health loop against JAX's
# ---------------------------------------------------------------------------


HEALTH_LOOPS = {
    "nan": dict(num_steps=12, nf=[("nan", 5)]),
    "inf": dict(num_steps=10, nf=[("inf", 6)]),
    "spike_ladder": dict(num_steps=14, nf=[("spike", 5), ("spike", 6),
                                           ("spike", 7)]),
    "skip_on_boundary": dict(num_steps=16, nf=[("nan", 7), ("spike", 11),
                                               ("spike", 12),
                                               ("spike", 13)]),
    "isolated_spikes": dict(num_steps=16, nf=[("spike", 6),
                                              ("spike", 12)]),
    "backoff_lr": dict(num_steps=12, nf=[("spike", 6), ("spike", 7)],
                       health=dict(warmup_steps=3, lr_backoff=0.5,
                                   lr_backoff_steps=2)),
    "rollback_budget": dict(num_steps=14, nf=[("spike", 6), ("spike", 7),
                                              ("spike", 8)],
                            health=dict(warmup_steps=3, max_rollbacks=0)),
    "sdc": dict(num_steps=14, nf=[], sdc=8,
                health=dict(warmup_steps=3, spot_check_every=4,
                            spot_check_slices=2)),
}


def _run_pair(name, tmp_path, monkeypatch):
    case = HEALTH_LOOPS[name]
    tnf = [T.NumericFaultEvent(offset=o, kind=k) for k, o in case["nf"]]
    jnf = [J.NumericFaultEvent(offset=o, kind=k) for k, o in case["nf"]]
    tfa = [T.FaultEvent(step=case["sdc"], kind="sdc")] \
        if "sdc" in case else []
    jfa = [J.FaultEvent(step=case["sdc"], kind="sdc")] \
        if "sdc" in case else []
    hkw = case.get("health", dict(warmup_steps=3))
    # the JAX harness's cluster on the one device the port's process has
    monkeypatch.setattr(J.FakeCluster, "devices",
                        lambda self: list(jax.devices())[:1])
    out = []
    for mod, hmod, nf, fa, sub in ((T, th, tnf, tfa, "t"),
                                   (J, jh, jnf, jfa, "j")):
        try:
            out.append(mod.run_toy_health_loop(
                str(tmp_path / sub), case["num_steps"], numeric_faults=nf,
                faults=fa, health=hmod.HealthConfig(**hkw)))
        except hmod.HealthExhausted as e:
            out.append(e)
    return out


@pytest.mark.parametrize("name", list(HEALTH_LOOPS))
def test_toy_health_loop_matches_jax(name, tmp_path, monkeypatch):
    (tres, tcl), (jres, jcl) = [o if isinstance(o, tuple) else (o, None)
                                for o in _run_pair(name, tmp_path,
                                                   monkeypatch)]
    if isinstance(jres, Exception):
        assert isinstance(tres, th.HealthExhausted), tres
        return
    assert not isinstance(tres, Exception), tres
    assert tres.final_step == jres.final_step
    assert tres.steps_run == jres.steps_run
    assert [e.__dict__ for e in tres.recoveries] == \
        [e.__dict__ for e in jres.recoveries]
    assert sorted(tres.losses) == sorted(jres.losses)
    for s, want in jres.losses.items():
        assert _rel(tres.losses[s], want) <= LOSS_TOL, s
    th_, jh_ = tres.health, jres.health
    for k in ("stage_counts", "rollbacks", "level",
              "detection_latency_steps"):
        assert th_[k] == jh_[k], k
    assert [(e["step"], e["kind"], e.get("rule")) for e in th_["events"]] \
        == [(e["step"], e["kind"], e.get("rule")) for e in jh_["events"]]
    assert len(th_["quarantined"]) == len(jh_["quarantined"])
    for a, b in zip(th_["quarantined"], jh_["quarantined"]):
        for k in ("step", "data_offset", "rule", "response"):
            assert a[k] == b[k], k
        for k in ("loss", "grad_norm", "update_ratio"):
            assert _rel(a["probe"][k], b["probe"][k]) <= TOL, k
        assert a["probe"]["nonfinite_total"] == \
            b["probe"]["nonfinite_total"]
    w = tres.state["w"]
    np.testing.assert_allclose(w.numpy(), np.asarray(jres.state["w"]),
                               rtol=0, atol=LOSS_TOL)
    if "sdc" in HEALTH_LOOPS[name]:
        assert tcl.spot_check_log == jcl.spot_check_log


def test_nan_skip_is_bit_identical_to_the_clean_fold(tmp_path):
    """A NaN batch is skipped in step and the run ends bit-identical to a
    clean run that never saw it (tests/test_health.py's acceptance gate,
    on the port alone)."""
    res, _ = T.run_toy_health_loop(
        str(tmp_path), num_steps=12,
        numeric_faults=[T.NumericFaultEvent(offset=5, kind="nan")])
    mesh, specs = T.toy_mesh_builder([0])
    state = T.toy_init(mesh, specs)
    step = T.toy_step_builder(mesh, specs)
    for t in range(12):
        if t == 5:
            continue
        loss, state = step(state, T.toy_target(t))
        assert float(loss) == res.losses[t], t
    assert torch.equal(state["w"], res.state["w"])
    assert torch.equal(state["opt"]["m"], res.state["opt"]["m"])


def test_replay_quarantined_standalone(tmp_path):
    res, _ = T.run_toy_health_loop(
        str(tmp_path), num_steps=10,
        numeric_faults=[T.NumericFaultEvent(offset=5, kind="nan")])
    rec = th.QuarantineRecord(**res.health["quarantined"][0])
    mesh, specs = T.toy_mesh_builder([0])
    step_fn = T.toy_health_step_builder(mesh, specs)
    state = T.toy_init(mesh, specs)
    before = state["w"].clone()
    out = th.replay_quarantined(
        rec, step_fn, state,
        T.toy_numeric_data_fn([T.NumericFaultEvent(offset=5, kind="nan")]))
    assert out["replayed"]["nonfinite_total"] > 0
    assert not out["replayed"]["ok"]
    assert torch.equal(state["w"], before)


# ---------------------------------------------------------------------------
# SDC: the spot checker and the codec checksum on delivery
# ---------------------------------------------------------------------------


def test_spot_checker_matches_jax_and_catches_a_flip():
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8),
            "opt": {"m": np.ones((4, 4), np.float32)}, "lr": 0.05}
    ttree = {"w": torch.from_numpy(tree["w"].copy()),
             "opt": {"m": torch.from_numpy(tree["opt"]["m"].copy())},
             "lr": 0.05}
    for slices in (1, 2):
        tspot = th.ParamSpotChecker(every=1, slices=slices)
        jspot = jh.ParamSpotChecker(every=1, slices=slices)
        for step in range(1, 5):
            a, b = tspot.check(ttree, step), jspot.check(tree, step)
            assert (a.crc, a.paths, a.slice_index) == \
                (b.crc, b.paths, b.slice_index)
    spot = th.ParamSpotChecker(every=1, slices=2)
    other = {"w": ttree["w"].clone(),
             "opt": {"m": ttree["opt"]["m"].clone()}, "lr": 0.05}
    other["opt"]["m"][0, 0] = 1.0000001
    caught = 0
    for step in range(1, 5):
        a, b = spot.check(ttree, step), spot.check(other, step)
        if a.crc != b.crc:
            with pytest.raises(th.SDCError):
                spot.compare(a, b.crc)
            caught += 1
    assert caught >= 1


def test_codec_checksum_catches_bit_flip_on_delivery():
    """A flipped coded payload raises ChecksumError at decode on the
    host-mediated delivery (``reshard.execute_encoded``)."""
    from paddle_tpu_torch.parallel.codec import (ChecksumError,
                                                 CollectiveCodec)
    from paddle_tpu_torch.parallel.reshard import (execute_encoded,
                                                   plan_reshard)
    from paddle_tpu_torch.parallel.specs import Mesh

    mesh = Mesh((1,), ("r",), device_type="cpu")
    host = {"w": np.random.RandomState(0).randn(64, 32).astype(np.float32)}
    plan = plan_reshard(host, mesh, None)
    codec = CollectiveCodec(block=64, weight_profile="int8", checksum=True)
    out = execute_encoded(plan, host, codec)
    assert (out["w"].numpy() - host["w"]).__abs__().max() < 0.2
    with pytest.raises(ChecksumError):
        execute_encoded(plan, host, codec,
                        corrupt=lambda p, path, ci: T.flip_bit(p, 17))


# ---------------------------------------------------------------------------
# the Llama steps
# ---------------------------------------------------------------------------

CFG = dict(vocab=64, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           max_pos=32)


def _llama_pair():
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JC
    from paddle_tpu.models import LlamaForCausalLM as JM
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         params_from_jax)

    state = paddle.get_rng_state()
    paddle.seed(20260804)
    jm = JM(JC.debug(**CFG))
    paddle.set_rng_state(state)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    model = LlamaForCausalLM(LlamaConfig.debug(**CFG), device="cpu") \
        .load_functional_state(params_from_jax(jstate, "cpu"))
    return jm, jstate, model


def _deep(tree):
    return th._copy_tree(tree)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_health_parity_and_guard(accum):
    from paddle_tpu_torch.models import build_train_step, llama_decay_mask
    from paddle_tpu_torch.optimizer import AdamW

    _, _, model = _llama_pair()
    opt = AdamW(learning_rate=1e-3, multi_precision=True)
    params = model.functional_state()
    state = opt.init_flat_state(params, decay_mask=llama_decay_mask(model))
    rng = np.random.default_rng(0)
    shape = (accum, 2, 8) if accum > 1 else (2, 8)
    ids = rng.integers(0, 64, shape).astype(np.int32)
    labels = rng.integers(0, 64, shape).astype(np.int32)
    base = build_train_step(model, opt, compute_dtype=torch.float32,
                            accum_steps=accum)
    probed = build_train_step(model, opt, compute_dtype=torch.float32,
                              accum_steps=accum, health=th.HealthConfig())
    l0, p0, s0 = base(_deep(params), _deep(state), 0, 1e-3, ids, labels)
    l1, p1, s1, probe = probed(_deep(params), _deep(state), 0, 1e-3, ids,
                               labels)
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    for g, st in s0["__flat__"].items():
        assert all(torch.equal(t, s1["__flat__"][g][n])
                   for n, t in st.items())
    sp = th.summarize_probe(probe)
    assert sp["ok"] and sp["nonfinite_total"] == 0

    bad = _deep(params)
    bad["model.norm.weight"][0] = float("nan")
    bad_state = _deep(state)
    _, p2, s2, probe2 = probed(bad, bad_state, 0, 1e-3, ids, labels)
    sp = th.summarize_probe(probe2)
    assert sp["nonfinite_total"] > 0 and not sp["ok"]
    assert p2 is bad and s2 is bad_state        # the bit-exact no-op
    assert all(torch.equal(p2[k], params[k]) or k == "model.norm.weight"
               for k in params)


def test_train_step_probe_matches_jax():
    """The Llama probe (grad norm, update ratio, loss) of one fp32 step
    within 1e-5 of JAX's ``build_train_step(health=)``'s on the same
    weights and batch."""
    from paddle_tpu.models import build_train_step as jbuild
    from paddle_tpu.models import llama as jllama
    from paddle_tpu.optimizer.optimizer import AdamW as JAdamW
    from paddle_tpu_torch.models import build_train_step, opt_state_from_jax
    from paddle_tpu_torch.optimizer import AdamW

    jm, jstate, model = _llama_pair()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    labels = rng.integers(0, 64, (2, 8)).astype(np.int32)
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  multi_precision=True)
    jp = {k: jnp.asarray(v) for k, v in jstate.items()}
    jst = jopt.init_flat_state(jp, decay_mask=jllama.llama_decay_mask(jm))
    tst = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    jstep = jbuild(jm, jopt, compute_dtype=jnp.float32,
                   health=jh.HealthConfig())
    _, _, _, jprobe = jstep(jp, jst, 0, 1e-3, ids, labels)
    opt = AdamW(learning_rate=1e-3, multi_precision=True)
    step = build_train_step(model, opt, compute_dtype=torch.float32,
                            health=th.HealthConfig())
    _, _, _, tprobe = step(model.functional_state(), tst, 0, 1e-3, ids,
                           labels)
    _check_probe(tprobe, jprobe)


def test_hybrid_step_health_parity_and_guard():
    from paddle_tpu_torch.models import (build_hybrid_train_step,
                                         hybrid_mesh, init_hybrid_state)
    from paddle_tpu_torch.optimizer import AdamW

    _, _, model = _llama_pair()
    mesh = hybrid_mesh("cpu")
    opt = AdamW(learning_rate=1e-3)
    params = init_hybrid_state(model, mesh)
    state = opt.init_state({k: v.local for k, v in params.items()})
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (2, 8)).astype(np.int32)
    labels = rng.integers(0, 64, (2, 8)).astype(np.int32)
    base = build_hybrid_train_step(model.cfg, opt, mesh,
                                   compute_dtype=torch.float32)
    probed = build_hybrid_train_step(model.cfg, opt, mesh,
                                     compute_dtype=torch.float32,
                                     health=th.HealthConfig())
    l0, p0, _ = base(_deep(params), _deep(state), 0, 1e-3, ids, labels)
    l1, p1, _, probe = probed(_deep(params), _deep(state), 0, 1e-3, ids,
                              labels)
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[k].local, p1[k].local) for k in p0)
    assert th.summarize_probe(probe)["ok"]
    bad = _deep(params)
    bad["model.norm.weight"].local[0] = float("nan")
    bad_state = _deep(state)
    _, p2, s2, probe2 = probed(bad, bad_state, 0, 1e-3, ids, labels)
    assert not th.summarize_probe(probe2)["ok"]
    assert p2 is bad and s2 is bad_state


def test_health_option_types():
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_hybrid_train_step,
                                         build_train_step, hybrid_mesh)
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu")
    with pytest.raises(TypeError, match="health"):
        build_train_step(model, AdamW(1e-3), health=object())
    with pytest.raises(TypeError, match="health"):
        build_hybrid_train_step(LlamaConfig.debug(), AdamW(1e-3),
                                hybrid_mesh("cpu"), health=object())
