"""The resilient train loop of the port (paddle_tpu_torch/distributed/
resilience.py) against the JAX package's ``resilient_train_loop`` on the
CPU, through the fault harnesses (tests/torch_fault_injection.py and
tests/fault_injection.py, JAX's cluster cut to the one device of the
port's one process).

- Every scenario of tests/test_resilience.py's one-process legs: kill,
  kill before the first checkpoint, preemption, hang (a stall of 6 s
  against a 1 s step timeout: 6x, so that the watchdog's 0.1 s scan
  flags it whatever the load, and JAX's first step, which compiles
  inside the watch window, stays under the timeout), slow step,
  rendezvous retry and exhaustion, restart budget, corrupt latest
  checkpoint, all checkpoints corrupt: the ``RecoveryEvent`` fields
  equal JAX's exactly, every loss
  within 1e-6 relative of JAX's (the same fp32 math, rounded in another
  order), and the resumed runs equal to the uninterrupted port run bit for
  bit.
- Scale down and up in the ``resil4`` gloo gang of 4 ranks
  (``resilience_gang_rank``): 4 -> 2 ranks by preemption (the live
  reshard over the old group, a new process group, ranks 2 and 3 parked),
  a kill on 2 ranks restored from the 4-rank checkpoint (reshard-on-load),
  back to 4 by preemption (the parked ranks rejoin and restore): the
  events equal JAX's for the same script on 4 of its devices, losses
  within 1e-6 relative, the final params within 1e-6.
"""

import glob
import json
import os
import random
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_fault_injection as T  # noqa: E402
from paddle_tpu_torch.distributed.resilience import (  # noqa: E402
    ResilienceConfig, ResilienceExhausted, backoff_delay)
from torch_gang import run_gang  # noqa: E402

LOSS_TOL = 1e-6


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _jax_run(tmp, n, faults=(), **kw):
    import jax

    import fault_injection as J

    kw.setdefault("device_count", 1)
    assert len(jax.devices()) >= kw["device_count"]
    return J.run_toy_loop(str(tmp), n, faults=[
        J.FaultEvent(step=f.step, kind=f.kind, device_count=f.device_count,
                     stall_s=f.stall_s) for f in faults], **kw)


def _same(tres, jres):
    assert [e.__dict__ for e in tres.recoveries] == \
        [e.__dict__ for e in jres.recoveries]
    assert sorted(tres.losses) == sorted(jres.losses)
    for s, want in jres.losses.items():
        assert _rel(tres.losses[s], want) <= LOSS_TOL, s
    assert tres.final_step == jres.final_step
    assert tres.steps_run == jres.steps_run


@pytest.fixture(scope="module")
def ref12(tmp_path_factory):
    """The uninterrupted 12-step port run."""
    res, _ = T.run_toy_loop(str(tmp_path_factory.mktemp("ref")), 12)
    assert res.final_step == 12 and not res.recoveries
    return res


SCENARIOS = {
    "kill": dict(n=12, faults=[T.FaultEvent(step=6, kind="kill")]),
    "kill_before_first_checkpoint": dict(
        n=8, faults=[T.FaultEvent(step=2, kind="kill")]),
    "preempt": dict(n=12, faults=[T.FaultEvent(step=7, kind="preempt")]),
    "hang": dict(n=8, faults=[T.FaultEvent(step=5, kind="hang",
                                           stall_s=6.0)],
                 kw=dict(step_timeout_s=1.0)),
    "slow": dict(n=8, faults=[T.FaultEvent(step=5, kind="slow",
                                           stall_s=0.02)],
                 kw=dict(step_timeout_s=10.0)),
    "restart_budget": dict(n=10, faults=[T.FaultEvent(step=s, kind="kill")
                                         for s in (2, 3, 4)],
                           kw=dict(max_restarts=3)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_jax(name, tmp_path, ref12):
    sc = SCENARIOS[name]
    kw = sc.get("kw", {})
    tres, tcl = T.run_toy_loop(str(tmp_path / "t"), sc["n"],
                               faults=list(sc["faults"]), **kw)
    jres, jcl = _jax_run(tmp_path / "j", sc["n"], sc["faults"], **kw)
    _same(tres, jres)
    assert [e.kind for e in tcl.fired] == [e.kind for e in jcl.fired]
    # a correct resume replays the uninterrupted trajectory exactly
    for s, loss in tres.losses.items():
        assert loss == ref12.losses[s], (name, s)


def test_rendezvous_retries_with_backoff_like_jax(tmp_path):
    tslept, jslept = [], []
    tres, tcl = T.run_toy_loop(str(tmp_path / "t"), 8,
                               faults=[T.FaultEvent(step=3, kind="kill")],
                               rendezvous_failures=3, sleep=tslept.append)
    jres, jcl = _jax_run(tmp_path / "j", 8,
                         [T.FaultEvent(step=3, kind="kill")],
                         rendezvous_failures=3, sleep=jslept.append)
    _same(tres, jres)
    assert tres.recoveries[0].rendezvous_attempts == 4
    assert tcl.rendezvous_log == jcl.rendezvous_log
    assert tslept == jslept          # the same seeded jitter
    raw = [0.01 * 2 ** i for i in range(3)]
    for got, base in zip(tslept, raw):
        assert 0.6 * base <= got <= 1.5 * base


@pytest.mark.parametrize("case", ["rendezvous", "restart"])
def test_budgets_exhaust_like_jax(case, tmp_path):
    import paddle_tpu.distributed.resilience as jres_mod

    if case == "rendezvous":
        kw = dict(faults=[T.FaultEvent(step=3, kind="kill")],
                  rendezvous_failures=99, sleep=lambda s: None)
        match = "re-rendezvous"
    else:
        kw = dict(faults=[T.FaultEvent(step=s, kind="kill")
                          for s in (2, 3, 4)], max_restarts=2)
        match = "restart budget"
    with pytest.raises(ResilienceExhausted, match=match):
        T.run_toy_loop(str(tmp_path / "t"), 8, **kw)
    with pytest.raises(jres_mod.ResilienceExhausted, match=match):
        _jax_run(tmp_path / "j", 8, kw.pop("faults"), **kw)


def test_backoff_delay_matches_jax():
    import paddle_tpu.distributed.resilience as jr

    for jitter in (0.25, 0.0):
        cfg = ResilienceConfig(checkpoint_dir="/unused", backoff_base_s=0.1,
                               backoff_max_s=0.5, backoff_jitter=jitter)
        jcfg = jr.ResilienceConfig(checkpoint_dir="/unused",
                                   backoff_base_s=0.1, backoff_max_s=0.5,
                                   backoff_jitter=jitter)
        a, b = random.Random(0), random.Random(0)
        got = [backoff_delay(cfg, i, a) for i in range(8)]
        assert got == [jr.backoff_delay(jcfg, i, b) for i in range(8)]
        assert all(d <= 0.5 * 1.25 + 1e-9 for d in got)
    assert got[:4] == [0.1, 0.2, 0.4, 0.5]


def _corrupt_checkpoint(root, step):
    files = sorted(glob.glob(os.path.join(root, f"step_{step:08d}",
                                          "state", "*")))
    assert files
    with open(files[0], "r+b") as f:
        f.seek(16)
        f.write(b"\xff" * 64)


@pytest.mark.parametrize("case", ["latest", "all"])
def test_corrupt_checkpoints_degrade_like_jax(case, tmp_path):
    n = 12 if case == "latest" else 8
    steps = (12,) if case == "latest" else (4, 8)
    out = {}
    for side in ("t", "j"):
        d = tmp_path / side
        run = T.run_toy_loop if side == "t" else _jax_run
        first, _ = run(d if side == "j" else str(d), n)
        if side == "t":
            for s in steps:
                _corrupt_checkpoint(str(d), s)
        else:
            import test_resilience as JT

            for s in steps:
                JT._corrupt_checkpoint(str(d), s)
        again = n + 2 if case == "latest" else n
        out[side] = (first, run(d if side == "j" else str(d), again)[0])
    (tf, tr), (jf, jr) = out["t"], out["j"]
    _same(tr, jr)
    if case == "latest":
        assert sorted(tr.losses) == list(range(8, 14))
        for s in range(8, 12):
            assert tr.losses[s] == tf.losses[s]
    else:
        assert sorted(tr.losses) == list(range(8))
        assert tr.losses[0] == tf.losses[0]


# ---------------------------------------------------------------------------
# the resil4 gang: scale down, kill, scale up
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resil4(tmp_path_factory):
    root = run_gang("resil4", T.resilience_gang_rank, 4, tmp_path_factory)
    return [json.loads((root / f"res.{r}.json").read_text())
            for r in range(4)]


def test_gang_scale_down_and_up_matches_jax(resil4, tmp_path):
    faults = [T.FaultEvent(step=s, kind=k, device_count=n)
              for k, s, n in T.GANG_FAULTS]
    jres, _ = _jax_run(tmp_path, T.GANG_STEPS, faults, device_count=4)
    r0 = resil4[0]
    assert not r0["parked"] and r0["final_step"] == T.GANG_STEPS
    assert r0["recoveries"] == [e.__dict__ for e in jres.recoveries]
    got = {int(k): v for k, v in r0["losses"].items()}
    assert sorted(got) == sorted(jres.losses)
    for s, want in jres.losses.items():
        assert _rel(got[s], want) <= LOSS_TOL, s
    np.testing.assert_allclose(np.asarray(r0["w"], np.float32),
                               np.asarray(jres.state["w"]), rtol=0,
                               atol=LOSS_TOL)
    # every rank ends in the grown world with the same params
    for r in resil4[1:]:
        assert not r["parked"] and r["w"] == r0["w"]
    ev = {e["fault"]: e for e in r0["recoveries"]}
    assert ev["WorkerLost"]["resume_step"] == 5         # the 4-rank ckpt
    assert [e["device_count"] for e in r0["recoveries"]] == [2, 2, 4]
