"""The seeded fixtures of the port's analysis passes: a minimal program
per finding code that must fire exactly that code (the true-positive half
of every pass's gate).

Port of ``paddle_tpu/analysis/fixtures.py``.  The graph half builds a tiny
program seeded with one bug of the class its pass hunts and runs the pass
alone with ``exemptions=()``, so the standing table cannot mask a
regression in the pass itself: DT001-003, DON001-002, RT001-002, MEM001
(and its four entry-point variants: the serving prefill chunk, the reshard
plan, the fleet's delivery, the KV handoff), MEM002, HEALTH001-002.  Every
graph fixture captures on ``device`` (the CPU by default: the self-check
runs at debug shapes).  The RACE part runs the lock-discipline pass over
the same source strings as JAX's.  ``SEEDED`` maps a code (``CODE`` or
``CODE[variant]``) to its fixture; reports are memoized per process, as
JAX's are.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import capture, check, static_peak
from .findings import Report
from .passes.retrace import retrace_sentinel


def _gen(seed: int = 20260803) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- dtype


def seeded_fp32_matmul(device="cpu") -> Report:
    """DT001: a bf16 program whose second matmul silently upcasts."""

    def bug(a, b):
        h = a @ b                                      # bf16: declares it
        return (h.float() @ b.float()).sum()           # the silent upcast

    a = torch.ones((128, 128), dtype=torch.bfloat16, device=device)
    return check(bug, a, a, passes=["dtype_promotion"], exemptions=(),
                 target="seeded:DT001", device=device)


def seeded_f64_leak(device="cpu") -> Report:
    """DT002: a float64 input drags float64 through the program."""

    def bug(a):
        return (a * 2.0).sum()

    a = torch.ones((64, 64), dtype=torch.float64, device=device)
    return check(bug, a, passes=["dtype_promotion"], exemptions=(),
                 target="seeded:DT002", device=device)


def seeded_fp32_carry(device="cpu") -> Report:
    """DT003: a bf16 micro-step loop accumulating into a full-width fp32
    buffer in place, every micro-step (the traffic the bf16 carry with
    fp32 folds removes)."""

    def bug(w, xs):
        acc = torch.zeros((128, 128), dtype=torch.float32, device=w.device)
        for x in xs:
            acc += (x @ w).float()                     # fp32 accumulate
        return acc

    w = torch.ones((128, 128), dtype=torch.bfloat16, device=device)
    xs = torch.ones((4, 128, 128), dtype=torch.bfloat16, device=device)
    return check(bug, w, xs, passes=["dtype_promotion"], exemptions=(),
                 target="seeded:DT003", device=device)


# ------------------------------------------------------------- donation


def seeded_undonated_state(device="cpu") -> Report:
    """DON001: a functional update of a param-sized dict: the caller keeps
    the old params (and the grads) while the new ones are built."""

    def bug(params, grads):
        return {k: v - 1e-3 * grads[k] for k, v in params.items()}

    params = {"w": torch.ones((768, 768), device=device)}
    grads = {"w": torch.ones((768, 768), device=device)}
    return check(bug, params, grads, passes=["donation"], exemptions=(),
                 target="seeded:DON001", device=device)


def seeded_use_after_donate(device="cpu") -> Report:
    """DON002: one storage passed in two positions, written in place
    through one of them."""

    def bug(a, b):
        a.mul_(2.0)
        return a + b

    x = torch.ones((128, 128), device=device)     # small: below DON001's
    return check(bug, x, x, passes=["donation"], exemptions=(),
                 target="seeded:DON002", device=device)


# --------------------------------------------------------------- retrace


def seeded_weak_type_churn(device="cpu") -> Report:
    """RT001: a Python float lr alternating with a 0-dim tensor."""
    step = retrace_sentinel(lambda x, lr: x * lr, name="seeded:RT001")
    x = torch.ones(8, device=device)
    step(x, 0.1)                                   # weak scalar
    step(x, torch.tensor(0.1, device=device))      # strong 0-dim tensor
    return step.report()


def seeded_signature_churn(device="cpu") -> Report:
    """RT002: unbucketed lengths, a fresh signature every call."""
    step = retrace_sentinel(lambda x: x.sum(), max_signatures=3,
                            name="seeded:RT002")
    for n in (1, 2, 3, 4):
        step(torch.ones(n, device=device))
    return step.report()


# --------------------------------------------------------- memory budget


def seeded_peak_over_budget(device="cpu") -> Report:
    """MEM001: a program whose static peak (its inputs alone, here) blows
    through a deliberately tiny declared budget."""

    def bug(a, b):
        return (a @ b).sum()

    a = torch.ones((512, 512), device=device)          # 1 MB per operand
    return check(bug, a, a, passes=["memory_budget"], exemptions=(),
                 target="seeded:MEM001", device=device,
                 options={"memory_budget": {"hbm_bytes": 64 << 10}})


def seeded_host_round_trip(device="cpu") -> Report:
    """MEM002: a whole buffer round-tripped device -> host -> device in
    one monolithic pair of copies against a streaming budget sized for
    half of it (the full-state movement the bucketed memory engine
    prevents).  The host buffer sits where the engine keeps its host
    state, under ``__offload__``."""

    def bug(a, state):
        host = state["__offload__"]["buf"]
        host.copy_(a)                                   # all out...
        back = torch.empty_like(a)
        back.copy_(host)                                # ...all back
        return back * 2.0

    a = torch.ones((512, 512), device=device)          # 1 MB each way
    state = {"__offload__": {"buf": torch.empty((512, 512))}}
    return check(bug, a, state, passes=["memory_budget"], exemptions=(),
                 target="seeded:MEM002", device=device,
                 options={"memory_budget": {"host_transfer_bytes": 1 << 20}})


def _flagship_model(device="cpu"):
    """The self-check's debug Llama (JAX's ``_flagship`` config), its fp32
    params from a fixed seed."""
    from ..models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.debug(vocab=128, hidden=64, layers=2, heads=4,
                            kv_heads=2, inter=128, max_pos=64)
    model = LlamaForCausalLM(cfg, device=device, dtype=torch.float32,
                             generator=_gen())
    return cfg, model


def seeded_prefill_chunk_over_budget(device="cpu") -> Report:
    """MEM001 on the serving entry: a unified ragged step whose prefill
    chunk (prefill_token_budget=48, 17 pages) blows through the budget
    declared for the decode-sized launch (``self_check.SERVING_HBM_BUDGET``
    fits the chunk-8 step): bumping the token budget must re-justify the
    declared budget, not grow the hot path silently."""
    from ..inference.serving import ContinuousBatchingEngine
    from .self_check import SERVING_HBM_BUDGET

    cfg, model = _flagship_model(device)
    eng = ContinuousBatchingEngine(cfg, model.functional_state(),
                                   max_slots=2, num_pages=17, page_size=16,
                                   max_seq_len=64, prefill_token_budget=48,
                                   device=device)
    fn, args, kwargs, _ = eng.analysis_entry()
    return check(fn, *args, kwargs=kwargs, passes=["memory_budget"],
                 exemptions=(), target="seeded:MEM001[prefill_chunk]",
                 device=device,
                 options={"memory_budget": {"hbm_bytes": SERVING_HBM_BUDGET}})


def seeded_reshard_over_budget(device="cpu") -> Report:
    """MEM001 on the reshard entry: an UNBOUNDED plan
    (``max_transient_bytes=None``: one step, whole leaves) moves a 1 MB
    host leaf through a redistribution entry whose declared transient
    budget is 64 KB (the overrun the size-capped planner prevents)."""
    from ..parallel.reshard import check_reshard_budget, plan_reshard
    from ..parallel.specs import Mesh, P

    mesh = Mesh((1,), ("x",), device_type=torch.device(device).type)
    tree = {"w": np.ones((512, 512), np.float32)}
    plan = plan_reshard(tree, mesh, {"w": P("x", None)},
                        max_transient_bytes=None)
    return check_reshard_budget(plan, tree, budget_bytes=64 << 10,
                                exemptions=(), device=device,
                                target="seeded:MEM001[reshard_plan]")


def seeded_replica_delivery_over_budget(device="cpu") -> Report:
    """MEM001 on the replica weight delivery: an UNBOUNDED delivery plan
    streams a 1 MB host weight tree against a 64 KB declared budget
    (``ReplicaSet.spawn`` streams through the size-capped cached plan;
    this proves the budget pin fires when the cap is bypassed)."""
    from ..inference.fleet import FleetConfig, ReplicaSet

    host = {"w": np.ones((512, 512), np.float32)}      # 1 MB, host-side
    rs = ReplicaSet(host, engine_factory=lambda p: None,
                    config=FleetConfig(max_transient_bytes=None),
                    device=device)
    return rs.check_delivery_budget(
        budget_bytes=64 << 10, exemptions=(),
        target="seeded:MEM001[replica_delivery]")


def seeded_kv_handoff_over_budget(device="cpu") -> Report:
    """MEM001 on the KV handoff: an UNBOUNDED handoff plan (the whole page
    tree in one step) streams a 256 KB fp32 page tree against a 64 KB
    declared budget."""
    from ..inference.disagg import KVHandoffPlanner

    # [L=2, npages=8, kvh=2, page=16, d=64] fp32 = 128 KB a pool side
    tree = {"k": np.ones((2, 8, 2, 16, 64), np.float32),
            "v": np.ones((2, 8, 2, 16, 64), np.float32)}
    planner = KVHandoffPlanner(max_transient_bytes=None, device=device)
    return planner.check_handoff_budget(
        tree, budget_bytes=64 << 10, exemptions=(),
        target="seeded:MEM001[kv_handoff]")


# ----------------------------------------------------------- health probe


def seeded_unfused_health_probe(device="cpu") -> Report:
    """HEALTH001: a "probe" whose output carries tree-sized buffers (a
    finite mask per leaf beside the scalars: the host-style detector
    ported naively), against the unprobed step's static peak plus a small
    overhead."""
    params = {f"w{i}": torch.ones((128, 128), device=device)
              for i in range(8)}
    grads = {k: v * 1e-3 for k, v in params.items()}

    def base(params, grads):
        new = {k: v - 1e-3 * grads[k] for k, v in params.items()}
        return sum(g.sum() for g in grads.values()), new

    def bug(params, grads):
        new = {k: v - 1e-3 * grads[k] for k, v in params.items()}
        loss = sum(g.sum() for g in grads.values())
        probe = {
            "grad_norm": torch.sqrt(sum(g.square().sum()
                                        for g in grads.values())),
            # the seeded bug: the probe OUTPUT is a full tree of masks
            "finite_mask": {k: torch.isfinite(g) for k, g in grads.items()},
        }
        return loss, new, probe

    baseline = static_peak(capture(base, (params, grads),
                                   device=device))["peak_bytes"]
    return check(bug, params, grads, passes=["health_probe"], exemptions=(),
                 target="seeded:HEALTH001", device=device,
                 options={"health_probe":
                          {"baseline_peak_bytes": baseline,
                           "probe_overhead_bytes": 16 << 10}})


def seeded_collective_health_probe(device="cpu") -> Report:
    """HEALTH002: a probe that all-reduces its grad norm inside an entry
    whose declared baseline carries no collective (on the one-device step
    any collective is the regression).  The capture records the
    ``c10d`` node on a process group of the ``fake`` backend (two ranks,
    in this process; nothing is sent), or on the live default group."""
    import torch.distributed as dist

    def bug(g):
        sq = (g * g).sum()
        dist.all_reduce(sq)                              # the bug
        return g * 2.0, torch.sqrt(sq)

    own = not dist.is_initialized()
    if own:
        # importing it registers the "fake" backend (collectives that
        # send nothing)
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=2)
    try:
        return check(bug, torch.ones((8, 8), device=device),
                     passes=["health_probe"], exemptions=(),
                     target="seeded:HEALTH002", device=device,
                     options={"health_probe": {"baseline_collectives": {}}})
    finally:
        if own:
            dist.destroy_process_group()


# ------------------------------------------------------ lock discipline


def _race_report(code: str, src: str) -> Report:
    import textwrap

    from .passes.lock_discipline import analyze_source

    rel = f"seeded/{code.lower()}.py"
    findings = analyze_source(textwrap.dedent(src), rel)
    return Report(target=f"seeded:{code}", findings=findings,
                  passes_run=("lock_discipline",))


def seeded_unguarded_write() -> Report:
    """RACE001: a counter bumped under its lock but reset lock-free —
    the reset can interleave between the bump's read and write."""
    return _race_report("RACE001", """
        import threading

        class Counter:
            def __init__(self):
                self._lock = threading.Lock()
                self.value = 0

            def bump(self):
                with self._lock:
                    self.value += 1

            def reset(self):
                self.value = 0
        """)


def seeded_lock_order_inversion() -> Report:
    """RACE002: one path nests send->recv, the other holds recv and
    reaches send THROUGH A HELPER CALL — the cross-method edge the
    analyzer must close over, and the classic two-thread deadlock."""
    return _race_report("RACE002", """
        import threading

        class Transfer:
            def __init__(self):
                self._send_lock = threading.Lock()
                self._recv_lock = threading.Lock()
                self.sent = 0
                self.received = 0

            def one(self):
                with self._send_lock:
                    with self._recv_lock:
                        self.sent += 1
                        self.received += 1

            def _locked_step(self):
                with self._send_lock:
                    self.sent += 1

            def other(self):
                with self._recv_lock:
                    self._locked_step()
                    self.received += 1
        """)


def seeded_blocking_under_lock() -> Report:
    """RACE003: a sleep inside the critical section — every other
    tick blocks on the lock for the full sleep (the serving-tick
    latency/deadlock hazard class: a kernel build, collective, recv,
    fsync under a lock)."""
    return _race_report("RACE003", """
        import threading
        import time

        class Poller:
            def __init__(self):
                self._lock = threading.Lock()
                self.last = None

            def poll(self):
                with self._lock:
                    time.sleep(0.05)
                    self.last = 1
        """)


def seeded_check_then_act() -> Report:
    """RACE004: the PRE-FIX watchdog handler/flag race, minimized —
    ``complete`` checks ``task.timed_out`` OUTSIDE the lock, then
    acquires it to act, while the scanner flags ``timed_out`` under
    the same lock: the flag can flip between check and act, yielding
    a task both completed and flagged hung (the bug the watchdog fixed;
    the pass must catch the bug we actually shipped)."""
    return _race_report("RACE004", """
        import threading

        class Manager:
            def __init__(self):
                self._lock = threading.Lock()
                self.tasks = {}

            def complete(self, task):
                if task.timed_out:          # check OUTSIDE the lock
                    return
                with self._lock:            # act UNDER it
                    task.done = True
                    self.tasks.pop(task.seq, None)

            def _scan(self):
                with self._lock:
                    for t in list(self.tasks.values()):
                        t.timed_out = True
        """)


GRAPH_SEEDED = {
    "DT001": seeded_fp32_matmul,
    "DT002": seeded_f64_leak,
    "DT003": seeded_fp32_carry,
    "DON001": seeded_undonated_state,
    "DON002": seeded_use_after_donate,
    "RT001": seeded_weak_type_churn,
    "RT002": seeded_signature_churn,
    "HEALTH001": seeded_unfused_health_probe,
    "HEALTH002": seeded_collective_health_probe,
    "MEM001": seeded_peak_over_budget,
    # registry keys carry a [variant] suffix: the report holds the BARE code
    "MEM001[prefill_chunk]": seeded_prefill_chunk_over_budget,
    "MEM001[reshard_plan]": seeded_reshard_over_budget,
    "MEM001[replica_delivery]": seeded_replica_delivery_over_budget,
    "MEM001[kv_handoff]": seeded_kv_handoff_over_budget,
    "MEM002": seeded_host_round_trip,
}

RACE_SEEDED = {
    "RACE001": seeded_unguarded_write,
    "RACE002": seeded_lock_order_inversion,
    "RACE003": seeded_blocking_under_lock,
    # the minimized pre-fix watchdog race
    "RACE004": seeded_check_then_act,
}

# Every graph fixture captures a small program, and one test process
# reaches the registry from several consumers (the parametrised fixture
# test, the self-check, the budget tests): reports are read-only and the
# programs deterministic, so each is paid once per (code, device).
_REPORT_MEMO: dict = {}


def _memoized_fixture(code, fn):
    def run(device="cpu") -> Report:
        key = (code, str(torch.device(device)))
        rep = _REPORT_MEMO.get(key)
        if rep is None:
            rep = fn(device) if code in GRAPH_SEEDED else fn()
            _REPORT_MEMO[key] = rep
        return rep

    run.__name__ = fn.__name__
    run.__doc__ = fn.__doc__
    run.__wrapped__ = fn
    return run


SEEDED = {code: _memoized_fixture(code, fn)
          for code, fn in {**GRAPH_SEEDED, **RACE_SEEDED}.items()}

__all__ = ["GRAPH_SEEDED", "RACE_SEEDED", "SEEDED"] + sorted(
    fn.__name__ for fn in {**GRAPH_SEEDED, **RACE_SEEDED}.values())
