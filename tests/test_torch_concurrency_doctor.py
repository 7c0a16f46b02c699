"""The port's Concurrency Doctor (paddle_tpu_torch/analysis/) against the
JAX package's (paddle_tpu/analysis/concurrency.py, lock_sanitizer.py,
passes/lock_discipline.py) on the CPU.

- The same pass: over the JAX package's own control plane (its
  ``CONTROL_PLANE_MODULES``), over the port's, over the seeded RACE
  fixtures' sources and over the pre-fix watchdog, the port's
  lock-discipline pass gives JAX's findings, field for field.
- True positives: each seeded fixture fires exactly its code.
- The port's sweep: its control plane is clean under its allowlist, every
  allowlist entry is justified, an unjustified entry is rejected at load
  and a stale entry fails the sweep.
- The sanitizer: the monitor detects a scripted lock-order inversion and
  an unguarded field, the barrier-stepped scheduler replays a hammer
  exactly from its seed on the port's ``PageAllocator`` (with the
  acquisitions JAX's makes) and on a port ``FleetRouter``, and the
  genuinely threaded hammers pin the page pool's
  consistency and the watchdog's single-writer terminal transition.
"""

import os
import sys
import textwrap
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import paddle_tpu_torch.analysis.concurrency as TC  # noqa: E402
import paddle_tpu_torch.analysis.lock_sanitizer as TS  # noqa: E402
from paddle_tpu_torch.analysis.fixtures import SEEDED  # noqa: E402
from paddle_tpu_torch.analysis.passes.lock_discipline import (  # noqa: E402
    analyze_source, guarded_write_map)

RACE_CODES = ["RACE001", "RACE002", "RACE003", "RACE004"]

PRE_FIX_WATCHDOG = textwrap.dedent("""
    import threading

    class CommTaskManager:
        def __init__(self):
            self._tasks = {}
            self._lock = threading.Lock()
            self.timed_out = []

        def complete(self, task):
            with self._lock:
                if task.timed_out:
                    return
                task.done = True
                self._tasks.pop(task.seq, None)

        def _loop(self, now):
            expired = []
            with self._lock:
                for seq, t in list(self._tasks.items()):
                    if now - t.start_time > t.timeout_s:
                        t.timed_out = True
                        expired.append(t)
                        del self._tasks[seq]
            for t in expired:
                self.timed_out.append(t)
    """)


def _rows(findings):
    return [(f.code, f.severity, f.pass_name, f.where, f.message,
             f.data) for f in findings]


def _jax():
    import paddle_tpu.analysis.concurrency as JC
    import paddle_tpu.analysis.lock_sanitizer as JS
    from paddle_tpu.analysis.passes import lock_discipline as JL

    return JC, JS, JL


# ---------------------------------------------------------------------------
# the same pass, the same findings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_pass_matches_jax_on_the_control_planes(tree):
    """JAX's and the port's passes over one control plane (each package's
    module list under its own root) find the same, field for field."""
    JC, _, JL = _jax()
    root = os.path.dirname(os.path.dirname(os.path.abspath(JC.__file__))) \
        if tree == "jax" else TC._PKG_ROOT
    modules = JC.CONTROL_PLANE_MODULES if tree == "jax" \
        else TC.CONTROL_PLANE_MODULES
    for rel in modules:
        path = os.path.join(root, rel)
        src = open(path, encoding="utf-8").read()
        assert _rows(TC.analyze_file(path, rel)) == \
            _rows(JL.analyze_file(path, rel)), rel
        assert guarded_write_map(src, rel) == \
            JL.guarded_write_map(src, rel), rel
    # the sweep without allowlist: JAX's one accepted hazard is found by
    # both passes on JAX's tree, none on the port's
    got, _ = TC.sweep_control_plane(modules, allowlist={}, root=root)
    want = [f for rel in modules
            for f in JL.analyze_file(os.path.join(root, rel), rel)]
    assert _rows(got.findings) == _rows(want)
    assert got.codes() == (["RACE003"] if tree == "jax" else [])


@pytest.mark.parametrize("code", RACE_CODES)
def test_seeded_fixture_fires_exactly_its_code_as_in_jax(code):
    from paddle_tpu.analysis.fixtures import SEEDED as JSEEDED

    rep = SEEDED[code]()
    assert rep.findings, f"{code} fixture produced no findings"
    assert set(rep.codes()) == {code}, rep.summary()
    assert _rows(rep.findings) == _rows(JSEEDED[code]().findings)


def test_pre_fix_watchdog_fires_like_jax():
    _, _, JL = _jax()
    got = analyze_source(PRE_FIX_WATCHDOG, "prefix/watchdog.py")
    assert "RACE001" in {f.code for f in got}
    assert _rows(got) == _rows(JL.analyze_source(PRE_FIX_WATCHDOG,
                                                 "prefix/watchdog.py"))


def test_lock_free_module_is_trivially_clean():
    src = "class Router:\n    def step(self):\n        self.tick = 1\n"
    assert analyze_source(src, "m.py") == []


# ---------------------------------------------------------------------------
# the port's sweep and its allowlist
# ---------------------------------------------------------------------------


def test_port_control_plane_sweeps_clean_with_live_allowlist():
    report, unused = TC.sweep_control_plane()
    assert report.ok, report.summary()
    assert unused == [] and report.suppressed == []
    for rel in TC.CONTROL_PLANE_MODULES:
        assert os.path.exists(os.path.join(TC._PKG_ROOT, rel)), rel
    # the fleet and the disaggregated router are swept
    assert {"inference/fleet.py", "inference/disagg.py"} \
        <= set(TC.CONTROL_PLANE_MODULES)


def test_allowlist_entries_all_justified(tmp_path):
    for key, reason in TC.load_allowlist().items():
        assert reason.strip(), f"{key} has no justification"
    p = tmp_path / "allow.txt"
    p.write_text("inference/serving.py::PageAllocator.alloc::RACE003\n")
    with pytest.raises(ValueError, match="justification"):
        TC.load_allowlist(str(p))
    p.write_text("inference/serving.py::RACE003  # two fields\n")
    with pytest.raises(ValueError, match="malformed"):
        TC.load_allowlist(str(p))


def test_stale_allowlist_entry_fails_the_sweep():
    extra = dict(TC.load_allowlist())
    extra[("inference/fleet.py", "FleetRouter.step", "RACE001")] = \
        "stale test entry"
    report, unused = TC.sweep_control_plane(allowlist=extra)
    assert report.ok
    assert unused == ["inference/fleet.py::FleetRouter.step::RACE001"]


def test_allowlisted_finding_stays_visible_as_suppressed(tmp_path):
    """An accepted hazard moves to ``report.suppressed``, never out of the
    report: a module with a sleep under its lock, allowlisted."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "poller.py").write_text(SEEDED_SOURCE_RACE003)
    allow = {("poller.py", "Poller.poll", "RACE003"): "reviewed"}
    report, unused = TC.sweep_control_plane(("poller.py",), allow,
                                            root=str(pkg))
    assert report.ok and unused == []
    assert [f.code for f in report.suppressed] == ["RACE003"]
    assert report.suppressed[0].exemption_id == "ALLOW:Poller.poll:RACE003"


SEEDED_SOURCE_RACE003 = textwrap.dedent("""
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


def test_concurrency_section_is_green():
    sec = TC.concurrency_section()
    assert sec["sweep"]["ok"] and sec["sanitizer"]["ok"], sec
    assert sec["sweep"]["modules"] == list(TC.CONTROL_PLANE_MODULES)


# ---------------------------------------------------------------------------
# the sanitizer
# ---------------------------------------------------------------------------


def test_monitor_detects_order_inversion_and_unguarded_field():
    mon = TS.LockMonitor()
    a, b = TS.SanitizedLock("A", mon), TS.SanitizedLock("B", mon)
    with a:
        with b:
            mon.access("Obj", "field")
    assert mon.order_violations() == []
    with b:
        with a:
            pass
    assert mon.order_violations() == [("A", "B")]
    mon.access("Obj", "field")              # the same field, A not held
    assert mon.unguarded("A") == [("Obj", "field")]


def test_barrier_scheduler_replays_like_jax():
    _, JS, _ = _jax()

    def mk(log, tag):
        return [lambda i=i: log.append((tag, i)) for i in range(5)]

    logs = {}
    for name, mod in (("port", TS), ("jax", JS)):
        log = []
        trace = mod.BarrierScheduler(seed=11).run([mk(log, "a"),
                                                   mk(log, "b")])
        logs[name] = (trace, log)
    assert logs["port"] == logs["jax"]
    again = []
    assert TS.BarrierScheduler(seed=11).run(
        [mk(again, "a"), mk(again, "b")]) == logs["port"][0]


def test_instrument_lock_swaps_in_place():
    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0

        def bump(self):
            with self._lock:
                self.n += 1

    box = Box()
    mon = TS.instrument_lock(box, "_lock", name="box")
    box.bump()
    assert mon.acquisitions == 1 and "bump" in mon.sites["box"]


def test_page_allocator_hammer_replays_exactly_like_jax():
    """The barrier-stepped hammer on the port's PageAllocator replays from
    its seed, and makes the same acquisitions as on JAX's."""
    _, JS, _ = _jax()
    runs = [TS.hammer_page_allocator(num_pages=6, threads=3, ops=60, seed=9,
                                     deterministic=True) for _ in range(2)]
    jrun = JS.hammer_page_allocator(num_pages=6, threads=3, ops=60, seed=9,
                                    deterministic=True)
    assert runs[0]["ok"] and runs[1]["ok"] and jrun["ok"]
    assert runs[0] == runs[1]
    for k in ("acquisitions", "deterministic_trace_len", "order_violations"):
        assert runs[0][k] == jrun[k], k
    assert runs[0]["cross_check"]["unexercised"] == []


def test_page_allocator_hammer_threaded():
    h = TS.hammer_page_allocator(num_pages=8, threads=4, ops=100, seed=5)
    assert h["ok"], h
    assert h["order_violations"] == [] and \
        h["cross_check"]["unexercised"] == []


def test_watchdog_hammer_pins_single_writer_transition():
    w = TS.hammer_watchdog(threads=4, tasks_per_thread=10, seed=2)
    assert w["ok"], w
    assert w["both_terminal"] == 0 and w["neither_terminal"] == 0
    assert w["timed_out"] + w["completed"] == w["tasks"]
    assert w["timed_out"] > 0


def test_router_hammer_replays_exactly():
    """The hammer over a port FleetRouter (the toy fleet on the CPU):
    under the tick lock it leaves no unguarded access, completes every
    submitted stream, and replays exactly from its seed."""
    import fault_injection as J
    import torch_fault_injection as T

    jcfg, _, jparams = J.toy_llama()
    tcfg, _, tparams = T.toy_llama(jparams)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32)
               for n in (5, 9, 17, 7)]

    def port_run():
        router, _ = T.build_serving_fleet(tcfg, tparams, target=2,
                                          device="cpu")
        h = TS.hammer_router(router, prompts, steps=24, seed=3)
        return h, {k: v.tolist() for k, v in router.results().items()}

    (h1, out1), (h2, out2) = port_run(), port_run()
    assert h1["ok"] and h1["unguarded"] == [] and h1["completed"] == 4
    assert h1 == h2 and out1 == out2


def test_page_allocator_and_prefix_cache_contracts():
    from paddle_tpu_torch.inference.serving import PageAllocator, PrefixCache

    alloc = PageAllocator(4)
    p = alloc.alloc()
    alloc.acquire(p)
    alloc.release([p, p])
    alloc.assert_consistent()
    bad = PageAllocator(4)
    bad.free.append(bad.alloc())
    with pytest.raises(AssertionError):
        bad.assert_consistent()
    cache = PrefixCache(page_size=2, alloc=PageAllocator(8))
    pages = [cache.alloc.alloc() for _ in range(2)]
    cache.insert([1, 2, 3, 4], pages)
    cache.assert_consistent()
    cache.host_pages = 3
    with pytest.raises(AssertionError, match="counter drift"):
        cache.assert_consistent()
    cache.host_pages = 0
    # consistency holds while mutators run in other threads
    pool = PageAllocator(8)

    def mutate():
        for _ in range(60):
            q = pool.alloc()
            if q is not None:
                pool.release([q])

    def check():
        for _ in range(30):
            pool.assert_consistent()

    TS.run_threaded([[mutate], [mutate], [check]])
    pool.assert_consistent()
    assert pool.available == 8
