"""The Concurrency Doctor's runtime half: instrumented locks and the
thread hammers.

Port of ``paddle_tpu/analysis/lock_sanitizer.py``.  The static pass
(``passes/lock_discipline.py``) reasons about source; this module watches
the same discipline at run time:

- ``SanitizedLock`` wraps a real ``threading.Lock``/``RLock`` and records,
  per acquisition, the acquiring thread, the locks it already held (the
  runtime acquisition-order graph) and the function it acquired from (the
  acquisition sites, the dynamic mirror of the static guarded-write map).
- ``LockMonitor`` aggregates the records: ``order_violations()`` reports
  lock pairs observed in both orders (a runtime RACE002), ``unguarded()``
  fields a hammer op touched without the lock the discipline demands (a
  runtime RACE001), and ``cross_check(static_map)`` compares acquisition
  sites against ``lock_discipline.guarded_write_map``'s prediction.
- the hammers drive the port's control-plane objects (``PageAllocator``,
  the watchdog's ``CommTaskManager``, a ``FleetRouter`` or
  ``DisaggRouter``) from concurrent threads or, for reproducible tests,
  from a barrier-stepped fake scheduler (``BarrierScheduler``) that
  interleaves the same ops in one real thread under a seeded order, so a
  hammer failure replays exactly.

Instrumentation is swap-in (``instrument_lock(obj)`` replaces
``obj._lock``); production code never imports this module.
"""

from __future__ import annotations

import random
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class LockMonitor:
    """Aggregated runtime observations.  Thread-safe via its own
    internal lock (never instrumented — the watcher must not watch
    itself)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_lock, acquired_lock) -> first site "qual"
        self.order_edges: Dict[Tuple[str, str], str] = {}
        # lock -> sorted set of acquiring function names
        self.sites: Dict[str, set] = {}
        # (owner, field) -> set of frozenset(held lock names)
        self.field_holds: Dict[Tuple[str, str], set] = {}
        self.acquisitions = 0

    # -- per-thread held stack --------------------------------------------
    def _held(self) -> List[str]:
        if not hasattr(self._tls, "held"):
            self._tls.held = []
        return self._tls.held

    def held_names(self) -> Tuple[str, ...]:
        return tuple(self._held())

    # -- recording ---------------------------------------------------------
    def on_acquire(self, name: str, site: str):
        held = self._held()
        with self._mu:
            self.acquisitions += 1
            self.sites.setdefault(name, set()).add(site)
            for h in held:
                if h != name:
                    self.order_edges.setdefault((h, name), site)
        held.append(name)

    def on_release(self, name: str):
        held = self._held()
        if name in held:
            held.reverse()
            held.remove(name)
            held.reverse()

    def access(self, owner: str, field: str):
        """Record a guarded-field access site with the CURRENT held-lock
        set (called by hammer ops / probes, inside or outside locks)."""
        snapshot = frozenset(self._held())
        with self._mu:
            self.field_holds.setdefault((owner, field), set()).add(snapshot)

    # -- verdicts ----------------------------------------------------------
    def order_violations(self) -> List[Tuple[str, str]]:
        """Lock pairs observed in both acquisition orders."""
        out = []
        with self._mu:
            for (a, b) in self.order_edges:
                if (b, a) in self.order_edges and a < b:
                    out.append((a, b))
        return sorted(out)

    def unguarded(self, lock: str) -> List[Tuple[str, str]]:
        """(owner, field) pairs accessed at least once WITHOUT ``lock``
        held, among fields that were also accessed WITH it (the dynamic
        mirror of RACE001's both-sides rule)."""
        out = []
        with self._mu:
            for key, holds in self.field_holds.items():
                seen_with = any(lock in h for h in holds)
                seen_without = any(lock not in h for h in holds)
                if seen_with and seen_without:
                    out.append(key)
        return sorted(out)

    def cross_check(self, static_map: Dict[str, Dict[str, list]],
                    lock: str) -> Dict[str, Any]:
        """Compare the static guarded-write map for ``lock`` against the
        functions observed acquiring the instrumented lock.  A static
        write-site the hammer exercised must show up as a runtime
        acquisition site; a missing one means either dead code or a
        code path that mutates guarded state WITHOUT the lock."""
        want = set()
        for field, quals in static_map.get(lock, {}).items():
            for q in quals:
                want.add(q.split(".")[-1])
        with self._mu:
            got = set(self.sites.get(lock, set()))
        return {"static_sites": sorted(want),
                "runtime_sites": sorted(got),
                "covered": sorted(want & got),
                "unexercised": sorted(want - got)}


class SanitizedLock:
    """Drop-in lock wrapper feeding a LockMonitor.  Supports the
    context-manager protocol plus acquire/release, so it substitutes for
    ``threading.Lock``/``RLock`` in the instrumented object."""

    def __init__(self, name: str, monitor: LockMonitor,
                 inner: Optional[Any] = None):
        self.name = name
        self.monitor = monitor
        self.inner = inner if inner is not None else threading.Lock()

    def _site(self) -> str:
        f = sys._getframe(2)
        return f.f_code.co_name

    def acquire(self, *args, **kwargs):
        got = self.inner.acquire(*args, **kwargs)
        if got:
            self.monitor.on_acquire(self.name, self._site())
        return got

    def release(self):
        self.monitor.on_release(self.name)
        self.inner.release()

    def __enter__(self):
        self.inner.acquire()
        self.monitor.on_acquire(self.name, self._site())
        return self

    def __exit__(self, *exc):
        self.monitor.on_release(self.name)
        self.inner.release()
        return False

    def locked(self):
        return self.inner.locked()


def instrument_lock(obj: Any, attr: str = "_lock",
                    monitor: Optional[LockMonitor] = None,
                    name: Optional[str] = None) -> LockMonitor:
    """Swap ``obj.<attr>`` for a SanitizedLock wrapping the original;
    returns the monitor (a fresh one unless given)."""
    monitor = monitor or LockMonitor()
    inner = getattr(obj, attr)
    if isinstance(inner, SanitizedLock):
        inner = inner.inner
    label = name or f"{type(obj).__name__}.{attr}"
    setattr(obj, attr, SanitizedLock(label, monitor, inner))
    return monitor


class BarrierScheduler:
    """Deterministic fake scheduler: N virtual threads' op lists are
    interleaved in ONE real thread under a seeded order — every "context
    switch" happens between ops, chosen by the rng, so a hammer run is
    exactly reproducible from its seed.  The genuinely-threaded hammers
    reuse the same op lists; this is the replay/debug mode."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.trace: List[Tuple[int, int]] = []   # (vthread, op index)

    def run(self, ops_per_thread: Sequence[Sequence[Callable[[], Any]]]):
        rng = random.Random(self.seed)
        cursors = [0] * len(ops_per_thread)
        live = [i for i, ops in enumerate(ops_per_thread) if ops]
        while live:
            i = rng.choice(live)
            op = ops_per_thread[i][cursors[i]]
            self.trace.append((i, cursors[i]))
            op()
            cursors[i] += 1
            if cursors[i] >= len(ops_per_thread[i]):
                live.remove(i)
        return self.trace


def run_threaded(ops_per_thread: Sequence[Sequence[Callable[[], Any]]],
                 timeout: float = 30.0) -> None:
    """Run each op list in its own real thread, started together behind
    a barrier.  Exceptions re-raise in the caller (first one wins)."""
    barrier = threading.Barrier(len(ops_per_thread))
    errors: List[BaseException] = []
    emu = threading.Lock()

    def runner(ops):
        barrier.wait()
        try:
            for op in ops:
                op()
        except BaseException as e:  # noqa: BLE001
            with emu:
                errors.append(e)

    threads = [threading.Thread(target=runner, args=(ops,), daemon=True)
               for ops in ops_per_thread]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    if errors:
        raise errors[0]


# ---------------------------------------------------------------------------
# hammers: real control-plane objects under concurrent (or replayed) ops
# ---------------------------------------------------------------------------


def _allocator_ops(alloc, monitor: LockMonitor, n_ops: int, seed: int):
    """One virtual thread's seeded alloc/acquire/release workload; every
    op leaves the thread's ref accounting balanced by the end."""
    rng = random.Random(seed)
    owned: List[int] = []

    def step():
        monitor.access("PageAllocator", "free")
        monitor.access("PageAllocator", "refs")
        roll = rng.random()
        if owned and roll < 0.45:
            alloc.release([owned.pop(rng.randrange(len(owned)))])
        elif owned and roll < 0.55:
            p = owned[rng.randrange(len(owned))]
            alloc.acquire(p)
            owned.append(p)
        else:
            p = alloc.alloc()
            if p is not None:
                owned.append(p)

    def drain():
        while owned:
            alloc.release([owned.pop()])

    return [step] * n_ops + [drain]


def hammer_page_allocator(num_pages: int = 8, threads: int = 4,
                          ops: int = 120, seed: int = 0,
                          deterministic: bool = False) -> Dict[str, Any]:
    """Concurrent alloc/acquire/release storm on a PageAllocator with an
    instrumented lock; asserts ``assert_consistent()`` afterwards and
    cross-checks the static lock map against the observed acquisition
    sites.  ``deterministic=True`` replays the same ops through the
    barrier-stepped fake scheduler (single real thread, seeded order)."""
    import os

    from ..inference.serving import PageAllocator

    alloc = PageAllocator(num_pages)
    monitor = instrument_lock(alloc, "_lock", name="_lock")
    op_lists = [_allocator_ops(alloc, monitor, ops, seed * 997 + i)
                for i in range(threads)]
    trace_len = None
    if deterministic:
        sched = BarrierScheduler(seed)
        sched.run(op_lists)
        trace_len = len(sched.trace)
    else:
        run_threaded(op_lists)
    alloc.assert_consistent()       # the checked contract, under fire
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "inference", "serving.py")
    from .passes.lock_discipline import guarded_write_map

    with open(src, "r", encoding="utf-8") as f:
        static_map = guarded_write_map(f.read(), "inference/serving.py")
    xc = monitor.cross_check(static_map, "_lock")
    ok = (not monitor.order_violations()
          and alloc.available == alloc.total
          and not xc["unexercised"])
    return {"ok": ok, "acquisitions": monitor.acquisitions,
            "order_violations": monitor.order_violations(),
            "cross_check": xc,
            "deterministic_trace_len": trace_len}


def hammer_watchdog(threads: int = 4, tasks_per_thread: int = 12,
                    seed: int = 0) -> Dict[str, Any]:
    """The regression pin for the watchdog's handler/flag race: N threads
    register+complete tasks (some pre-aged past their deadline) while
    the scanner thread flags timeouts.  The FIXED single-writer
    transition must hold: every task ends in EXACTLY one of
    done/timed_out, and the instrumented manager lock shows no order
    violation."""
    from ..distributed import watchdog as _wd
    from ..distributed.watchdog import CommTaskManager

    mgr = CommTaskManager(scan_interval=0.001)
    # the hammer MANUFACTURES dozens of timeouts; the scanner's
    # per-timeout error trace is signal in production and noise here
    prev_disabled = _wd.logger.disabled
    _wd.logger.disabled = True
    monitor = instrument_lock(mgr, "_lock", name="manager._lock")
    all_tasks: List[Any] = []
    mu = threading.Lock()

    def ops_for(tid: int):
        rng = random.Random(seed * 31 + tid)
        ops = []

        def one():
            t = mgr.register(f"collective-{tid}", timeout_s=30.0)
            aged = rng.random() < 0.5
            if aged:
                # age the task past its deadline so the scanner races
                # the completion for the terminal transition; linger a
                # few scan intervals so the scanner actually competes
                t.start_time -= 60.0
                threading.Event().wait(0.004)
            with mu:
                all_tasks.append(t)
            mgr.complete(t)

        ops.extend([one] * tasks_per_thread)
        return ops

    try:
        run_threaded([ops_for(i) for i in range(threads)])
        # let the scanner drain what completion lost the race for
        deadline = 50
        while mgr._tasks and deadline:
            threading.Event().wait(0.002)
            deadline -= 1
    finally:
        mgr.shutdown()
        _wd.logger.disabled = prev_disabled
    both = [t for t in all_tasks if t.done and t.timed_out]
    neither = [t for t in all_tasks if not t.done and not t.timed_out]
    ok = (not both and not neither and not monitor.order_violations())
    return {"ok": ok, "tasks": len(all_tasks),
            "timed_out": sum(1 for t in all_tasks if t.timed_out),
            "completed": sum(1 for t in all_tasks if t.done),
            "both_terminal": len(both), "neither_terminal": len(neither),
            "order_violations": monitor.order_violations()}


def hammer_router(router, prompts, *, steps: int = 64,
                  max_new_tokens: int = 4, vthreads: int = 3,
                  seed: int = 0, discipline: bool = True
                  ) -> Dict[str, Any]:
    """Drive a REAL FleetRouter/DisaggRouter's submit/step ops through
    the deterministic scheduler under a sanitized TICK LOCK.

    The routers are single-threaded BY DESIGN (their docstring
    contract); the hammer encodes the discipline that makes concurrent
    callers legal — every op serializes on the tick lock — and the
    monitor proves it held: with ``discipline=True`` every router-state
    access is recorded under the lock (``unguarded() == []``); with
    ``discipline=False`` the same workload records the violation the
    sanitizer exists to catch (the detection self-test)."""
    monitor = LockMonitor()
    tick_lock = SanitizedLock("router_tick", monitor)

    def guarded(fn, *a, **kw):
        if discipline:
            with tick_lock:
                monitor.access("FleetRouter", "queue")
                return fn(*a, **kw)
        monitor.access("FleetRouter", "queue")
        return fn(*a, **kw)

    rids: List[int] = []
    submit_ops = [(lambda p=p: rids.append(
        guarded(router.submit, p, max_new_tokens=max_new_tokens)))
        for p in prompts]
    step_ops = [lambda: guarded(router.step)] * steps
    # split the step budget across the other virtual threads
    per = max(1, steps // max(1, vthreads - 1))
    op_lists = [submit_ops] + [step_ops[i * per:(i + 1) * per]
                               for i in range(max(1, vthreads - 1))]
    sched = BarrierScheduler(seed)
    sched.run(op_lists)
    while router.pending():
        guarded(router.step)
    out = router.results()
    # a disciplined run leaves no unguarded access; an undisciplined
    # run must record at least one (else the sanitizer is blind)
    unguarded = monitor.unguarded("router_tick")
    ok = (sorted(out) == sorted(rids)
          and (not unguarded if discipline else bool(unguarded)))
    return {"ok": ok, "completed": len(out), "submitted": len(rids),
            "unguarded": [list(u) for u in unguarded],
            "trace_len": len(sched.trace),
            "order_violations": monitor.order_violations()}


def sanitizer_self_test() -> Dict[str, Any]:
    """Fast, deterministic self-test for the doctor report: the
    order-inversion detector fires on a scripted ab/ba sequence, and the
    barrier-stepped PageAllocator hammer sweeps clean with a stable
    trace.  No real thread timing — reproducible by construction."""
    # 1) detection: a scripted lock-order inversion must be observed
    mon = LockMonitor()
    a = SanitizedLock("A", mon)
    b = SanitizedLock("B", mon)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    detects = mon.order_violations() == [("A", "B")]

    # 2) clean deterministic hammer, trace stable across two runs
    h1 = hammer_page_allocator(num_pages=6, threads=3, ops=40, seed=7,
                               deterministic=True)
    h2 = hammer_page_allocator(num_pages=6, threads=3, ops=40, seed=7,
                               deterministic=True)
    stable = (h1["deterministic_trace_len"]
              == h2["deterministic_trace_len"]
              and h1["acquisitions"] == h2["acquisitions"])
    ok = bool(detects and h1["ok"] and h2["ok"] and stable)
    return {"ok": ok, "order_inversion_detected": detects,
            "deterministic_hammer": h1, "trace_stable": stable}
