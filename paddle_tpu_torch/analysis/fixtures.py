"""The seeded fixtures of the port's analysis passes: a minimal program
per finding code that must fire exactly that code (the true-positive half
of every pass's gate).

Port of the RACE part of ``paddle_tpu/analysis/fixtures.py``: the four
lock-discipline fixtures, as the same source strings.  ``SEEDED`` maps a
code to its fixture; each returns the pass's ``Report`` over its source.
"""

from __future__ import annotations

from .findings import Report


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


SEEDED = {
    "RACE001": seeded_unguarded_write,
    "RACE002": seeded_lock_order_inversion,
    "RACE003": seeded_blocking_under_lock,
    # the minimized pre-fix watchdog race
    "RACE004": seeded_check_then_act,
}

__all__ = ["SEEDED", "seeded_blocking_under_lock", "seeded_check_then_act",
           "seeded_lock_order_inversion", "seeded_unguarded_write"]
