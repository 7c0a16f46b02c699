"""Collective/step watchdog.

Port of ``paddle_tpu/distributed/watchdog.py``: every watched collective
(or a whole train step) is a ``CommTask``; a daemon ``CommTaskManager``
thread scans the in-flight tasks and, past the task's timeout, records it
(op, group, start site, elapsed), logs it and fires the registered
handlers.

Why the watchdog lives outside the blocked call: a hung NCCL collective
never returns to Python, and the host blocks at the next synchronisation
(``float(loss)`` in the resilient loop), so only another thread can see
the stall.  ``abort_on_timeout`` then tears the live process group down
(``distributed_c10d._abort_process_group``, the backends' abort, where
the installed torch has it, else ``destroy_process_group``), which makes
a blocked NCCL call return with an error, and takes the process down
(exit code 124) so that the launcher's restart policy recovers the job.
The abort runs on a thread of its own and the exit follows it within
``ABORT_GRACE_S`` whether or not it returned: gloo's abort returns but
leaves its blocked call blocked, and an abort that blocked must not keep
the process alive.  NCCL's abort releases the blocked call, and the main
thread may then end the interpreter before the abort returns (its C++
thread then dies with the CUDA driver, SIGABRT): an exit hook makes
that exit 124 too.

The JAX module reads ``FLAGS_comm_timeout_s``, ``FLAGS_comm_abort_on_
timeout`` and ``FLAGS_nccl_blocking_wait`` from its flag registry; the port
reads the same names from the environment (``flag``), with the same
defaults.
"""

from __future__ import annotations

import atexit
import logging
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

#: flag name -> default (the JAX registry's, paddle_tpu/common/flags.py)
FLAG_DEFAULTS = {
    "FLAGS_comm_timeout_s": 1800.0,
    "FLAGS_comm_abort_on_timeout": False,
    "FLAGS_nccl_blocking_wait": False,
}

_TRUE = ("1", "true", "yes", "on")


def flag(name: str):
    """The value of a watchdog flag: the environment variable of that name
    when set (a float for the timeout, a bool for the switches), else the
    default."""
    default = FLAG_DEFAULTS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if isinstance(default, bool):
        return raw.strip().lower() in _TRUE
    return float(raw)


_SEQ = 0
_SEQ_LOCK = threading.Lock()


@dataclass
class CommTask:
    """One in-flight collective (or watched step).

    ``done`` and ``timed_out`` are mutually exclusive terminal states: the
    transition is made under the manager's lock (one writer), so a
    completion racing the scanner never yields a task that is both
    finished and flagged hung."""

    name: str
    group_desc: str = ""
    timeout_s: float = 0.0
    seq: int = 0
    start_time: float = field(default_factory=time.monotonic)
    _stack: Optional[object] = None  # raw StackSummary; formatted lazily
    done: bool = False
    timed_out: bool = False

    def elapsed(self) -> float:
        return time.monotonic() - self.start_time

    @property
    def start_site(self) -> str:
        if self._stack is None:
            return ""
        return "".join(self._stack.format())


class CommTaskManager:
    """Background scanner of in-flight tasks (one per process through
    ``instance()``)."""

    _instance: Optional["CommTaskManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self, scan_interval: float = 0.1):
        self._tasks: Dict[int, CommTask] = {}
        self._lock = threading.Lock()
        self._handlers: List[Callable[[CommTask], None]] = []
        self.timed_out: List[CommTask] = []
        self._scan_interval = scan_interval
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @classmethod
    def instance(cls) -> "CommTaskManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add_handler(self, fn: Callable[[CommTask], None]):
        with self._lock:
            self._handlers.append(fn)

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="comm-watchdog", daemon=True)
            self._thread.start()

    def register(self, name: str, group_desc: str = "",
                 timeout_s: Optional[float] = None) -> CommTask:
        """A new in-flight task.  ``timeout_s`` None reads
        ``FLAGS_comm_timeout_s``; 0 or less disables the watch: no
        registration, no scanner thread, no stack capture."""
        global _SEQ
        if timeout_s is None:
            timeout_s = float(flag("FLAGS_comm_timeout_s"))
        if timeout_s <= 0:
            return CommTask(name=name, group_desc=group_desc, timeout_s=0.0)
        with _SEQ_LOCK:
            _SEQ += 1
            seq = _SEQ
        # capture the frames unformatted (no linecache reads); they are
        # formatted only if the task times out
        stack = traceback.StackSummary.extract(
            traceback.walk_stack(sys._getframe(1)), limit=5,
            lookup_lines=False)
        stack.reverse()
        task = CommTask(name=name, group_desc=group_desc,
                        timeout_s=timeout_s, seq=seq, _stack=stack)
        with self._lock:
            self._tasks[seq] = task
        self._ensure_thread()
        return task

    def complete(self, task: CommTask):
        """Mark a task finished.  If the scanner already flagged it, this
        is a no-op: the handlers' decision stands (the late result of a
        hung collective is suspect)."""
        with self._lock:
            if task.timed_out:
                return
            task.done = True
            self._tasks.pop(task.seq, None)

    def _loop(self):
        while not self._stop.wait(self._scan_interval):
            now = time.monotonic()
            expired = []
            handlers = ()
            with self._lock:
                for seq, t in list(self._tasks.items()):
                    if t.done:
                        del self._tasks[seq]
                        continue
                    if t.timeout_s > 0 and now - t.start_time > t.timeout_s:
                        t.timed_out = True
                        expired.append(t)
                        del self._tasks[seq]
                # the trace list moves with the flag, under one lock
                self.timed_out.extend(expired)
                if expired:
                    handlers = tuple(self._handlers)
            for t in expired:
                logger.error(
                    "[comm watchdog] task '%s' (group=%s, seq=%d) exceeded "
                    "%.1fs (elapsed %.1fs); started at:\n%s",
                    t.name, t.group_desc or "-", t.seq, t.timeout_s,
                    t.elapsed(), t.start_site)
                for h in handlers:
                    try:
                        h(t)
                    except Exception:
                        logger.exception("comm watchdog handler failed")
                if (flag("FLAGS_comm_abort_on_timeout")
                        or flag("FLAGS_nccl_blocking_wait")):
                    abort_on_timeout(t)

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class comm_watch:
    """Context manager marking a collective (or a step) in flight::

        with comm_watch("train_step", timeout_s=120):
            loss = float(step(batch))
    """

    def __init__(self, name: str, group_desc: str = "",
                 timeout_s: Optional[float] = None):
        self.name = name
        self.group_desc = group_desc
        self.timeout_s = timeout_s
        self.task: Optional[CommTask] = None

    def __enter__(self) -> CommTask:
        self.task = CommTaskManager.instance().register(
            self.name, self.group_desc, self.timeout_s)
        return self.task

    def __exit__(self, *exc):
        CommTaskManager.instance().complete(self.task)
        return False


#: seconds the exit waits for the process group's abort to return
ABORT_GRACE_S = 10.0


def abort_process_group() -> bool:
    """Abort every live process group, so that a collective blocked in
    NCCL returns (with an error) instead of hanging the host:
    ``distributed_c10d._abort_process_group`` where this torch has it
    (the backends' abort; torch 2.3 on), else ``destroy_process_group``.
    False when no group is live."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if not (dist.is_available() and dist.is_initialized()):
        return False
    abort = getattr(c10d, "_abort_process_group", None)
    name = "_abort_process_group" if abort is not None \
        else "destroy_process_group"
    logger.critical("[comm watchdog] %s (backend %s)", name,
                    dist.get_backend())
    (abort or dist.destroy_process_group)()
    logger.critical("[comm watchdog] %s returned", name)
    return True


def abort_on_timeout(task: CommTask):
    """Handler: on a hung collective, abort the live process groups, then
    take the process down (exit code 124) so that the launcher's restart
    policy recovers the job.  The exit waits at most ``ABORT_GRACE_S``
    for the abort."""
    logger.critical("[comm watchdog] aborting process: task '%s' hung "
                    "(%.1fs > %.1fs)", task.name, task.elapsed(),
                    task.timeout_s)

    def _abort():
        try:
            abort_process_group()
        except Exception:
            logger.exception("[comm watchdog] the abort failed")

    atexit.register(os._exit, 124)
    t = threading.Thread(target=_abort, name="comm-abort", daemon=True)
    t.start()
    t.join(ABORT_GRACE_S)
    if t.is_alive():
        logger.critical("[comm watchdog] the abort did not return in "
                        "%.1fs", ABORT_GRACE_S)
    logging.shutdown()
    os._exit(124)
