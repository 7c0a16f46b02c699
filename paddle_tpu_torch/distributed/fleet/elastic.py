"""Elastic restart policy and heartbeats.

Port of ``paddle_tpu/distributed/fleet/elastic.py``: the decision core of
gang restarts (gang liveness, a restart budget, optional heartbeat files)
that the resilient train loop (``distributed/resilience.py``) and a
launcher share::

    mgr = ElasticManager(nnodes="2:4", max_restart=3)
    while True:
        st = mgr.decide(poll_workers())
        if st is ElasticStatus.RESTART: relaunch(); continue
        break
"""

from __future__ import annotations

import enum
import logging
import os
import threading
import time
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)

HEARTBEAT_ENV = "PADDLE_ELASTIC_HEARTBEAT_DIR"


class ElasticStatus(enum.Enum):
    RUNNING = "running"
    COMPLETED = "completed"
    RESTART = "restart"
    ERROR = "error"


def parse_nnodes(nnodes: str):
    """``"N"`` or ``"N1:N2"`` -> (min, max) nodes."""
    parts = str(nnodes).split(":")
    lo = int(parts[0])
    hi = int(parts[-1])
    if lo < 1 or hi < lo:
        raise ValueError(f"invalid nnodes range {nnodes!r}")
    return lo, hi


class ElasticManager:
    """Gang restart policy: any worker failing fails the gang; while the
    restart budget lasts, the whole gang restarts (a half-restarted ring
    cannot make progress)."""

    def __init__(self, nnodes: str = "1", max_restart: int = 0,
                 heartbeat_timeout: float = 30.0):
        self.min_nodes, self.max_nodes = parse_nnodes(nnodes)
        self.max_restart = max_restart
        self.restart_count = 0
        self.heartbeat_timeout = heartbeat_timeout

    @property
    def elastic_enabled(self) -> bool:
        return self.max_nodes > self.min_nodes or self.max_restart > 0

    def register_failure(self) -> bool:
        """In-process fault bookkeeping (faults arrive as exceptions): one
        fault takes one gang restart; False when the budget is spent."""
        if self.restart_count >= self.max_restart:
            return False
        self.restart_count += 1
        return True

    def decide(self, exit_codes: Sequence[Optional[int]]) -> ElasticStatus:
        """Decide from a poll of worker exit codes (None: still running)."""
        if any(c is not None and c != 0 for c in exit_codes):
            if self.restart_count < self.max_restart:
                self.restart_count += 1
                logger.warning(
                    "[elastic] worker failed (codes=%s); gang restart %d/%d",
                    list(exit_codes), self.restart_count, self.max_restart)
                return ElasticStatus.RESTART
            return ElasticStatus.ERROR
        if all(c == 0 for c in exit_codes):
            return ElasticStatus.COMPLETED
        return ElasticStatus.RUNNING

    def stale_heartbeats(self, hb_dir: str, now: Optional[float] = None
                         ) -> List[str]:
        """Ranks whose heartbeat file (``hb.<rank>``) went stale: dead-node
        detection where process liveness cannot be observed."""
        if not os.path.isdir(hb_dir):
            return []
        now = time.time() if now is None else now
        stale = []
        for name in sorted(os.listdir(hb_dir)):
            if not name.startswith("hb."):
                continue
            age = now - os.path.getmtime(os.path.join(hb_dir, name))
            if age > self.heartbeat_timeout:
                stale.append(name[3:])
        return stale


class HeartbeatWriter:
    """Worker side: touch ``hb.<rank>`` in the directory named by
    ``PADDLE_ELASTIC_HEARTBEAT_DIR`` every ``interval`` seconds from a
    daemon thread; a no-op when the variable is unset."""

    def __init__(self, rank: Optional[int] = None, interval: float = 2.0):
        self.dir = os.environ.get(HEARTBEAT_ENV)
        self.rank = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.interval = interval
        self._thread = None
        self._stop = None

    def start(self):
        if not self.dir:
            return self
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"hb.{self.rank}")
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(self.interval):
                with open(path, "a"):
                    os.utime(path)

        with open(path, "a"):
            os.utime(path)
        self._thread = threading.Thread(
            target=loop, name="elastic-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._stop is not None:
            self._stop.set()
