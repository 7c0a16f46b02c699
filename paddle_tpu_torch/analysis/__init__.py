"""Analysis of the port (mirror of ``paddle_tpu/analysis``): so far the
Concurrency Doctor, the lock-discipline pass over the host-side control
plane (``concurrency.py``, ``passes/lock_discipline.py``) and its runtime
half (``lock_sanitizer.py``), with the typed findings (``findings.py``)
and the seeded RACE fixtures (``fixtures.py``).  The graph passes, the
doctors' entries and the roofline are ROADMAP A7's later parts."""

from .concurrency import (ALLOWLIST_PATH, CONTROL_PLANE_MODULES,
                          load_allowlist, sweep_control_plane)
from .findings import Finding, Report

__all__ = ["ALLOWLIST_PATH", "CONTROL_PLANE_MODULES", "Finding", "Report",
           "load_allowlist", "sweep_control_plane"]
