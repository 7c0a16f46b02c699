"""Analysis of the port (mirror of ``paddle_tpu/analysis``).

- The Graph Doctor: ``check(fn, *args)`` captures an entry point as an FX
  graph on fake tensors (``core.py``; the kernels are registered
  operators, ``ops/_registry.py``; DESIGN.md) and runs the graph passes
  over it: DT001-003 (``passes/dtype_promotion.py``), DON001-002
  (``passes/donation.py``), MEM000-002 (``passes/memory_budget.py``, also
  the MEM001 hooks of the reshard plan, the fleet's delivery, the KV
  handoff and the serving entry), HEALTH001-002
  (``passes/health_probe.py``); the call-driven ``retrace_sentinel``
  (RT001-002); tracked ``exemptions.py``; the seeded fixtures
  (``fixtures.py``) and ``self_check.py`` (``python -m
  paddle_tpu_torch.analysis --self-check``).
- Above one rank: captures on a ``"fake"`` process group
  (``core.fake_ranks``, ``fake_mesh``, ``capture_ranks``,
  ``check_ranks``), each collective node annotated with its group, axis,
  peer and payload; COLL001-002 (``passes/collective_order.py``),
  COMM001-004 (``passes/collective_budget.py``, with the wire tables),
  HLO002 (``passes/hlo_checks.py``), SHARD001-005 and SCHED001
  (``passes/sharding_consistency.py`` over the canonical tables of
  ``sharding.py``).
- The Concurrency Doctor: the lock-discipline pass over the host-side
  control plane (``concurrency.py``, ``passes/lock_discipline.py``) and
  its runtime half (``lock_sanitizer.py``), with the seeded RACE fixtures.
  With a process group live, ``check_ranks`` captures in a spawned
  child.
- The roofline's drift gate (``self_check.roofline_drift_section``): the
  estimator of ``parallel/roofline.py`` against the joint walk's measured
  records."""

from .concurrency import (ALLOWLIST_PATH, CONTROL_PLANE_MODULES,
                          load_allowlist, sweep_control_plane)
from .core import (AnalysisContext, AnalysisPass, PASS_REGISTRY, SkipPass,
                   capture, capture_ranks, check, check_ranks, fake_mesh,
                   fake_ranks, register_pass, resolve_passes, static_peak)
from .exemptions import EXEMPTIONS, Exemption, apply_exemptions
from .findings import AnalysisError, Finding, Report
from .passes.retrace import RetraceSentinel, retrace_sentinel

__all__ = ["ALLOWLIST_PATH", "AnalysisContext", "AnalysisError",
           "AnalysisPass", "CONTROL_PLANE_MODULES", "EXEMPTIONS",
           "Exemption", "Finding", "PASS_REGISTRY", "Report",
           "RetraceSentinel", "SkipPass", "apply_exemptions", "capture",
           "capture_ranks", "check", "check_ranks", "fake_mesh",
           "fake_ranks", "load_allowlist", "register_pass", "resolve_passes",
           "retrace_sentinel", "static_peak", "sweep_control_plane"]
