"""The Concurrency Doctor's sweep of the port's control plane (its static
half).

Port of ``paddle_tpu/analysis/concurrency.py``: the lock-discipline pass
(``passes/lock_discipline.py``, RACE001-004) over the port's host-side
control-plane modules, with the reviewed allowlist applied, the AST-lint
workflow:

- ``CONTROL_PLANE_MODULES`` is the swept set (serving engine and page
  pool, fleet and disaggregated routers, watchdog, resilience loop,
  store helpers, health guardian, checkpoint manager and writer), paths
  relative to ``paddle_tpu_torch/``;
- ``concurrency_allowlist.txt`` holds the accepted findings
  (``relpath::qualname::CODE  # reason``), moved to ``report.suppressed``
  so that the hazard stays detected, never silenced;
- an allowlist entry that no live finding matches fails the sweep (the
  table tracks decisions, not history).

``sweep_control_plane(root=...)`` sweeps another package root with the
same module list (the JAX package's, for the tests' comparison).  The
runtime half (instrumented locks and the thread hammers) is
``analysis/lock_sanitizer.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding, Report
from .passes.lock_discipline import PASS_NAME, analyze_file

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWLIST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "concurrency_allowlist.txt")

# the host-side control plane: every module that owns threads, locks or
# state a concurrent serving or elastic loop mutates.  A lock-free module
# costs one ast.parse and reports clean; keeping it in the sweep means a
# lock added there is analyzed from its first commit.
CONTROL_PLANE_MODULES = (
    "inference/serving.py",
    "inference/fleet.py",
    "inference/disagg.py",
    "distributed/watchdog.py",
    "distributed/resilience.py",
    "distributed/store.py",
    "distributed/health.py",
    "distributed/checkpoint/manager.py",
    "distributed/checkpoint/save_state_dict.py",
)


def load_allowlist(path: str = ALLOWLIST_PATH) -> Dict[Tuple[str, str, str],
                                                       str]:
    """{(relpath, qualname, CODE): reason}.  Entries must carry a
    non-empty ``# reason``: an allowlisted hazard without a written
    justification is rejected at load time (the review rule)."""
    table: Dict[Tuple[str, str, str], str] = {}
    if not os.path.exists(path):
        return table
    with open(path, "r", encoding="utf-8") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            entry, _, comment = line.partition("#")
            reason = comment.strip()
            parts = [p.strip() for p in entry.strip().split("::")]
            if len(parts) != 3:
                raise ValueError(
                    f"{path}:{lineno}: malformed entry {line!r} "
                    f"(want relpath::qualname::CODE  # reason)")
            if not reason:
                raise ValueError(
                    f"{path}:{lineno}: entry {entry.strip()!r} has no "
                    f"justification - every accepted concurrency hazard "
                    f"needs a written reason")
            table[(parts[0], parts[1], parts[2])] = reason
    return table


def _match_key(finding: Finding) -> Tuple[str, str, str]:
    rel = (finding.where or "").split(":", 1)[0]
    return rel, str(finding.data.get("qual", "")), finding.code


def sweep_control_plane(
        modules: Sequence[str] = CONTROL_PLANE_MODULES,
        allowlist: Optional[Dict[Tuple[str, str, str], str]] = None,
        root: str = _PKG_ROOT,
) -> Tuple[Report, List[str]]:
    """(report, unused_allowlist_keys): the lock-discipline sweep over the
    control plane under ``root`` with the reviewed allowlist applied.  The
    gate is ``report.ok and not unused``: a finding only an allowlist
    entry explains stays visible in ``report.suppressed``; an entry nothing
    matches is stale and fails."""
    if allowlist is None:
        allowlist = load_allowlist()
    findings: List[Finding] = []
    suppressed: List[Finding] = []
    used = set()
    for rel in modules:
        path = os.path.join(root, rel)
        for f in analyze_file(path, rel):
            key = _match_key(f)
            if key in allowlist:
                f.exemption_id = f"ALLOW:{key[1]}:{key[2]}"
                suppressed.append(f)
                used.add(key)
            else:
                findings.append(f)
    unused = ["::".join(k) for k in sorted(set(allowlist) - used)]
    report = Report(target="concurrency:control-plane",
                    findings=findings, suppressed=suppressed,
                    passes_run=(PASS_NAME,))
    return report, unused


def concurrency_section() -> dict:
    """The doctor report's ``concurrency`` block: the static sweep and the
    deterministic sanitizer self-test (barrier-stepped, no real thread
    timing, so the block is reproducible)."""
    out: dict = {}
    try:
        report, unused = sweep_control_plane()
        out["sweep"] = {
            "ok": report.ok and not unused,
            "modules": list(CONTROL_PLANE_MODULES),
            "findings": [f.format() for f in report.findings],
            "suppressed": [f.format() for f in report.suppressed],
            "unused_allowlist": unused,
        }
    except Exception as e:  # noqa: BLE001
        out["sweep"] = {"ok": False, "error": repr(e)}
    try:
        from .lock_sanitizer import sanitizer_self_test

        out["sanitizer"] = sanitizer_self_test()
    except Exception as e:  # noqa: BLE001
        out["sanitizer"] = {"ok": False, "error": repr(e)}
    return out
