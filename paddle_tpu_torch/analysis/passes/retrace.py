"""RT - the retrace sentinel.

Port of ``paddle_tpu/analysis/passes/retrace.py``.  Call-driven, as in JAX:
one capture cannot show signature churn, so the sentinel wraps a callable,
fingerprints every call's signature and reports typed findings.

    step = retrace_sentinel(build_train_step(...))
    ... run ...
    step.report().raise_if_findings()

A Python scalar is JAX's weak type (``float32``/``int32``, weak; a bool is
``bool``, strong); a tensor or numpy array is strong.  The port runs
eagerly and compiles nothing, so there is no compilation count to soften
RT001 with, as JAX's sentinel does: the churn costs any compiled caller
(a CUDA graph, a ``torch.compile`` wrapper) one capture per flip.

Codes:
- RT001: two call signatures identical but for weak-type flags;
- RT002: more distinct signatures than ``max_signatures``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..findings import Finding, Report


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaf_sig(x) -> Tuple:
    """(kind, shape, dtype, weak) fingerprint of one argument leaf."""
    if isinstance(x, torch.Tensor):
        return ("array", tuple(x.shape), _dtype_name(x.dtype), False)
    if isinstance(x, np.ndarray):
        return ("array", tuple(x.shape), str(x.dtype), False)
    if isinstance(x, np.generic):
        return ("array", (), str(x.dtype), False)
    if isinstance(x, bool):
        return ("array", (), "bool", False)
    if isinstance(x, int):
        return ("array", (), "int32", True)
    if isinstance(x, float):
        return ("array", (), "float32", True)
    return ("static", repr(x), "", False)


class RetraceSentinel:
    """Wraps a callable; counts call signatures and flags weak-type and
    static-argument churn.  ``max_signatures`` bounds healthy signature
    diversity (bucketed prefill lengths are a handful; hundreds are
    churn)."""

    def __init__(self, fn, max_signatures: int = 8,
                 name: Optional[str] = None):
        self._fn = fn
        self._max = int(max_signatures)
        self.name = name or getattr(fn, "__name__", repr(fn))
        self.signatures: Dict[Tuple, int] = {}
        self._findings: List[Finding] = []
        self._rt002_emitted = False
        functools.update_wrapper(self, fn, updated=())

    def _signature(self, args, kwargs) -> Tuple:
        leaves, spec = pytree.tree_flatten((args, kwargs))
        return (str(spec),) + tuple(_leaf_sig(x) for x in leaves)

    @staticmethod
    def _strip_weak(sig: Tuple) -> Tuple:
        return (sig[0],) + tuple(leaf[:3] for leaf in sig[1:])

    def __call__(self, *args, **kwargs):
        sig = self._signature(args, kwargs)
        fresh = sig not in self.signatures
        self.signatures[sig] = self.signatures.get(sig, 0) + 1
        if fresh:
            self._on_new_signature(sig)
        return self._fn(*args, **kwargs)

    def _on_new_signature(self, sig: Tuple):
        stripped = self._strip_weak(sig)
        twins = [s for s in self.signatures
                 if s != sig and self._strip_weak(s) == stripped]
        if twins:
            diffs = [i - 1 for i, (a, b) in
                     enumerate(zip(sig, twins[0])) if a != b]
            self._findings.append(Finding(
                code="RT001", pass_name="retrace_sentinel",
                message=(
                    f"{self.name}: call signature differs from an earlier "
                    f"one ONLY in weak-type flags (leaf index(es) {diffs}): "
                    f"a Python scalar and a tensor alternate in the same "
                    f"position, and every compiled caller (a CUDA graph, "
                    f"torch.compile) recaptures on each flip.  Pin the "
                    f"caller to one form (e.g. torch.tensor(lr, "
                    f"dtype=torch.float32))"),
                data={"leaves": diffs}))
        if len(self.signatures) > self._max and not self._rt002_emitted:
            self._rt002_emitted = True
            self._findings.append(Finding(
                code="RT002", pass_name="retrace_sentinel",
                message=(
                    f"{self.name}: {len(self.signatures)} distinct call "
                    f"signatures (> max_signatures={self._max}): shape or "
                    f"static-argument churn; bucket dynamic lengths and "
                    f"hoist per-call objects out of the signature"),
                data={"count": len(self.signatures)}))

    def report(self) -> Report:
        return Report(target=self.name, findings=list(self._findings),
                      passes_run=("retrace_sentinel",))


def retrace_sentinel(fn, max_signatures: int = 8,
                     name: Optional[str] = None) -> RetraceSentinel:
    return RetraceSentinel(fn, max_signatures=max_signatures, name=name)
