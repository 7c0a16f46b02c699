"""The hand-written kernels as registered operators.

Each kernel launcher (B1-B8) is one operator of the ``paddle_tpu_torch``
namespace, defined through the low-level ``torch.library.Library`` API
(``define`` + ``impl`` per dispatch key + ``register_fake``) and called as
``torch.ops.paddle_tpu_torch.<name>.default``:

- the ``CUDA`` implementation is the ctypes launch of the kernel (it counts
  the launch in its module's ``LAUNCHES``);
- the ``CPU`` implementation is the kernel's ``*_plain`` twin;
- the fake implementation gives the outputs' shapes and dtypes and touches
  no data, so a capture on fake tensors (``analysis/core.py``) records the
  kernel as one graph node on either device and launches nothing.

The wrappers (``hb_flash_forward``, ``paged_decode``, ...) keep their
argument checks and call the operator; the autograd functions
(``_FlashHB``, ``_Flash``, ``_GroupedMatmul``) call the forward and
backward operators, so a gradient flows as before.

``SCRATCH`` holds, per operator, the device bytes its CUDA implementation
allocates beside its outputs (partials, live-tile tables, fp32 staging),
from the shapes alone: the capture's static peak adds them at the node.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

NAMESPACE = "paddle_tpu_torch"
# FRAGMENT: ``parallel/memory.py`` defines its tag op in the same namespace
LIB = torch.library.Library(NAMESPACE, "FRAGMENT")

#: operator name -> the TPU kernel it ports (PERF.md's table)
KERNELS: Dict[str, str] = {}
#: operator name -> fn(*args) -> device bytes of the CUDA implementation's
#: scratch, beside its outputs
SCRATCH: Dict[str, Callable[..., int]] = {}


def define(name: str, schema: str, *, kernel: str, cpu: Callable,
           cuda: Callable, fake: Callable,
           scratch: Optional[Callable[..., int]] = None):
    """Register operator ``name`` (``schema`` is its argument and return
    list) and return its overload ``torch.ops.paddle_tpu_torch.<name>
    .default``."""
    LIB.define(name + schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    KERNELS[name] = kernel
    if scratch is not None:
        SCRATCH[name] = scratch
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def kernel_op(target) -> Optional[str]:
    """The operator name when ``target`` (a graph node's target) is one of
    the registered kernels, else None."""
    if not isinstance(target, torch._ops.OpOverload):
        return None
    ns, _, name = target._schema.name.partition("::")
    return name if ns == NAMESPACE and name in KERNELS else None


__all__ = ["KERNELS", "LIB", "NAMESPACE", "SCRATCH", "define", "kernel_op"]
