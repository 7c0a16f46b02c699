"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100, ``sm_90a``).

The JAX package ``paddle_tpu`` stays the reference.  This package mirrors
its layout (``models/``, ``ops/``, ``inference/``, ``incubate/``,
``optimizer/``, ``parallel/``, ``csrc/``) so each port
module sits where its counterpart sits, and it imports neither ``jax`` nor
anything of ``paddle_tpu``.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.  On a
CUDA tensor every kernel wrapper launches its hand-written kernel or
raises; only a tensor that lies on the CPU takes the kernel's plain
PyTorch version.  Kernels are compiled from ``csrc/`` at their first CUDA
call, never at import time.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
