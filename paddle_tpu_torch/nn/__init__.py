"""Neural-network functions of the port (mirror of ``paddle_tpu/nn``; the
attention entries of ``nn.functional`` so far)."""

from . import functional

__all__ = ["functional"]
