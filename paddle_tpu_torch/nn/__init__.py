"""Neural-network functions of the port (mirror of ``paddle_tpu/nn``; the
attention and dropout entries of ``nn.functional`` so far)."""

from . import functional

__all__ = ["functional"]
