"""Neural-network layers and functions of the port (mirror of
``paddle_tpu/nn``): the layers GPT-MoE is built from (``Linear``,
``Embedding``, ``GELU``, ``LayerNorm``, ``Sequential``, ``LayerList``) and
the attention and dropout entries of ``nn.functional``; the rest is
ROADMAP A8."""

from . import functional
from .common import GELU, Embedding, Linear
from .container import LayerList, Sequential
from .norm import LayerNorm

__all__ = ["functional", "GELU", "Embedding", "Linear", "LayerList",
           "LayerNorm", "Sequential"]
