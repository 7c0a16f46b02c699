"""The MoE stack of the port on one device (mirror of
``paddle_tpu/incubate/distributed/models/moe``): the gates, ``MoELayer``
and the MoE-aware clip; ``pipelined.py`` holds the single-device
reference of the pipelined blocks."""

from .gate import GShardGate, NaiveGate, SwitchGate
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import MoELayer

__all__ = ["GShardGate", "NaiveGate", "SwitchGate",
           "ClipGradForMOEByGlobalNorm", "MoELayer"]
