"""The MoE stack of the port (mirror of
``paddle_tpu/incubate/distributed/models/moe``): the gates, ``MoELayer``
and the MoE-aware clip; ``pipelined.py`` holds the pipelined MoE blocks
over a pp x ep x mp mesh and their single-device reference."""

from .gate import GShardGate, NaiveGate, SwitchGate
from .grad_clip import ClipGradForMOEByGlobalNorm
from .moe_layer import MoELayer

__all__ = ["GShardGate", "NaiveGate", "SwitchGate",
           "ClipGradForMOEByGlobalNorm", "MoELayer"]
