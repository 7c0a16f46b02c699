"""Sequential and LayerList (mirror of ``paddle_tpu/nn/container.py``):
children named ``"0"``, ``"1"``, ... as Paddle names them, so parameter
names such as ``blocks.0.mlp.2.weight`` match the JAX model's."""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable

from torch import nn


class Sequential(nn.Sequential):
    """Layers applied in order; takes layers, ``(name, layer)`` tuples or
    one ``OrderedDict``, as Paddle's ``Sequential``."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
        elif any(isinstance(layer, tuple) for layer in layers):
            super().__init__(OrderedDict(
                layer if isinstance(layer, tuple) else (str(i), layer)
                for i, layer in enumerate(layers)))
        else:
            super().__init__(*layers)


class LayerList(nn.ModuleList):
    """A list of layers (Paddle's ``LayerList``)."""

    def __init__(self, sublayers: Iterable[nn.Module] = ()):
        super().__init__(sublayers)
