"""Linear, Embedding and GELU layers (mirror of ``paddle_tpu/nn/common.py``:
only what GPT-MoE is built from; the rest of ``nn/`` is ROADMAP A8).

Parameters keep Paddle's names and layouts: a Linear weight is ``[in,
out]`` (``y = x @ W + b``), so a JAX state dict crosses through numpy with
no transpose.  Initial values come from the port's default generator
(``ops/random.py``: ``paddle.seed`` reseeds it), drawn as the JAX
initializers draw them: Xavier-uniform Linear weights and zero biases,
Normal(0, 1) embeddings.  The bits differ from ``jax.random``'s.  Layers
live on ``device`` (``None``: the GPU, as every entry point of the port).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops import random as _random


def _attr_unsupported(layer: str, **attrs) -> None:
    for name, value in attrs.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{layer}: {name}={value!r} (initializer objects and "
                f"ParamAttr) belongs to the nn breadth, ROADMAP queue A8")


class Linear(nn.Module):
    """``y = x @ W + b`` with ``W`` [in, out] (mirror of ``Linear``);
    ``bias_attr=False`` leaves no bias."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _attr_unsupported("Linear", weight_attr=weight_attr,
                          bias_attr=bias_attr)
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        gen = _random.default_generator().generator(dev)
        w = torch.empty((in_features, out_features), device=dev).uniform_(
            -limit, limit, generator=gen)
        self.weight = nn.Parameter(w.to(dtype))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(out_features, device=dev,
                                                 dtype=dtype))

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        return out if self.bias is None else out + self.bias

    def extra_repr(self) -> str:
        return f"in={self.in_features}, out={self.out_features}"


class Embedding(nn.Module):
    """Row lookup (mirror of ``Embedding``): Normal(0, 1) rows, the
    ``padding_idx`` row zero at init and its lookups zero."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        _attr_unsupported("Embedding", weight_attr=weight_attr)
        dev = resolve_device(device)
        self._padding_idx = padding_idx
        w = torch.empty((num_embeddings, embedding_dim), device=dev).normal_(
            0.0, 1.0, generator=_random.default_generator().generator(dev))
        if padding_idx is not None:
            w[padding_idx] = 0.0
        self.weight = nn.Parameter(w.to(dtype))

    def forward(self, x):
        ids = torch.as_tensor(x, device=self.weight.device).long()
        out = self.weight[ids]
        if self._padding_idx is not None:
            out = torch.where((ids == self._padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out


class GELU(nn.Module):
    """Mirror of ``nn.GELU``: the exact erf form by default
    (``approximate=False``), unlike ``jax.nn.gelu``'s tanh default that the
    MoE experts use."""

    def __init__(self, approximate: bool = False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate="tanh" if self.approximate else "none")
