"""LayerNorm (mirror of ``paddle_tpu/nn/norm.py :: LayerNorm``; the rest of
the norm layers is ROADMAP A8)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import DeviceLike, resolve_device


class LayerNorm(nn.Module):
    """Normalisation over the trailing ``normalized_shape`` axes: the
    statistics and the normalised value in fp32, cast to x's dtype, then
    the gain and the bias in that dtype (the JAX ``layer_norm`` op's
    order).  ``weight_attr=False`` / ``bias_attr=False`` drop them."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        if weight_attr is False:
            self.register_parameter("weight", None)
        else:
            self.weight = nn.Parameter(torch.ones(
                self._normalized_shape, device=dev, dtype=dtype))
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(torch.zeros(
                self._normalized_shape, device=dev, dtype=dtype))

    def forward(self, x):
        axes = tuple(range(x.dim() - len(self._normalized_shape), x.dim()))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        out = ((xf - mean) * torch.rsqrt(var + self._epsilon)).to(x.dtype)
        if self.weight is not None:
            out = out * self.weight
        if self.bias is not None:
            out = out + self.bias
        return out
