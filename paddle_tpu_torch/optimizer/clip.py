"""Gradient clipping (mirror of ``paddle_tpu/optimizer/clip.py``).

A clip is called as ``clip(params, grads) -> grads`` over two lists of one
length, ``None`` for a parameter without a gradient.  As in the JAX
package, ``ClipGradByValue`` and ``ClipGradByNorm`` clip every gradient,
and ``ClipGradByGlobalNorm`` leaves out of the norm, and unscaled, every
parameter whose ``need_clip`` attribute is False.  The norms are taken in
fp32 and each gradient comes back in its own dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class GradClipBase:
    def __call__(self, params, grads):
        raise NotImplementedError


def _factor(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """clip_norm / norm where the norm exceeds clip_norm, else 1."""
    return torch.where(norm > clip_norm,
                       clip_norm / torch.clamp(norm, min=1e-12),
                       torch.ones_like(norm))


class ClipGradByValue(GradClipBase):
    def __init__(self, max, min=None):  # noqa: A002
        self.max = max
        self.min = -max if min is None else min

    def __call__(self, params, grads):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(GradClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params, grads):
        out = []
        for g in grads:
            if g is None:
                out.append(None)
                continue
            gf = g.float()
            out.append((gf * _factor(torch.linalg.vector_norm(gf),
                                     self.clip_norm)).to(g.dtype))
        return out


class ClipGradByGlobalNorm(GradClipBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm

    def __call__(self, params, grads):
        sq = [torch.sum(torch.square(g.float()))
              for p, g in zip(params, grads)
              if g is not None and getattr(p, "need_clip", True)]
        if not sq:
            return grads
        factor = _factor(torch.sqrt(torch.sum(torch.stack(sq))),
                         self.clip_norm)
        return [g if g is None or not getattr(p, "need_clip", True)
                else (g.float() * factor).to(g.dtype)
                for p, g in zip(params, grads)]


def clip_grads_functional(grads: Dict[str, Optional[torch.Tensor]],
                          clip_norm: float
                          ) -> Tuple[Dict[str, Optional[torch.Tensor]],
                                     torch.Tensor]:
    """Global-norm clip of a gradient dict for the functional train step:
    (clipped grads, the global norm before clipping)."""
    leaves = [g for g in grads.values() if g is not None]
    norm = torch.sqrt(sum((torch.sum(torch.square(g.float()))
                           for g in leaves), torch.zeros(())))
    factor = _factor(norm, clip_norm)
    return ({k: None if g is None else (g.float() * factor).to(g.dtype)
             for k, g in grads.items()}, norm)
