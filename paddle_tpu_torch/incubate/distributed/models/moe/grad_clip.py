"""MoE-aware global-norm gradient clipping (mirror of
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``).

On one device every expert parameter is whole, so the expert norm needs
no reduction over an expert-parallel group; the class still splits the
expert and dense norms so that both stay observable (``last_global_norm``,
``last_moe_norm``), as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .....optimizer.clip import GradClipBase, _factor


def _is_expert_param_default(p) -> bool:
    return bool(getattr(p, "is_expert", False)
                or getattr(p, "no_sync", False))


class ClipGradForMOEByGlobalNorm(GradClipBase):
    """Global-norm clip with the expert/dense split: the norm is
    sqrt(expert sum of squares + dense sum of squares) over the gradients
    of parameters with ``need_clip`` (default True), each gradient scaled
    by clip_norm / norm when the norm exceeds clip_norm; parameters with
    ``need_clip=False`` pass through.  ``is_expert_param_func(p)`` picks
    the expert parameters (default: ``is_expert`` or ``no_sync``, as
    ``MoELayer`` flags its banks); ``moe_group`` is accepted for the API."""

    def __init__(self, clip_norm: float,
                 is_expert_param_func: Optional[Callable] = None,
                 moe_group=None, group_name: str = "default_moe_group"):
        self.clip_norm = float(clip_norm)
        self.is_expert_param = is_expert_param_func or _is_expert_param_default
        self.moe_group = moe_group
        self.last_global_norm = None
        self.last_moe_norm = None

    @staticmethod
    def _sq_sum(pairs, device):
        terms = [torch.sum(torch.square(g.float())) for _, g in pairs]
        if not terms:
            return torch.zeros((), dtype=torch.float32, device=device)
        return torch.sum(torch.stack(terms))

    def __call__(self, params, grads):
        dense, expert = [], []
        for p, g in zip(params, grads):
            if g is None or not getattr(p, "need_clip", True):
                continue
            (expert if self.is_expert_param(p) else dense).append((p, g))
        live = [g for g in grads if g is not None]
        device = live[0].device if live else None
        moe_sq = self._sq_sum(expert, device)
        global_norm = torch.sqrt(moe_sq + self._sq_sum(dense, device))
        self.last_moe_norm = float(torch.sqrt(moe_sq))
        self.last_global_norm = float(global_norm)
        factor = _factor(global_norm, self.clip_norm)
        return [g if g is None or not getattr(p, "need_clip", True)
                else (g.float() * factor).to(g.dtype)
                for p, g in zip(params, grads)]
