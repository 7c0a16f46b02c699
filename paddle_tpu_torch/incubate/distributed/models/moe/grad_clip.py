"""MoE-aware global-norm gradient clipping (mirror of
``paddle_tpu/incubate/distributed/models/moe/grad_clip.py``).

The norm must count each element once across the ranks.  JAX sums the
squares of a sharded global array; here each rank holds blocks, so each
parameter's sum of squares is summed over the mesh axes its block is cut
along (``ep`` for the expert stacks, and ``mp`` where their hidden is cut:
the reference's all-reduce over the ``moe_group``; ``mp`` for a cut dense
weight) before the expert and dense parts combine.  A parameter's placement
is read from its gradient when that is a ``ShardedTensor``, else from the
parameter's ``placement`` (the ``NamedSharding`` that ``MoELayer(mesh=)``
and ``apply_gpt_moe_sharding`` set); on one device nothing is summed.  The
expert and dense norms both stay observable (``last_global_norm``,
``last_moe_norm``), as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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
    def _cut(p, g) -> Tuple[object, Tuple[str, ...]]:
        """(mesh, the axes of size > 1 the block is cut along) of one
        gradient, or (None, ()) for a whole tensor."""
        from .....parallel.specs import ShardedTensor

        if isinstance(g, ShardedTensor):
            return g.mesh, tuple(sorted(g.axes_at_rest()))
        ns = getattr(p, "placement", None)
        if ns is None:
            return None, ()
        axes = sorted({a for e in ns.spec for a in
                       (e if isinstance(e, tuple) else (e,))
                       if a is not None and ns.mesh.shape.get(a, 1) > 1})
        return ns.mesh, tuple(axes)

    def _sq_sum(self, pairs, device):
        """The global sum of squares of ``pairs``: the local sums of the
        blocks cut alike, each group summed over its axes."""
        from .....parallel.compat import all_reduce_raw

        groups: Dict[Tuple[int, Tuple[str, ...]], list] = {}
        meshes = {}
        for p, g in pairs:
            mesh, axes = self._cut(p, g)
            local = getattr(g, "local", g)
            key = (id(mesh), axes)
            meshes[key] = mesh
            groups.setdefault(key, []).append(
                torch.sum(torch.square(local.float())))
        total = torch.zeros((), dtype=torch.float32, device=device)
        for key, terms in groups.items():
            t = torch.sum(torch.stack(terms))
            for a in key[1]:
                t = all_reduce_raw(t, a, meshes[key])
            total = total + t
        return total

    def __call__(self, params, grads):
        dense, expert = [], []
        for p, g in zip(params, grads):
            if g is None or not getattr(p, "need_clip", True):
                continue
            (expert if self.is_expert_param(p) else dense).append((p, g))
        live = [getattr(g, "local", g) for g in grads if g is not None]
        device = live[0].device if live else None
        moe_sq = self._sq_sum(expert, device)
        global_norm = torch.sqrt(moe_sq + self._sq_sum(dense, device))
        self.last_moe_norm = float(torch.sqrt(moe_sq))
        self.last_global_norm = float(global_norm)
        factor = _factor(global_norm, self.clip_norm)

        def scaled(g):
            local = getattr(g, "local", g)
            out = (local.float() * factor).to(local.dtype)
            return g.with_local(out) if hasattr(g, "with_local") else out

        return [g if g is None or not getattr(p, "need_clip", True)
                else scaled(g) for p, g in zip(params, grads)]
