"""Ulysses segment parallelism (the reference's ``sep`` axis).

Port of ``paddle_tpu/parallel/sep.py`` (``ulysses_attention``): for a
sequence cut over ``axis``, attention runs as a tiled all-to-all from
sequence to heads, full-sequence causal flash attention on h/P heads (the
port's ``flash_attention``, the mirror of ``flash_attention_raw``: B1/B2 on
the card where its head-batched predicate holds, else B5/B6), and the
inverse all-to-all.  Two all-to-alls replace the P^2 point-to-point
exchanges of a naive scheme; h and kvh must divide by P (DeepSpeed-Ulysses'
constraint; ring attention covers the rest).  The all-to-alls are
``compat.all_to_all``, whose backward is the swapped exchange; over an axis
of size 1 they are the identity, and the call is ``flash_attention``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import compat as _compat
from .compat import _size


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str = "sep", causal: bool = True,
                      scale: Optional[float] = None, *,
                      mesh) -> torch.Tensor:
    """Attention for q [b, s_local, h, d], k/v [b, s_local, kvh, d], this
    rank's blocks of a sequence cut over ``axis`` of the live ``mesh``.
    Requires h and kvh divisible by the axis size.  Returns [b, s_local, h,
    d]."""
    from ..ops.flash_attention import flash_attention

    p = _size(mesh, axis)
    h, kvh = q.shape[2], k.shape[2]
    if h % p or kvh % p:
        raise ValueError(f"heads ({h}, kv {kvh}) must divide sep degree {p}")

    def seq_to_heads(x):          # [b, s/P, h, d] -> [b, s, h/P, d]
        return _compat.all_to_all(x, axis, 2, 1, tiled=True, mesh=mesh)

    def heads_to_seq(x):
        return _compat.all_to_all(x, axis, 1, 2, tiled=True, mesh=mesh)

    og = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                         causal=causal, scale=scale)
    return heads_to_seq(og)


__all__ = ["ulysses_attention"]
