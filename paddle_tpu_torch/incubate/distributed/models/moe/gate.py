"""MoE gates (mirror of ``paddle_tpu/incubate/distributed/models/moe/
gate.py``).

Each gate maps token probabilities to the GShard masks: combine weights
[G, E, C] and the dispatch mask [G, E, C], with per-expert capacity C.  The
mask math lives in plain functions; the gate classes hold the gate weight
(zeros at init, as in JAX) and the aux-loss choice.

Routing rests on ``argmax``'s first-index rule for ties (a zero gate makes
every probability equal, so token t goes to experts 0, then 1), which
``torch.argmax`` keeps on the CPU and on CUDA as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .....device import DeviceLike, resolve_device


def moe_capacity(num_tokens: int, topk: int, num_expert: int,
                 capacity_factor: float) -> int:
    """The per-expert slot count (the same Python float expression, in the
    same order, as the JAX ``moe_capacity``), shared by the gates and the
    capacity EP block."""
    return int(capacity_factor * num_tokens * topk / num_expert + 1)


def load_balance_aux_loss(probs):
    """GShard eq. (4) / Switch: E * sum(top-1 token fraction * mean prob)."""
    e = probs.shape[-1]
    frac = F.one_hot(probs.argmax(dim=-1), e).to(torch.float32).mean(dim=0)
    return e * (frac * probs.mean(dim=0)).sum()


def zero_aux_loss(probs):
    return torch.zeros((), dtype=torch.float32, device=probs.device)


def top_k_masks(probs, topk: int, capacity: int):
    """Greedy top-k routing with per-expert capacity: (combine, dispatch),
    each [G, E, C] fp32; assignments past an expert's capacity are
    dropped."""
    combine, dispatch, _ = top_k_masks_with_drops(probs, topk, capacity)
    return combine, dispatch


def top_k_masks_with_drops(probs, topk: int, capacity: int):
    """``top_k_masks`` plus ``dropped``, the int32 count of (token, expert)
    assignments refused by the capacity.  Each of the ``topk`` rounds takes
    the argmax of what is left, gives each token the running slot count of
    its expert (tokens in order, after the earlier rounds' assignments),
    keeps it below ``capacity``, and adds the token's raw probability at
    its slot.  The one-hot slot tensor of the JAX loop is a scatter here
    (the same values, without an int64 [G, E, C] one-hot)."""
    g, e = probs.shape
    dev = probs.device
    combine = torch.zeros((g, e, capacity), dtype=torch.float32, device=dev)
    dispatch = torch.zeros_like(combine)
    remaining = probs
    position_in_expert = torch.zeros(e, dtype=torch.int32, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(topk):
        mask = F.one_hot(remaining.argmax(dim=-1), e).to(torch.float32)
        # a token's slot within its expert: the running prefix count
        pos = (mask.cumsum(dim=0) - 1) * mask + position_in_expert * mask
        keep = (pos < capacity) & (mask > 0)
        dropped = dropped + ((mask > 0) & ~keep).sum().to(torch.int32)
        w = (probs * mask).sum(dim=-1, keepdim=True)      # [G, 1]
        slot = torch.where(keep, pos.to(torch.int64), 0)
        sel = torch.zeros_like(combine).scatter_(
            2, slot[..., None], keep.to(torch.float32)[..., None])
        combine = combine + w[..., None] * sel
        dispatch = torch.maximum(dispatch, sel)
        position_in_expert = position_in_expert + mask.sum(dim=0).to(
            torch.int32)
        remaining = remaining * (1.0 - mask)
    return combine, dispatch, dropped


class NaiveGate(nn.Module):
    """Top-k softmax gate, no aux loss (mirror of ``NaiveGate``): weight
    [d_model, num_expert * world_size], zeros."""

    aux_loss_fn = staticmethod(zero_aux_loss)

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, device: DeviceLike = None):
        super().__init__()
        self.num_expert = num_expert * world_size
        self.topk = topk
        self.weight = nn.Parameter(torch.zeros(
            (d_model, self.num_expert), dtype=torch.float32,
            device=resolve_device(device)))

    def capacity(self, num_tokens: int, capacity_factor: float) -> int:
        return moe_capacity(num_tokens, self.topk, self.num_expert,
                            capacity_factor)


class GShardGate(NaiveGate):
    """Top-2 gate with the load-balancing aux loss (mirror of
    ``GShardGate``)."""

    aux_loss_fn = staticmethod(load_balance_aux_loss)

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 2, capacity=(1.2, 2.4), group=None,
                 device: DeviceLike = None):
        super().__init__(d_model, num_expert, world_size, topk=topk,
                         device=device)


class SwitchGate(NaiveGate):
    """Top-1 gate (mirror of ``SwitchGate``): ``topk`` is forced to 1."""

    aux_loss_fn = staticmethod(load_balance_aux_loss)

    def __init__(self, d_model: int, num_expert: int, world_size: int = 1,
                 topk: int = 1, capacity=(1.2, 2.4), group=None,
                 device: DeviceLike = None):
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device)
