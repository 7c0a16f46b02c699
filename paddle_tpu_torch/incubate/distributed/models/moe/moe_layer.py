"""The MoE layer (mirror of ``paddle_tpu/incubate/distributed/models/moe/
moe_layer.py``): ``MoELayer`` over stacked expert weights ``[E, ...]``,
with two forward ops.

- The capacity op (``_moe_forward_op``) is the GShard masked einsum, as
  in JAX: dispatch ``gec,gm->ecm``, the expert FFN, combine
  ``gec,ecm->gm``.  JAX leaves these einsums to XLA, so they are
  ``torch.einsum`` here.
- The dropless op (``_moe_dropless_op``) replaces JAX's ``lax.ragged_dot``
  with the port's grouped-matmul kernels (``ops/grouped_matmul.py``: B7
  forward and dx, B8 dW): token copies sorted by expert (stable), segments
  aligned to ``block_rows``, alignment rows masked out.

Both route on the fp32 router softmax of ``x @ gate_w`` (each cast to fp32
first) and combine with the RAW top-k probabilities, not renormalised
(only ``fused_moe`` renormalises).  The expert FFN's gelu is
``jax.nn.gelu``'s default, the tanh form, unlike ``nn.GELU``'s exact one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .....device import DeviceLike, resolve_device
from .....ops.grouped_matmul import (align_rows, grouped_matmul,
                                     sorted_segments)
from .gate import GShardGate, NaiveGate, SwitchGate, top_k_masks_with_drops

# the dropless op's segment alignment quantum (the kernels' row block)
DROPLESS_BLOCK_ROWS = 8


def _activation(h, kind: str):
    """The expert FFN's activation: ``jax.nn.gelu`` (approximate=True, the
    tanh form), relu, or swiglu on the halves of ``h``."""
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "relu":
        return F.relu(h)
    if kind == "swiglu":
        a, b = h.chunk(2, dim=-1)
        return F.silu(a) * b
    raise ValueError(f"activation {kind!r}")


def _promoted(a, b):
    """``a`` and ``b`` in their promoted dtype (jnp.einsum promotes mixed
    operands, torch.einsum refuses them)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _router(x2d, gate_w):
    """The fp32 router probabilities [G, E]."""
    return torch.softmax(x2d.float() @ gate_w.float(), dim=-1)


def top_k_sorted(probs, k: int):
    """``lax.top_k``: the k largest per row, ties to the lowest index (a
    stable descending sort; ``torch.topk`` does not promise the tie
    order)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], ids[:, :k]


def _moe_forward_op(x2d, gate_w, w_up, b_up, w_down, b_down, *, topk: int,
                    capacity: int, aux_fn=None, activation: str = "gelu"):
    """The capacity (GShard masked-einsum) MoE FFN.  x2d [G, m]; gate_w
    [m, E]; w_up [E, m, h]; w_down [E, h, m].  Returns (y [G, m], aux,
    dropped): the fp32 count of assignments the capacity refused, with no
    gradient."""
    probs = _router(x2d, gate_w)
    combine, dispatch, dropped = top_k_masks_with_drops(probs, topk,
                                                        capacity)
    aux = (aux_fn(probs) if aux_fn is not None
           else torch.zeros((), dtype=torch.float32, device=x2d.device))
    cdt = combine.to(x2d.dtype)
    ddt = dispatch.to(x2d.dtype)
    expert_in = torch.einsum("gec,gm->ecm", ddt, x2d)
    h = torch.einsum("ecm,emh->ech", *_promoted(expert_in, w_up))
    h = _activation(h + b_up[:, None, :], activation)
    eo = torch.einsum("ech,ehm->ecm", *_promoted(h, w_down))
    eo = eo + b_down[:, None, :]
    y = torch.einsum("gec,ecm->gm", *_promoted(cdt, eo))
    return y, aux, dropped.detach().to(torch.float32)


def dropless_experts(x2d, top_p, top_ids, w_up, b_up, w_down, b_down,
                     activation: str = "gelu",
                     block_rows: int = DROPLESS_BLOCK_ROWS):
    """The routed expert FFN of the dropless path on the grouped-matmul
    kernels: the token copies (top_ids [G, k]) sorted by expert, stably,
    into block-aligned segments; up and down products (B7, dx B7, dW B8);
    the per-expert biases gathered; rows past the last segment masked; each
    copy's output weighted by its raw probability and added back in token
    order.  Weights and biases are cast to x2d's dtype, as the JAX op
    casts them."""
    g, m = x2d.shape
    e, bm = w_up.shape[0], int(block_rows)
    dev = x2d.device
    order, sorted_ids, counts, seg_st, dest, rpad = sorted_segments(
        top_ids, e, bm)
    token_of = order // top_ids.shape[1]
    wsorted = top_p.reshape(-1)[order]
    xr = torch.zeros((rpad, m), dtype=x2d.dtype, device=dev).index_copy(
        0, dest, x2d[token_of])
    # rexp maps a padded row to its expert (bias gather); rows past the
    # last segment are masked, which also zeroes their backward flow
    blk_cum = torch.cumsum(align_rows(counts, bm), 0)
    rows = torch.arange(rpad, device=dev)
    rexp = torch.searchsorted(blk_cum, rows, right=True).clamp(max=e - 1)
    row_valid = (rows < blk_cum[-1])[:, None]
    wids = torch.arange(e, dtype=torch.int32, device=dev)
    h = grouped_matmul(xr, w_up.to(x2d.dtype), seg_st, counts, wids, bm)
    h = torch.where(row_valid, h + b_up.to(h.dtype)[rexp], 0.0)
    h = _activation(h, activation)
    eo = grouped_matmul(h, w_down.to(h.dtype), seg_st, counts, wids, bm)
    back = (eo[dest] + b_down.to(eo.dtype)[sorted_ids]).to(x2d.dtype)
    return torch.zeros((g, m), dtype=x2d.dtype, device=dev).index_add(
        0, token_of, back * wsorted.to(x2d.dtype)[:, None])


def _moe_dropless_op(x2d, gate_w, w_up, b_up, w_down, b_down, *, topk: int,
                     aux_fn=None, activation: str = "gelu"):
    """The dropless MoE FFN (capacity = infinity): every routed copy goes
    through its expert (``dropless_experts``).  Returns (y [G, m], aux,
    dropped = 0)."""
    probs = _router(x2d, gate_w)
    aux = (aux_fn(probs) if aux_fn is not None
           else torch.zeros((), dtype=torch.float32, device=x2d.device))
    top_p, top_ids = top_k_sorted(probs, topk)
    y = dropless_experts(x2d, top_p, top_ids, w_up, b_up, w_down, b_down,
                         activation)
    return y, aux, torch.zeros((), dtype=torch.float32, device=x2d.device)


def _single_device_mesh(mesh, what: str) -> None:
    if mesh is not None and int(np.prod(getattr(mesh, "shape", (1,)))) > 1:
        raise NotImplementedError(
            f"{what}: expert parallelism over a multi-device mesh belongs "
            f"to multi-GPU training, ROADMAP queue A5.3")


class MoELayer(nn.Module):
    """Drop-in MoE FFN (mirror of ``MoELayer``): stacked expert weights
    ``w_up`` [E, m, h], ``b_up``, ``w_down`` [E, h, m], ``b_down``, drawn
    as JAX draws them (``np.random.RandomState(0)``, so a port layer and a
    JAX layer start bit-equal) and flagged ``is_expert`` for
    ``ClipGradForMOEByGlobalNorm``; the gate's weight starts at zeros.
    ``l_aux`` holds the last forward's aux loss and ``tokens_dropped`` its
    fp32 count of assignments the capacity refused (0 when dropless).  A
    mesh of more than one device raises (ROADMAP A5.3)."""

    GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}

    def __init__(self, d_model: int, d_hidden: int, num_expert: int = 8,
                 gate="gshard", top_k: int = 2,
                 capacity_factor: float = 1.2, activation: str = "gelu",
                 mesh=None, ep_axis: str = "ep",
                 mp_axis: Optional[str] = None, moe_group=None,
                 recompute_interval: int = 0, dropless: bool = False,
                 device: DeviceLike = None):
        super().__init__()
        _single_device_mesh(mesh, "MoELayer")
        dev = resolve_device(device)
        if isinstance(gate, str):
            topk = 1 if gate == "switch" else top_k
            self.gate = self.GATES[gate](d_model, num_expert, topk=topk,
                                         device=dev)
        else:
            self.gate = gate
        self.num_expert = num_expert
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.dropless = dropless
        self.l_aux = None
        self.tokens_dropped = None
        scale = 1.0 / (d_model ** 0.5)
        rng = np.random.RandomState(0)

        def param(a):
            return nn.Parameter(torch.from_numpy(
                np.asarray(a, np.float32)).to(dev))

        self.w_up = param(rng.randn(num_expert, d_model, d_hidden) * scale)
        self.b_up = param(np.zeros((num_expert, d_hidden)))
        self.w_down = param(rng.randn(num_expert, d_hidden, d_model) * scale)
        self.b_down = param(np.zeros((num_expert, d_model)))
        for p in (self.w_up, self.b_up, self.w_down, self.b_down):
            p.is_expert = True

    def forward(self, x):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        aux_fn = self.gate.aux_loss_fn
        if self.dropless:
            y, aux, dropped = _moe_dropless_op(
                x2d, self.gate.weight, self.w_up, self.b_up, self.w_down,
                self.b_down, topk=self.gate.topk, aux_fn=aux_fn,
                activation=self.activation)
        else:
            capacity = self.gate.capacity(x2d.shape[0], self.capacity_factor)
            y, aux, dropped = _moe_forward_op(
                x2d, self.gate.weight, self.w_up, self.b_up, self.w_down,
                self.b_down, topk=self.gate.topk, capacity=capacity,
                aux_fn=aux_fn, activation=self.activation)
        self.l_aux = aux
        self.tokens_dropped = dropped
        return y.reshape(shape)
