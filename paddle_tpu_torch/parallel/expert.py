"""The dropless MoE block and its train step on one device.

Port of the single-device part of ``paddle_tpu/parallel/expert.py``:
``MoEEPConfig``, ``moe_ep_shapes``, ``init_moe_ep_params`` (the same
``np.random.RandomState`` draws), ``_activation``, ``_moe_loss``,
``build_moe_ep_dropless_forward`` and ``build_moe_ep_dropless_train_step``.

The JAX body runs per expert-parallel rank inside a ``shard_map``; with an
expert-parallel degree of 1 its all-to-all exchanges are the identity
(``make_ep_all_to_all(None)``), each rank window is the whole sorted copy
list and the stats row is the only row.  The functions here are that body
with the exchanges removed, step for step: top-k routing on fp32 router
probabilities (raw, not renormalised), token copies sorted by expert
(stable), block-aligned ragged segments, the two expert GEMMs on the
grouped-matmul kernels (``ops/grouped_matmul.py::grouped_matmul``: B7
forward and dx, B8 dW), ``row_valid`` masking, the per-expert bias gathers,
the weighted combine and the stats (``aux``, ``dropped`` = 0, ``load``).

An expert-parallel degree above 1, an ``OverlapConfig`` (and so a codec)
or a mesh of more than one device raise ``NotImplementedError`` naming
ROADMAP queue A5 (multi-GPU training).  The capacity path
(``build_moe_ep_forward``) and ``build_moe_dense_train_step`` are not
ported yet (queue A3/A5).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops.grouped_matmul import align_rows, grouped_matmul, sorted_segments

__all__ = ["MoEEPConfig", "moe_ep_shapes", "init_moe_ep_params",
           "build_moe_ep_dropless_forward",
           "build_moe_ep_dropless_train_step"]


@dataclasses.dataclass(frozen=True)
class MoEEPConfig:
    """One MoE FFN block (mirror of ``MoEEPConfig``).  ``capacity_factor``
    and ``capacity`` size the capacity path's slots (not ported yet); the
    dropless path ignores them.  ``aux_weight`` scales the load-balance
    aux loss."""

    d_model: int
    d_hidden: int
    num_expert: int
    top_k: int = 2
    capacity_factor: float = 1.2
    capacity: Optional[int] = None
    activation: str = "gelu"
    aux_weight: float = 0.01


def moe_ep_shapes(cfg: MoEEPConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the block's leaves, keyed by name."""
    e, m, h = cfg.num_expert, cfg.d_model, cfg.d_hidden
    return {"gate_w": (m, e), "w_up": (e, m, h), "b_up": (e, h),
            "w_down": (e, h, m), "b_down": (e, m)}


def _single_device(mesh, oc) -> None:
    if oc is not None:
        raise NotImplementedError(
            "an OverlapConfig (hierarchical exchange, codec) belongs to "
            "multi-GPU training, ROADMAP queue A5")
    if mesh is not None and int(np.prod(getattr(mesh, "shape", (1,)))) > 1:
        raise NotImplementedError(
            "expert parallelism over a multi-device mesh belongs to "
            "multi-GPU training, ROADMAP queue A5")


def init_moe_ep_params(cfg: MoEEPConfig, mesh=None, seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The block's fp32 params from ``np.random.RandomState(seed)``, drawn
    as the JAX ``init_moe_ep_params`` draws them, on ``device``."""
    _single_device(mesh, None)
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    m, h, e = cfg.d_model, cfg.d_hidden, cfg.num_expert
    scale = 1.0 / (m ** 0.5)
    params = {
        "gate_w": rng.randn(m, e).astype(np.float32),
        "w_up": rng.randn(e, m, h).astype(np.float32) * scale,
        "b_up": np.zeros((e, h), np.float32),
        "w_down": rng.randn(e, h, m).astype(np.float32) * scale,
        "b_down": np.zeros((e, m), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in params.items()}


def _activation(h, kind: str):
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    if kind == "relu":
        return F.relu(h)
    if kind == "swiglu":
        a, b = h.chunk(2, dim=-1)
        return F.silu(a) * b
    raise ValueError(f"activation {kind!r}")


def _moe_loss(y, x2d, tgt, aux, aux_weight: float):
    """The MSE-against-target objective of the JAX step: the per-token
    squared error summed, and the weighted aux term."""
    se = ((x2d + y).float() - tgt).square().sum(dim=-1)
    return se.sum(), aux_weight * aux


def build_moe_ep_dropless_forward(cfg: MoEEPConfig, mesh=None, oc=None,
                                  block_rows: int = 8):
    """The dropless MoE block, ``fwd(params, x2d) -> (y, aux, dropped,
    load)`` (mirror of ``build_moe_ep_dropless_forward`` at an
    expert-parallel degree of 1).  ``block_rows`` is the kernels' segment
    alignment quantum."""
    _single_device(mesh, oc)
    e = cfg.num_expert
    bm = int(block_rows)

    def fwd(params, x2d):
        gate_w = params["gate_w"]
        w_up, b_up = params["w_up"], params["b_up"]
        w_down, b_down = params["w_down"], params["b_down"]
        dev = x2d.device
        g_local, m = x2d.shape
        probs = torch.softmax(x2d.float() @ gate_w.float(), dim=-1)
        # lax.top_k: ties to the lowest index, raw-prob combine weights
        vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_p, top_ids = vals[:, :cfg.top_k], ids[:, :cfg.top_k]

        # dispatch: the single rank window is the sorted copy list (the
        # dropless worst case, g * top_k rows); copy q lands at its
        # expert's segment start + its index within the expert's run
        order, sorted_ids, counts, seg_st, dest, rpad = sorted_segments(
            top_ids, e, bm)
        token_of = order // cfg.top_k
        wsorted = top_p.reshape(-1)[order]
        rows_used = align_rows(counts, bm).sum()
        xr = torch.zeros((rpad, m), dtype=x2d.dtype, device=dev).index_copy(
            0, dest, x2d[token_of])

        # expert FFN on the grouped-matmul kernels; rexp maps a padded row
        # to its expert (bias gather), rows past the last segment masked
        blk_cum = torch.cumsum(align_rows(counts, bm), 0)
        rexp = torch.searchsorted(blk_cum, torch.arange(rpad, device=dev),
                                  right=True).clamp(max=e - 1)
        row_valid = (torch.arange(rpad, device=dev) < rows_used)[:, None]
        wids = torch.arange(e, dtype=torch.int32, device=dev)
        h = grouped_matmul(xr, w_up.to(x2d.dtype), seg_st, counts, wids, bm)
        h = torch.where(row_valid, h + b_up.to(h.dtype)[rexp], 0.0)
        h = _activation(h, cfg.activation)
        eo = grouped_matmul(h, w_down.to(h.dtype), seg_st, counts, wids, bm)

        # combine: each copy's expert output + its expert's bias, weighted,
        # added into token order
        back = (eo[dest] + b_down.to(eo.dtype)[sorted_ids]).to(x2d.dtype)
        y = torch.zeros((g_local, m), dtype=x2d.dtype, device=dev).index_add(
            0, token_of, back * wsorted.to(x2d.dtype)[:, None])

        # stats: dropped is structurally zero
        top1 = probs.argmax(dim=-1)
        load = F.one_hot(top1, e).float().mean(dim=0).detach()
        me = probs.mean(dim=0)
        aux = e * (load * me).sum()
        dropped = torch.zeros((), dtype=torch.float32, device=dev)
        return y, aux, dropped, load

    fwd.block_rows = bm
    return fwd


def build_moe_ep_dropless_train_step(cfg: MoEEPConfig, mesh=None, oc=None,
                                     lr: float = 1e-2, block_rows: int = 8):
    """The dropless train step (mirror of
    ``build_moe_ep_dropless_train_step``): ``step(params, x2d, tgt) ->
    (loss, aux, dropped, load, new_params)``, loss = summed squared error
    over the tokens + ``aux_weight * aux``, plain SGD at ``lr``.  As the
    JAX step donates its params, this one updates them IN PLACE and
    returns the same tensors."""
    fwd = build_moe_ep_dropless_forward(cfg, mesh, oc, block_rows)

    def step(params, x2d, tgt):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y, aux, dropped, load = fwd(leaves, x2d)
        total, aux_term = _moe_loss(y, x2d, tgt, aux, cfg.aux_weight)
        loss = total / x2d.shape[0] + aux_term
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            for k, g in zip(names, grads):
                params[k].sub_(lr * g.to(params[k].dtype))
        return loss.detach(), aux.detach(), dropped, load, params

    return step
