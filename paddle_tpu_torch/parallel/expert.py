"""The MoE expert block and its train steps on one device.

Port of the single-device part of ``paddle_tpu/parallel/expert.py``:
``MoEEPConfig`` (``ep_capacity`` on the gates' ``moe_capacity``),
``moe_ep_shapes``, ``init_moe_ep_params`` (the same
``np.random.RandomState`` draws), ``_activation``, ``_moe_loss``, the
capacity half (``build_moe_ep_forward``, ``build_moe_ep_train_step``,
``build_moe_dense_train_step``) and the dropless half
(``build_moe_ep_dropless_forward``, ``build_moe_ep_dropless_train_step``).

The JAX bodies run per expert-parallel rank inside a ``shard_map``; with an
expert-parallel degree of 1 their all-to-all exchanges are the identity
(``make_ep_all_to_all(None)``), each rank window is the whole token set and
the stats row is the only row.  The functions here are those bodies with
the exchanges removed, step for step.

- Capacity: routing by ``top_k_masks_with_drops`` at ``ep_capacity`` of
  the token count, the dispatch, expert and combine einsums (the masked
  einsum JAX leaves to XLA: ``torch.einsum`` here), the stats (``aux``,
  ``dropped``, ``load``).
- Dropless: top-k on the fp32 router probabilities (raw, not
  renormalised), token copies sorted by expert (stable), block-aligned
  ragged segments, the two expert GEMMs on the grouped-matmul kernels
  (``moe_layer.dropless_experts``: B7 forward and dx, B8 dW), the stats
  with ``dropped`` = 0.

An expert-parallel degree above 1, an ``OverlapConfig`` (and so a codec)
or a mesh of more than one device raise ``NotImplementedError`` naming
ROADMAP queue A5.3 (expert parallelism; the overlap config A5.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..incubate.distributed.models.moe.gate import (load_balance_aux_loss,
                                                    moe_capacity,
                                                    top_k_masks_with_drops)
from ..incubate.distributed.models.moe.moe_layer import (
    _activation, _moe_forward_op, _router, _single_device_mesh,
    dropless_experts, top_k_sorted)

__all__ = ["MoEEPConfig", "moe_ep_shapes", "init_moe_ep_params",
           "build_moe_ep_forward", "build_moe_ep_train_step",
           "build_moe_dense_train_step", "build_moe_ep_dropless_forward",
           "build_moe_ep_dropless_train_step"]


@dataclasses.dataclass(frozen=True)
class MoEEPConfig:
    """One MoE FFN block (mirror of ``MoEEPConfig``).  ``capacity_factor``
    sizes the capacity path's slots per expert (``ep_capacity``) and
    ``capacity`` overrides it with an explicit count; the dropless path
    ignores both.  ``aux_weight`` scales the load-balance aux loss."""

    d_model: int
    d_hidden: int
    num_expert: int
    top_k: int = 2
    capacity_factor: float = 1.2
    capacity: Optional[int] = None
    activation: str = "gelu"
    aux_weight: float = 0.01

    def ep_capacity(self, local_tokens: int) -> int:
        if self.capacity is not None:
            return int(self.capacity)
        return moe_capacity(local_tokens, self.top_k, self.num_expert,
                            self.capacity_factor)


def moe_ep_shapes(cfg: MoEEPConfig) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the block's leaves, keyed by name."""
    e, m, h = cfg.num_expert, cfg.d_model, cfg.d_hidden
    return {"gate_w": (m, e), "w_up": (e, m, h), "b_up": (e, h),
            "w_down": (e, h, m), "b_down": (e, m)}


def _single_device(mesh, oc) -> None:
    if oc is not None:
        raise NotImplementedError(
            "an OverlapConfig (hierarchical exchange, codec) belongs to "
            "multi-GPU training, ROADMAP queue A5.2")
    _single_device_mesh(mesh, "the MoE EP block")


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


def _moe_loss(y, x2d, tgt, aux, aux_weight: float, shards: int = 1):
    """The MSE-against-target objective of the JAX steps: the per-token
    squared error summed (per batch shard, the partials added in shard
    order when ``shards`` > 1, as the dense reference mimics the EP psum),
    and the weighted aux term."""
    se = ((x2d + y).float() - tgt).square().sum(dim=-1)
    total = se.reshape(shards, -1).sum(dim=1).sum() if shards > 1 \
        else se.sum()
    return total, aux_weight * aux


def _stats(probs, e: int):
    """(aux, load) of the single stats row: the top-1 fraction per expert
    (no gradient) and GShard's aux over the mean probabilities."""
    load = F.one_hot(probs.argmax(dim=-1), e).float().mean(dim=0).detach()
    return e * (load * probs.mean(dim=0)).sum(), load


def _sgd_step(fwd, params, x2d, tgt, lr: float, aux_weight: float,
              shards: int = 1):
    """One SGD step of the residual objective over ``fwd(leaves, x2d) ->
    (y, aux, *stats)``: loss = the summed squared error over the tokens /
    their count + ``aux_weight * aux``, the gradients taken on leaf copies
    of ``params`` and the update written into ``params`` IN PLACE (the JAX
    steps donate them).  Returns (loss, aux, stats)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    y, aux, *stats = fwd(leaves, x2d)
    total, aux_term = _moe_loss(y, x2d, tgt, aux, aux_weight, shards)
    loss = total / x2d.shape[0] + aux_term
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        for k, g in zip(leaves, grads):
            params[k].sub_(lr * g.to(params[k].dtype))
    return loss.detach(), aux.detach(), stats


def build_moe_ep_forward(cfg: MoEEPConfig, mesh=None, oc=None,
                         batch_axes: Tuple[str, ...] = ("dp", "sharding",
                                                        "ep"),
                         local_tokens: Optional[int] = None):
    """The capacity MoE block, ``fwd(params, x2d) -> (y, aux, dropped,
    load)`` (mirror of ``build_moe_ep_forward`` at an expert-parallel
    degree of 1): routing at ``cfg.ep_capacity`` of the token count (or of
    ``local_tokens``), the ``[E, C, d]`` dispatch einsum, the expert FFN
    with the weights cast to the tokens' dtype, the combine einsum; the
    aux loss and ``load`` from the one stats row, ``dropped`` the fp32
    overflow count."""
    _single_device(mesh, oc)
    e = cfg.num_expert

    def fwd(params, x2d):
        cap = cfg.ep_capacity(local_tokens if local_tokens is not None
                              else x2d.shape[0])
        probs = _router(x2d, params["gate_w"])
        combine, dispatch, dropped = top_k_masks_with_drops(
            probs, cfg.top_k, cap)
        send = torch.einsum("gec,gm->ecm", dispatch.to(x2d.dtype), x2d)
        h = torch.einsum("ecm,emh->ech", send,
                         params["w_up"].to(send.dtype)) \
            + params["b_up"].to(send.dtype)[:, None, :]
        h = _activation(h, cfg.activation)
        eo = torch.einsum("ech,ehm->ecm", h, params["w_down"].to(h.dtype)) \
            + params["b_down"].to(h.dtype)[:, None, :]
        y = torch.einsum("gec,ecm->gm", combine.to(x2d.dtype), eo)
        aux, load = _stats(probs, e)
        return y, aux, dropped.detach().float(), load

    return fwd


def build_moe_ep_train_step(cfg: MoEEPConfig, mesh=None, oc=None,
                            batch_axes: Tuple[str, ...] = ("dp", "sharding",
                                                           "ep"),
                            lr: float = 1e-2,
                            local_tokens: Optional[int] = None):
    """The capacity train step (mirror of ``build_moe_ep_train_step``):
    ``step(params, x2d, tgt) -> (loss, aux, dropped, load, params)``, the
    residual block ``y = x + moe(x)`` against an MSE target plus the
    weighted aux loss, plain SGD at ``lr``, the params updated IN PLACE."""
    fwd = build_moe_ep_forward(cfg, mesh, oc, batch_axes, local_tokens)

    def step(params, x2d, tgt):
        loss, aux, (dropped, load) = _sgd_step(fwd, params, x2d, tgt, lr,
                                               cfg.aux_weight)
        return loss, aux, dropped, load, params

    return step


def build_moe_dense_train_step(cfg: MoEEPConfig, lr: float = 1e-2,
                               capacity: Optional[int] = None,
                               shards: int = 1):
    """The dense reference step (mirror of ``build_moe_dense_train_step``):
    the same objective over ``MoELayer``'s capacity op with a pinned global
    capacity (default: every token fits) and the gshard aux loss;
    ``shards`` sums the squared error per shard first, as the EP psum
    does.  ``step(params, x2d, tgt) -> (loss, aux, dropped, params)``, the
    params updated IN PLACE."""

    def fwd(p, x2d):
        return _moe_forward_op(
            x2d, p["gate_w"], p["w_up"], p["b_up"], p["w_down"], p["b_down"],
            topk=cfg.top_k,
            capacity=capacity if capacity is not None else x2d.shape[0],
            aux_fn=load_balance_aux_loss, activation=cfg.activation)

    def step(params, x2d, tgt):
        loss, aux, (dropped,) = _sgd_step(fwd, params, x2d, tgt, lr,
                                          cfg.aux_weight, shards)
        return loss, aux, dropped, params

    return step


def build_moe_ep_dropless_forward(cfg: MoEEPConfig, mesh=None, oc=None,
                                  block_rows: int = 8):
    """The dropless MoE block, ``fwd(params, x2d) -> (y, aux, dropped,
    load)`` (mirror of ``build_moe_ep_dropless_forward`` at an
    expert-parallel degree of 1): the single rank window is the sorted
    copy list (the dropless worst case, g * top_k rows), run through
    ``dropless_experts``; ``dropped`` is structurally zero.
    ``block_rows`` is the kernels' segment alignment quantum."""
    _single_device(mesh, oc)
    bm = int(block_rows)

    def fwd(params, x2d):
        probs = _router(x2d, params["gate_w"])
        top_p, top_ids = top_k_sorted(probs, cfg.top_k)
        y = dropless_experts(x2d, top_p, top_ids, params["w_up"],
                             params["b_up"], params["w_down"],
                             params["b_down"], cfg.activation, bm)
        aux, load = _stats(probs, cfg.num_expert)
        return (y, aux, torch.zeros((), dtype=torch.float32,
                                    device=x2d.device), load)

    fwd.block_rows = bm
    return fwd


def build_moe_ep_dropless_train_step(cfg: MoEEPConfig, mesh=None, oc=None,
                                     lr: float = 1e-2, block_rows: int = 8):
    """The dropless train step (mirror of
    ``build_moe_ep_dropless_train_step``): the capacity step's objective
    and SGD over the dropless block, ``step(params, x2d, tgt) -> (loss,
    aux, dropped, load, params)``, the params updated IN PLACE."""
    fwd = build_moe_ep_dropless_forward(cfg, mesh, oc, block_rows)

    def step(params, x2d, tgt):
        loss, aux, (dropped, load) = _sgd_step(fwd, params, x2d, tgt, lr,
                                               cfg.aux_weight)
        return loss, aux, dropped, load, params

    return step
