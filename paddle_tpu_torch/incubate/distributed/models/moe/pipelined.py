"""The single-device reference of the pipelined MoE blocks (mirror of
``paddle_tpu/incubate/distributed/models/moe/pipelined.py``): ``moe_block``
and ``sequential_moe_forward``, and ``init_pipelined_moe_params`` without a
mesh (the same numpy draws).

The pipelined forwards (``pipelined_moe_forward``, ``moe_block_ep``,
``pipelined_moe_forward_ep``) run inside a pp x ep x mp program through
``pipeline_apply`` and raise ``NotImplementedError`` naming ROADMAP queue
A5.5 (pipelining), as does ``init_pipelined_moe_params`` over a mesh of
more than one device (its pp x ep x mp placement is the pipelined stack's).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .....device import DeviceLike, resolve_device
from .moe_layer import _moe_forward_op


def _needs_a5(what: str):
    raise NotImplementedError(
        f"{what} runs the MoE stack pipelined over pp with experts over ep "
        f"(pipeline_apply): multi-GPU training, ROADMAP queue A5.5")


def init_pipelined_moe_params(mesh, num_layers: int, num_expert: int,
                              d_model: int, d_hidden: int, seed: int = 0,
                              device: DeviceLike = None
                              ) -> Dict[str, torch.Tensor]:
    """Layer-major [L, E, ...] expert stacks from
    ``np.random.RandomState(seed)``, drawn as the JAX function draws them,
    on ``device``; ``mesh`` must be None (or one device)."""
    shape = getattr(mesh, "shape", ())
    sizes = shape.values() if isinstance(shape, dict) else shape
    if mesh is not None and int(np.prod(tuple(sizes))) > 1:
        _needs_a5("init_pipelined_moe_params over a mesh")
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    params = {
        "gate_w": rng.randn(num_layers, d_model, num_expert).astype(
            np.float32),
        "w_up": rng.randn(num_layers, num_expert, d_model, d_hidden).astype(
            np.float32) * 0.3,
        "b_up": np.zeros((num_layers, num_expert, d_hidden), np.float32),
        "w_down": rng.randn(num_layers, num_expert, d_hidden,
                            d_model).astype(np.float32) * 0.3,
        "b_down": np.zeros((num_layers, num_expert, d_model), np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in params.items()}


def moe_block(lp: Dict[str, torch.Tensor], act, topk: int = 2):
    """One residual MoE-FFN block (capacity = the whole batch: nothing
    drops)."""
    y, _, _ = _moe_forward_op(act, lp["gate_w"], lp["w_up"], lp["b_up"],
                              lp["w_down"], lp["b_down"], topk=topk,
                              capacity=act.shape[0], aux_fn=None)
    return act + y


def sequential_moe_forward(params: Dict[str, torch.Tensor], x,
                           topk: int = 2):
    """The unsharded sequential reference: [m, mb, d_model] micro-batches
    through every layer's ``moe_block``, one micro-batch at a time."""
    ref = x
    for i in range(params["gate_w"].shape[0]):
        lp = {k: v[i] for k, v in params.items()}
        ref = torch.stack([moe_block(lp, ref[j], topk=topk)
                           for j in range(x.shape[0])])
    return ref


def pipelined_moe_forward(params, x, mesh, topk: int = 2):
    _needs_a5("pipelined_moe_forward")


def moe_block_ep(lp, act, topk: int = 2, ep_axis: str = "ep"):
    _needs_a5("moe_block_ep")


def pipelined_moe_forward_ep(params, x, mesh, topk: int = 2):
    _needs_a5("pipelined_moe_forward_ep")
