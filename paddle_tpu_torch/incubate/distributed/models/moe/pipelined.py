"""Pipelined MoE blocks: pp x ep x mp composition (mirror of
``paddle_tpu/incubate/distributed/models/moe/pipelined.py``).

A stack of residual MoE-FFN blocks pipelined over ``pp`` (layer-major
[L, E, ...] stacks, ``pipeline_apply`` dataflow), with the experts placed
over ``ep`` and the expert hidden dims over ``mp`` at rest
(``MOE_BLOCK_SPECS``).  The tokens are the same on every rank.

- ``pipelined_moe_forward``: the expert stacks are gathered over ``ep`` and
  ``mp`` at the start (the JAX region's ``P("pp")`` in_specs) and every
  stage runs ``moe_block`` expert-replicated (capacity = the whole batch,
  nothing drops);
- ``pipelined_moe_forward_ep``: the stacks stay cut over ``ep`` (only
  ``mp`` is gathered) and each stage runs ``moe_block_ep``: a rank routes
  every token, computes only its experts' slots and the residual combine
  psums the partial outputs over ``ep``.

Both return [m, mb, d_model] on every rank (the last stage's outputs,
psummed over ``pp``).  ``sequential_moe_forward`` is the unsharded
reference; ``init_pipelined_moe_params`` draws what the JAX function draws
(``np.random.RandomState(seed)``) and, over a mesh, keeps this rank's
blocks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .....device import DeviceLike, resolve_device
from .....parallel import compat as _compat
from .....parallel.specs import Mesh, NamedSharding, P, ShardedTensor
from .gate import top_k_masks
from .moe_layer import _moe_forward_op

MOE_BLOCK_SPECS = {
    "gate_w": P("pp", None, None),
    "w_up": P("pp", "ep", None, "mp"),
    "b_up": P("pp", "ep", "mp"),
    "w_down": P("pp", "ep", "mp", None),
    "b_down": P("pp", "ep", None),
}


def _need_mesh(mesh, what: str) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh= takes a parallel.specs.Mesh over "
                        f"('pp', 'ep', 'mp'), got {type(mesh).__name__}")


def init_pipelined_moe_params(mesh, num_layers: int, num_expert: int,
                              d_model: int, d_hidden: int, seed: int = 0,
                              device: DeviceLike = None
                              ) -> Dict[str, torch.Tensor]:
    """Layer-major [L, E, ...] expert stacks from
    ``np.random.RandomState(seed)``, drawn as the JAX function draws them,
    on ``device``: whole tensors with ``mesh=None``, else this rank's
    ``ShardedTensor`` blocks placed by ``MOE_BLOCK_SPECS``."""
    if mesh is not None:
        _need_mesh(mesh, "init_pipelined_moe_params")
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
    out = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    if mesh is None:
        return out
    return {k: NamedSharding(mesh, MOE_BLOCK_SPECS[k]).shard(v)
            for k, v in out.items()}


def moe_block(lp: Dict[str, torch.Tensor], act, topk: int = 2):
    """One residual MoE-FFN block (capacity = the whole batch: nothing
    drops)."""
    y, _, _ = _moe_forward_op(act, lp["gate_w"], lp["w_up"], lp["b_up"],
                              lp["w_down"], lp["b_down"], topk=topk,
                              capacity=act.shape[0], aux_fn=None)
    return act + y


def moe_block_ep(lp: Dict[str, torch.Tensor], act, topk: int = 2,
                 ep_axis: str = "ep", *, mesh=None):
    """One residual MoE-FFN block with this rank's E_local experts of
    ``ep_axis``: the routing masks of every expert are computed (the
    tokens are the same on every rank), sliced to this rank's expert
    block, its experts' slots computed, and the partial outputs psummed
    over ``ep_axis`` in the residual combine."""
    _need_mesh(mesh, "moe_block_ep")
    e_local = lp["w_up"].shape[0]
    off = mesh.axis_index(ep_axis) * e_local
    probs = torch.softmax(act.float() @ lp["gate_w"].float(), dim=-1)
    combine, dispatch = top_k_masks(probs, topk, act.shape[0])
    cdt = combine[:, off:off + e_local].to(act.dtype)
    ddt = dispatch[:, off:off + e_local].to(act.dtype)
    expert_in = torch.einsum("gec,gm->ecm", ddt, act)
    h = torch.einsum("ecm,emh->ech", expert_in, lp["w_up"].to(act.dtype)) \
        + lp["b_up"].to(act.dtype)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    eo = torch.einsum("ech,ehm->ecm", h, lp["w_down"].to(act.dtype)) \
        + lp["b_down"].to(act.dtype)[:, None, :]
    y_partial = torch.einsum("gec,ecm->gm", cdt, eo)
    return act + _compat.psum(y_partial, ep_axis, mesh=mesh)


def _stage_blocks(params, mesh, gather_axes):
    """This rank's pp block of every stack, gathered over ``gather_axes``
    (whole tensors are cut first)."""
    out = {}
    for k, v in params.items():
        spec = MOE_BLOCK_SPECS[k]
        if not isinstance(v, ShardedTensor):
            v = NamedSharding(mesh, spec).shard(v)
        t = v.local
        for dim, entry in enumerate(spec):
            if entry in gather_axes:
                t = _compat.gather_blocks(t, (entry,), dim=dim, mesh=mesh)
        out[k] = t
    return out


def _pipelined(params, x, mesh, topk, block_fn, gather_axes):
    from .....parallel.pipelining import pipeline_apply

    sp = _stage_blocks(params, mesh, gather_axes)

    def stage_fn(stage, act):
        for i in range(stage["gate_w"].shape[0]):
            act = block_fn({k: v[i] for k, v in stage.items()}, act)
        return act

    outs = pipeline_apply(stage_fn, sp, x, axis="pp",
                          squeeze_stage_dim=False, mesh=mesh)
    pp = int(mesh.shape.get("pp", 1))
    last = float(mesh.axis_index("pp") == pp - 1)
    return _compat.psum(outs * last, "pp", mesh=mesh)


def pipelined_moe_forward(params: Dict[str, torch.Tensor], x, mesh,
                          topk: int = 2):
    """[m, mb, d_model] micro-batches through the pipelined MoE stack on
    ``mesh`` (("pp", "ep", "mp")), the experts gathered at the start;
    returns [m, mb, d_model] on every rank."""
    _need_mesh(mesh, "pipelined_moe_forward")
    return _pipelined(params, x, mesh, topk,
                      lambda lp, a: moe_block(lp, a, topk=topk),
                      ("ep", "mp"))


def pipelined_moe_forward_ep(params: Dict[str, torch.Tensor], x, mesh,
                             topk: int = 2):
    """The ep > 1 variant of ``pipelined_moe_forward``: the expert stacks
    stay cut over ``ep`` (only ``mp`` is gathered) and each stage runs
    ``moe_block_ep``."""
    _need_mesh(mesh, "pipelined_moe_forward_ep")
    return _pipelined(params, x, mesh, topk,
                      lambda lp, a: moe_block_ep(lp, a, topk=topk,
                                                 mesh=mesh), ("mp",))


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
