"""The MoE layer (mirror of ``paddle_tpu/incubate/distributed/models/moe/
moe_layer.py``): ``MoELayer`` over stacked expert weights ``[E, ...]``,
with two expert routes, each also a whole op on one device.

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

``MoELayer.forward`` runs one op, ``_moe_mesh_op``, on the layer's
placement: a layer built without a mesh sits on the mesh of one rank,
where every gather and sum is the identity and the op is the capacity or
dropless op above, step for step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

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


def _capacity_experts(x2d, cdt, ddt, w_up, b_up, w_down, b_down,
                      activation: str = "gelu", reduce=None):
    """The capacity op's expert half: dispatch ``gec,gm->ecm``, the expert
    FFN, combine ``gec,ecm->gm``; ``reduce`` sums the down product over the
    ranks that split the expert hidden, before ``b_down`` is added."""
    expert_in = torch.einsum("gec,gm->ecm", ddt, x2d)
    h = torch.einsum("ecm,emh->ech", *_promoted(expert_in, w_up))
    h = _activation(h + b_up[:, None, :], activation)
    eo = torch.einsum("ech,ehm->ecm", *_promoted(h, w_down))
    if reduce is not None:
        eo = reduce(eo)
    eo = eo + b_down[:, None, :]
    return torch.einsum("gec,ecm->gm", *_promoted(cdt, eo))


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
    y = _capacity_experts(x2d, combine.to(x2d.dtype), dispatch.to(x2d.dtype),
                          w_up, b_up, w_down, b_down, activation)
    return y, aux, dropped.detach().to(torch.float32)


def dropless_experts(x2d, top_p, top_ids, w_up, b_up, w_down, b_down,
                     activation: str = "gelu",
                     block_rows: int = DROPLESS_BLOCK_ROWS,
                     first_expert: Optional[int] = None, reduce=None):
    """The routed expert FFN of the dropless path on the grouped-matmul
    kernels: the token copies (top_ids [G, k]) sorted by expert, stably,
    into block-aligned segments; up and down products (B7, dx B7, dW B8);
    the per-expert biases gathered; rows past the last segment masked; each
    copy's output weighted by its raw probability and added back in token
    order.  Weights and biases are cast to x2d's dtype, as the JAX op
    casts them.

    On a mesh the banks hold this rank's experts ``[first_expert,
    first_expert + E_local)``: copies routed elsewhere sort into one more
    segment past the local ones, which no product covers, and add nothing.
    ``reduce`` sums the down product over the ranks that split the expert
    hidden, before ``b_down`` is added."""
    g, m = x2d.shape
    e, bm = w_up.shape[0], int(block_rows)
    dev = x2d.device
    ids, foreign = top_ids, None
    if first_expert is not None:
        ids = top_ids - int(first_expert)
        foreign = (ids < 0) | (ids >= e)
        ids = torch.where(foreign, e, ids)
    order, sorted_ids, counts, seg_st, dest, rpad = sorted_segments(
        ids, e if foreign is None else e + 1, bm)
    if foreign is not None:
        counts, seg_st = counts[:e], seg_st[:e]
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
    if reduce is not None:
        eo = reduce(eo)
    if foreign is None:
        back = (eo[dest] + b_down.to(eo.dtype)[sorted_ids]).to(x2d.dtype)
    else:
        local = (sorted_ids < e)[:, None]
        back = torch.where(local, eo[dest] + b_down.to(eo.dtype)[
            sorted_ids.clamp(max=e - 1)], 0.0).to(x2d.dtype)
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


def check_mesh(mesh, what: str):
    """``mesh`` must be a live ``parallel.specs.Mesh`` (``init_mesh``, or
    one of one rank)."""
    from .....parallel.specs import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh= takes a parallel.specs.Mesh, got "
                        f"{type(mesh).__name__}")
    if not mesh.live:
        raise ValueError(f"{what} needs a live mesh (parallel.specs."
                         f"init_mesh)")
    return mesh


def _axis(mesh, axis: Optional[str]) -> Optional[str]:
    """``axis`` when the mesh has it at a size above 1, else None."""
    if axis and axis in mesh.axis_names and int(mesh.shape[axis]) > 1:
        return axis
    return None


@dataclasses.dataclass(frozen=True)
class _Placement:
    """Where a ``MoELayer``'s experts sit on a mesh: the expert stacks cut
    over ``ep_axis`` (this rank holds ``[e0, e0 + e_local)``), their hidden
    over ``mp_axis`` (None: not cut), and ``data_axes``, the axes that
    split the layer's tokens by default."""

    mesh: Any
    ep_axis: Optional[str]
    mp_axis: Optional[str]
    data_axes: Tuple[str, ...]
    e0: int
    e_local: int


def _served_rows(mesh, data_axes, ep_axis, rows: int, device):
    """The global rows (in the gathered order over ``data_axes``) whose
    tokens this rank's experts serve: its own rows, or with ``ep_axis``
    (an axis that splits the tokens) those of every rank of its ep line,
    in ep order, as ``all_gather`` over ep lays them out.  None when they
    are all the rows."""
    blocks = [mesh.block_index(data_axes)] if ep_axis is None else [
        mesh.block_index(data_axes, {ep_axis: j})
        for j in range(int(mesh.shape[ep_axis]))]
    n = 1
    for a in data_axes:
        n *= int(mesh.shape[a])
    if len(blocks) == n:
        return None
    return torch.cat([torch.arange(b * rows, (b + 1) * rows, device=device)
                      for b in blocks])


def _moe_mesh_op(layer, x2d, data_axes=None):
    """``MoELayer``'s forward on a mesh: the function the layer computes
    without one, on this rank's tokens and expert blocks.

    The fp32 router probabilities of every rank along the data axes are
    gathered in rank order (``compat.gather_blocks``), so the capacity
    masks and the aux loss are the global ones of the meshless op.  This rank's
    experts serve its own tokens (or, when ``ep`` splits the tokens, its ep
    line's, all-gathered) and the partial outputs sum over ``ep`` (or are
    reduce-scattered back); a hidden split over ``mp`` sums the down
    product over ``mp`` before ``b_down``.  Convention: a value every rank
    of an axis holds carries its whole cotangent on each (``pbroadcast``
    where ranks use parts of it), so every weight's gradient is complete
    but over the token-splitting axes."""
    from .....parallel import compat

    pl = layer._placement
    mesh, ep, mp = pl.mesh, pl.ep_axis, pl.mp_axis
    data = pl.data_axes if data_axes is None else tuple(
        a for a in data_axes if _axis(mesh, a))
    if mp is not None and mp in data:
        raise ValueError(f"the expert hidden's axis {mp!r} cannot split "
                         f"the tokens")
    group = ep is not None and ep in data
    aux_fn = layer.gate.aux_loss_fn
    probs = compat.gather_blocks(_router(x2d, layer.gate.weight), data,
                               mesh=mesh)
    aux = (aux_fn(probs) if aux_fn is not None
           else torch.zeros((), dtype=torch.float32, device=x2d.device))
    # each ep rank routes through its experts only: the routing's
    # cotangent is summed over ep (the aux's is whole on every rank)
    route = compat.pbroadcast(probs, ep, mesh=mesh) if ep else probs
    rows = _served_rows(mesh, data, ep if group else None, x2d.shape[0],
                        x2d.device)
    if group:
        x_in = compat.all_gather(x2d, ep, axis=0, mesh=mesh)
    else:
        x_in = compat.pbroadcast(x2d, ep, mesh=mesh) if ep else x2d
    reduce = None
    if mp is not None:
        x_in = compat.pbroadcast(x_in, mp, mesh=mesh)

        def reduce(t):
            return compat.psum(t, mp, mesh=mesh)

    num_expert = probs.shape[1]
    local = pl.e_local != num_expert
    if layer.dropless:
        top_p, top_ids = top_k_sorted(route if rows is None else route[rows],
                                      layer.gate.topk)
        y = dropless_experts(x_in, top_p, top_ids, layer.w_up, layer.b_up,
                             layer.w_down, layer.b_down, layer.activation,
                             first_expert=pl.e0 if local else None,
                             reduce=reduce)
        dropped = torch.zeros((), dtype=torch.float32, device=x2d.device)
    else:
        capacity = layer.gate.capacity(probs.shape[0], layer.capacity_factor)
        combine, dispatch, dropped = top_k_masks_with_drops(
            route, layer.gate.topk, capacity)
        if rows is not None:
            combine, dispatch = combine[rows], dispatch[rows]
        if local:
            sl = slice(pl.e0, pl.e0 + pl.e_local)
            combine, dispatch = combine[:, sl], dispatch[:, sl]
        y = _capacity_experts(x_in, combine.to(x2d.dtype),
                              dispatch.to(x2d.dtype), layer.w_up,
                              layer.b_up, layer.w_down, layer.b_down,
                              layer.activation, reduce)
    if group:
        y = compat.psum_scatter(y, ep, mesh=mesh)
    elif ep is not None:
        y = compat.psum(y, ep, mesh=mesh)
    return y, aux, dropped.detach().to(torch.float32)


class MoELayer(nn.Module):
    """Drop-in MoE FFN (mirror of ``MoELayer``): stacked expert weights
    ``w_up`` [E, m, h], ``b_up``, ``w_down`` [E, h, m], ``b_down``, drawn
    as JAX draws them (``np.random.RandomState(0)``, so a port layer and a
    JAX layer start bit-equal) and flagged ``is_expert`` for
    ``ClipGradForMOEByGlobalNorm``; the gate's weight starts at zeros.
    ``l_aux`` holds the last forward's aux loss and ``tokens_dropped`` its
    fp32 count of assignments the capacity refused (0 when dropless).

    Without a mesh the layer sits on the mesh of one rank.  ``mesh`` (a
    live ``parallel.specs.Mesh`` whose ``ep_axis`` has more than one rank)
    places the layer as JAX places it: the experts
    ``Shard(0)`` over ``ep_axis``, their hidden over ``mp_axis`` (``w_up``
    (ep, None, mp), ``b_up`` (ep, mp), ``w_down`` (ep, mp, None),
    ``b_down`` (ep, None)), the gate replicated; each parameter then holds
    this rank's block (its ``placement`` attribute the ``NamedSharding``),
    the forward takes this rank's tokens (split over the mesh's other
    axes, or over ``data_axes=`` given to the forward) and computes the
    meshless function (``_moe_mesh_op``)."""

    GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}

    def __init__(self, d_model: int, d_hidden: int, num_expert: int = 8,
                 gate="gshard", top_k: int = 2,
                 capacity_factor: float = 1.2, activation: str = "gelu",
                 mesh=None, ep_axis: str = "ep",
                 mp_axis: Optional[str] = None, moe_group=None,
                 recompute_interval: int = 0, dropless: bool = False,
                 device: DeviceLike = None):
        super().__init__()
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
        from .....parallel.specs import Mesh, P

        self._placement = _Placement(
            mesh=Mesh((1,), (ep_axis,), device_type=dev.type), ep_axis=None,
            mp_axis=None, data_axes=(), e0=0, e_local=num_expert)
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
        if mesh is not None:
            check_mesh(mesh, "MoELayer")
            if _axis(mesh, ep_axis):
                mp = _axis(mesh, mp_axis)
                self.place(mesh, {
                    "gate.weight": P(),
                    "w_up": P(ep_axis, None, mp), "b_up": P(ep_axis, mp),
                    "w_down": P(ep_axis, mp, None),
                    "b_down": P(ep_axis, None)})

    @torch.no_grad()
    def place(self, mesh, specs, cut: bool = True) -> None:
        """Place the layer on ``mesh``: ``specs`` maps each parameter name
        (``w_up``, ..., ``gate.weight``) to its spec, which must divide
        its shape on the mesh; with ``cut`` each parameter keeps this
        rank's block (else it holds it already).  Each parameter's
        ``placement`` becomes its ``NamedSharding``; the forward then runs
        ``_moe_mesh_op``."""
        from .....parallel.specs import (NamedSharding, filter_divisible_spec,
                                         filter_spec_to_mesh)

        params = dict(self.named_parameters())
        for name, spec in specs.items():
            p = params[name]
            ns = NamedSharding(mesh, filter_spec_to_mesh(spec, mesh))
            if cut:
                shape = tuple(p.shape)
                if filter_divisible_spec(spec, shape, mesh) != ns.spec:
                    raise ValueError(f"MoELayer.{name}: {spec} does not "
                                     f"divide {shape} on {mesh}")
                p.data = ns.shard(p.data).local
            p.placement = ns
        w_up = tuple(self.w_up.placement.spec) + (None,) * 3
        ep, mp = w_up[0], w_up[2]
        el = int(self.w_up.shape[0])
        self._placement = _Placement(
            mesh=mesh, ep_axis=ep, mp_axis=mp,
            data_axes=tuple(a for a in mesh.axis_names
                            if a not in (ep, mp) and _axis(mesh, a)),
            e0=(mesh.axis_index(ep) * el if ep else 0), e_local=el)

    def forward(self, x, data_axes=None):
        shape = x.shape
        y, aux, dropped = _moe_mesh_op(self, x.reshape(-1, shape[-1]),
                                       data_axes)
        self.l_aux = aux
        self.tokens_dropped = dropped
        return y.reshape(shape)
