"""The MoE expert block and its train steps, on one device or over an
expert-parallel mesh.

Port of ``paddle_tpu/parallel/expert.py``.  The JAX bodies run per rank
inside a ``shard_map`` over a ``("dp", "sharding", "ep")`` mesh; here each
rank runs the same body on its own blocks, over explicit collectives:

- **the at-rest plan**: expert-stacked leaves (``w_up``, ``b_up``,
  ``w_down``, ``b_down``) lead with ``ep`` (``specs.expert_leaf_spec``),
  the gate replicates (``moe_ep_spec_for``, ``moe_ep_layout``);
  ``init_moe_ep_params(mesh=)`` draws the JAX function's
  ``np.random.RandomState`` values and keeps this rank's blocks;
- **the token transport** (``make_ep_all_to_all``): one tiled all-to-all
  over ``ep``, or where ``ep`` spans slices the two-stage exchange (within
  each slice, then across slices on the destination-slice super-blocks,
  with JAX's static reorders, so with the codec off it equals the flat
  exchange bit for bit); with a ``CollectiveCodec`` the inter-slice stage
  moves the packed int8/fp8 rows (``codec.encode_rows``, one all-to-all,
  ``decode_rows``).  An autograd Function whose backward applies the same
  exchange to the cotangent: the tiled all-to-all's block permutation is
  an involution;
- **the capacity region** (``build_moe_ep_forward``): routing at
  ``cfg.ep_capacity`` of the rank's tokens, the ``[E, C, m]`` send buffer,
  the exchange, the local experts on ``[E_local, ep * C, m]``, the
  exchange back and the combine (the masked einsums JAX leaves to XLA:
  ``torch.einsum``);
- **the dropless region** (``build_moe_ep_dropless_forward``): top-k on
  the fp32 probabilities, the copies sorted by expert, the int32 counts
  exchanged first (never coded), the payload in static per-destination
  windows of ``g_local * top_k`` rows, compacted into block-aligned
  segments, the two expert GEMMs on the grouped-matmul kernels (B7
  forward and dx, B8 dW), the combine back through the exchange;
- **the stats**: each batch shard's row ``[mean prob | top-1 fraction |
  dropped]`` is gathered over the batch axes in shard order
  (``compat.gather_blocks``) and reduced as the JAX entry reduces it, so
  ``aux``, ``load`` and ``dropped`` are the global values on every rank;
- **the steps** (``build_moe_ep_train_step``,
  ``build_moe_ep_dropless_train_step``): each rank's block of the global
  batch, the per-shard squared-error sums added in shard order, plain SGD
  on the local blocks, in place.  Each leaf's gradient is summed over the
  mesh axes it is not cut along: expert leaves over ``dp`` and
  ``sharding``, never over ``ep`` (the exchange brings every rank's
  tokens to them), the gate over all three.

``mesh=None`` is the mesh of one rank (``("dp", "sharding", "ep")`` =
(1, 1, 1)), which needs no process group: every exchange and gather is the
identity and the functions take and return plain tensors.  On a mesh the
regions take this rank's token block and parameter blocks (plain or
``ShardedTensor``), the steps the global batch and ``ShardedTensor``
params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..incubate.distributed.models.moe.gate import (load_balance_aux_loss,
                                                    moe_capacity,
                                                    top_k_masks_with_drops)
from ..incubate.distributed.models.moe.moe_layer import (
    _activation, _moe_forward_op, _router, check_mesh, top_k_sorted)
from ..ops.grouped_matmul import align_rows, grouped_matmul, segment_starts
from . import compat as _compat
from .codec import decode_rows, encode_rows
from .specs import (EXPERT_AXIS, P, Mesh, NamedSharding, ShardedTensor,
                    SpecLayout, TensorSpec, expert_leaf_spec,
                    filter_divisible_spec, is_expert_leaf, layout_mesh_axes,
                    mesh_axis_sizes, spec_to_dim_axes)

__all__ = ["EXPERT_AXIS", "MoEEPConfig", "make_ep_all_to_all",
           "moe_ep_shapes", "moe_ep_spec_for", "moe_ep_layout",
           "init_moe_ep_params", "build_moe_ep_forward",
           "build_moe_ep_train_step", "build_moe_dense_train_step",
           "build_moe_ep_dropless_forward",
           "build_moe_ep_dropless_train_step"]

_EP_AXES = ("dp", "sharding", EXPERT_AXIS)


@dataclasses.dataclass(frozen=True)
class MoEEPConfig:
    """One MoE FFN block (mirror of ``MoEEPConfig``).  ``capacity_factor``
    sizes the capacity path's slots per expert per source shard
    (``ep_capacity`` of the rank's tokens) and ``capacity`` overrides it
    with an explicit count; the dropless path ignores both.
    ``aux_weight`` scales the load-balance aux loss."""

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
    """Global shapes of the block's leaves, keyed by name."""
    e, m, h = cfg.num_expert, cfg.d_model, cfg.d_hidden
    return {"gate_w": (m, e), "w_up": (e, m, h), "b_up": (e, h),
            "w_down": (e, h, m), "b_down": (e, m)}


# ---------------------------------------------------------------------------
# the at-rest plan
# ---------------------------------------------------------------------------


def moe_ep_spec_for(name: str) -> P:
    """The declared EP plan: expert-stacked leaves lead with ``ep``, shared
    leaves (the gate) replicate."""
    if is_expert_leaf(name):
        return expert_leaf_spec()
    return P()


def moe_ep_layout(cfg: MoEEPConfig, mesh: Mesh,
                  dtype: str = "float32") -> SpecLayout:
    """The block's ``SpecLayout`` under the at-rest rule (``ep`` among its
    mesh axes)."""
    entries = {}
    for name, shape in moe_ep_shapes(cfg).items():
        spec = filter_divisible_spec(moe_ep_spec_for(name), shape, mesh)
        entries[name] = TensorSpec(
            shape=tuple(int(d) for d in shape), dtype=str(dtype),
            dim_axes=spec_to_dim_axes(spec, len(shape)))
    return SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries)


def _ep_mesh(mesh, what: str) -> Mesh:
    """A live mesh for the block; None: the one-rank (1, 1, 1) mesh."""
    if mesh is None:
        return Mesh((1, 1, 1), _EP_AXES)
    return check_mesh(mesh, what)


def init_moe_ep_params(cfg: MoEEPConfig, mesh=None, seed: int = 0,
                       device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The block's fp32 params from ``np.random.RandomState(seed)``, drawn
    as the JAX ``init_moe_ep_params`` draws them, on ``device``: whole
    tensors without a mesh, else this rank's ``ShardedTensor`` blocks under
    the EP plan (the shard JAX places at the same mesh coordinate)."""
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
    out = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    if mesh is None:
        return out
    _ep_degree(cfg, mesh)
    mesh = check_mesh(mesh, "init_moe_ep_params")
    return {k: NamedSharding(mesh, filter_divisible_spec(
        moe_ep_spec_for(k), tuple(v.shape), mesh)).shard(v)
        for k, v in out.items()}


def _ep_degree(cfg: MoEEPConfig, mesh: Mesh) -> int:
    ep = int(mesh_axis_sizes(mesh).get(EXPERT_AXIS, 1))
    if cfg.num_expert % ep:
        raise ValueError(
            f"num_expert {cfg.num_expert} not divisible by ep degree {ep}: "
            f"expert stacks Shard(0) over ep need equal local expert counts")
    return ep


# ---------------------------------------------------------------------------
# the token transport: tiled all-to-all over ep, two-stage and coded
# ---------------------------------------------------------------------------


def _flat_a2a(x, axis: str, mesh, groups=None):
    return _compat._all_to_all_raw(x, axis, 0, 0, mesh, True, groups=groups)


def _ep_exchange_impl(x, axis: str, hier, codec, kind: str = "grad", *,
                      mesh):
    """One tiled all-to-all over ``axis`` (the leading dim holds one block
    per destination), two-stage when ``hier`` (a ``HierAxis``) is given:
    stage 1 within each slice regroups the blocks by destination
    intra-slice index, stage 2 exchanges destination-slice super-blocks
    across slices (each one encoded row under ``codec``).  The static
    reorders line the result up with the flat exchange's source-major
    order, so without a codec the two are equal bit for bit."""
    if hier is None:
        return _flat_a2a(x, axis, mesh)
    S, K, N = hier.num_slices, hier.per_slice, hier.size
    if x.shape[0] % N:
        raise ValueError(f"ep exchange: leading dim {x.shape[0]} not "
                         f"divisible by the ep axis size {N}")
    bs, rest = x.shape[0] // N, tuple(x.shape[1:])
    # stage-1 order: position j*S + s holds the block for ici_groups[s][j]
    ord1 = [hier.ici_groups[s][j] for j in range(K) for s in range(S)]
    b1 = x.reshape((N, bs) + rest)[torch.as_tensor(ord1).to(x.device)]
    r1 = _flat_a2a(b1.reshape((N * bs,) + rest), axis, mesh,
                   groups=hier.ici_groups)
    # destination-slice super-blocks: [K, S, ...] -> [S, K, ...]
    b2 = r1.reshape((K, S, bs) + rest).transpose(0, 1)
    rp = codec.resolve(kind) if codec is not None else None
    if rp is None:
        r2 = _flat_a2a(b2.reshape((N * bs,) + rest), axis, mesh,
                       groups=hier.dcn_groups)
    else:
        r2 = _dcn_a2a_coded(b2, axis, hier, codec, rp, mesh)
    # block s*K + j came from axis position ici_groups[s][j]
    src = [hier.ici_groups[s][j] for s in range(S) for j in range(K)]
    back = torch.as_tensor(np.argsort(src)).to(x.device)
    return r2.reshape((N, bs) + rest)[back].reshape((N * bs,) + rest)


def _dcn_a2a_coded(b2, axis: str, hier, codec, rp, mesh):
    """The inter-slice stage on the packed payload: the S destination-slice
    super-blocks encoded as S rows, one int8 all-to-all over the DCN
    groups, the S received rows decoded."""
    profile, stochastic = rp
    S = hier.num_slices
    row_shape = tuple(b2.shape[1:])
    n = math.prod(row_shape)
    packed = encode_rows(b2.reshape(S, n).float(), codec, profile,
                         stochastic=stochastic)
    ex = _flat_a2a(packed, axis, mesh, groups=hier.dcn_groups)
    return decode_rows(ex, n, codec, profile).reshape(
        (S,) + row_shape).to(b2.dtype)


class _EPExchange(torch.autograd.Function):
    """The exchange; its backward is the same exchange on the cotangent."""

    @staticmethod
    def forward(ctx, x, impl):
        ctx.impl = impl
        return impl(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.impl(g.contiguous()), None


def make_ep_all_to_all(axis: Optional[str], hier=None, codec=None,
                       kind: str = "grad", *, mesh=None):
    """The EP token transport over ``axis`` of ``mesh`` (mirror of
    ``make_ep_all_to_all``): ``exchange(x)`` with x's leading dim one block
    per destination rank; backward the same exchange (under ``kind``'s
    codec profile both ways).  ``axis=None`` (degree 1) is the identity.
    Where ``hier`` is given its stage groups must exist
    (``overlap.register_hier``, at build time on every rank)."""
    if axis is None:
        return lambda x: x

    def impl(x):
        return _ep_exchange_impl(x, axis, hier, codec, kind, mesh=mesh)

    def ep_exchange(x):
        return _EPExchange.apply(x, impl)

    return ep_exchange


# ---------------------------------------------------------------------------
# the EP regions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _EPPlan:
    """What a region needs of its mesh: the ep degree and this rank's
    expert range, the token-splitting axes, the exchanges."""

    mesh: Mesh
    ep: int
    e_local: int
    data_axes: Tuple[str, ...]
    hier: object
    codec: object
    exchange: object
    exchange_counts: object


def _ep_plan(cfg: MoEEPConfig, mesh, oc, batch_axes, what: str) -> _EPPlan:
    from .overlap import OverlapConfig, register_hier

    mesh = _ep_mesh(mesh, what)
    if oc is not None and not isinstance(oc, OverlapConfig):
        raise TypeError("oc= takes a parallel.overlap.OverlapConfig")
    oc = oc if oc is not None else OverlapConfig()
    sizes = mesh_axis_sizes(mesh)
    ep = _ep_degree(cfg, mesh)
    ep_ax = EXPERT_AXIS if ep > 1 else None
    hier = oc.resolve_hier(mesh, ep_ax) if ep_ax is not None else None
    if hier is not None:
        register_hier(mesh, ep_ax, hier)
    # quantize across slices only: no hierarchical ep axis, no codec
    codec = oc.codec if hier is not None else None
    return _EPPlan(
        mesh=mesh, ep=ep, e_local=cfg.num_expert // ep,
        data_axes=tuple(a for a in batch_axes if sizes.get(a, 0) > 1),
        hier=hier, codec=codec,
        exchange=make_ep_all_to_all(ep_ax, hier, codec, mesh=mesh),
        exchange_counts=make_ep_all_to_all(ep_ax, hier, None, mesh=mesh))


def _local(t):
    return t.local if isinstance(t, ShardedTensor) else t


def _stats_row(probs, e: int, dropped):
    """One batch shard's stats row [1, 2E + 1]: mean probability, top-1
    fraction and the overflow count (the last two without gradient)."""
    frac = F.one_hot(probs.argmax(dim=-1), e).float().mean(dim=0)
    return torch.cat([probs.mean(dim=0), frac.detach(),
                      dropped.detach().float().reshape(1)])[None]


def _entry(plan: _EPPlan, e: int, y, row):
    """The JAX entry's reduction of the gathered stats rows: the mean over
    shards of the probabilities and the top-1 fractions, GShard's aux
    over them, the overflow counts summed."""
    stats = _compat.gather_blocks(row, plan.data_axes, mesh=plan.mesh)
    me = stats[:, :e].mean(dim=0)
    load = stats[:, e:2 * e].detach().mean(dim=0)
    aux = e * (load * me).sum()
    return y, aux, stats[:, 2 * e].detach().sum(), load


def _tag(fwd, plan: _EPPlan):
    fwd.hier, fwd.codec = plan.hier, plan.codec
    fwd.ep, fwd.e_local = plan.ep, plan.e_local
    fwd.mesh, fwd.data_axes = plan.mesh, plan.data_axes
    return fwd


def build_moe_ep_forward(cfg: MoEEPConfig, mesh=None, oc=None,
                         batch_axes: Tuple[str, ...] = _EP_AXES,
                         local_tokens: Optional[int] = None):
    """The capacity MoE region, ``fwd(params, x2d) -> (y, aux, dropped,
    load)`` (mirror of ``build_moe_ep_forward``): ``params`` this rank's
    blocks, ``x2d`` [g_local, m] this rank's tokens (the global batch
    split over ``batch_axes``); ``y`` this rank's rows; ``aux``, ``dropped``
    (fp32) and ``load`` [E] the global values.  Routing at
    ``cfg.ep_capacity`` of the rank's tokens (or of ``local_tokens``), the
    ``[E, C, m]`` send buffer through the exchange, the local experts on
    ``[E_local, ep * C, m]`` with their weights cast to the tokens' dtype,
    the exchange back and the combine."""
    plan = _ep_plan(cfg, mesh, oc, batch_axes, "build_moe_ep_forward")
    e, ep, el = cfg.num_expert, plan.ep, plan.e_local

    def fwd(params, x2d):
        p = {k: _local(v) for k, v in params.items()}
        g_local, m = x2d.shape
        cap = cfg.ep_capacity(local_tokens if local_tokens is not None
                              else g_local)
        probs = _router(x2d, p["gate_w"])
        combine, dispatch, dropped = top_k_masks_with_drops(
            probs, cfg.top_k, cap)
        send = torch.einsum("gec,gm->ecm", dispatch.to(x2d.dtype), x2d)
        recv = plan.exchange(send)
        # source-rank-major blocks [ep, E_local, C, m] -> each local
        # expert sees every source shard's slots
        buf = recv.reshape(ep, el, cap, m).transpose(0, 1).reshape(
            el, ep * cap, m)
        h = torch.einsum("ecm,emh->ech", buf, p["w_up"].to(buf.dtype)) \
            + p["b_up"].to(buf.dtype)[:, None, :]
        h = _activation(h, cfg.activation)
        eo = torch.einsum("ech,ehm->ecm", h, p["w_down"].to(h.dtype)) \
            + p["b_down"].to(h.dtype)[:, None, :]
        back = eo.reshape(el, ep, cap, m).transpose(0, 1).reshape(e, cap, m)
        y = torch.einsum("gec,ecm->gm", combine.to(x2d.dtype),
                         plan.exchange(back))
        return _entry(plan, e, y, _stats_row(probs, e, dropped))

    return _tag(fwd, plan)


def build_moe_ep_dropless_forward(cfg: MoEEPConfig, mesh=None, oc=None,
                                  batch_axes: Tuple[str, ...] = _EP_AXES,
                                  block_rows: int = 8):
    """The dropless MoE region, ``fwd(params, x2d) -> (y, aux, dropped,
    load)`` (mirror of ``build_moe_ep_dropless_forward``), the capacity
    region's contract with no capacity buffer: ``dropped`` is 0.  Per
    rank: top-k on the fp32 probabilities (raw weights), the copies sorted
    by expert (stable); the int32 counts [ep, E_local] through the
    exchange first (never coded); the payload in static windows of ``W =
    g_local * top_k`` rows per destination, dead rows zero; the received
    windows compacted into block-aligned segments, one per local expert;
    the expert GEMMs on the grouped-matmul kernels (``block_rows`` the
    segment quantum), rows past the last segment masked; each window row's
    output (with its ``b_down``) back through the exchange, weighted and
    added in token order."""
    plan = _ep_plan(cfg, mesh, oc, batch_axes,
                    "build_moe_ep_dropless_forward")
    e, ep, el, bm = cfg.num_expert, plan.ep, plan.e_local, int(block_rows)

    def fwd(params, x2d):
        p = {k: _local(v) for k, v in params.items()}
        g_local, m = x2d.shape
        dev = x2d.device
        probs = _router(x2d, p["gate_w"])
        top_p, top_ids = top_k_sorted(probs, cfg.top_k)
        T = W = g_local * cfg.top_k
        flat_ids = top_ids.reshape(-1).to(torch.int32)
        order = torch.argsort(flat_ids, stable=True)
        token_of = order // cfg.top_k
        sorted_ids = flat_ids[order].long()
        wsorted = top_p.reshape(-1)[order]
        counts = torch.zeros(e, dtype=torch.int32, device=dev).scatter_add_(
            0, flat_ids.long(), torch.ones_like(flat_ids))
        # counts first: row p = what source rank p routes to my experts
        counts_from = plan.exchange_counts(
            counts.reshape(ep, el)).reshape(ep, el)
        # copies are expert-sorted, so destination-sorted: rank r's run
        # lands at the head of r's window
        rank_of = sorted_ids // el
        rank_counts = counts.reshape(ep, el).sum(dim=1)
        rank_starts = torch.cumsum(rank_counts, 0) - rank_counts
        pos = torch.arange(T, device=dev) - rank_starts[rank_of]
        slot = rank_of * W + pos
        # at ep 1 the one window is the sorted copy list: no scatter
        send = x2d[token_of]
        if ep > 1:
            send = torch.zeros((ep * W, m), dtype=x2d.dtype,
                               device=dev).index_copy(0, slot, send)
        recv = plan.exchange(send)          # window p: rows from rank p
        # row q of window p belongs to local expert l (searchsorted on the
        # running counts) and lands at segment_start[l] + rows from earlier
        # ranks for l + its index within the (p, l) run
        cum_in = torch.cumsum(counts_from, dim=1)
        off_in = cum_in - counts_from
        col_ex = torch.cumsum(counts_from, dim=0) - counts_from
        tot_l = counts_from.sum(dim=0).to(torch.int32)
        seg_st = segment_starts(tot_l, bm)
        rows_used = align_rows(tot_l, bm).sum()
        rpad = int(align_rows(ep * W, bm) + el * bm)
        q = torch.arange(W, device=dev)
        l_c = torch.searchsorted(cum_in.contiguous(),
                                 q.expand(ep, W).contiguous().to(
                                     cum_in.dtype),
                                 right=True).clamp(max=el - 1)
        valid = q[None, :] < cum_in[:, -1:]
        p_idx = torch.arange(ep, device=dev)[:, None]
        dest = (seg_st[l_c] + col_ex[p_idx, l_c]
                + (q[None, :] - off_in[p_idx, l_c])).long()
        destf = torch.where(valid, dest, rpad).reshape(-1)
        # dead window rows go to one extra row, cut off
        xr = torch.zeros((rpad + 1, m), dtype=x2d.dtype,
                         device=dev).index_copy(0, destf, recv)[:rpad]
        blk_cum = torch.cumsum(align_rows(tot_l, bm), 0)
        rows = torch.arange(rpad, device=dev)
        rexp = torch.searchsorted(blk_cum, rows.to(blk_cum.dtype),
                                  right=True).clamp(max=el - 1)
        row_valid = (rows < rows_used)[:, None]
        wids = torch.arange(el, dtype=torch.int32, device=dev)
        h = grouped_matmul(xr, p["w_up"].to(x2d.dtype), seg_st, tot_l,
                           wids, bm)
        h = torch.where(row_valid, h + p["b_up"].to(h.dtype)[rexp], 0.0)
        h = _activation(h, cfg.activation)
        eo = grouped_matmul(h, p["w_down"].to(h.dtype), seg_st, tot_l,
                            wids, bm)
        dest_cl = dest.clamp(max=rpad - 1).reshape(-1)
        back = eo[dest_cl] + p["b_down"].to(eo.dtype)[l_c.reshape(-1)]
        if ep > 1:
            back = torch.where(valid.reshape(-1)[:, None], back, 0.0)
        ys = plan.exchange(back.to(x2d.dtype))
        if ep > 1:
            ys = ys[slot]
        y = torch.zeros((g_local, m), dtype=x2d.dtype, device=dev).index_add(
            0, token_of, ys * wsorted.to(x2d.dtype)[:, None])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return _entry(plan, e, y, _stats_row(probs, e, zero))

    fwd.block_rows = bm
    return _tag(fwd, plan)


# ---------------------------------------------------------------------------
# train steps (EP and the dense single-device reference)
# ---------------------------------------------------------------------------


def _moe_loss(y, x2d, tgt, aux, aux_weight: float, shards: int = 1):
    """The MSE-against-target objective of the JAX steps: the per-token
    squared error summed (per batch shard, the partials added in shard
    order when ``shards`` > 1, as the dense reference mimics the EP psum),
    and the weighted aux term."""
    se = ((x2d + y).float() - tgt).square().sum(dim=-1)
    total = se.reshape(shards, -1).sum(dim=1).sum() if shards > 1 \
        else se.sum()
    return total, aux_weight * aux


def _batch_block(x, mesh, axes):
    """This rank's block of dim 0 over ``axes``."""
    n = math.prod(int(mesh.shape[a]) for a in axes)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} tokens does not split over "
                         f"{axes} ({n} shards)")
    b = x.shape[0] // n
    return x.narrow(0, mesh.block_index(axes) * b, b)


def _ep_step(fwd, cfg: MoEEPConfig, lr: float):
    """``step(params, x2d, tgt) -> (loss, aux, dropped, load, params)``
    over a region: this rank's block of the global batch, the loss = the
    per-shard squared-error sums added in shard order / the global token
    count + ``aux_weight * aux``, SGD on the local blocks in place.
    ``step.gradients(params, x2d, tgt)`` is the gradient half: (loss, aux,
    dropped, load, the ``ShardedTensor`` blocks, their complete gradient
    blocks)."""
    mesh, data = fwd.mesh, fwd.data_axes
    sizes = mesh_axis_sizes(mesh)
    # ranks along a mesh axis that does not split the tokens hold the same
    # rows: each counts 1/rep of them, so every gradient sums over every
    # axis its leaf is not cut along
    rep = math.prod(n for a, n in sizes.items() if a not in data)

    def placed(params):
        out = {}
        for k, v in params.items():
            if isinstance(v, ShardedTensor):
                out[k] = v
                continue
            ns = NamedSharding(mesh, filter_divisible_spec(
                moe_ep_spec_for(k), tuple(v.shape), mesh))
            out[k] = ns.wrap(v, v.shape) if mesh.size == 1 else ns.shard(v)
        return out

    def gradients(params, x2d, tgt):
        """(loss, aux, dropped, load, the blocks at rest, their complete
        gradient blocks)."""
        at_rest = placed(params)
        xb, tb = _batch_block(x2d, mesh, data), _batch_block(tgt, mesh, data)
        leaves = {k: v.local.detach().requires_grad_()
                  for k, v in at_rest.items()}
        y, aux, dropped, load = fwd(leaves, xb)
        se, aux_term = _moe_loss(y, xb, tb, aux, cfg.aux_weight)
        total = _compat.gather_blocks(se.reshape(1), data, mesh=mesh).sum()
        loss = total / x2d.shape[0] + aux_term
        grads = torch.autograd.grad(loss / rep, list(leaves.values()))
        done = {}
        for (k, v), g in zip(at_rest.items(), grads):
            axes = tuple(a for a, n in sizes.items()
                         if n > 1 and a not in v.axes_at_rest())
            done[k] = v.with_local(g, axes).complete().local
        return loss.detach(), aux.detach(), dropped, load, at_rest, done

    def step(params, x2d, tgt):
        loss, aux, dropped, load, at_rest, grads = gradients(params, x2d,
                                                              tgt)
        with torch.no_grad():
            for k, v in at_rest.items():
                v.local.sub_(lr * grads[k].to(v.dtype))
        plain = mesh.size == 1 and not any(isinstance(v, ShardedTensor)
                                           for v in params.values())
        return loss, aux, dropped, load, params if plain else at_rest

    step.gradients = gradients
    step.forward = fwd
    return step


def build_moe_ep_train_step(cfg: MoEEPConfig, mesh=None, oc=None,
                            batch_axes: Tuple[str, ...] = _EP_AXES,
                            lr: float = 1e-2,
                            local_tokens: Optional[int] = None):
    """The capacity train step (mirror of ``build_moe_ep_train_step``):
    ``step(params, x2d, tgt) -> (loss, aux, dropped, load, params)``, the
    residual block ``y = x + moe(x)`` against an MSE target plus the
    weighted aux loss, plain SGD at ``lr``, the params updated IN PLACE
    (the JAX step donates them).  ``x2d``/``tgt`` are the global batch; on
    a mesh ``params`` are ``ShardedTensor`` blocks (plain global tensors
    are cut, and the blocks returned)."""
    fwd = build_moe_ep_forward(cfg, mesh, oc, batch_axes, local_tokens)
    return _ep_step(fwd, cfg, lr)


def build_moe_ep_dropless_train_step(cfg: MoEEPConfig, mesh=None, oc=None,
                                     batch_axes: Tuple[str, ...] = _EP_AXES,
                                     lr: float = 1e-2, block_rows: int = 8):
    """The dropless train step (mirror of
    ``build_moe_ep_dropless_train_step``): the capacity step's objective,
    SGD and contract over the dropless region."""
    fwd = build_moe_ep_dropless_forward(cfg, mesh, oc, batch_axes,
                                        block_rows)
    return _ep_step(fwd, cfg, lr)


def build_moe_dense_train_step(cfg: MoEEPConfig, lr: float = 1e-2,
                               capacity: Optional[int] = None,
                               shards: int = 1):
    """The dense single-device reference step (mirror of
    ``build_moe_dense_train_step``): the same objective over
    ``MoELayer``'s capacity op with a pinned global capacity (default:
    every token fits) and the gshard aux loss; ``shards`` sums the squared
    error per shard first, as the EP step does.  ``step(params, x2d, tgt)
    -> (loss, aux, dropped, params)``, the params updated IN PLACE."""

    def step(params, x2d, tgt):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y, aux, dropped = _moe_forward_op(
            x2d, leaves["gate_w"], leaves["w_up"], leaves["b_up"],
            leaves["w_down"], leaves["b_down"], topk=cfg.top_k,
            capacity=capacity if capacity is not None else x2d.shape[0],
            aux_fn=load_balance_aux_loss, activation=cfg.activation)
        total, aux_term = _moe_loss(y, x2d, tgt, aux, cfg.aux_weight, shards)
        loss = total / x2d.shape[0] + aux_term
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                params[k].sub_(lr * g.to(params[k].dtype))
        return loss.detach(), aux.detach(), dropped, params

    return step
