"""Communication-overlap engine of the decoder stack.

Port of ``paddle_tpu/parallel/overlap.py``.  On a sharding-3 x TP mesh the
mesh train step gathers every ZeRO-3 weight where it is used and reduces
every weight gradient where it completes, each collective blocking; this
module writes the collective schedule of the decoder stack out, as five
levers (``OverlapConfig``):

1. **Layer-ahead gather prefetch.** A layer's weights cut over
   ``sharding`` travel as size-capped flat buckets; layer i+1's bucket
   all-gathers are issued asynchronously (``async_op=True``) before layer
   i's compute and waited just before layer i+1 unpacks them: exactly L
   gathers per bucket, none wrapped around.  Under remat the gather sits
   inside the checkpointed layer, so the backward gathers again, and the
   next layer's gather is still issued ahead of the current layer's
   forward (the recomputation gathers synchronously).
2. **Bucketed gradient reduce-scatter.** A bucket's backward issues one
   reduce-scatter (then the psums over the other batch axes), the last
   collective of that chain asynchronously, into a buffer nothing reads
   until the step has waited every outstanding ``Work``: the bucket
   gradients reach the layer's leaves when the step unpacks them
   (``stack.grads``), after the backward.
3. **Collective matmul for TP.** The row-parallel projections (o_proj,
   down_proj) run as a ``ppermute`` ring above a size threshold, each
   chunk's product overlapping the previous partial sum's transfer.
4. **Two-stage collectives.** Where ``sharding`` spans slices
   (``distributed.topology.hierarchical_axis``; on the port's ranks only an
   explicit ``slice_map`` arms it), gathers and reduce-scatters run within
   each slice first and across slices on the 1/per_slice residue, over the
   ``axis_index_groups`` of ``parallel/compat.py``.
5. **The codec on the inter-slice stage** (``parallel/codec.py``): only
   the residue that crosses slices is quantized, encoded once, decoded at
   the receiver and summed in fp32; the intra-slice stage stays in full
   precision, and without a hierarchy the codec is inert.

The layer (``decoder_layer_tp``) runs the mesh step's layer body
(``models/llama.py``'s ``decoder_layer_forward``) on the gathered weights,
with the same tensor-parallel convention, a replicated value carrying the
whole cotangent on every rank (``pbroadcast`` before the column-parallel
projections, the row-parallel sum's backward the identity), so at world
size 1 the two run the same arithmetic.  The JAX region's shard_map
instead divides the output cotangent by the unnamed axes and psums every
input's over them, on top of the region's own gradient syncs; its
gradients then exceed the loss's by the size of those axes (the JAX
overlap step's bucket leaves by dp, its replicated leaves by dp x
sharding, the embedding by mp), which AdamW's scale invariance hides from
its parity tests.  The port keeps the loss's gradients.

What stays in the JAX package for later work: ``OVERLAP_REGION_FUNCS``
names JAX frames for the Graph Doctor, and the XLA latency-hiding flags
have no PyTorch counterpart; both wait for ROADMAP A7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compat as _compat
from .codec import CollectiveCodec, decode_rows, encode_rows
from .compat import Pending, _ready, all_gather_raw, all_reduce_raw, \
    reduce_scatter_raw


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

# below this many output elements a ring step's chunk product is too small
# to hide a hop behind; the plain matmul and one psum win
COLLECTIVE_MATMUL_MIN_OUT_ELEMS = 1 << 16


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Per-lever switches of the overlap engine (mirror of
    ``OverlapConfig``).

    ``hierarchical``: "auto" asks ``distributed.topology`` (two-stage only
    when the sharding axis spans slices; the port's ranks expose no slice
    index, so "auto" is flat unless ``slice_map`` is given), "on" requires
    ``slice_map``, "off" forces flat collectives.  ``codec``: the
    inter-slice codec, active only when a hierarchy resolves."""

    prefetch: bool = True
    bucket_bytes: int = 4 << 20
    collective_matmul: bool = True
    collective_matmul_min_out_elems: int = COLLECTIVE_MATMUL_MIN_OUT_ELEMS
    hierarchical: str = "auto"          # "auto" | "on" | "off"
    slice_map: Optional[Tuple[int, ...]] = None
    codec: Optional[CollectiveCodec] = None

    def hides_collectives(self) -> bool:
        """Whether the schedule can hide collective time behind layer
        compute (only the prefetch pipeline does)."""
        return bool(self.prefetch)

    def resolve_hier(self, mesh, axis: Optional[str]):
        """The ``HierAxis`` of ``axis`` under this config, or None (plan
        math only: ``register_hier`` makes its process groups)."""
        from ..distributed.topology import hierarchical_axis

        if self.hierarchical == "off" or axis is None:
            return None
        if self.hierarchical not in ("auto", "on"):
            raise ValueError(
                f"OverlapConfig.hierarchical={self.hierarchical!r}; "
                "expected 'auto', 'on' or 'off'")
        hier = hierarchical_axis(mesh, axis, self.slice_map)
        if self.hierarchical == "on" and hier is None:
            raise ValueError(
                "hierarchical='on' but the mesh axis does not span "
                "slices and no slice_map was given")
        return hier


def register_hier(mesh, axis: str, hier) -> None:
    """Make the process groups of ``hier``'s two stages on a live mesh (a
    collective over the world: every rank calls it, at build time)."""
    if hier is not None and mesh.size > 1:
        mesh.create_index_groups(axis, hier.ici_groups)
        mesh.create_index_groups(axis, hier.dcn_groups)


def _then(p, fn: Callable, async_op: bool):
    return p.then(fn) if async_op else fn(p)


# ---------------------------------------------------------------------------
# two-stage collectives (values; the bucket transport runs them)
# ---------------------------------------------------------------------------


def _hier_block_order(hier) -> np.ndarray:
    """Block permutation that lines the two-stage chunk layout up with the
    flat reduce-scatter's (axis position p holds block p): position
    ``ici_groups[s][j]`` ends with block ``j*S + s``."""
    S, K = hier.num_slices, hier.per_slice
    order = np.empty(S * K, dtype=np.int64)
    for s in range(S):
        for j in range(K):
            order[j * S + s] = hier.ici_groups[s][j]
    return order


def _split_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    lead = x.shape[0]
    if lead % n:
        raise ValueError(f"leading dim {lead} not divisible by {n} "
                         f"(hierarchical block split)")
    return x.reshape((n, lead // n) + tuple(x.shape[1:]))


def _codec_resolve(codec: Optional[CollectiveCodec], kind: str):
    if codec is None:
        return None
    return codec.resolve(kind)


def hier_psum_scatter(x: torch.Tensor, axis: str, hier,
                      codec: Optional[CollectiveCodec] = None,
                      kind: str = "grad", *, mesh, async_op: bool = False):
    """Two-stage reduce-scatter over ``axis`` along dim 0: equal to the
    flat ``psum_scatter`` (the same block at the same position), the
    inter-slice stage on the intra-slice residue, coded under ``codec``.
    With ``async_op`` the last collective is left in flight (a
    ``Pending``)."""
    order = torch.as_tensor(_hier_block_order(hier), device=x.device)
    x2 = _split_blocks(x, hier.size)[order].reshape(tuple(x.shape))
    y = reduce_scatter_raw(x2, axis, 0, mesh, groups=hier.ici_groups)
    rp = _codec_resolve(codec, kind)
    if rp is None:
        return reduce_scatter_raw(y, axis, 0, mesh, groups=hier.dcn_groups,
                                  async_op=async_op)
    return _dcn_psum_scatter_coded(y, axis, hier, codec, rp, mesh=mesh,
                                   async_op=async_op)


def _dcn_psum_scatter_coded(y, axis: str, hier, codec, rp, *, mesh,
                            async_op: bool = False):
    """The inter-slice reduce-scatter on the packed payload: encode the S
    per-destination residue rows, one int8 all-to-all over the DCN groups,
    decode the S received rows in fp32 and sum them."""
    profile, stochastic = rp
    S = hier.num_slices
    rows = _split_blocks(y, S)
    row_shape = tuple(rows.shape[1:])
    n = math.prod(row_shape)
    packed = encode_rows(rows.reshape(S, n), codec, profile,
                         stochastic=stochastic)
    ex = _compat._all_to_all_raw(packed, axis, 0, 0, mesh, True,
                                 groups=hier.dcn_groups, async_op=async_op)

    def finish(ex):
        dec = decode_rows(ex, n, codec, profile)
        return dec.sum(dim=0).reshape(row_shape).to(y.dtype)

    return _then(ex, finish, async_op)


def hier_all_gather(x: torch.Tensor, axis: str, hier,
                    codec: Optional[CollectiveCodec] = None,
                    kind: str = "weight", *, mesh, async_op: bool = False):
    """Two-stage all-gather along dim 0, the inverse of
    ``hier_psum_scatter`` (and equal to the flat tiled all-gather): the
    inter-slice stage first (coded under ``codec``), then the intra-slice
    stage on the decoded values, then the block un-permute.  With
    ``async_op`` the inter-slice stage is left in flight and the rest runs
    at ``wait()``."""
    order = _hier_block_order(hier)
    rp = _codec_resolve(codec, kind)
    if rp is None:
        y = all_gather_raw(x, axis, 0, mesh, groups=hier.dcn_groups,
                           async_op=async_op)
    else:
        y = _dcn_all_gather_coded(x, axis, hier, codec, rp, mesh=mesh,
                                  async_op=async_op)

    def finish(y):
        z = all_gather_raw(y, axis, 0, mesh, groups=hier.ici_groups)
        inv = torch.as_tensor(np.argsort(order), device=z.device)
        return _split_blocks(z, hier.size)[inv].reshape(
            (-1,) + tuple(x.shape[1:]))

    return _then(y, finish, async_op)


def _dcn_all_gather_coded(x, axis: str, hier, codec, rp, *, mesh,
                          async_op: bool = False):
    """The inter-slice all-gather on the packed payload: encode the local
    shard as one row, gather the rows over the DCN groups, decode each."""
    profile, stochastic = rp
    n = x.numel()
    packed = encode_rows(x.reshape(1, n), codec, profile,
                         stochastic=stochastic)
    g = all_gather_raw(packed, axis, 0, mesh, groups=hier.dcn_groups,
                       async_op=async_op)

    def finish(g):
        dec = decode_rows(g, n, codec, profile)
        return dec.reshape((hier.num_slices * x.shape[0],)
                           + tuple(x.shape[1:])).to(x.dtype)

    return _then(g, finish, async_op)


def hier_psum(x: torch.Tensor, axis: str, hier,
              codec: Optional[CollectiveCodec] = None, kind: str = "grad",
              *, mesh, async_op: bool = False):
    """Two-stage all-reduce over ``axis``: an fp32 psum within each slice,
    then the residue crosses slices as the packed payload (encode, gather
    over the DCN groups, decode, sum), the same on every rank.  Without a
    codec for ``kind`` it is the flat psum."""
    rp = _codec_resolve(codec, kind)
    if rp is None:
        return all_reduce_raw(x, axis, mesh, async_op=async_op)
    profile, stochastic = rp
    y = all_reduce_raw(x, axis, mesh, groups=hier.ici_groups)
    n = y.numel()
    packed = encode_rows(y.reshape(1, n), codec, profile,
                         stochastic=stochastic)
    g = all_gather_raw(packed, axis, 0, mesh, groups=hier.dcn_groups,
                       async_op=async_op)

    def finish(g):
        dec = decode_rows(g, n, codec, profile)
        return dec.sum(dim=0).reshape(y.shape).to(x.dtype)

    return _then(g, finish, async_op)


# ---------------------------------------------------------------------------
# the bucket transport (the ZeRO-3 wire format)
# ---------------------------------------------------------------------------


class _BucketGather(torch.autograd.Function):
    """The gathered bucket of one fetch.  Standalone (``sink`` None) the
    input is the local bucket and the backward returns its reduced
    gradient; in the step the inputs are the layer's leaves of the bucket
    (so the node lies on their gradient path), and the backward leaves the
    reduction in flight in ``sink`` and returns nothing."""

    @staticmethod
    def forward(ctx, transport, fetch, sink, key, *inputs):
        ctx.meta = (transport, sink, key, len(inputs))
        return fetch.wait()

    @staticmethod
    def backward(ctx, g):
        transport, sink, key, n = ctx.meta
        if sink is None:
            return (None,) * 4 + (transport.reduce(g),)
        sink.add(key, transport.reduce(g, async_op=True))
        return (None,) * (4 + n)


class BucketTransport:
    """A flat bucket's way over ``axis`` (``make_bucket_gather``): the
    forward all-gathers the local bucket (two-stage under ``hier``), the
    backward reduce-scatters its cotangent (``grad_mode="scatter"``: the
    batch rides the axis too) or keeps this rank's slice of it ("slice":
    every rank computed the same cotangent), then psums over
    ``batch_psum_axes``.  ``codec`` (with ``hier``) quantizes the
    inter-slice stage of both directions."""

    def __init__(self, axis: Optional[str], hier=None,
                 batch_psum_axes: Tuple[str, ...] = (),
                 grad_mode: str = "scatter",
                 codec: Optional[CollectiveCodec] = None, *, mesh):
        if grad_mode not in ("scatter", "slice"):
            raise ValueError(f"grad_mode {grad_mode!r}")
        self.axis, self.hier, self.codec = axis, hier, codec
        self.batch_psum_axes = tuple(batch_psum_axes)
        self.grad_mode, self.mesh = grad_mode, mesh

    def gather(self, local: torch.Tensor, async_op: bool = False):
        """The all-gathered bucket (a ``Pending`` with ``async_op``)."""
        local = local.detach()
        if self.axis is None:
            return _ready(local, async_op)
        if self.hier is not None:
            return hier_all_gather(local, self.axis, self.hier, self.codec,
                                   "weight", mesh=self.mesh,
                                   async_op=async_op)
        return all_gather_raw(local, self.axis, 0, self.mesh,
                              async_op=async_op)

    def reduce(self, g: torch.Tensor, async_op: bool = False):
        """The backward's chain: every collective but the last runs now,
        the last is left in flight with ``async_op``."""
        stages: List[Callable] = []
        mesh = self.mesh
        if self.axis is not None:
            if self.grad_mode == "slice":
                n = mesh.shape[self.axis]
                blk = g.shape[0] // n
                g = g.narrow(0, mesh.axis_index(self.axis) * blk, blk)
            elif self.hier is not None:
                stages.append(lambda t, a: hier_psum_scatter(
                    t, self.axis, self.hier, self.codec, "grad", mesh=mesh,
                    async_op=a))
            else:
                stages.append(lambda t, a: reduce_scatter_raw(
                    t, self.axis, 0, mesh, async_op=a))
        for ax in self.batch_psum_axes:
            stages.append(lambda t, a, ax=ax: all_reduce_raw(
                t, ax, mesh, async_op=a))
        if not stages:
            return _ready(g.contiguous(), async_op)
        for stage in stages[:-1]:
            g = stage(g, False)
        return stages[-1](g, async_op)

    def attach(self, fetch: Pending, anchors: Sequence[torch.Tensor],
               sink: "StackGrads", key) -> torch.Tensor:
        """Wait ``fetch`` as the gathered bucket of the step's autograd
        graph: its gradient leaves in flight into ``sink[key]``."""
        return _BucketGather.apply(self, fetch, sink, key, *anchors)

    def __call__(self, bucket_local: torch.Tensor) -> torch.Tensor:
        """The gathered bucket with autograd (the JAX custom_vjp)."""
        return _BucketGather.apply(self, self.gather(bucket_local, True),
                                   None, None, bucket_local)


def make_bucket_gather(axis: Optional[str], hier=None,
                       batch_psum_axes: Tuple[str, ...] = (),
                       grad_mode: str = "scatter",
                       codec: Optional[CollectiveCodec] = None, *,
                       mesh) -> BucketTransport:
    """The bucket transport (mirror of ``make_bucket_gather``; see
    ``BucketTransport``)."""
    return BucketTransport(axis, hier, batch_psum_axes, grad_mode, codec,
                           mesh=mesh)


class StackGrads:
    """Where the stack's bucket backwards leave their reductions in
    flight, keyed (bucket, layer).  ``wait_all`` waits every one (nothing
    reads their buffers before); the stack's ``grads`` then cuts each
    layer's leaf gradients out."""

    def __init__(self):
        self.pending: Dict[Any, Pending] = {}

    def add(self, key, pending: Pending) -> None:
        if key in self.pending:
            raise RuntimeError(f"bucket {key} reduced twice in one backward")
        self.pending[key] = pending

    def wait_all(self) -> Dict[Any, torch.Tensor]:
        return {k: p.wait() for k, p in self.pending.items()}


class _GradSync(torch.autograd.Function):
    """Identity on one or several tensors whose backward psums their
    cotangents over ``axes`` as one flat row (one collective per axis, the
    ``hier`` axis two-stage under ``codec``)."""

    @staticmethod
    def forward(ctx, axes, hier_axis, hier, codec, mesh, *xs):
        ctx.meta = (axes, hier_axis, hier, codec, mesh)
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        axes, hier_axis, hier, codec, mesh = ctx.meta
        g = torch.cat([t.reshape(-1) for t in gs]) if len(gs) > 1 \
            else gs[0]
        for a in axes:
            if a == hier_axis and codec is not None:
                g = hier_psum(g, a, hier, codec=codec, kind="grad",
                              mesh=mesh)
            else:
                g = all_reduce_raw(g, a, mesh)
        out, off = [], 0
        for shape in ctx.shapes:
            n = math.prod(shape)
            out.append(g[off:off + n].reshape(shape))
            off += n
        return (None,) * 5 + tuple(out)


def make_grad_sync(reduce_axes: Tuple[str, ...], hier_axis=None, hier=None,
                   codec: Optional[CollectiveCodec] = None, *,
                   mesh) -> Callable:
    """Identity whose backward psums over ``reduce_axes`` (the replicated
    leaves' gradient reduction, in the owning layer's backward); the
    ``hier_axis`` psum runs two-stage with the residue coded when ``codec``
    quantizes gradients.  Takes one tensor, or several (their cotangents
    reduced as one row) and returns them as a tuple."""
    axes = tuple(a for a in reduce_axes if mesh.shape.get(a, 1) > 1)
    use_codec = (hier is not None and hier_axis in axes
                 and _codec_resolve(codec, "grad") is not None)
    c = codec if use_codec else None

    def sync(*xs):
        out = _GradSync.apply(axes, hier_axis, hier, c, mesh, *xs) \
            if axes else xs
        return out if len(xs) > 1 else out[0]

    return sync


# ---------------------------------------------------------------------------
# the layer layout and the bucket plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _LeafPlace:
    suffix: str
    shape: Tuple[int, ...]        # GLOBAL shape
    sh_dim: Optional[int]         # dim cut over 'sharding' (None: no)
    mp_dim: Optional[int]         # dim cut over 'mp' (None: no)

    def local_shape(self, sh: int, mp: int) -> Tuple[int, ...]:
        s = list(self.shape)
        if self.sh_dim is not None:
            s[self.sh_dim] //= sh
        if self.mp_dim is not None:
            s[self.mp_dim] //= mp
        return tuple(s)


def plan_layer_layout(shapes: Dict[str, Tuple[int, ...]], mesh,
                      spec_for: Callable) -> Dict[str, _LeafPlace]:
    """Per suffix, the dim each of ``sharding`` and ``mp`` cuts
    (``specs.axis_dim_picks``: each axis falls back to replication on its
    own)."""
    from .specs import axis_dim_picks

    out: Dict[str, _LeafPlace] = {}
    for suffix, shape in shapes.items():
        picks = axis_dim_picks(spec_for(suffix), shape, mesh,
                               axes=("sharding", "mp"))
        out[suffix] = _LeafPlace(suffix, tuple(int(d) for d in shape),
                                 picks["sharding"], picks["mp"])
    return out


def leaf_partition_spec(place: _LeafPlace, lead: Optional[str] = None):
    """PartitionSpec of one stacked leaf (a leading [L] dim, replicated or
    cut over ``lead``)."""
    from .specs import P

    entries: List[Any] = [None] * len(place.shape)
    if place.sh_dim is not None:
        entries[place.sh_dim] = "sharding"
    if place.mp_dim is not None:
        entries[place.mp_dim] = "mp"
    return P(lead, *entries)


def chunk_leaf_spec(place: _LeafPlace):
    """[v, blk, *local] spec of the hybrid path's chunked leaves: the chunk
    dim over pp, the block dim replicated, the inner dims the leaf's own."""
    from .specs import P

    return P("pp", None, *tuple(leaf_partition_spec(place))[1:])


def split_by_bytes(items: Sequence[str], bytes_of, cap: int
                   ) -> List[List[str]]:
    """Greedy size-capped accumulate-and-split: the cap splits, never
    reorders; an item larger than the cap gets its own bucket."""
    buckets: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for it in items:
        nbytes = int(bytes_of(it))
        if cur and cur_bytes + nbytes > cap:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(it)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def plan_buckets(layout: Dict[str, _LeafPlace], order: Sequence[str],
                 sh: int, mp: int, bucket_bytes: int, itemsize: int
                 ) -> List[List[str]]:
    """Size-capped buckets over the gathered leaves, in traversal order."""
    gathered = [s for s in order if layout[s].sh_dim is not None]
    return split_by_bytes(
        gathered,
        lambda s: math.prod(layout[s].local_shape(sh, mp)) * itemsize,
        bucket_bytes)


def _pack_bucket(leaves: Dict[str, Sequence[torch.Tensor]],
                 bucket: Sequence[str], local: Dict[str, Tuple[int, ...]],
                 dtype: torch.dtype) -> torch.Tensor:
    """The L layers' blocks of ``bucket`` (suffix -> the per-layer tensors,
    of shape ``local[suffix]``) written, cast to ``dtype``, into one
    preallocated [L, bucket_elems] buffer.  No autograd: the gradients come
    back through the transport's sink (``_unpack_bucket_grads``)."""
    L = len(leaves[bucket[0]])
    n = [math.prod(local[s]) for s in bucket]
    with torch.no_grad():
        buf = torch.empty((L, sum(n)), dtype=dtype,
                          device=leaves[bucket[0]][0].device)
        for i in range(L):
            off = 0
            for s, k in zip(bucket, n):
                buf[i, off:off + k].copy_(leaves[s][i].reshape(-1))
                off += k
    return buf


def _unpack_bucket_grads(rows: Sequence[torch.Tensor], bucket: Sequence[str],
                         local: Dict[str, Tuple[int, ...]],
                         leaves: Dict[str, Sequence[torch.Tensor]]
                         ) -> Dict[str, List[torch.Tensor]]:
    """Inverse of ``_pack_bucket`` for the gradients: ``rows[i]`` is layer
    i's reduced bucket gradient (waited); each leaf's is cut out of it, in
    the leaf's dtype."""
    out: Dict[str, List[torch.Tensor]] = {s: [] for s in bucket}
    for i, row in enumerate(rows):
        row = row.reshape(-1)
        off = 0
        for s in bucket:
            n = math.prod(local[s])
            out[s].append(row[off:off + n].reshape(local[s]).to(
                leaves[s][i].dtype))
            off += n
    return out


def _unpack_bucket_full(flat_full: torch.Tensor, bucket: Sequence[str],
                        layout: Dict[str, _LeafPlace], sh: int, mp: int
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of the pack after the gather: ``flat_full`` is [sh *
    bucket_elems] (rank-major); each leaf's sharding-gathered, mp-local
    tensor is its per-rank segments joined along its sharded dim."""
    out: Dict[str, torch.Tensor] = {}
    seg = flat_full.reshape(sh, -1)
    off = 0
    for sfx in bucket:
        pl = layout[sfx]
        lshape = pl.local_shape(sh, mp)
        n = math.prod(lshape)
        pieces = seg[:, off:off + n].reshape((sh,) + lshape)
        out[sfx] = torch.cat(pieces.unbind(0), dim=pl.sh_dim) if sh > 1 \
            else pieces[0]
        off += n
    return out


def llama_layer_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Global shapes of one Llama decoder layer's leaves by suffix."""
    h, nh, nkv, hd, it = (cfg.hidden_size, cfg.num_attention_heads,
                          cfg.num_key_value_heads, cfg.head_dim,
                          cfg.intermediate_size)
    return {
        "input_layernorm.weight": (h,),
        "self_attn.q_proj.weight": (h, nh * hd),
        "self_attn.k_proj.weight": (h, nkv * hd),
        "self_attn.v_proj.weight": (h, nkv * hd),
        "self_attn.o_proj.weight": (nh * hd, h),
        "post_attention_layernorm.weight": (h,),
        "mlp.gate_proj.weight": (h, it),
        "mlp.up_proj.weight": (h, it),
        "mlp.down_proj.weight": (it, h),
    }


def gather_tree_over_sharding(tree: Dict[str, torch.Tensor],
                              layout: Dict[str, _LeafPlace], lead_ndim: int,
                              sh: int, mp: int, axis: Optional[str],
                              hier=None, bucket_bytes: int = 4 << 20,
                              codec: Optional[CollectiveCodec] = None, *,
                              mesh) -> Dict[str, torch.Tensor]:
    """Gather a whole tree's sharding-cut leaves at once, bucket by bucket
    (one all-gather each, two-stage under ``hier``); ``lead_ndim`` leading
    dims ride along; uncut leaves pass through.  Values, no autograd."""
    if axis is None:
        return dict(tree)
    order = [s for s in sorted(tree) if layout[s].sh_dim is not None]
    out = {s: v for s, v in tree.items() if layout[s].sh_dim is None}
    itemsize = next(iter(tree.values())).element_size()
    buckets = split_by_bytes(
        order, lambda s: tree[s].numel() * itemsize, bucket_bytes)
    for bucket in buckets:
        flat = torch.cat([tree[s].reshape(-1) for s in bucket])
        if hier is not None:
            full = hier_all_gather(flat, axis, hier, codec, "weight",
                                   mesh=mesh)
        else:
            full = all_gather_raw(flat, axis, 0, mesh)
        seg = full.reshape(sh, -1)
        off = 0
        for s in bucket:
            lshape = tuple(tree[s].shape)
            n = math.prod(lshape)
            pieces = seg[:, off:off + n].reshape((sh,) + lshape)
            out[s] = torch.cat(pieces.unbind(0),
                               dim=lead_ndim + layout[s].sh_dim)
            off += n
    return out


def slice_tree_own_shard(tree: Dict[str, torch.Tensor],
                         layout: Dict[str, _LeafPlace], lead_ndim: int,
                         sh: int, axis: Optional[str], *, mesh
                         ) -> Dict[str, torch.Tensor]:
    """Inverse of ``gather_tree_over_sharding`` for gradients every rank
    computed whole (the batch does not ride the axis): each keeps its own
    shard."""
    if axis is None:
        return dict(tree)
    r = mesh.axis_index(axis)
    out = {}
    for s, v in tree.items():
        pl = layout[s]
        if pl.sh_dim is None:
            out[s] = v
            continue
        d = lead_ndim + pl.sh_dim
        n_local = v.shape[d] // sh
        out[s] = v.narrow(d, r * n_local, n_local)
    return out


# ---------------------------------------------------------------------------
# collective matmul (the ppermute ring of a row-parallel projection)
# ---------------------------------------------------------------------------


class _GatherReplicated(torch.autograd.Function):
    """Untiled all-gather whose result is replicated: its cotangent is the
    same on every rank, so the backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.meta = (axis, mesh)
        return all_gather_raw(x.unsqueeze(0), axis, 0, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.meta
        return g[mesh.axis_index(axis)], None, None


def ring_collective_matmul(y: torch.Tensor, w_local: torch.Tensor,
                           axis: str, *, mesh) -> torch.Tensor:
    """``psum_axis(y @ w_local)`` as an axis-size-step ``ppermute`` ring
    (mirror of ``ring_collective_matmul``): the output columns are cut into
    one chunk per rank; at step t rank r multiplies chunk ``(r + 1 - t) %
    size`` and adds it to the partial sum passed on from its left
    neighbour, so every chunk passes every rank once; rank r ends with
    chunk ``(r + 2) % size`` complete, and a gather with the static
    un-permute replicates the result."""
    size = int(mesh.shape.get(axis, 1))
    if size == 1:
        return y @ w_local
    r = mesh.axis_index(axis)
    n = w_local.shape[-1]
    if n % size:
        return _compat.psum(y @ w_local, axis, mesh=mesh)
    chunk = n // size
    perm = [(i, (i + 1) % size) for i in range(size)]
    acc = None
    for t in range(size):
        c = (r + 1 - t) % size
        part = y @ w_local.narrow(-1, c * chunk, chunk)
        acc = part if acc is None else \
            _compat.ppermute(acc, axis, perm, mesh=mesh) + part
    g = _GatherReplicated.apply(acc, axis, mesh)
    order = torch.as_tensor(np.argsort([(i + 2) % size
                                        for i in range(size)]),
                            device=g.device)
    out = g[order].movedim(0, -2)
    return out.reshape(tuple(y.shape[:-1]) + (n,))


def tp_row_matmul(y: torch.Tensor, w_local: torch.Tensor,
                  axis: Optional[str], oc: OverlapConfig, *,
                  mesh) -> torch.Tensor:
    """Row-parallel projection: the ring above the size threshold, else the
    matmul and one psum."""
    if axis is None:
        return y @ w_local
    out_elems = math.prod(y.shape[:-1]) * int(w_local.shape[-1])
    if (oc.collective_matmul
            and out_elems >= oc.collective_matmul_min_out_elems):
        return ring_collective_matmul(y, w_local, axis, mesh=mesh)
    return _compat.psum(y @ w_local, axis, mesh=mesh)


# ---------------------------------------------------------------------------
# the Llama decoder layer on gathered, mp-local weights
# ---------------------------------------------------------------------------


def decoder_layer_tp(lp: Dict[str, torch.Tensor], x: torch.Tensor, cos,
                     sin, cfg, mp_axis: Optional[str], oc: OverlapConfig,
                     segment_ids=None, *, mesh,
                     tag: Optional[Callable] = None,
                     attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """One decoder layer on sharding-gathered, mp-local weights ``lp``
    (suffix -> tensor; mirror of ``decoder_layer_tp``): the mesh step's
    layer body (``models.llama.decoder_layer_forward``) with q/k/v/gate/up
    column-parallel on the local heads and columns and o_proj/down_proj
    row-parallel through ``tp_row_matmul``.  ``mp_axis`` is ``"mp"`` or
    None (no tensor parallelism); ``tag(t, name)`` places the memory
    engine's saveable tags; ``attn_fn(q, k, v)`` overrides the attention
    call on the local heads (the hybrid step passes ring or Ulysses
    attention over ``sep``), None keeps causal flash."""
    from ..models.llama import decoder_layer_forward

    if mp_axis not in (None, "mp"):
        raise ValueError(f"mp_axis={mp_axis!r}: the layer's tensor-parallel "
                         f"axis is 'mp'")
    mp = int(mesh.shape.get(mp_axis, 1)) if mp_axis is not None else 1
    nh, nkv = cfg.num_attention_heads, cfg.num_key_value_heads
    if nkv % mp or nh % mp:
        raise ValueError(
            f"num heads ({nh} q / {nkv} kv) not divisible by mp={mp} - "
            "the overlap engine computes attention on mp-local heads")

    def row(y, name, tp):
        return tp_row_matmul(y, lp[name], mp_axis if tp else None, oc,
                             mesh=mesh)

    tp = mp_axis is not None
    return decoder_layer_forward(x, cos, sin, cfg, lp.__getitem__,
                                 lambda h, name: h @ lp[name], row,
                                 seg=segment_ids, mesh=mesh, attn_tp=tp,
                                 mlp_tp=tp, tag=tag, attn_fn=attn_fn)


# ---------------------------------------------------------------------------
# the prefetch loop
# ---------------------------------------------------------------------------


class _Ahead:
    """A layer's prefetched gathers, taken by the first run of its
    (checkpointed) body; a recomputation finds it empty and gathers
    again."""

    def __init__(self, fetched):
        self.fetched = fetched

    def take(self):
        fetched, self.fetched = self.fetched, None
        return fetched


def gathered_layer_scan(layer_fn: Callable, xs_buckets: List[torch.Tensor],
                        xs_sync: List[torch.Tensor], x: torch.Tensor,
                        buckets: List[List[str]], sync_suffixes: List[str],
                        layout: Dict[str, _LeafPlace], sh: int, mp: int,
                        gather_fns: List[BucketTransport],
                        sync_fn: Callable, oc: OverlapConfig,
                        remat: bool = False, remat_policy=None, *,
                        anchors: Sequence[Sequence[Sequence[torch.Tensor]]],
                        sink: StackGrads) -> torch.Tensor:
    """Run the decoder stack with the layer-ahead gather prefetch (mirror
    of ``gathered_layer_scan``; the scan is a loop over layers).

    ``xs_buckets[b]``: [L, bucket_elems_local] packed bucket shards;
    ``xs_sync[i]``: layer i's non-gathered leaves, in ``sync_suffixes``
    order (with autograd; ``sync_fn`` reduces their gradients as one row,
    as JAX packs them into one); ``anchors[b][i]``: layer i's leaves of
    bucket b, the gradient path of its gather (``BucketTransport.attach``).
    Schedules:

    - prefetch, no remat: layer i+1's gathers are issued (async) before
      layer i's compute and waited where layer i+1 unpacks them;
    - remat: the gather sits inside the checkpointed layer (the backward
      gathers again); with prefetch the next layer's gather is issued
      ahead of the current layer's forward and taken by its first run;
    - no prefetch: each layer gathers at its top.
    """
    from .memory import checkpoint_layer

    L = len(xs_sync)

    def fetch(i, async_op):
        return [gather_fns[b].gather(xs_buckets[b][i], async_op=async_op)
                if async_op else
                Pending(None, gather_fns[b].gather(xs_buckets[b][i]))
                for b in range(len(buckets))]

    def unpack(i, fetched):
        lp: Dict[str, torch.Tensor] = {}
        for b, bucket in enumerate(buckets):
            full = gather_fns[b].attach(fetched[b], anchors[b][i], sink,
                                        (b, i))
            lp.update(_unpack_bucket_full(full, bucket, layout, sh, mp))
        if sync_suffixes:
            synced = sync_fn(*xs_sync[i])
            if len(sync_suffixes) == 1:
                synced = (synced,)
            lp.update(zip(sync_suffixes, synced))
        return lp

    if not remat:
        ahead = fetch(0, True) if oc.prefetch else None
        for i in range(L):
            cur = ahead if oc.prefetch else fetch(i, False)
            if oc.prefetch:
                lp = unpack(i, cur)          # waits layer i's gathers
                ahead = fetch(i + 1, True) if i + 1 < L else None
            else:
                lp = unpack(i, cur)
            x = layer_fn(lp, x)
        return x

    ahead = fetch(0, True) if oc.prefetch else None
    for i in range(L):
        slot = _Ahead(ahead)
        if oc.prefetch:
            ahead = fetch(i + 1, True) if i + 1 < L else None

        def body(xcur, i=i, slot=slot):
            fetched = slot.take()
            if fetched is None:
                fetched = fetch(i, False)
            return layer_fn(unpack(i, fetched), xcur)

        x = checkpoint_layer(body, remat_policy, x)
    return x


# ---------------------------------------------------------------------------
# the decoder stack (build_train_step's overlap path)
# ---------------------------------------------------------------------------


def stack_layout_plan(shapes: Dict[str, Tuple[int, ...]], mesh,
                      spec_for: Callable, oc: OverlapConfig,
                      compute_dtype=torch.bfloat16):
    """The engine's at-rest layout as a shape-level plan: (layout, buckets,
    sync_suffixes).  ``build_overlap_stack`` consumes exactly this, and
    ``PartitionSchedule.stack_plan`` derives from it (one copy)."""
    layout = plan_layer_layout(shapes, mesh, spec_for)
    order = sorted(shapes)
    sh = int(mesh.shape.get("sharding", 1))
    mp = int(mesh.shape.get("mp", 1))
    itemsize = torch.empty((), dtype=compute_dtype).element_size()
    buckets = plan_buckets(layout, order, sh, mp, oc.bucket_bytes, itemsize)
    gathered = {s for b in buckets for s in b}
    sync_suffixes = [s for s in order if s not in gathered]
    return layout, buckets, sync_suffixes


def build_overlap_stack(cfg, mesh, shapes: Dict[str, Tuple[int, ...]],
                        spec_for: Callable, oc: OverlapConfig,
                        batch_axes: Tuple[str, ...] = ("dp", "sharding"),
                        remat: bool = False, remat_policy=None,
                        compute_dtype=torch.bfloat16) -> Callable:
    """The decoder stack on a live mesh (mirror of ``build_overlap_stack``):

        stack(leaves, x, cos, sin, segment_ids=None, sink=...) -> h

    ``leaves``: suffix -> the L layers' at-rest blocks (this rank's, in the
    at-rest dtype, with autograd); ``x``: this rank's [b, s, hidden] batch
    block, replicated over mp; ``sink``: a ``StackGrads`` that receives the
    bucket reductions, which ``stack.grads(sink, leaves)`` waits and cuts
    into each leaf's gradient (complete: reduced over every batch axis).
    The non-gathered leaves' gradients come back through autograd,
    complete too.  Building it makes the hierarchy's process groups
    (collective: every rank builds)."""
    from .memory import tag_saveable

    sh = int(mesh.shape.get("sharding", 1))
    mp = int(mesh.shape.get("mp", 1))
    sh_ax = "sharding" if sh > 1 else None
    mp_ax = "mp" if mp > 1 else None
    data_axes = tuple(a for a in batch_axes
                      if a in mesh.axis_names and mesh.shape[a] > 1)
    psum_axes = tuple(a for a in data_axes if a != "sharding")
    grad_mode = "scatter" if "sharding" in data_axes else "slice"
    hier = oc.resolve_hier(mesh, sh_ax)
    register_hier(mesh, sh_ax, hier)
    layout, buckets, sync_suffixes = stack_layout_plan(
        shapes, mesh, spec_for, oc, compute_dtype)
    if mp > 1:
        for sfx, pl in layout.items():
            if sfx.endswith("proj.weight") and pl.mp_dim is None:
                raise ValueError(f"{sfx}: not cut over mp={mp}; the overlap "
                                 f"engine runs tensor-parallel layers only")
    codec = oc.codec if hier is not None else None
    gather_fns = [make_bucket_gather(sh_ax, hier, psum_axes, grad_mode,
                                     codec, mesh=mesh) for _ in buckets]
    sync_fn = make_grad_sync(data_axes, hier_axis=sh_ax, hier=hier,
                             codec=codec, mesh=mesh)
    local = {s: layout[s].local_shape(sh, mp) for s in layout}
    tagged = remat and remat_policy is not None and remat_policy.tagged

    def tag(t, name):
        return tag_saveable(t, name) if tagged else t

    def stack(leaves: Dict[str, Sequence[torch.Tensor]], x, cos, sin,
              segment_ids=None, *, sink: StackGrads):
        L = len(next(iter(leaves.values())))
        for s, ts in leaves.items():
            if tuple(ts[0].shape) != local[s]:
                raise ValueError(f"{s}: block {tuple(ts[0].shape)} is not "
                                 f"the overlap layout's {local[s]}")
        # the cast leaves written once per micro-step into one flat buffer
        # per bucket; their gradients come back through ``grads``
        xs_buckets = [_pack_bucket(leaves, bucket, local, compute_dtype)
                      for bucket in buckets]
        anchors = [[tuple(leaves[s][i] for s in bucket) for i in range(L)]
                   for bucket in buckets]
        xs_sync = [[leaves[s][i].to(compute_dtype) for s in sync_suffixes]
                   for i in range(L)]

        def layer_fn(lp, xcur):
            return decoder_layer_tp(lp, xcur, cos, sin, cfg, mp_ax, oc,
                                    segment_ids=segment_ids, mesh=mesh,
                                    tag=tag)

        return gathered_layer_scan(
            layer_fn, xs_buckets, xs_sync, x, buckets, sync_suffixes,
            layout, sh, mp, gather_fns, sync_fn, oc, remat=remat,
            remat_policy=remat_policy, anchors=anchors, sink=sink)

    def grads(sink: StackGrads, leaves: Dict[str, Sequence[torch.Tensor]]
              ) -> Dict[str, List[torch.Tensor]]:
        """Wait every bucket reduction of ``sink`` and cut each layer's
        leaf gradients out of them (in the leaves' dtype)."""
        done = sink.wait_all()
        L = len(next(iter(leaves.values())))
        out: Dict[str, List[torch.Tensor]] = {}
        for b, bucket in enumerate(buckets):
            out.update(_unpack_bucket_grads([done[(b, i)] for i in range(L)],
                                            bucket, local, leaves))
        return out

    stack.grads = grads
    stack.layout = layout
    stack.buckets = buckets
    stack.sync_suffixes = sync_suffixes
    stack.hier = hier
    return stack


__all__ = ["COLLECTIVE_MATMUL_MIN_OUT_ELEMS", "BucketTransport",
           "OverlapConfig", "StackGrads", "build_overlap_stack",
           "chunk_leaf_spec", "decoder_layer_tp",
           "gather_tree_over_sharding", "gathered_layer_scan",
           "hier_all_gather", "hier_psum", "hier_psum_scatter",
           "leaf_partition_spec", "llama_layer_shapes", "make_bucket_gather",
           "make_grad_sync", "plan_buckets", "plan_layer_layout",
           "register_hier", "ring_collective_matmul", "slice_tree_own_shard",
           "split_by_bytes", "stack_layout_plan", "tp_row_matmul"]
