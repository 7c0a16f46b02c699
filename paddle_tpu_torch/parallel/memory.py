"""Memory engine of the port (mirror of ``paddle_tpu/parallel/memory.py``).

Three levers and a meter, as in the JAX package:

1. **Named remat policies.** ``MemoryConfig(remat=...)`` picks what each
   decoder layer keeps for its backward under ``torch.utils.checkpoint``
   (non-reentrant): ``none`` (no checkpoint), ``dots`` (matmul outputs
   kept), ``names`` (the two tagged block outputs kept, ``SAVEABLE_NAMES``),
   ``offload`` (those two parked in host memory and brought back in
   backward) and ``full`` (nothing kept).  A ``SavePolicy`` carries the
   choice into the checkpoint as its ``context_fn``: a dispatch mode that
   stores the chosen ops' outputs in the forward and hands them back,
   instead of running the ops again, in the recomputation.  A tag is an
   identity op (``tag_saveable``, the counterpart of ``checkpoint_name``)
   that the decoder layer places on its block outputs.
2. **Host-resident optimizer state.** The fused AdamW flat groups
   (``Adam.init_flat_state``) split into size-capped buckets held in pinned
   host memory (``init_offloaded_state``); ``apply_flat_offloaded`` streams
   them through the card two buckets at a time, with the numbers of
   ``Adam.apply_flat``.
3. **Activation offload.** ``activation_offload`` moves the tagged block
   outputs to host memory under any policy (``resolve_remat``).
4. **The meter.** ``measure_step_memory`` reads the card's peak allocated
   bytes over one call; ``tune_memory_config`` walks ``MEMORY_LATTICE``
   cheapest first and returns the first point that fits.

The JAX meter compiles and reads XLA's memory analysis; here the step runs
once on the card, so the meter needs a CUDA device.  On a mesh each rank
keeps its own block of the shard-major flat state (``flat_layout=``) in
pinned host memory, streamed the same way.  ``JointConfig`` and
``joint_memory_codec_lattice`` walk memory residency and the overlap
engine's inter-slice codec together, and ``tune_memory_config`` takes a
second budget, the post-codec inter-slice bytes, measured by a function
the caller gives.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..optimizer.optimizer import _pin_lr_f32

# the tags the decoder layer places on its attention-block and MLP-block
# outputs (models/llama.py): the [b, s, hidden] residual-stream terms
SAVEABLE_NAMES: Tuple[str, ...] = ("decoder_attn_out", "decoder_mlp_out")

REMAT_POLICIES = ("none", "dots", "names", "offload", "full")
RESIDENCIES = ("device", "host")

# the port's copies of the two policy tables of paddle_tpu/parallel/
# roofline.py that MemoryConfig reads: extra forward passes the backward
# recomputes, and activation bytes kept relative to no remat
REMAT_RECOMPUTE_FACTOR = {"none": 0.0, "dots": 0.0, "names": 1.0,
                          "offload": 1.0, "full": 1.0}
_ACT_KEEP_FACTOR = {"none": 1.0, "dots": 0.5, "names": 0.25,
                    "offload": 0.25, "full": 0.125}


# ------------------------------------------------------------------ tags

@torch.library.custom_op("paddle_tpu_torch::tag_saveable", mutates_args=())
def _tag_op(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_tag_op.register_fake
def _tag_fake(x, name):
    return torch.empty_like(x)


def _tag_backward(ctx, grad):
    return grad, None


_tag_op.register_autograd(_tag_backward)


def tag_saveable(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` through the identity tag op ``name`` (one of
    ``SAVEABLE_NAMES``): a ``SavePolicy`` that names it keeps its output.
    The tag copies x; callers place it only under a policy that reads it."""
    return _tag_op(x, name)


# -------------------------------------------------------------- policies

_DOT_OPS = frozenset({torch.ops.aten.mm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default})
_TAG_OP = torch.ops.paddle_tpu_torch.tag_saveable.default


@dataclasses.dataclass(frozen=True)
class SavePolicy:
    """What a checkpointed layer keeps for its backward: with ``dots`` every
    matmul output (``dots_saveable``), the outputs of the tags in ``names``
    on the card, those in ``offload`` in host memory (pinned when the
    tensor is on a GPU); everything else is recomputed."""

    dots: bool = False
    names: Tuple[str, ...] = ()
    offload: Tuple[str, ...] = ()

    @property
    def tagged(self) -> bool:
        """Whether the layer must place its tags."""
        return bool(self.names or self.offload)

    def where(self, func, args) -> Optional[str]:
        """"host", "device" or None (recompute) for one op call."""
        if func is _TAG_OP:
            if args[1] in self.offload:
                return "host"
            return "device" if args[1] in self.names else None
        return "device" if self.dots and func in _DOT_OPS else None

    def context_fn(self):
        """The (forward, recomputation) contexts of one checkpoint call."""
        store: collections.deque = collections.deque()
        return _Keep(self, store), _Replay(self, store)


def _park(out: torch.Tensor, where: str):
    if where == "device":
        return out.detach(), None
    host = torch.empty(out.shape, dtype=out.dtype,
                       pin_memory=out.is_cuda)
    host.copy_(out, non_blocking=out.is_cuda)
    return host, out.device


def _unpark(kept):
    t, device = kept
    if device is None:
        return t.detach()
    return t.to(device, non_blocking=True)


class _Keep(TorchDispatchMode):
    def __init__(self, policy: SavePolicy, store):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        where = self.policy.where(func, args)
        if where is not None:
            self.store.append(_park(out, where))
        return out


class _Replay(TorchDispatchMode):
    def __init__(self, policy: SavePolicy, store):
        super().__init__()
        self.policy, self.store = policy, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.policy.where(func, args) is not None:
            return _unpark(self.store.popleft())
        return func(*args, **(kwargs or {}))


dots_saveable = SavePolicy(dots=True)


def named_save_policy() -> SavePolicy:
    """Keep the two tagged block outputs on the card, recompute the rest."""
    return SavePolicy(names=SAVEABLE_NAMES)


def offload_names_policy() -> SavePolicy:
    """Park the two tagged block outputs in host memory, recompute the
    rest."""
    return SavePolicy(offload=SAVEABLE_NAMES)


def save_from_both_policies(a: SavePolicy, b: SavePolicy) -> SavePolicy:
    """Keep what either policy keeps."""
    return SavePolicy(dots=a.dots or b.dots, names=a.names + b.names,
                      offload=a.offload + b.offload)


def checkpoint_layer(fn: Callable, policy: Optional[SavePolicy], *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``;
    ``policy`` None is full remat (nothing kept)."""
    from torch.utils.checkpoint import checkpoint

    if policy is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=policy.context_fn)


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """One point on the residency lattice (mirror of ``MemoryConfig``).

    ``remat``: the per-decoder-layer policy, one of ``REMAT_POLICIES``.
    ``optimizer_residency``: ``"device"`` (the flat AdamW state on the
    card) or ``"host"`` (bucket-streamed, ``init_offloaded_state``).
    ``activation_offload``: the tagged block outputs kept in host memory;
    under ``none`` and ``dots`` the layer is checkpointed with every matmul
    output kept on the card, so no matmul is recomputed.
    ``stream_bucket_bytes``: the size cap of the state's stream buckets.
    ``hbm_budget_bytes`` / ``host_transfer_budget_bytes``: declared budgets
    a caller may audit the step against."""

    remat: str = "none"
    optimizer_residency: str = "device"
    activation_offload: bool = False
    stream_bucket_bytes: int = 4 << 20
    hbm_budget_bytes: Optional[int] = None
    host_transfer_budget_bytes: Optional[int] = None

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(
                f"MemoryConfig.remat={self.remat!r}; expected one of "
                f"{REMAT_POLICIES}")
        if self.optimizer_residency not in RESIDENCIES:
            raise ValueError(
                f"MemoryConfig.optimizer_residency="
                f"{self.optimizer_residency!r}; expected one of "
                f"{RESIDENCIES}")

    def act_keep_factor(self) -> float:
        """Activation bytes kept per token-layer relative to no remat,
        halved by ``activation_offload``."""
        keep = _ACT_KEEP_FACTOR.get(self.remat, 1.0)
        if self.activation_offload:
            keep *= 0.5
        return keep

    def recompute_fwd_passes(self) -> float:
        """Extra forward passes the backward recomputes under this policy
        ("dots" keeps every matmul, so its recompute counts 0)."""
        return REMAT_RECOMPUTE_FACTOR.get(self.remat, 0.0)

    def resolve_remat(self) -> Tuple[bool, Optional[SavePolicy]]:
        """(use_checkpoint, policy) of the decoder-layer wrap; policy None
        with use_checkpoint is full remat."""
        if self.remat == "none":
            if not self.activation_offload:
                return False, None
            return True, save_from_both_policies(dots_saveable,
                                                 offload_names_policy())
        if self.remat == "dots":
            if self.activation_offload:
                return True, save_from_both_policies(dots_saveable,
                                                     offload_names_policy())
            return True, dots_saveable
        if self.remat == "names":
            return True, (offload_names_policy() if self.activation_offload
                          else named_save_policy())
        if self.remat == "offload":
            return True, offload_names_policy()
        if self.activation_offload:
            return True, offload_names_policy()
        return True, None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def label(self) -> str:
        bits = [self.remat, self.optimizer_residency]
        if self.activation_offload:
            bits.append("act_offload")
        return "/".join(bits)


# the tuner's walk order, cheapest predicted step time first: host
# residency of the optimizer state before heavier remat, activation offload
# before matmul recompute, "full" last
MEMORY_LATTICE: Tuple[MemoryConfig, ...] = (
    MemoryConfig(remat="none"),
    MemoryConfig(remat="none", optimizer_residency="host"),
    MemoryConfig(remat="none", optimizer_residency="host",
                 activation_offload=True),
    MemoryConfig(remat="dots"),
    MemoryConfig(remat="dots", optimizer_residency="host"),
    MemoryConfig(remat="dots", optimizer_residency="host",
                 activation_offload=True),
    MemoryConfig(remat="names"),
    MemoryConfig(remat="names", optimizer_residency="host"),
    MemoryConfig(remat="offload", optimizer_residency="host"),
    MemoryConfig(remat="full", optimizer_residency="host"),
)


# ---------------------------------------- host-resident optimizer state

def stream_bucket_plan(n_elems: int, itemsize: int, cap: int
                       ) -> List[Tuple[int, int]]:
    """(offset, size) slices of a flat group under the size cap, in order;
    a cap of 0 or less is one bucket."""
    if n_elems <= 0:
        return []
    if cap <= 0:
        return [(0, n_elems)]
    per = max(int(cap) // int(itemsize), 1)
    return [(off, min(per, n_elems - off)) for off in range(0, n_elems, per)]


def _host_empty(n: int, for_device: torch.device) -> torch.Tensor:
    """An fp32 host buffer, pinned when it serves a GPU."""
    return torch.empty(n, dtype=torch.float32,
                       pin_memory=for_device.type == "cuda")


def offload_flat_state(flat_state: Dict[str, Any],
                       bucket_bytes: int = 4 << 20) -> Dict[str, Any]:
    """A flat state (``{'__flat__': {group: {moment1, moment2[, master]}}}``)
    as ``{'__offload__': {group: {key: (bucket0, bucket1, ...)}}}``: each
    bucket a contiguous slice of the flat buffer, copied to host memory
    (pinned for a GPU state)."""
    if not (isinstance(flat_state, dict)
            and set(flat_state) == {"__flat__"}):
        raise ValueError("offload_flat_state expects a state from "
                         "init_flat_state ({'__flat__': ...})")
    out: Dict[str, Dict[str, Tuple]] = {}
    for gname, gs in flat_state["__flat__"].items():
        og = {}
        for key, arr in gs.items():
            buckets = []
            for off, size in stream_bucket_plan(arr.shape[0],
                                                arr.element_size(),
                                                bucket_bytes):
                b = _host_empty(size, arr.device)
                b.copy_(arr[off:off + size])
                buckets.append(b)
            og[key] = tuple(buckets)
        out[gname] = og
    return {"__offload__": out}


def _key_spans(g) -> List[Tuple[str, int, int]]:
    """(key, start, end) of each tensor in its group's flat order."""
    spans, off = [], 0
    for k, size in zip(g["keys"], g["sizes"]):
        spans.append((k, off, off + size))
        off += size
    return spans


def _pieces(spans, off: int, size: int):
    """The (key, slice in the key's tensor, slice in the bucket) pieces of
    the group's flat range [off, off + size)."""
    end = off + size
    for k, a, b in spans:
        lo, hi = max(a, off), min(b, end)
        if lo < hi:
            yield k, slice(lo - a, hi - a), slice(lo - off, hi - off)


def _pack(out: torch.Tensor, row_of, spans, off: int, size: int):
    """Write the fp32 flat range [off, off + size) of the group's
    concatenation of rows (``row_of(key)``, each cast to fp32) into
    out[:size]."""
    for k, src, dst in _pieces(spans, off, size):
        out[dst].copy_(row_of(k)[src])
    return out[:size]


def _group_rows(g, values):
    """(key, 1-D row) of each leaf of a flat group, made one at a time,
    whose concatenation is the group's flat buffer (in the values' dtype):
    this rank's shard-major row of an at-rest block, a row-major leaf
    (all-gathered from its blocks on a mesh), or the leaf itself (a view)."""
    from .specs import ShardedTensor

    lo = g.get("layout")
    for k in g["keys"]:
        v = values[k]
        if lo is not None:
            yield k, lo.local_row(g["plans"][k], v)
        elif isinstance(v, ShardedTensor):
            yield k, v.full().reshape(-1)
        else:
            yield k, v.reshape(-1)


def _rank_groups(groups, params):
    """``groups`` with the sizes of this rank's flat buffers: a shard-major
    group's leaves are this rank's rows (``leaf_plan``'s ``local``).  The
    host-resident shard-major state is per rank, so it takes
    ``ShardedTensor`` params."""
    from ..optimizer.optimizer import _sharded

    sharded = _sharded(params.values())
    out = []
    for g in groups:
        if "layout" in g:
            if not sharded:
                raise ValueError(
                    f"group {g['name']}: the host-resident shard-major state "
                    f"holds this rank's block; pass the params as "
                    f"ShardedTensor blocks (apply_llama_sharding)")
            g = dict(g, sizes=[g["plans"][k].local for k in g["keys"]])
        out.append(g)
    return out


def _rank_flat_groups(optimizer, who, params, grads, flat, decay_mask,
                      flat_layout):
    """The groups of ``who``'s fused update (``_checked_flat_groups``)
    with this rank's sizes (``_rank_groups``), each checked against the
    elements its state ``flat[name]`` covers (a buffer, or a tuple of host
    buckets)."""
    groups = _rank_groups(optimizer._checked_flat_groups(
        who, params, grads, {"__flat__": flat}, decay_mask, flat_layout),
        params)
    for g in groups:
        m1 = flat[g["name"]]["moment1"]
        n = sum(int(b.shape[0]) for b in m1) if isinstance(m1, tuple) \
            else int(m1.shape[0])
        if n != sum(g["sizes"]):
            raise ValueError(
                f"{who}: the state of group {g['name']} covers {n} elements "
                f"but the params flatten to {sum(g['sizes'])}: a state built "
                f"for another param set")
    return groups


def init_offloaded_state(optimizer, params, decay_mask=None,
                         master_from=None, bucket_bytes: int = 4 << 20,
                         flat_layout=None) -> Dict[str, Any]:
    """``offload_flat_state(optimizer.init_flat_state(...))`` built bucket
    by bucket, so the flat state never sits on the card: zero moments in
    host memory and, for non-fp32 groups under ``multi_precision``, fp32
    masters from ``master_from`` (or the params), each bucket packed on
    the card from the leaves' rows (``_group_rows``, one leaf at a time)
    and copied to host memory.  With a ``flat_layout`` and
    ``ShardedTensor`` params the state is this rank's block of the
    shard-major one, as the JAX package builds it."""
    out: Dict[str, Dict[str, Tuple]] = {}
    groups = _rank_groups(optimizer._flat_groups(params, decay_mask,
                                                 flat_layout), params)
    for g in groups:
        dev = params[g["keys"][0]].device
        plan = stream_bucket_plan(sum(g["sizes"]), 4, bucket_bytes)
        og = {"moment1": tuple(_host_empty(s, dev).zero_() for _, s in plan),
              "moment2": tuple(_host_empty(s, dev).zero_() for _, s in plan)}
        if optimizer._multi_precision and g["dtype"] != "float32":
            src = master_from if master_from is not None else params
            masters = tuple(_host_empty(s, dev) for _, s in plan)
            # each bucket is packed in fp32 on the card, then copied out
            stage = torch.empty(max((s for _, s in plan), default=0),
                                dtype=torch.float32, device=dev)
            i, off = 0, 0
            for _, row in _group_rows(g, src):
                end, pos = off + row.numel(), off
                while pos < end:
                    b0, size = plan[i]
                    hi = min(b0 + size, end)
                    stage[pos - b0:hi - b0].copy_(row[pos - off:hi - off])
                    pos = hi
                    if hi == b0 + size:
                        masters[i].copy_(stage[:size])
                        i += 1
                off = end
            og["master"] = masters
        out[g["name"]] = og
    return {"__offload__": out}


def state_is_offloaded(state) -> bool:
    return isinstance(state, dict) and set(state) == {"__offload__"}


def offloaded_bytes(state) -> int:
    """Host bytes held by an offloaded state's buckets."""
    return sum(b.numel() * b.element_size()
               for gs in state["__offload__"].values()
               for bs in gs.values() for b in bs)


def gather_offloaded_state(state) -> Dict[str, Any]:
    """Inverse of ``offload_flat_state``: each key's buckets concatenated
    into the flat form, in host memory (after the card's pending copies
    into them)."""
    if not state_is_offloaded(state):
        raise ValueError("not an offloaded state")
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    flat = {}
    for gname, gs in state["__offload__"].items():
        flat[gname] = {k: torch.cat(bs) if bs
                       else torch.zeros(0, dtype=torch.float32)
                       for k, bs in gs.items()}
    return {"__flat__": flat}


class _Lanes:
    """The copy lanes of the offloaded update.  On a GPU: a stream for the
    host-to-device copies and one for the device-to-host copies beside the
    compute stream, ordered by events, so bucket i+1 comes in and bucket
    i-1 goes out while bucket i updates.  On the CPU every lane is None and
    every copy runs in line."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.main = self.inward = self.outward = None
        if self.cuda:
            self.main = torch.cuda.current_stream(device)
            self.inward = torch.cuda.Stream(device)
            self.outward = torch.cuda.Stream(device)
            # the grads, params and the previous call's host buckets are
            # ready once what the compute stream queued so far is done
            self.inward.wait_stream(self.main)
            self.outward.wait_stream(self.main)

    @staticmethod
    def on(lane):
        return contextlib.nullcontext() if lane is None \
            else torch.cuda.stream(lane)

    @staticmethod
    def event(lane):
        if lane is None:
            return None
        ev = torch.cuda.Event()
        ev.record(lane)
        return ev

    @staticmethod
    def wait(lane, ev) -> None:
        if ev is not None:
            lane.wait_event(ev)

    def finish(self) -> None:
        if self.cuda:
            self.main.wait_stream(self.outward)


def apply_flat_offloaded(optimizer, params, grads, state, lr,
                         step: int = 0, decay_mask=None,
                         flat_sharding=None, flat_layout=None, *,
                         write: bool = True):
    """Fused Adam/AdamW over a host-resident bucketed state, with the
    numbers of ``optimizer.apply_flat``: each bucket's moments (and master)
    are copied to the card, updated by the optimizer's own
    ``_flat_group_update`` over the bucket's slice of the packed fp32
    gradients (and of the params, for a group without a master), and copied
    back into the same host buffers; the new params, cast to their dtype,
    are written into the params' own storage.  So the params and the state
    are updated in place (the JAX step donates both) and the call returns
    ``(params, state)``.

    Two buckets are in flight on a GPU (``_Lanes``): bucket i+1's
    host-to-device copy and bucket i-1's device-to-host copy run on side
    streams while bucket i updates; the card holds two buckets of staging
    and one bucket of packed gradients, never a whole flat group.  Host
    buffers should be pinned (``init_offloaded_state`` pins them) for the
    copies to overlap.  With ``ShardedTensor`` params (a mesh rank) the
    stream runs over this rank's rows of the leaves (``_LeafRows``), made
    as the buckets reach them and written back to the at-rest blocks as
    the buckets pass them.

    ``write=False`` is the health gate's first pass (as in
    ``apply_flat_in_place``): each bucket still streams to the card and its
    update is computed, but nothing is copied back to the host and nothing
    is written into the params; the return is the global fp32 sum of
    squares of the params' update, a 0-d tensor on the device.  The pass
    moves the state's bytes host to device a second time; no copy of the
    state is made."""
    if not state_is_offloaded(state):
        raise ValueError("apply_flat_offloaded needs a state from "
                         "init_offloaded_state / offload_flat_state")
    groups = _rank_flat_groups(optimizer, "apply_flat_offloaded", params,
                               grads, state["__offload__"], decay_mask,
                               flat_layout)
    rows = _LeafRows(groups, params, grads, write=write)
    parts = _stream_update(optimizer, groups, rows, state, lr, step, write)
    if write:
        return dict(params), state
    return _group_sq_total(groups, rows, parts,
                           next(iter(params.values())).device)


class _LeafRows:
    """The leaves' rows for the bucket stream (``_group_rows``): each made
    when a bucket first reads it.  Once the stream has passed the end of a
    leaf's span (``release``), a mesh rank writes its param row back into
    the at-rest block (``unpack_row`` for a shard-major row, the rank's
    block of a row-major leaf) and drops both rows: the card holds the
    rows of the leaves under the buckets in flight, never all of the
    rank's.  A plain leaf's rows are views of the tensors, updated in
    place.  ``write=False`` reads only: a released row is dropped, never
    written back (the gate's first pass of ``apply_flat_in_place`` and
    ``apply_flat_offloaded``)."""

    def __init__(self, groups, params, grads, write: bool = True):
        self.params, self.grads = params, grads
        self.write = write
        self.group = {k: g for g in groups for k in g["keys"]}
        self.rows_p: Dict[str, torch.Tensor] = {}
        self.rows_g: Dict[str, torch.Tensor] = {}

    def _row(self, values, k) -> torch.Tensor:
        g = self.group[k]
        _, row = next(_group_rows(dict(g, keys=[k]), values))
        return row

    def param(self, k) -> torch.Tensor:
        if k not in self.rows_p:
            self.rows_p[k] = (self._row(self.params, k).clone()
                              if self._sharded(k)
                              else self.params[k].view(-1))
        return self.rows_p[k]

    def grad(self, k) -> torch.Tensor:
        if k not in self.rows_g:
            self.rows_g[k] = self._row(self.grads, k)
        return self.rows_g[k]

    def _sharded(self, k) -> bool:
        from .specs import ShardedTensor

        return isinstance(self.params[k], ShardedTensor)

    def release(self, k) -> None:
        from .specs import _block_slices

        row = self.rows_p.pop(k, None)
        self.rows_g.pop(k, None)
        if row is None or not self.write or not self._sharded(k):
            return
        p, g = self.params[k], self.group[k]
        if "layout" in g:
            block = g["layout"].unpack_row(g["plans"][k], row, p)
        else:
            block = row.reshape(p.shape)[_block_slices(p.spec, p.shape,
                                                       p.mesh)]
        p.local.copy_(block)


def _update_sq(new_row: torch.Tensor, old_row: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of squares of ``new_row - old_row``."""
    d = new_row.to(torch.float32, copy=True)
    d.sub_(old_row)
    s = torch.linalg.vector_norm(d, dtype=torch.float32)
    return s * s


def _bucket_update(optimizer, g, spans, rows: _LeafRows, off: int, size: int,
                   m1, m2, master, gbuf, pbuf, lr, step, write: bool = True):
    """One bucket of a flat group's update: the fp32 flat range [off, off +
    size) of the gradients packed into ``gbuf`` (and of the params into
    ``pbuf`` when ``master`` is None, a group without a master), then
    ``_flat_group_update`` over it and the bucket's ``m1``, ``m2`` and
    ``master``; the new params, cast to their dtype, are written into the
    leaves' rows (``rows``) and the new moments and master into ``m1``,
    ``m2`` and ``master``; the rows of the leaves the bucket ends are
    released.  ``write=False`` writes nothing and returns the fp32 sums of
    squares of the params' update, one for each leaf piece of the bucket."""
    if master is None:
        mst = _pack(pbuf, rows.param, spans, off, size)
    else:
        mst = master
    gsl = _pack(gbuf, rows.grad, spans, off, size)
    new_master, nm1, nm2 = optimizer._flat_group_update(
        gsl, m1, m2, mst, lr, step, g["decay"])
    sq = []
    for k, src, dst in _pieces(spans, off, size):
        prow = rows.param(k)[src]
        if write:
            prow.copy_(new_master[dst])
        else:
            sq.append(_update_sq(new_master[dst].to(prow.dtype), prow))
    if write:
        m1.copy_(nm1)
        m2.copy_(nm2)
        if master is not None:
            master.copy_(new_master)
    for k, _, end in spans:
        if off < end <= off + size:     # the stream is past this leaf
            rows.release(k)
    return sq


def _stream_update(optimizer, groups, rows: _LeafRows, state, lr, step,
                   write: bool = True) -> Dict[str, list]:
    """The bucket stream of ``apply_flat_offloaded`` over ``groups`` whose
    leaves' rows (``rows``) concatenate to the state's buffers; updates
    the params (through ``rows``) and ``state`` in place.  ``write=False``
    streams the buckets in only and returns, per group, the sums of
    squares of its update's pieces (``_bucket_update``)."""
    tasks = []
    for g in groups:
        gs = state["__offload__"][g["name"]]
        spans, off = _key_spans(g), 0
        for i, b in enumerate(gs["moment1"]):
            size = int(b.shape[0])
            tasks.append((g, gs, spans, i, off, size))
            off += size
    parts: Dict[str, list] = {g["name"]: [] for g in groups}
    if not tasks:
        return parts
    dev = rows.params[groups[0]["keys"][0]].device
    cap = max(t[5] for t in tasks)
    keys = {k for t in tasks for k in t[1]}
    lanes = _Lanes(dev)
    slots = [{k: torch.empty(cap, dtype=torch.float32, device=dev)
              for k in keys} for _ in range(2)]
    gbuf = torch.empty(cap, dtype=torch.float32, device=dev)
    pbuf = None
    came_in, went_out = [None, None], [None, None]

    def fetch(j):
        _, gs, _, i, _, size = tasks[j]
        s = j % 2
        with lanes.on(lanes.inward):
            lanes.wait(lanes.inward, went_out[s])
            for key, bs in gs.items():
                slots[s][key][:size].copy_(bs[i], non_blocking=lanes.cuda)
            came_in[s] = lanes.event(lanes.inward)

    lr = _pin_lr_f32(lr)
    fetch(0)
    for j, (g, gs, spans, i, off, size) in enumerate(tasks):
        s = j % 2
        if j + 1 < len(tasks):
            fetch(j + 1)
        lanes.wait(lanes.main, came_in[s])
        # the slots hold every key of any group: take this group's
        slot = {key: slots[s][key][:size] for key in gs}
        if "master" not in gs and pbuf is None:
            pbuf = torch.empty(cap, dtype=torch.float32, device=dev)
        parts[g["name"]] += _bucket_update(
            optimizer, g, spans, rows, off, size, slot["moment1"],
            slot["moment2"], slot.get("master"), gbuf, pbuf, lr, step, write)
        done = lanes.event(lanes.main)
        if not write:           # the slot is free once the bucket is read
            went_out[s] = done
            continue
        with lanes.on(lanes.outward):
            lanes.wait(lanes.outward, done)
            for key, bs in gs.items():
                bs[i].copy_(slot[key], non_blocking=lanes.cuda)
            went_out[s] = lanes.event(lanes.outward)
    lanes.finish()
    return parts


def _group_sq_total(groups, rows: _LeafRows, parts: Dict[str, list],
                    device) -> torch.Tensor:
    """The global fp32 sum of squares of an update from its groups' pieces
    (``_bucket_update(write=False)``): each group's sum, completed over
    the layout's axes for a shard-major group (whose rows are distinct on
    every rank of them; a row-major group's are whole on every rank), then
    the sum over the groups; a 0-d zero on ``device`` when nothing was
    updated."""
    from . import compat

    sq = []
    for g in groups:
        part = parts.get(g["name"])
        if not part:
            continue
        total = torch.stack(part).sum()
        lo = g.get("layout")
        if lo is not None and rows._sharded(g["keys"][0]):
            for a in lo.axes:
                total = compat.all_reduce_raw(total, a, lo.mesh)
        sq.append(total)
    if not sq:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(sq).sum()


# ------------------------------------------- in-place device-resident updates

#: the bucket cap of the in-place flat update: the most fp32 elements of
#: one group updated at once (the transients of the Adam arithmetic)
IN_PLACE_BUCKET_BYTES = 16 << 20


def apply_flat_in_place(optimizer, params, grads, state, lr, step: int = 0,
                        decay_mask=None, flat_layout=None, *,
                        write: bool = True):
    """``optimizer.apply_flat`` over a device-resident flat state, in place:
    each group is updated in buckets of at most ``IN_PLACE_BUCKET_BYTES``
    of fp32 (``_bucket_update``), the bucket's moments and master written
    back into the state's own buffers and the new params, cast to their
    dtype, into the params' own storage (a mesh rank's rows go back to its
    at-rest blocks as the stream passes each leaf, ``_LeafRows``).  The
    arithmetic is ``_flat_group_update`` element for element, so the
    values are ``apply_flat``'s bit for bit; the card holds one bucket of
    transients beside the state, never a second copy of it.  Returns
    ``(params, state)``, the objects it was given.

    ``write=False`` is the health gate's first pass: nothing is written,
    and the return is the global fp32 sum of squares of the params'
    update (each bucket's new params in their dtype against the old), a
    0-d tensor on the device; the second pass recomputes the same buckets
    and writes them."""
    if not optimizer.state_is_flat(state):
        raise ValueError("apply_flat_in_place needs a state from "
                         "init_flat_state")
    groups = _rank_flat_groups(optimizer, "apply_flat_in_place", params,
                               grads, state["__flat__"], decay_mask,
                               flat_layout)
    rows = _LeafRows(groups, params, grads, write=write)
    lr = _pin_lr_f32(lr)
    parts: Dict[str, list] = {}
    for g in groups:
        gs = state["__flat__"][g["name"]]
        spans = _key_spans(g)
        plan = stream_bucket_plan(sum(g["sizes"]), 4, IN_PLACE_BUCKET_BYTES)
        dev = gs["moment1"].device
        cap = max((s for _, s in plan), default=0)
        gbuf = torch.empty(cap, dtype=torch.float32, device=dev)
        pbuf = None if "master" in gs else torch.empty(
            cap, dtype=torch.float32, device=dev)
        part = parts.setdefault(g["name"], [])
        for off, size in plan:
            m1, m2, mst = (gs[key][off:off + size] if key in gs else None
                           for key in ("moment1", "moment2", "master"))
            part += _bucket_update(optimizer, g, spans, rows, off, size, m1,
                                   m2, mst, gbuf, pbuf, lr, step, write)
    if write:
        return params, state
    dev = next(iter(state["__flat__"].values()))["moment1"].device \
        if state["__flat__"] else torch.device("cpu")
    return _group_sq_total(groups, rows, parts, dev)


def apply_in_place(optimizer, params, grads, state, lr, step: int = 0,
                   decay_mask=None, *, write: bool = True):
    """``optimizer.apply`` over a per-tensor state, in place: one leaf at a
    time, ``optimizer.apply`` of that leaf alone (its block, for a
    ``ShardedTensor``; a completed gradient block on a mesh), its new value
    and state copied into the caller's tensors, a state the leaf did not
    have yet added to ``state``.  Returns ``(params, state)``.
    ``write=False`` writes nothing and returns the global fp32 sum of
    squares of the params' update, leaf by leaf as ``health._sq_diff``
    sums it (the gate's first pass)."""
    from ..distributed.health import _sq_diff
    from .specs import ShardedTensor as ST

    def local(t):
        return t.local if isinstance(t, ST) else t

    sq = []
    for k, v in params.items():
        g = grads.get(k)
        if g is None:
            continue
        st = state.get(k)
        new_p, new_s = optimizer.apply(
            {k: local(v)}, {k: local(g.complete() if isinstance(g, ST)
                                     else g)},
            {k: {n: local(t) for n, t in st.items()}} if st else {},
            lr, step, decay_mask=decay_mask)
        nv, ns = new_p[k], new_s[k]
        if not write:
            sq.append(_sq_diff(v.with_local(nv) if isinstance(v, ST)
                               else nv, v))
            continue
        local(v).copy_(nv)
        if st:
            for n, t in ns.items():
                if n in st:
                    if local(st[n]) is not t:
                        local(st[n]).copy_(t)
                else:
                    st[n] = v.with_local(t) if isinstance(v, ST) else t
        else:
            state[k] = {n: v.with_local(t) if isinstance(v, ST) else t
                        for n, t in ns.items()}
    if write:
        return params, state
    if not sq:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(sq).sum()


# ------------------------------------------------------- meter and tuner

def measure_step_memory(fn, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once on the card and read its memory
    from the CUDA allocator's statistics: ``argument_bytes`` allocated
    before the call, ``peak_bytes`` the most allocated during it,
    ``temp_bytes`` their difference and ``output_bytes`` what the call left
    allocated beyond its arguments.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_step_memory reads the CUDA allocator's "
                           "peak statistics and needs a CUDA device")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    del out
    return {"argument_bytes": before, "peak_bytes": peak,
            "temp_bytes": peak - before, "output_bytes": after - before}


def choose_memory_config(records: Sequence[Dict[str, Any]],
                         hbm_bytes: int) -> Optional[int]:
    """Index of the first (cheapest) record whose peak fits the budget,
    None when none fits."""
    for i, rec in enumerate(records):
        if rec["peak_bytes"] <= hbm_bytes:
            return i
    return None


@dataclasses.dataclass(frozen=True)
class JointConfig:
    """One point of the joint MemoryConfig x OverlapConfig(codec) lattice
    (mirror of ``JointConfig``): the tuner walks memory residency and the
    inter-slice codec together.  ``overlap`` is an ``OverlapConfig``, kept
    opaque here."""

    memory: MemoryConfig
    overlap: Optional[Any] = None

    def label(self) -> str:
        lab = self.memory.label()
        codec = getattr(self.overlap, "codec", None)
        lab += "/" + (codec.label() if codec is not None else "codec-off")
        return lab

    def to_json(self) -> Dict[str, Any]:
        codec = getattr(self.overlap, "codec", None)
        return {"memory": self.memory.to_json(),
                "codec": codec.to_json() if codec is not None else None}


def codec_lattice_points() -> Tuple:
    """The codec knob's walk order, increasing error: off, int8 stochastic
    gradients, then fp8 both ways."""
    from .codec import CollectiveCodec

    return (None,
            CollectiveCodec(),
            CollectiveCodec(grad_profile="fp8", weight_profile="fp8",
                            stochastic=False))


def joint_memory_codec_lattice(overlap,
                               memory_lattice: Optional[Sequence] = None,
                               codec_points: Optional[Sequence] = None
                               ) -> Tuple[JointConfig, ...]:
    """MemoryConfig x codec over a base ``OverlapConfig``: per memory point
    (cheapest first) the codec points in increasing-error order."""
    mem = tuple(MEMORY_LATTICE if memory_lattice is None
                else memory_lattice)
    pts = tuple(codec_lattice_points() if codec_points is None
                else codec_points)
    return tuple(JointConfig(m, dataclasses.replace(overlap, codec=c))
                 for m in mem for c in pts)


def tune_memory_config(step_builder: Callable[[Any], Tuple],
                       hbm_bytes: int, lattice: Optional[Sequence] = None,
                       *, dcn_wire_bytes: Optional[int] = None,
                       dcn_bytes_fn: Optional[Callable] = None,
                       meter: Optional[Callable] = None):
    """Walk ``lattice`` (``MEMORY_LATTICE``: cheapest predicted step time
    first; ``MemoryConfig`` or ``JointConfig`` points), measure each built
    step's peak on the card (``measure_step_memory``) and return
    ``(config, records)``: the first point that fits (None if none does)
    and every point's record.  ``step_builder(cfg)`` returns ``(fn,
    args)``.  ``dcn_wire_bytes`` adds the second budget: each point's
    post-codec inter-slice bytes, measured by ``dcn_bytes_fn(cfg, fn,
    args)``, must fit too.  ``meter(fn, *args)`` replaces the card's
    meter (the Graph Doctor's static peak of a capture, for a walk over
    ranks of a fake process group)."""
    if dcn_wire_bytes is not None and dcn_bytes_fn is None:
        raise ValueError(
            "tune_memory_config: dcn_wire_bytes declared but no "
            "dcn_bytes_fn to measure it - a budget with no measurement "
            "would silently pass every point")
    lattice = tuple(MEMORY_LATTICE if lattice is None else lattice)
    records: List[Dict[str, Any]] = []
    for cfg in lattice:
        fn, args = step_builder(cfg)
        stats = (meter or measure_step_memory)(fn, *args)
        rec = {"config": cfg.to_json(), "label": cfg.label(), **stats,
               "fits": stats["peak_bytes"] <= hbm_bytes}
        if dcn_wire_bytes is not None:
            dcn = int(dcn_bytes_fn(cfg, fn, args))
            rec["dcn_wire_bytes"] = dcn
            rec["fits"] = bool(rec["fits"] and dcn <= dcn_wire_bytes)
        records.append(rec)
    idx = next((i for i, rec in enumerate(records) if rec["fits"]), None)
    return (lattice[idx] if idx is not None else None), records
