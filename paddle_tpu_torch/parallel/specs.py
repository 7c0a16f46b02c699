"""Per-tensor partition specs, the named mesh and the at-rest block type.

Port of ``paddle_tpu/parallel/specs.py``: one placement vocabulary shared
by the schedule (``schedule.py``), the Llama sharding plan and the mesh
train step (``models/llama.py``).  What JAX leaves to its runtime the port
spells out here:

- ``P`` is the port's PartitionSpec: a tuple of entries, each an axis name,
  a tuple of axis names (the first axis major) or ``None``;
- ``Mesh`` names the axes of a row-major grid of ranks.  Built by
  ``init_mesh`` it is live: it holds a ``torch.distributed`` DeviceMesh
  (NCCL on ``cuda``, gloo on ``cpu``) and one process group per axis, and
  rank r sits at the row-major coordinate r, as JAX's ``Mesh(devs.reshape(
  ...))`` places device r.  Built directly (``Mesh(shape, names)``) it is
  abstract: plan math only, no process group; but a mesh of one rank is
  rank 0 and needs no group, since every collective over a size-1 axis is
  a no-op (the one-device train step runs on such a mesh).  The process
  groups of an axis's ``axis_index_groups`` (the two-stage collectives'
  stages) are made once per group list by ``create_index_groups``;
- ``ShardedTensor`` is a leaf at rest: this rank's block (``local``), the
  global shape, the spec it is placed under and the axes over which the
  ranks hold addends rather than copies (``partial``, a gradient's state
  before its reduction), the port's counterpart of a JAX array with a
  ``NamedSharding``;
- ``NamedSharding(mesh, spec).shard(x)`` cuts a global tensor into this
  rank's block: the placement ``jax.device_put`` makes.

Everything but ``ShardedTensor.complete``/``full`` and ``init_mesh`` is
host-side plan math over shapes and axis sizes.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import math
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compat


class P(tuple):
    """PartitionSpec: one entry per leading dim; trailing dims replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


# ---------------------------------------------------------------------------
# the expert-parallel axis
# ---------------------------------------------------------------------------

#: the expert-parallel mesh axis: a weight axis for expert-stacked leaves
#: (their leading [E] dim), a batch axis for everything else
EXPERT_AXIS = "ep"

_EXPERT_LEAF_MARKERS = (".experts.", "mlp.w_up", "mlp.b_up",
                        "mlp.w_down", "mlp.b_down")


def is_expert_leaf(name: str) -> bool:
    """True when ``name`` denotes an expert-stacked leaf (leading [E] dim
    placed on the ``ep`` axis)."""
    return any(m in name for m in _EXPERT_LEAF_MARKERS) \
        or name in ("w_up", "b_up", "w_down", "b_down")


def expert_leaf_spec(tail: P = P()) -> P:
    """The expert placement rule: the leading [E] dim rides ``ep``, the
    remaining dims follow ``tail``."""
    return P(EXPERT_AXIS, *tuple(tail))


# ---------------------------------------------------------------------------
# the entry-layer spec vocabulary
# ---------------------------------------------------------------------------

#: the replicated placement (plan defaults, unplanned names)
REPLICATED = P()


def batch_entry(axes: Sequence[str]):
    """Axes tuple -> one spec entry (None when empty, the bare axis when
    single)."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def batch_partition_spec(mesh: "Mesh",
                         data_axes: Sequence[str] = ("dp", "sharding")) -> P:
    """The [B, ...]-leading batch placement: the data axes present on the
    mesh with real degree, folded into one leading entry."""
    axes = tuple(a for a in data_axes
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    return P(batch_entry(axes))


def lead_batch_spec(spec: P, ndim: int = 1) -> P:
    """Keep only the leading (batch) entry of a batch spec, replicating
    ``ndim - 1`` trailing dims."""
    entries = tuple(spec)
    return P(entries[0] if entries else None, *([None] * (ndim - 1)))


def activation_spec(entry, ndim: int = 3) -> P:
    """[B, S, H] activation pin: the batch entry leads, the rest
    replicated."""
    return P(entry, *([None] * (ndim - 1)))


def microbatched(*entries) -> P:
    """A leading micro-batch axis is never sharded; the remaining dims
    follow ``entries``."""
    return P(None, *entries)


def token_batch_spec(batch, sep=None) -> P:
    """[B, S] ids/labels pin: batch entry on dim 0, sequence on dim 1."""
    return P(batch, sep)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


class Mesh:
    """A named row-major grid of ranks (see the module docstring).
    ``shape`` maps axis name to size, in axis order, as JAX's
    ``mesh.shape``; ``devices`` is the grid of global ranks."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None, device_type: Optional[str] = None):
        sizes = tuple(int(n) for n in shape)
        names = tuple(str(a) for a in axis_names)
        if len(sizes) != len(names):
            raise ValueError(f"mesh shape {sizes} and axis names {names} "
                             f"differ in rank")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        self.axis_names = names
        self.shape = collections.OrderedDict(zip(names, sizes))
        self.devices = np.arange(math.prod(sizes)).reshape(sizes)
        self.device_mesh = device_mesh
        self.device_type = device_type
        # (axis, group list) -> (process group, this rank's group's ranks)
        self._index_groups: Dict[Any, Tuple[Any, Tuple[int, ...]]] = {}
        # one rank: rank 0, every collective a no-op, no group needed
        self._rank = 0 if self.size == 1 else None
        if device_mesh is not None:
            import torch.distributed as dist

            self._rank = dist.get_rank()
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh of {self.size} ranks over a world "
                                 f"of {dist.get_world_size()}")

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def live(self) -> bool:
        """True when the mesh can run collectives: it holds process groups,
        or it has one rank and never needs one."""
        return self.device_mesh is not None or self.size == 1

    @property
    def rank(self) -> int:
        if self._rank is None:
            raise ValueError("an abstract mesh has no rank; build a live one "
                             "with init_mesh")
        return self._rank

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis."""
        idx = np.unravel_index(self.rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_index(self, axis: str) -> int:
        return self.coords[axis] if self.shape.get(axis, 1) > 1 else 0

    def group(self, axis: str):
        """The process group of ``axis`` (the ranks that differ only
        there), ordered by coordinate."""
        if self.device_mesh is None:
            raise ValueError(f"an abstract (or one-rank) mesh has no "
                             f"process group for {axis!r}; build a live one "
                             f"with init_mesh")
        return self.device_mesh.get_group(mesh_dim=axis)

    def _check_groups(self, axis: str, groups) -> Tuple[Tuple[int, ...], ...]:
        n = int(self.shape[axis])
        groups = tuple(tuple(int(p) for p in g) for g in groups)
        flat = sorted(p for g in groups for p in g)
        if flat != list(range(n)) or len({len(g) for g in groups}) != 1:
            raise ValueError(f"axis_index_groups {groups} is not a partition "
                             f"of the {n} positions of {axis!r} into groups "
                             f"of one size")
        return groups

    def create_index_groups(self, axis: str, groups) -> None:
        """Make the process groups of ``groups`` (a partition of ``axis``'s
        positions, ``lax``'s ``axis_index_groups``) on every line of the
        axis, once per group list.  ``dist.new_group`` is collective over
        the world, so every rank calls this with the same lists in one
        order, outside any branch a rank may skip; the collectives then
        find the groups here (``index_group``) and never make one."""
        groups = self._check_groups(axis, groups)
        key = (axis, groups)
        if key in self._index_groups or self.size == 1:
            return
        import torch.distributed as dist

        me = self.rank
        pos = self.axis_names.index(axis)
        lines = np.moveaxis(self.devices, pos, -1).reshape(
            -1, self.devices.shape[pos])
        mine = None
        for line in lines:
            for g in groups:
                ranks = [int(line[p]) for p in g]
                pg = dist.new_group(ranks) if len(ranks) > 1 else None
                if me in ranks:
                    mine = (pg, tuple(ranks))
        self._index_groups[key] = mine

    def index_group(self, axis: str, groups):
        """(process group, ranks) of this rank's group of ``groups`` on
        ``axis``, the ranks in the group's listed order; the group list
        must have been made by ``create_index_groups``."""
        key = (axis, tuple(tuple(int(p) for p in g) for g in groups))
        if key not in self._index_groups:
            raise ValueError(
                f"axis_index_groups {key[1]} of {axis!r} were never made: "
                f"call mesh.create_index_groups({axis!r}, groups) on every "
                f"rank first (it is collective over the world)")
        return self._index_groups[key]

    def peer(self, axis: str, index: int) -> int:
        """Global rank of the rank at coordinate ``index`` on ``axis`` whose
        other coordinates are this rank's."""
        c = self.coords
        c[axis] = index
        return int(self.devices[tuple(c[a] for a in self.axis_names)])

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {'live' if self.live else 'abstract'})"


_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_mesh(device_type: str, shape: Sequence[int],
              axis_names: Sequence[str] = ("dp", "sharding", "mp"), *,
              store=None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = 300.0) -> Mesh:
    """A live mesh over ``init_device_mesh(device_type, shape,
    mesh_dim_names=axis_names)``.  Without a default process group one is
    started first: NCCL for ``cuda``, gloo for ``cpu``, from ``store`` (a
    ``torch.distributed`` Store, e.g. a ``FileStore``) with ``rank`` and
    ``world_size``, or from the environment ``torchrun`` sets.  A failed start raises; there is no other backend to
    fall back to.  On ``cuda`` each process takes the card of its
    ``LOCAL_RANK`` (its rank modulo the cards when unset)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in _BACKENDS:
        raise ValueError(f"init_mesh: device_type {device_type!r} is not "
                         f"'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_mesh('cuda', ...) needs a CUDA device")
    want = _BACKENDS[device_type]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"a {device_type} mesh needs the {want} "
                               f"backend; the process group runs {have}")
    else:
        kw: Dict[str, Any] = {"backend": want,
                              "timeout": datetime.timedelta(
                                  seconds=timeout_s)}
        if store is not None:
            kw.update(store=store, rank=rank, world_size=world_size)
        if device_type == "cuda":
            r = rank if rank is not None else int(os.environ.get("RANK", 0))
            local = int(os.environ.get("LOCAL_RANK",
                                       r % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(**kw)
    dm = init_device_mesh(device_type, tuple(int(n) for n in shape),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(shape, axis_names, device_mesh=dm, device_type=device_type)


# ---------------------------------------------------------------------------
# mesh introspection
# ---------------------------------------------------------------------------


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis name: size} for every mesh axis, size-1 axes included."""
    return {str(a): int(mesh.shape[a]) for a in mesh.axis_names}


def mesh_device_ids(mesh: Mesh) -> frozenset:
    """The set of global ranks a mesh addresses."""
    return frozenset(int(d) for d in mesh.devices.flat)


def _entry_axes(entry) -> Tuple[str, ...]:
    """One spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    if isinstance(entry, tuple):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def filter_spec_to_mesh(spec: P, mesh: Mesh) -> P:
    """Drop axes absent from the mesh or of size 1."""
    sizes = mesh_axis_sizes(mesh)

    def keep(entry):
        kept = tuple(a for a in _entry_axes(entry) if sizes.get(a, 0) > 1)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]

    return P(*(keep(e) for e in tuple(spec)))


def filter_divisible_spec(spec: P, shape: Sequence[int], mesh: Mesh) -> P:
    """The at-rest rule: filter the spec to the mesh, then replicate any
    entry whose dim the product of its axis sizes does not divide (an
    entry shards over all its axes or none)."""
    spec = filter_spec_to_mesh(spec, mesh)
    sizes = mesh_axis_sizes(mesh)
    entries = []
    for i, entry in enumerate(tuple(spec)):
        axes = _entry_axes(entry)
        if not axes:
            entries.append(None)
            continue
        ways = math.prod(sizes[a] for a in axes)
        if i >= len(shape) or int(shape[i]) % ways != 0:
            entries.append(None)
        else:
            entries.append(entry)
    return P(*entries)


def axis_dim_picks(spec: P, shape: Sequence[int], mesh: Mesh,
                   axes: Sequence[str] = ("sharding", "mp")
                   ) -> Dict[str, Optional[int]]:
    """Per wanted axis, the first dim whose plan entry names it and whose
    size the axis divides (each axis falls back to replication on its own);
    a dim hosts one picked axis, the earlier-listed one."""
    sizes = mesh_axis_sizes(mesh)
    picks: Dict[str, Optional[int]] = {a: None for a in axes}
    for i, entry in enumerate(tuple(spec)):
        if i >= len(shape):
            continue
        for a in _entry_axes(entry):
            if a not in picks or picks[a] is not None:
                continue
            if sizes.get(a, 0) <= 1:
                continue
            if int(shape[i]) % sizes[a]:
                continue
            picks[a] = i
    seen: Dict[int, str] = {}
    for a in axes:
        d = picks[a]
        if d is None:
            continue
        if d in seen:
            picks[a] = None
        else:
            seen[d] = a
    return picks


def pick_batch_axes(mesh: Mesh, axes: Sequence[str], size: int
                    ) -> Tuple[str, ...]:
    """Largest ``axes`` prefix whose degree product divides ``size``."""
    sizes = mesh_axis_sizes(mesh)
    used = tuple(axes)
    while used and size % math.prod(sizes.get(a, 1) for a in used):
        used = used[:-1]
    return used


# ---------------------------------------------------------------------------
# the canonical per-tensor spec
# ---------------------------------------------------------------------------


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, str(dtype))).element_size()


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Placement of one logical tensor: global shape, dtype name, per-dim
    mesh axes (empty tuple: replicated) and memory kind."""

    shape: Tuple[int, ...]
    dtype: str
    dim_axes: Tuple[Tuple[str, ...], ...]
    memory_kind: str = "device"

    def __post_init__(self):
        if len(self.dim_axes) != len(self.shape):
            raise ValueError(
                f"dim_axes rank {len(self.dim_axes)} != shape rank "
                f"{len(self.shape)} ({self.shape})")

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * _itemsize(self.dtype)

    def partition_spec(self) -> P:
        return P(*(None if not axes
                   else (axes if len(axes) > 1 else axes[0])
                   for axes in self.dim_axes))

    def describe(self) -> str:
        dims = ",".join("/".join(axes) if axes else "-"
                        for axes in self.dim_axes)
        return (f"[{'x'.join(map(str, self.shape))}] {self.dtype} "
                f"dims=({dims}) mem={self.memory_kind}")


def spec_to_dim_axes(spec: P, ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """PartitionSpec -> per-dim axis tuples, padded to rank."""
    entries = tuple(spec)[:ndim]
    out = [_entry_axes(e) for e in entries]
    out += [()] * (ndim - len(out))
    return tuple(out)


@dataclasses.dataclass
class SpecLayout:
    """One stack's table: tensor name -> ``TensorSpec``, with the mesh
    axes (name, size) it was derived against."""

    mesh_axes: Tuple[Tuple[str, int], ...]
    entries: Dict[str, TensorSpec] = dataclasses.field(default_factory=dict)

    def __getitem__(self, name: str) -> TensorSpec:
        return self.entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self.entries

    def items(self):
        return self.entries.items()

    def to_table(self) -> Dict[str, Any]:
        """JSON-able dump (the JAX package's ``canonical_table`` form)."""
        return {
            "mesh_axes": [[a, n] for a, n in self.mesh_axes],
            "tensors": {
                name: {"shape": list(ts.shape), "dtype": ts.dtype,
                       "dim_axes": [list(axes) for axes in ts.dim_axes],
                       "memory_kind": ts.memory_kind}
                for name, ts in sorted(self.entries.items())},
        }


def layout_mesh_axes(mesh: Mesh) -> Tuple[Tuple[str, int], ...]:
    return tuple((str(a), int(mesh.shape[a])) for a in mesh.axis_names)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _block_slices(spec: P, shape: Sequence[int], mesh: Mesh
                  ) -> Tuple[slice, ...]:
    """This rank's block of a global ``shape`` under ``spec``: per dim, the
    block index is the row-major coordinate over the entry's axes (the
    first axis major)."""
    sizes = mesh_axis_sizes(mesh)
    coords = mesh.coords
    out = []
    for i, dim in enumerate(shape):
        axes = _entry_axes(tuple(spec)[i]) if i < len(spec) else ()
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        ways = math.prod(sizes[a] for a in axes) if axes else 1
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coords[a]
        blk = int(dim) // ways
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


@dataclasses.dataclass
class ShardedTensor:
    """A leaf at rest: this rank's block of a global tensor (see the
    module docstring).  ``partial`` names the axes over which the ranks'
    blocks are addends of the value instead of copies of it."""

    local: torch.Tensor
    shape: Tuple[int, ...]
    spec: P
    mesh: Mesh
    partial: Tuple[str, ...] = ()

    @classmethod
    def from_global(cls, x: torch.Tensor, spec: P, mesh: Mesh
                    ) -> "ShardedTensor":
        """This rank's block of the global ``x`` (a contiguous copy)."""
        spec = filter_divisible_spec(spec, tuple(x.shape), mesh)
        block = x[_block_slices(spec, tuple(x.shape), mesh)]
        return cls(block.contiguous().clone(), tuple(int(d) for d in x.shape),
                   spec, mesh)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def is_floating_point(self) -> bool:
        return self.local.is_floating_point()

    def shard_like(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global tensor of this placement."""
        return x[_block_slices(self.spec, self.shape, self.mesh)] \
            .contiguous().clone()

    def with_local(self, local: torch.Tensor, partial=()) -> "ShardedTensor":
        """The same placement over another block."""
        return ShardedTensor(local, self.shape, self.spec, self.mesh,
                             tuple(partial))

    def axes_at_rest(self) -> frozenset:
        return frozenset(a for e in self.spec for a in _entry_axes(e)
                         if self.mesh.shape.get(a, 1) > 1)

    def complete(self) -> "ShardedTensor":
        """Sum the addends: all-reduce over each partial axis."""
        x = self.local
        for a in self.partial:
            if a in self.axes_at_rest():
                raise ValueError(f"axis {a!r} is both a block axis and a "
                                 f"partial axis of this tensor")
            x = compat.all_reduce_raw(x, a, self.mesh)
        return self.with_local(x)

    def full(self) -> torch.Tensor:
        """The global tensor on every rank (after ``complete``): gather
        each dim over its axes, the minor axis first."""
        x = self.complete().local
        for i, entry in enumerate(tuple(self.spec)):
            for a in reversed(_entry_axes(entry)):
                x = compat.all_gather_raw(x, a, i, self.mesh)
        return x

    def __repr__(self) -> str:
        part = f", partial={self.partial}" if self.partial else ""
        return (f"ShardedTensor(shape={self.shape}, spec={self.spec!r}, "
                f"local={tuple(self.local.shape)} {_dtype_name(self.dtype)}"
                f"{part})")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: the placement ``shard`` applies."""

    mesh: Mesh
    spec: P

    def shard(self, x: torch.Tensor) -> ShardedTensor:
        """This rank's block of the global ``x``."""
        return ShardedTensor.from_global(x, self.spec, self.mesh)

    def wrap(self, block: torch.Tensor, shape: Sequence[int]
             ) -> ShardedTensor:
        """An existing block of a tensor of global ``shape``."""
        return ShardedTensor(block, tuple(int(d) for d in shape), self.spec,
                             self.mesh)


def _memory_kind(x: torch.Tensor) -> str:
    """"pinned_host" for a pinned host buffer, else the default
    ("device": the CPU is a CPU mesh's default memory)."""
    return "pinned_host" if (x.device.type == "cpu" and x.is_pinned()) \
        else "device"


def tensor_spec_from_array(x) -> TensorSpec:
    """A ``ShardedTensor`` (or a plain tensor, replicated) -> its spec."""
    if isinstance(x, ShardedTensor):
        return TensorSpec(shape=tuple(x.shape), dtype=_dtype_name(x.dtype),
                          dim_axes=spec_to_dim_axes(x.spec, len(x.shape)),
                          memory_kind=_memory_kind(x.local))
    shape = tuple(int(d) for d in x.shape)
    return TensorSpec(shape=shape, dtype=_dtype_name(x.dtype),
                      dim_axes=tuple(() for _ in shape),
                      memory_kind=_memory_kind(x))


def layout_from_arrays(tree: Dict[str, Any],
                       mesh: Optional[Mesh] = None) -> SpecLayout:
    """Table of a concrete tree: each leaf's own placement.  ``mesh``
    defaults to the first ``ShardedTensor``'s; with none the table has no
    axes."""
    if mesh is None:
        mesh = next((v.mesh for v in tree.values()
                     if isinstance(v, ShardedTensor)), None)
    axes = layout_mesh_axes(mesh) if mesh is not None else ()
    return SpecLayout(mesh_axes=axes,
                      entries={name: tensor_spec_from_array(v)
                               for name, v in tree.items()})


def layout_from_plan(shapes: Dict[str, Tuple[int, ...]], mesh: Mesh,
                     spec_for: Callable[[str], P], dtype: str,
                     memory_kind: str = "device") -> SpecLayout:
    """Table of a declared plan under the at-rest rule."""
    entries = {}
    for name, shape in shapes.items():
        spec = filter_divisible_spec(spec_for(name), shape, mesh)
        entries[name] = TensorSpec(
            shape=tuple(int(d) for d in shape), dtype=str(dtype),
            dim_axes=spec_to_dim_axes(spec, len(shape)),
            memory_kind=memory_kind)
    return SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries)
