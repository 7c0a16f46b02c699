"""The partitioning schedule: named tactics over one table of placements.

Port of ``paddle_tpu/parallel/schedule.py``:

- ``Tactic``/``TACTICS`` name what each mesh axis partitions (``dp``,
  ``sharding3`` = ZeRO-3 over ``sharding``, ``tp`` = Megatron over ``mp``,
  ``pp``, ``sep``, ``ep``);
- ``PartitionSchedule`` holds the per-tensor ``SpecLayout`` table and the
  tactics, built from a plan (``from_plan``, ``from_model``) or recovered
  from a table (``from_table``); the mesh train step reads its at-rest
  specs (``spec_for``), its placement (``named_sharding``) and its batch
  spec (``batch_spec``);
- ``FlatUpdateLayout`` is the shard-major wire format of the fused flat
  AdamW (the 2004.13336 cross-replica update sharding): each leaf
  flattens as [shard blocks in the layout's axis order, local elements],
  so row r of a leaf's [ways, local] form is rank r's part of the update.
  ``flatten_leaf``/``pack_group`` and their inverses are the global form,
  element for element the JAX one; ``local_row``/``pack_local`` and
  ``unpack_local`` are the per-rank form the mesh step runs: a leaf's
  at-rest block becomes this rank's row by a local relayout, a
  reduce-scatter over the axes its gradient is partial over and a slice
  over the other axes it is replicated on, and the updated row goes back
  by all-gathers over those axes.

- ``StackSchedule`` is the overlap engine's derived schedule of one
  decoder stack (``stack_plan``: the leaf placements, the gather buckets,
  the grad-sync leaves, the prefetch window, the ring order and the
  two-stage structure with its codec), from the single copy in
  ``overlap.stack_layout_plan``;
- ``PartitionPoint``, ``JointScheduleConfig``, ``joint_schedule_lattice``,
  ``choose_joint_config`` and ``tune_schedule_config`` are the joint
  partition x memory x overlap tuner, the memory tuner's cheapest-first
  walk one axis richer.

``from_moe_ep`` is the MoE EP block's schedule (``parallel/expert.py``'s
plan, the ``ep`` or ``ep_dropless`` tactic).  The DCN wire measurement of
a built step (``measure_dcn_wire_bytes``) is the Graph Doctor's COMM004
pricing of its capture; ``tune_schedule_config(predict=True)`` ranks the
lattice by ``roofline``'s estimate and builds only the top K.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compat
from .specs import (Mesh, NamedSharding, P, ShardedTensor,
                    SpecLayout, TensorSpec, _entry_axes,
                    filter_divisible_spec, filter_spec_to_mesh,
                    layout_mesh_axes,
                    mesh_axis_sizes, spec_to_dim_axes)


# ---------------------------------------------------------------------------
# the tactic vocabulary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tactic:
    """One named tactic: the mesh axis it rides and what it partitions
    (``data``: the batch; ``weight``: the weights; ``both``: ZeRO-3-style,
    weights at rest and the batch)."""

    name: str
    axis: str
    kind: str


#: the tactics in composition order (outermost first)
TACTICS: Dict[str, Tactic] = {
    "pp": Tactic("pp", "pp", "weight"),
    "dp": Tactic("dp", "dp", "data"),
    "sharding3": Tactic("sharding3", "sharding", "both"),
    "sep": Tactic("sep", "sep", "data"),
    "tp": Tactic("tp", "mp", "weight"),
    "ep": Tactic("ep", "ep", "both"),
    "ep_dropless": Tactic("ep_dropless", "ep", "both"),
}

_AXIS_TO_TACTIC: Dict[str, Tactic] = {}
for _t in TACTICS.values():
    _AXIS_TO_TACTIC.setdefault(_t.axis, _t)
del _t


def tactics_for_mesh(mesh: Mesh) -> Tuple[Tactic, ...]:
    """The tactics a mesh composes, in its axis order (size-1 axes
    dropped)."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(_AXIS_TO_TACTIC[a] for a in mesh.axis_names
                 if a in _AXIS_TO_TACTIC and sizes[a] > 1)


_LAYER_RE = re.compile(r"^(model\.layers\.)(\d+)\.")
_LAYER_PREFIX = "model.layers."


def canonical_key(name: str) -> str:
    """``model.layers.<i>.X`` -> ``model.layers.*.X``."""
    return _LAYER_RE.sub(r"\g<1>*.", name)


def hybrid_leaf_spec(name: str, shape: Sequence[int], mesh: Mesh,
                     plan_for: Callable[[str], P]) -> P:
    """At-rest spec of one hybrid-state leaf: stacked layer leaves
    (``model.layers.<suffix>``, leading [L]) lead with 'pp', inner dims
    follow the plan under the at-rest rule."""
    shape = tuple(int(d) for d in shape)
    stacked = name.startswith(_LAYER_PREFIX)
    inner = shape[1:] if stacked else shape
    spec = filter_divisible_spec(plan_for(name), inner, mesh)
    if not stacked:
        return spec
    pp = int(mesh.shape["pp"]) if "pp" in mesh.axis_names else 1
    if shape[0] % max(pp, 1):
        raise ValueError(
            f"{name}: {shape[0]} layers not divisible by pp degree {pp}")
    return P("pp" if pp > 1 else None, *tuple(spec))


# ---------------------------------------------------------------------------
# the shard-major flat-update wire format
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _FlatLeafPlan:
    """Shard-major decomposition of one leaf: ``x.reshape(pre)
    .transpose(perm).reshape(ways, -1)``.  ``dim_axes`` names the axis of
    each ``pre`` factor (None for the local ones)."""

    shape: Tuple[int, ...]
    pre: Tuple[int, ...]
    perm: Tuple[int, ...]
    local: int
    spec: Any = None
    dim_axes: Tuple[Optional[str], ...] = ()


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class FlatUpdateLayout:
    """The shard-major wire format of the flat update (module docstring).
    ``signature`` is part of the flat-group names
    (``decay|float32|sm[dp2.sharding2.mp2]``), so a state built under one
    layout and fed to a step that expects another fails on its group
    names instead of misordering the masters."""

    def __init__(self, mesh: Mesh,
                 spec_for: Callable[[str, Tuple[int, ...]], P],
                 axes: Optional[Sequence[str]] = None):
        self.mesh = mesh
        self._spec_for = spec_for
        sizes = mesh_axis_sizes(mesh)
        if axes is None:
            axes = tuple(a for a in mesh.axis_names if sizes[a] > 1)
        self.axes: Tuple[str, ...] = tuple(axes)
        self.sizes = sizes
        self.ways = math.prod(sizes[a] for a in self.axes) \
            if self.axes else 1

    @property
    def signature(self) -> str:
        return "sm[" + ".".join(f"{a}{self.sizes[a]}"
                                for a in self.axes) + "]"

    def flat_spec(self) -> P:
        """Placement of the 1-D flat group buffers."""
        if not self.axes:
            return P()
        return P(self.axes if len(self.axes) > 1 else self.axes[0])

    def rank_block(self) -> int:
        """This rank's row: its row-major coordinate over the layout's
        axes."""
        idx = 0
        coords = self.mesh.coords
        for a in self.axes:
            idx = idx * self.sizes[a] + coords[a]
        return idx

    # -- per-leaf plans ------------------------------------------------------

    def leaf_plan(self, name: str, shape: Sequence[int]
                  ) -> Optional[_FlatLeafPlan]:
        """Shard-major decomposition of one leaf, or None when the shape
        cannot host every axis (its group then keeps the row-major
        format)."""
        shape = tuple(int(d) for d in shape)
        if not shape:
            return None
        spec = filter_divisible_spec(self._spec_for(name, shape), shape,
                                     self.mesh)
        entries = tuple(spec)
        dims: List[List[Any]] = []
        for i, dim in enumerate(shape):
            rem = int(dim)
            for a in (_entry_axes(entries[i]) if i < len(entries) else ()):
                n = self.sizes.get(a, 1)
                if n <= 1:
                    continue
                if rem % n:
                    return None
                dims.append([n, a])
                rem //= n
            dims.append([rem, None])
        used = {ax for _, ax in dims if ax is not None}
        for a in self.axes:
            if a in used:
                continue
            n = self.sizes[a]
            for j, (sz, ax) in enumerate(dims):
                if ax is None and sz % n == 0 and sz >= n:
                    dims[j:j + 1] = [[n, a], [sz // n, None]]
                    break
            else:
                return None
        block = [next(j for j, (_, ax) in enumerate(dims) if ax == a)
                 for a in self.axes]
        rest = [j for j in range(len(dims)) if j not in block]
        pre = tuple(int(sz) for sz, _ in dims)
        return _FlatLeafPlan(shape=shape, pre=pre, perm=tuple(block + rest),
                             local=math.prod(pre[j] for j in rest),
                             spec=spec,
                             dim_axes=tuple(ax for _, ax in dims))

    # -- the global transforms (the JAX order, exact inverses) ---------------

    def flatten_leaf(self, plan: _FlatLeafPlan, x) -> torch.Tensor:
        """Global leaf -> its [ways, local] shard-major form."""
        a = _as_tensor(x).reshape(plan.pre).permute(plan.perm)
        return a.reshape(self.ways, plan.local)

    def unflatten_leaf(self, plan: _FlatLeafPlan, flat2d) -> torch.Tensor:
        """Exact inverse of ``flatten_leaf``."""
        mid = tuple(plan.pre[j] for j in plan.perm)
        a = _as_tensor(flat2d).reshape(mid)
        return a.permute(tuple(int(i) for i in np.argsort(plan.perm))) \
            .reshape(plan.shape)

    def pack_group(self, plans: Dict[str, _FlatLeafPlan],
                   keys: Sequence[str], values: Dict[str, Any],
                   dtype=torch.float32) -> torch.Tensor:
        """Group wire format: the leaves' [ways, local] forms side by side,
        read row by row into one 1-D buffer."""
        if not keys:
            return torch.zeros((0,), dtype=dtype)
        cols = [self.flatten_leaf(plans[k], _as_tensor(values[k]).to(dtype))
                for k in keys]
        return torch.cat(cols, dim=1).reshape(-1)

    def unpack_group(self, plans: Dict[str, _FlatLeafPlan],
                     keys: Sequence[str], flat) -> Dict[str, torch.Tensor]:
        """Inverse of ``pack_group``: 1-D flat group -> global leaves."""
        out: Dict[str, torch.Tensor] = {}
        if not keys:
            return out
        f2 = _as_tensor(flat).reshape(self.ways, -1)
        off = 0
        for k in keys:
            pl = plans[k]
            out[k] = self.unflatten_leaf(pl, f2[:, off:off + pl.local])
            off += pl.local
        return out

    # -- the per-rank transforms (what the mesh step runs) -------------------

    def _local_pre(self, plan: _FlatLeafPlan, at_rest) -> List[int]:
        return [1 if ax in at_rest else sz
                for sz, ax in zip(plan.pre, plan.dim_axes)]

    def local_row(self, plan: _FlatLeafPlan, x: ShardedTensor
                  ) -> torch.Tensor:
        """This rank's row [local] of a leaf from its at-rest block: the
        local relayout, then per layout axis a reduce-scatter where the
        block is partial over it, a slice where it is a copy, nothing
        where the axis already cuts the block at rest."""
        at_rest = x.axes_at_rest()
        pre = self._local_pre(plan, at_rest)
        k = len(self.axes)
        y = x.local.reshape(pre).permute(plan.perm)
        y = y.reshape([pre[j] for j in plan.perm[:k]] + [plan.local])
        coords = self.mesh.coords
        for i, a in enumerate(self.axes):
            if a in at_rest:
                if a in x.partial:
                    raise ValueError(f"axis {a!r} both cuts this block and "
                                     f"sums it")
                continue
            if a in x.partial:
                y = compat.reduce_scatter_raw(y, a, i, self.mesh)
            else:
                y = y.narrow(i, coords[a], 1)
        return y.reshape(plan.local)

    def unpack_row(self, plan: _FlatLeafPlan, row: torch.Tensor,
                   like: ShardedTensor) -> torch.Tensor:
        """Inverse of ``local_row`` for a complete value: the at-rest block
        of ``like``'s placement, all-gathered over the axes the leaf is
        replicated on."""
        at_rest = like.axes_at_rest()
        pre = self._local_pre(plan, at_rest)
        k = len(self.axes)
        y = row.reshape([1] * k + [plan.local])
        for i, a in enumerate(self.axes):
            if a not in at_rest:
                y = compat.all_gather_raw(y, a, i, self.mesh)
        y = y.reshape([pre[j] for j in plan.perm])
        y = y.permute(tuple(int(i) for i in np.argsort(plan.perm)))
        return y.reshape(like.local.shape)

    def pack_local(self, plans: Dict[str, _FlatLeafPlan],
                   keys: Sequence[str], values: Dict[str, ShardedTensor],
                   dtype=torch.float32) -> torch.Tensor:
        """This rank's block of ``pack_group`` from at-rest blocks."""
        if not keys:
            return torch.zeros((0,), dtype=dtype)
        return torch.cat([self.local_row(plans[k], values[k]).to(dtype)
                          for k in keys])

    def unpack_local(self, plans: Dict[str, _FlatLeafPlan],
                     keys: Sequence[str], block: torch.Tensor,
                     like: Dict[str, ShardedTensor]
                     ) -> Dict[str, torch.Tensor]:
        """Inverse of ``pack_local``: each leaf's at-rest block."""
        out, off = {}, 0
        for k in keys:
            pl = plans[k]
            out[k] = self.unpack_row(pl, block[off:off + pl.local], like[k])
            off += pl.local
        return out

    def block_of(self, flat) -> torch.Tensor:
        """This rank's block of a global 1-D flat group buffer."""
        flat = _as_tensor(flat)
        n = flat.shape[0] // self.ways
        r = self.rank_block()
        return flat[r * n:(r + 1) * n]

    def gather_block(self, block: torch.Tensor) -> torch.Tensor:
        """The global flat group buffer from every rank's block."""
        for a in reversed(self.axes):
            block = compat.all_gather_raw(block, a, 0, self.mesh)
        return block


# ---------------------------------------------------------------------------
# the stack-schedule derivation (what the overlap engine consumes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StackSchedule:
    """The overlap engine's derived schedule of one decoder stack (mirror of
    ``StackSchedule``): leaf placements, gather buckets, grad-sync leaves,
    the prefetch window (layers of gather-ahead), the collective matmul's
    ring order and the resolved two-stage structure with its codec."""

    layout: Dict[str, Any]             # suffix -> overlap._LeafPlace
    buckets: List[List[str]]
    sync_suffixes: List[str]
    prefetch_window: int
    ring_order: Tuple[Tuple[int, int], ...]
    hier: Optional[Any] = None
    codec: Optional[Any] = None

    def describe(self) -> Dict[str, Any]:
        return {
            "buckets": [list(b) for b in self.buckets],
            "sync_suffixes": list(self.sync_suffixes),
            "prefetch_window": self.prefetch_window,
            "ring_order": [list(p) for p in self.ring_order],
            "hierarchical": None if self.hier is None else {
                "num_slices": self.hier.num_slices,
                "per_slice": self.hier.per_slice},
            "codec": (self.codec.to_json()
                      if self.codec is not None else None),
        }


# ---------------------------------------------------------------------------
# the schedule object
# ---------------------------------------------------------------------------


class PartitionSchedule:
    """The partitioning schedule: the per-tensor table and the tactics
    over one mesh (module docstring)."""

    def __init__(self, mesh: Mesh, plan_for: Callable[[str], P],
                 table: SpecLayout,
                 tactics: Optional[Tuple[Tactic, ...]] = None):
        self.mesh = mesh
        self.plan_for = plan_for
        self.table = table
        self.tactics = (tactics if tactics is not None
                        else tactics_for_mesh(mesh))

    # -- construction --------------------------------------------------------

    @classmethod
    def from_plan(cls, mesh: Mesh, shapes: Dict[str, Tuple[int, ...]],
                  spec_for: Callable[[str], P], dtype: str = "float32",
                  tactics: Optional[Sequence[str]] = None
                  ) -> "PartitionSchedule":
        """Per-name global shapes and a plan rule, placed under the at-rest
        rule; the layers of one role must agree."""
        entries: Dict[str, TensorSpec] = {}
        for name, shape in shapes.items():
            key = canonical_key(name)
            spec = filter_divisible_spec(spec_for(name), shape, mesh)
            ts = TensorSpec(shape=tuple(int(d) for d in shape),
                            dtype=str(dtype),
                            dim_axes=spec_to_dim_axes(spec, len(shape)))
            prev = entries.get(key)
            if prev is not None and prev != ts:
                raise ValueError(
                    f"{key}: layer roles disagree under the plan "
                    f"({prev.describe()} vs {ts.describe()})")
            entries[key] = ts
        table = SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries)
        tac = (tuple(TACTICS[t] for t in tactics)
               if tactics is not None else None)
        return cls(mesh, spec_for, table, tac)

    @classmethod
    def from_model(cls, model, mesh: Mesh, plan=None) -> "PartitionSchedule":
        """A Llama-family model's parameters (global shapes) under its
        plan (``LLAMA_SHARDING_PLAN`` by default)."""
        from ..models.llama import global_param_shapes, plan_spec_for

        return cls.from_plan(mesh, global_param_shapes(model),
                             lambda n: plan_spec_for(n, plan))

    @classmethod
    def from_table(cls, table: Dict[str, Any],
                   mesh: Optional[Mesh] = None) -> "PartitionSchedule":
        """Recover a schedule from a ``SpecLayout.to_table()`` dump;
        ``mesh`` defaults to an abstract mesh of the table's axes."""
        axes = [(str(a), int(n)) for a, n in table["mesh_axes"]]
        if mesh is None:
            mesh = Mesh([n for _, n in axes] or [1],
                        tuple(a for a, _ in axes) or ("dp",))
        entries: Dict[str, TensorSpec] = {}
        for name, ts in table["tensors"].items():
            entries[name] = TensorSpec(
                shape=tuple(int(d) for d in ts["shape"]),
                dtype=str(ts["dtype"]),
                dim_axes=tuple(tuple(str(a) for a in axs)
                               for axs in ts["dim_axes"]),
                memory_kind=str(ts.get("memory_kind", "device")))
        layout = SpecLayout(mesh_axes=tuple(axes), entries=entries)

        def plan_for(name: str) -> P:
            """Full names (any layer index), the stacked form and bare
            intra-layer suffixes all resolve."""
            key = canonical_key(name)
            ts = entries.get(key)
            if ts is None and key.startswith(_LAYER_PREFIX):
                ts = entries.get(_LAYER_PREFIX + "*."
                                 + key[len(_LAYER_PREFIX):])
            if ts is None:
                ts = entries.get(_LAYER_PREFIX + "*." + key)
            if ts is None:
                for k, v in entries.items():
                    if k.endswith("." + key):
                        ts = v
                        break
            if ts is None:
                return P()
            return ts.partition_spec()

        return cls(mesh, plan_for, layout)

    @classmethod
    def from_moe_ep(cls, cfg, mesh: Mesh, dtype: str = "float32",
                    tactics: Optional[Sequence[str]] = None,
                    dropless: bool = False) -> "PartitionSchedule":
        """The MoE EP block's schedule (mirror of ``from_moe_ep``): the
        block's declared plan (``expert.moe_ep_layout``'s: expert leaves
        lead with ``ep``, the gate replicates) under the at-rest rule.
        ``cfg`` is a ``MoEEPConfig``.  ``dropless=True`` names the
        ``ep_dropless`` tactic on the ``ep`` axis instead of ``ep``: the
        table is the same (the dropless block changes the token transport,
        not the placement)."""
        from .expert import moe_ep_shapes, moe_ep_spec_for
        from .specs import EXPERT_AXIS

        if tactics is None and dropless:
            tactics = ["ep_dropless" if t.axis == EXPERT_AXIS else t.name
                       for t in tactics_for_mesh(mesh)]
        return cls.from_plan(mesh, moe_ep_shapes(cfg), moe_ep_spec_for,
                             dtype=dtype, tactics=tactics)

    # -- introspection -------------------------------------------------------

    def tactic_names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tactics)

    def shape_of(self, name: str) -> Optional[Tuple[int, ...]]:
        ts = self.table.entries.get(canonical_key(name))
        return None if ts is None else ts.shape

    # -- the placements ------------------------------------------------------

    def plan_spec_for(self, name: str) -> P:
        """The plan's spec before the divisibility rule (the overlap
        engine's per-axis pick rule applies its own)."""
        return filter_spec_to_mesh(self.plan_for(name), self.mesh)

    def spec_for(self, name: str, shape: Sequence[int]) -> P:
        """At-rest spec of one leaf: the plan under the at-rest rule."""
        return filter_divisible_spec(self.plan_for(name),
                                     tuple(int(d) for d in shape), self.mesh)

    def named_sharding(self, name: str, shape: Sequence[int]
                       ) -> NamedSharding:
        """The placement of one leaf (``.shard(x)`` cuts this rank's
        block)."""
        return NamedSharding(self.mesh, self.spec_for(name, shape))

    def batch_spec(self, data_axes: Sequence[str] = ("dp", "sharding")
                   ) -> P:
        """The [B, ...] batch spec over the data axes present."""
        from .specs import batch_partition_spec

        return batch_partition_spec(self.mesh, data_axes)

    def reshard_specs(self) -> Dict[str, P]:
        """Per-canonical-name at-rest specs in the reshard planner's form
        (dotted path -> P)."""
        return {name: ts.partition_spec()
                for name, ts in self.table.items()}

    def reshard_spec(self, path: str, leaf=None) -> P:
        """The planner's ``(path, leaf) -> P`` rule: the table's entry
        first, then the plan rule (the planner's ``fit_spec`` degrades
        either to a valid placement on any mesh)."""
        ts = self.table.entries.get(canonical_key(path))
        if ts is not None:
            return ts.partition_spec()
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if shape:
            return self.spec_for(path, shape)
        return self.plan_for(path)

    def flat_update_layout(self, axes: Optional[Sequence[str]] = None
                           ) -> FlatUpdateLayout:
        """The shard-major flat-update wire format of this schedule."""
        return FlatUpdateLayout(self.mesh, lambda n, s: self.plan_for(n),
                                axes=axes)

    # -- the other stacks ----------------------------------------------------

    def layer_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Per-layer leaf shapes by intra-layer suffix, from the table."""
        out = {}
        for name, ts in self.table.items():
            if name.startswith(_LAYER_PREFIX + "*."):
                out[name[len(_LAYER_PREFIX) + 2:]] = ts.shape
        return out

    def stack_plan(self, oc=None, compute_dtype=torch.bfloat16,
                   shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                   ) -> StackSchedule:
        """The overlap engine's whole schedule, from
        ``overlap.stack_layout_plan`` (one copy), with the ring order, the
        prefetch window and the two-stage structure and codec (plan math:
        no process group is made)."""
        from . import overlap as _ov

        oc = oc if oc is not None else _ov.OverlapConfig()
        shapes = shapes if shapes is not None else self.layer_shapes()
        layout, buckets, sync = _ov.stack_layout_plan(
            shapes, self.mesh, self.plan_spec_for, oc,
            compute_dtype=compute_dtype)
        sizes = mesh_axis_sizes(self.mesh)
        sh = sizes.get("sharding", 1)
        hier = oc.resolve_hier(self.mesh, "sharding" if sh > 1 else None)
        mp = sizes.get("mp", 1)
        ring = tuple((i, (i + 1) % mp) for i in range(mp)) if mp > 1 \
            else ()
        return StackSchedule(
            layout=layout, buckets=buckets, sync_suffixes=sync,
            prefetch_window=1 if oc.prefetch else 0,
            ring_order=ring, hier=hier,
            codec=oc.codec if hier is not None else None)

    def hybrid_spec(self, name: str, shape: Sequence[int]) -> P:
        """At-rest spec of one hybrid-state leaf."""
        return hybrid_leaf_spec(name, shape, self.mesh, self.plan_for)

    def rederive(self, mesh: Mesh) -> "PartitionSchedule":
        """The same tactics over another mesh."""
        entries = {}
        for name, ts in self.table.items():
            spec = filter_divisible_spec(self.plan_for(name), ts.shape, mesh)
            entries[name] = TensorSpec(
                shape=ts.shape, dtype=ts.dtype,
                dim_axes=spec_to_dim_axes(spec, len(ts.shape)),
                memory_kind=ts.memory_kind)
        return PartitionSchedule(
            mesh, self.plan_for,
            SpecLayout(mesh_axes=layout_mesh_axes(mesh), entries=entries))

    # -- reporting -----------------------------------------------------------

    def describe(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in layout_mesh_axes(self.mesh)
                         if n > 1)
        return (f"PartitionSchedule[{' / '.join(self.tactic_names())}]"
                f" over ({axes}; {len(self.table.entries)} tensors)")


# ---------------------------------------------------------------------------
# the joint partition x memory x overlap tuner
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionPoint:
    """One partitioning point of the joint lattice (mirror of
    ``PartitionPoint``): mesh axis degrees, outer to inner, and the slice
    map when the point spans slices (which arms the two-stage schedule)."""

    name: str
    axes: Tuple[Tuple[str, int], ...]
    slice_map: Optional[Tuple[int, ...]] = None
    #: the axis the slice map describes
    dcn_axis: str = "sharding"

    def mesh(self, devices=None) -> Mesh:
        """The point's mesh, abstract (plan math; ``init_mesh`` makes a live
        one of the same shape).  ``devices``: how many ranks there are, or
        a sequence of them, at least the point's count."""
        total = math.prod(n for _, n in self.axes)
        if devices is not None:
            have = devices if isinstance(devices, int) else len(devices)
            if have < total:
                raise ValueError(f"{self.name}: wants {total} devices, "
                                 f"have {have}")
        return Mesh([n for _, n in self.axes],
                    tuple(a for a, _ in self.axes))

    def dcn_axes(self) -> Dict[str, List[int]]:
        """{axis: slice map} of the slice-spanning axis; empty when the
        point is one slice."""
        if self.slice_map is None:
            return {}
        return {self.dcn_axis: list(self.slice_map)}

    def label(self) -> str:
        body = "x".join(f"{a}{n}" for a, n in self.axes if n > 1)
        return f"{self.name}({body})" + \
            ("[2slice]" if self.slice_map else "")

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "axes": [[a, n] for a, n in self.axes],
                "slice_map": (list(self.slice_map)
                              if self.slice_map else None)}


@dataclasses.dataclass(frozen=True)
class JointScheduleConfig:
    """One point of the joint lattice: partitioning x memory residency x
    overlap/codec (its label/json match ``memory.JointConfig``)."""

    partition: PartitionPoint
    memory: Any                        # parallel.memory.MemoryConfig
    overlap: Optional[Any] = None      # parallel.overlap.OverlapConfig

    def label(self) -> str:
        lab = self.partition.label() + "/" + self.memory.label()
        codec = getattr(self.overlap, "codec", None)
        lab += "/" + (codec.label() if codec is not None else "codec-off")
        return lab

    def to_json(self) -> Dict[str, Any]:
        codec = getattr(self.overlap, "codec", None)
        return {"partition": self.partition.to_json(),
                "memory": self.memory.to_json(),
                "codec": codec.to_json() if codec is not None else None}


def joint_schedule_lattice(points: Sequence[PartitionPoint],
                           memory_lattice: Optional[Sequence] = None,
                           codec_points: Optional[Sequence] = None,
                           base_overlap=None
                           ) -> Tuple[JointScheduleConfig, ...]:
    """Partitioning x MemoryConfig x codec in increasing predicted cost:
    the points as the caller lists them (cheapest first), per point the
    memory lattice, then the codec points; a codec only under a point that
    spans slices (quantize across slices only)."""
    from .memory import MEMORY_LATTICE, codec_lattice_points
    from .overlap import OverlapConfig

    mem = tuple(MEMORY_LATTICE if memory_lattice is None
                else memory_lattice)
    cps = tuple(codec_lattice_points() if codec_points is None
                else codec_points)
    base = base_overlap if base_overlap is not None else OverlapConfig()
    out = []
    for pt in points:
        for m in mem:
            for c in cps:
                if c is not None and pt.slice_map is None:
                    continue
                oc = dataclasses.replace(
                    base, codec=c,
                    hierarchical="on" if pt.slice_map else "off",
                    slice_map=pt.slice_map)
                out.append(JointScheduleConfig(pt, m, oc))
    return tuple(out)


def choose_joint_config(records: Sequence[Dict[str, Any]],
                        hbm_bytes: Optional[int] = None,
                        dcn_wire_bytes: Optional[int] = None
                        ) -> Optional[int]:
    """Index of the first (cheapest) record within every declared budget
    (peak bytes, post-codec DCN wire bytes), or None."""
    for i, rec in enumerate(records):
        if hbm_bytes is not None and rec["peak_bytes"] > hbm_bytes:
            continue
        if dcn_wire_bytes is not None \
                and rec.get("dcn_wire_bytes", 0) > dcn_wire_bytes:
            continue
        return i
    return None


def measure_dcn_wire_bytes(cfg: JointScheduleConfig, fn, args) -> int:
    """Post-codec DCN bytes of one built step (the COMM004 cost model of
    the joint walk): the Graph Doctor captures ``fn(*args)`` once on fake
    tensors on this rank's process group (a fake one in a rehearsal,
    ``analysis.core.fake_ranks``) and prices its collectives against the
    point's slice map (``collect_wire_table``).  The step's mesh names the
    axes (``fn.schedule.mesh``, else the first ``ShardedTensor`` of the
    arguments)."""
    import torch.utils._pytree as pytree

    from ..analysis.core import capture
    from ..analysis.passes.collective_budget import collect_wire_table
    from .specs import ShardedTensor

    dcn_axes = cfg.partition.dcn_axes()
    if not dcn_axes:
        return 0
    leaves = pytree.tree_leaves(list(args),
                                is_leaf=lambda x: isinstance(x,
                                                             ShardedTensor))
    mesh = getattr(getattr(fn, "schedule", None), "mesh", None) or next(
        (x.mesh for x in leaves if isinstance(x, ShardedTensor)), None)
    dev = next((x.device for x in leaves
                if isinstance(x, (torch.Tensor, ShardedTensor))), None)
    cap = capture(fn, tuple(args), device=dev, mesh=mesh)
    return int(collect_wire_table(cap, mesh, dcn_axes)["dcn"]["bytes"])


def tune_schedule_config(step_builder: Callable[[JointScheduleConfig],
                                                Tuple],
                         hbm_bytes: int,
                         lattice: Sequence[JointScheduleConfig], *,
                         dcn_wire_bytes: Optional[int] = None,
                         predict: bool = False,
                         estimator: Optional[Callable] = None,
                         top_k: int = 1, meter: Optional[Callable] = None,
                         dcn_bytes_fn: Optional[Callable] = None):
    """The joint search: ``memory.tune_memory_config``'s walk (cheapest
    first, each built step's peak measured on the card, or by ``meter``,
    first fit wins) over the partition x memory x overlap lattice; returns
    ``(chosen, records)``.  A DCN wire budget is measured by
    ``measure_dcn_wire_bytes`` (each point's step captured and priced), or
    by ``dcn_bytes_fn``.

    ``predict=True`` ranks the lattice by the roofline's estimate first and
    builds only the top K (``_predicted_walk``): ``estimator`` (a callable
    JointScheduleConfig -> StepTimeEstimate, ``roofline.joint_estimator``)
    orders the points and, when it renders a budget verdict
    (``estimate.fits``), skips the points it predicts do not fit; the
    measured peak and DCN bytes stay the verdict on every point built.
    Records come back in lattice order, each with its ``predicted``
    estimate and ``predicted_rank``; ``compiled`` says whether the point
    was built and measured (the reference's word for it), and only those
    carry the measured ``peak_bytes`` and ``fits``.  Without an estimator
    it raises ``ValueError``: a ranking with no estimate would silently
    fall back to lattice order."""
    from .memory import tune_memory_config

    dcn_fn = dcn_bytes_fn or measure_dcn_wire_bytes
    if predict:
        if estimator is None:
            raise ValueError(
                "tune_schedule_config(predict=True) needs an estimator "
                "(roofline.joint_estimator): a predicted ranking with no "
                "estimate would silently fall back to lattice order")
        return _predicted_walk(step_builder, hbm_bytes, tuple(lattice),
                               estimator, dcn_wire_bytes=dcn_wire_bytes,
                               top_k=max(1, int(top_k)), meter=meter,
                               dcn_bytes_fn=dcn_fn)
    if dcn_wire_bytes is None:
        return tune_memory_config(step_builder, hbm_bytes,
                                  lattice=tuple(lattice), meter=meter)
    return tune_memory_config(step_builder, hbm_bytes,
                              lattice=tuple(lattice),
                              dcn_wire_bytes=dcn_wire_bytes,
                              dcn_bytes_fn=dcn_fn, meter=meter)


def _predicted_walk(step_builder, hbm_bytes, lattice, estimator, *,
                    dcn_wire_bytes=None, top_k=1, meter=None,
                    dcn_bytes_fn=measure_dcn_wire_bytes):
    """The predict-mode walk: estimate every point, visit them in predicted
    order (cheapest first) skipping those the estimator predicts do not
    fit, build and measure at most ``top_k`` (``meter``, else the card's
    ``measure_step_memory``) and stop at the first whose measured peak,
    and DCN bytes when budgeted, fit."""
    from .memory import measure_step_memory

    ests = [estimator(jc) for jc in lattice]

    def _total(e):
        return e.total_s if hasattr(e, "total_s") else e["total_s"]

    order = sorted(range(len(lattice)), key=lambda i: _total(ests[i]))
    records = []
    for i, (jc, est) in enumerate(zip(lattice, ests)):
        ej = est.to_json() if hasattr(est, "to_json") else dict(est)
        records.append({"config": jc.to_json(), "label": jc.label(),
                        "predicted": ej,
                        "predicted_rank": order.index(i),
                        "compiled": False})
    chosen = None
    built = 0
    for idx in order:
        if built >= top_k:
            break
        if records[idx]["predicted"].get("fits") is False:
            continue            # predicted not to fit: not worth a build
        jc = lattice[idx]
        fn, args = step_builder(jc)
        stats = (meter or measure_step_memory)(fn, *args)
        rec = records[idx]
        rec.update(stats, compiled=True,
                   fits=stats["peak_bytes"] <= hbm_bytes)
        if dcn_wire_bytes is not None:
            dcn = int(dcn_bytes_fn(jc, fn, args))
            rec["dcn_wire_bytes"] = dcn
            rec["fits"] = bool(rec["fits"] and dcn <= dcn_wire_bytes)
        built += 1
        if rec["fits"]:
            chosen = jc
            break
    return chosen, records


__all__ = ["FlatUpdateLayout", "JointScheduleConfig", "PartitionPoint",
           "PartitionSchedule", "StackSchedule", "TACTICS", "Tactic",
           "canonical_key", "choose_joint_config", "hybrid_leaf_spec",
           "joint_schedule_lattice", "measure_dcn_wire_bytes",
           "tactics_for_mesh", "tune_schedule_config"]
