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

What waits for later parts of ROADMAP A5 raises ``NotImplementedError``:
the overlap engine's ``stack_plan`` and ``StackSchedule`` (A5.2), EP's
``from_moe_ep`` (A5.3) and the joint partition x memory x overlap tuner
(A5.2, it searches over ``OverlapConfig`` and the collective codecs).
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
                    filter_divisible_spec, layout_mesh_axes,
                    mesh_axis_sizes, spec_to_dim_axes)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} belongs to ROADMAP queue {item}, not ported yet")


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
# the overlap engine's derivation (A5.2)
# ---------------------------------------------------------------------------


class StackSchedule:
    """The overlap engine's derived stack schedule: ROADMAP A5.2."""

    def __init__(self, *args, **kwargs):
        raise _unported("StackSchedule (the overlap engine's input)",
                        "A5.2")


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
    def from_moe_ep(cls, *args, **kwargs) -> "PartitionSchedule":
        """The EP constructor: ROADMAP A5.3."""
        raise _unported("PartitionSchedule.from_moe_ep (expert "
                        "parallelism)", "A5.3")

    # -- introspection -------------------------------------------------------

    def tactic_names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tactics)

    def shape_of(self, name: str) -> Optional[Tuple[int, ...]]:
        ts = self.table.entries.get(canonical_key(name))
        return None if ts is None else ts.shape

    # -- the placements ------------------------------------------------------

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

    def flat_update_layout(self, axes: Optional[Sequence[str]] = None
                           ) -> FlatUpdateLayout:
        """The shard-major flat-update wire format of this schedule."""
        return FlatUpdateLayout(self.mesh, lambda n, s: self.plan_for(n),
                                axes=axes)

    # -- the other stacks ----------------------------------------------------

    def stack_plan(self, *args, **kwargs):
        """The overlap engine's stack schedule: ROADMAP A5.2."""
        raise _unported("PartitionSchedule.stack_plan (the overlap "
                        "engine)", "A5.2")

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
# the joint partition x memory x overlap tuner (A5.2)
# ---------------------------------------------------------------------------


def _joint(name: str):
    def unported(*args, **kwargs):
        raise _unported(f"{name} (the joint partition x memory x overlap "
                        f"tuner)", "A5.2")
    unported.__name__ = name
    return unported


class PartitionPoint:
    def __init__(self, *args, **kwargs):
        raise _unported("PartitionPoint (the joint tuner)", "A5.2")


class JointScheduleConfig:
    def __init__(self, *args, **kwargs):
        raise _unported("JointScheduleConfig (the joint tuner)", "A5.2")


joint_schedule_lattice = _joint("joint_schedule_lattice")
choose_joint_config = _joint("choose_joint_config")
measure_dcn_wire_bytes = _joint("measure_dcn_wire_bytes")
tune_schedule_config = _joint("tune_schedule_config")

__all__ = ["FlatUpdateLayout", "JointScheduleConfig", "PartitionPoint",
           "PartitionSchedule", "StackSchedule", "TACTICS", "Tactic",
           "canonical_key", "choose_joint_config", "hybrid_leaf_spec",
           "joint_schedule_lattice", "measure_dcn_wire_bytes",
           "tactics_for_mesh", "tune_schedule_config"]
