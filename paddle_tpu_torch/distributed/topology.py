"""Hybrid-parallel topology, and which positions of a mesh axis share a
slice.

Port of ``paddle_tpu/distributed/topology.py``.  ``CommunicateTopology``
is the rank-grid arithmetic of an N-D hybrid layout (rank lists,
coordinates, per-axis communication lists); ``HybridCommunicateGroup``
builds that grid from the parallel degrees in a chosen axis order over the
port's ``parallel.specs.Mesh`` and hands out per-axis groups
(``AxisGroup``: the mesh and the axis names, the process group of a live
mesh), with the reference's ``get_*_parallel_*`` getters.

The slice part: ``device_slice_index``, ``HierAxis``, ``axis_slice_map``,
``hierarchical_axis`` and ``mesh_spans_slices``.  A job whose mesh axis
spans slices (groups of devices joined by a fast fabric, the slices by a
slower network) wants two-stage collectives: within each slice first, then
across slices on the 1/per_slice residue.  These helpers answer the one
question the overlap engine (``parallel/overlap.py``) asks: does axis A
span slices, and if so which of its positions share one?

A CUDA device exposes no slice index, as JAX's CPU devices expose none, so
``hierarchical="auto"`` resolves no hierarchy here: an explicit
``slice_map`` (one slice id per axis position) is the one way to arm the
two-stage schedule.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# canonical axis order, outermost first: the reference's default order
# dp x pp x sharding x sep x mp with pp outermost and mp innermost
DEFAULT_ORDER = ["pp", "dp", "sharding", "sep", "mp"]


class AxisGroup:
    """A communication group: one mesh axis, or a fused set of them."""

    def __init__(self, topo: "HybridCommunicateGroup", axes: Tuple[str, ...]):
        self._topo = topo
        self.axes = axes

    @property
    def nranks(self) -> int:
        n = 1
        for a in self.axes:
            n *= self._topo.get_dim_size(a)
        return n

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def name(self) -> str:
        return "+".join(self.axes)

    @property
    def ranks(self) -> List[int]:
        """The global ranks of this rank's group, in grid order."""
        return self._topo.group_ranks(self.axes)

    def __repr__(self):
        return f"AxisGroup(axes={self.axes}, nranks={self.nranks})"


class CommunicateTopology:
    """Rank-grid arithmetic: rank r sits at the row-major coordinate r of
    a grid of ``dims`` named ``hybrid_group_names``."""

    def __init__(self, hybrid_group_names: Sequence[str], dims: Sequence[int]):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = {}
        self._world = int(np.prod(dims)) if dims else 1
        self._grid = np.arange(self._world).reshape(dims)

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self) -> int:
        return self._world

    def get_rank(self, **args) -> int:
        coord = tuple(args[name] for name in self._parallel_names)
        return int(self._grid[coord])

    def get_coord(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, self._grid.shape)
        return {n: int(i) for n, i in zip(self._parallel_names, idx)}

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """The ranks at coordinate ``index`` of ``axis_name``."""
        axis = self._parallel_names.index(axis_name)
        return [int(r) for r in np.take(self._grid, index, axis=axis).flatten()]

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """Every group along ``axis_name``: one rank list per combination
        of the other axes."""
        axis = self._parallel_names.index(axis_name)
        moved = np.moveaxis(self._grid, axis, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, self._grid.shape[axis])]


class HybridCommunicateGroup:
    """The N-D hybrid-parallel topology over one ``parallel.specs.Mesh``:
    dp (data), pp (pipeline), sharding (ZeRO), sep (sequence) and mp
    (tensor) degrees laid out in ``order``.  ``mesh`` is a live mesh of
    those axes; without one the mesh is abstract (rank arithmetic
    only).  ``rank`` is
    this process's global rank: the live mesh's, else the default process
    group's, else 0."""

    def __init__(self, dp_degree: int = 1, mp_degree: int = 1,
                 pp_degree: int = 1, sharding_degree: int = 1,
                 sep_degree: int = 1,
                 order: Optional[Sequence[str]] = None,
                 mesh=None, rank: Optional[int] = None):
        from ..parallel.specs import Mesh

        self._degrees = {"dp": dp_degree, "mp": mp_degree, "pp": pp_degree,
                         "sharding": sharding_degree, "sep": sep_degree}
        order = list(order or DEFAULT_ORDER)
        if sorted(order) != sorted(DEFAULT_ORDER):
            raise ValueError(f"order must be a permutation of "
                             f"{DEFAULT_ORDER}, got {order}")
        self._order = order
        dims = [self._degrees[a] for a in order]
        self._topo = CommunicateTopology(order, dims)
        if mesh is None:
            mesh = Mesh(dims, order)
        elif [int(mesh.shape.get(a, 0)) for a in order] != dims:
            raise ValueError(f"mesh {mesh} does not carry the degrees "
                             f"{dict(zip(order, dims))} in order {order}")
        self._mesh = mesh
        if rank is None:
            rank = mesh._rank
        if rank is None:
            import torch.distributed as dist

            rank = dist.get_rank() if dist.is_available() \
                and dist.is_initialized() else 0
        self._global_rank = int(rank)

    @property
    def mesh(self):
        return self._mesh

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_dim_size(self, axis: str) -> int:
        return self._degrees[axis]

    def axis_group(self, *axes: str) -> AxisGroup:
        return AxisGroup(self, tuple(axes))

    def group_ranks(self, axes: Sequence[str]) -> List[int]:
        """The global ranks that share this rank's coordinates on every
        axis outside ``axes``, in grid order."""
        me = self._topo.get_coord(self._global_rank)
        return [r for r in range(self._topo.world_size())
                if all(c == me[a] for a, c in self._topo.get_coord(r).items()
                       if a not in axes)]

    def get_global_rank(self) -> int:
        return self._global_rank

    def get_hybrid_group_names(self):
        return self._topo.get_hybrid_group_names()

    def get_data_parallel_world_size(self) -> int:
        return self._degrees["dp"]

    def get_model_parallel_world_size(self) -> int:
        return self._degrees["mp"]

    def get_pipe_parallel_world_size(self) -> int:
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self) -> int:
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self) -> int:
        return self._degrees["sep"]

    def _rank_in(self, axis: str, rank: Optional[int] = None) -> int:
        rank = self._global_rank if rank is None else rank
        return self._topo.get_coord(rank)[axis]

    def get_data_parallel_rank(self) -> int:
        return self._rank_in("dp")

    def get_model_parallel_rank(self) -> int:
        return self._rank_in("mp")

    def get_stage_id(self) -> int:
        return self._rank_in("pp")

    def get_sharding_parallel_rank(self) -> int:
        return self._rank_in("sharding")

    def get_sep_parallel_rank(self) -> int:
        return self._rank_in("sep")

    def get_data_parallel_group(self) -> AxisGroup:
        return self.axis_group("dp")

    def get_model_parallel_group(self) -> AxisGroup:
        return self.axis_group("mp")

    def get_pipe_parallel_group(self) -> AxisGroup:
        return self.axis_group("pp")

    def get_sharding_parallel_group(self) -> AxisGroup:
        return self.axis_group("sharding")

    def get_sep_parallel_group(self) -> AxisGroup:
        return self.axis_group("sep")

    def get_dp_sep_parallel_group(self) -> AxisGroup:
        """The fused dp x sep group (the gradient all-reduce of sep-parallel
        params)."""
        return self.axis_group("dp", "sep")

    def get_check_parallel_group(self, sharding: bool = False) -> AxisGroup:
        axes = tuple(a for a in self._order
                     if a not in ("dp",) and self._degrees[a] > 1)
        return AxisGroup(self, axes)

    def data_axes(self) -> Tuple[str, ...]:
        """The axes the global batch splits over (dp and sharding, the
        FSDP convention)."""
        axes = tuple(a for a in ("dp", "sharding") if self._degrees[a] > 1)
        return axes or ("dp",)

    def __repr__(self):
        degs = ", ".join(f"{a}={self._degrees[a]}" for a in self._order)
        return f"HybridCommunicateGroup({degs}, order={self._order})"


def device_slice_index(device) -> Optional[int]:
    """The slice a device belongs to, or None when it exposes none (a CUDA
    or CPU device, a ``torch.device`` or a rank number)."""
    idx = getattr(device, "slice_index", None)
    if idx is None:
        return None
    try:
        return int(idx)
    except (TypeError, ValueError):
        return None


class HierAxis:
    """Hierarchical structure of one mesh axis that spans slices.

    ``ici_groups``: axis positions grouped by slice (the intra-slice
    stage); ``dcn_groups``: positions grouped by their offset within the
    slice (the inter-slice stage on the reduced residue).  ``num_slices``
    * ``per_slice`` is the axis size; groups exist only when every slice
    holds the same number of positions."""

    def __init__(self, num_slices: int, per_slice: int,
                 ici_groups: List[List[int]], dcn_groups: List[List[int]]):
        self.num_slices = num_slices
        self.per_slice = per_slice
        self.ici_groups = ici_groups
        self.dcn_groups = dcn_groups

    @property
    def size(self) -> int:
        return self.num_slices * self.per_slice

    def __repr__(self):
        return (f"HierAxis(slices={self.num_slices}, "
                f"per_slice={self.per_slice})")


def axis_slice_map(mesh, axis: str,
                   slice_map: Optional[Sequence[int]] = None
                   ) -> Optional[List[int]]:
    """The slice index of each position of ``axis``, or None when the
    devices carry no slice topology (always, for the port's ranks, unless
    ``slice_map`` declares it)."""
    n = int(mesh.shape[axis])
    if slice_map is not None:
        sm = [int(s) for s in slice_map]
        if len(sm) != n:
            raise ValueError(
                f"slice_map has {len(sm)} entries for axis {axis!r} of "
                f"size {n}")
        return sm
    # the ranks of the axis at the other axes' coordinate 0
    line = np.moveaxis(np.asarray(mesh.devices),
                       mesh.axis_names.index(axis), 0)
    line = line.reshape(line.shape[0], -1)[:, 0]
    out = []
    for d in line:
        s = device_slice_index(d)
        if s is None:
            return None
        out.append(s)
    return out


def hierarchical_axis(mesh, axis: str,
                      slice_map: Optional[Sequence[int]] = None
                      ) -> Optional[HierAxis]:
    """The two-stage group structure of ``axis``, or None when it does not
    span slices (one slice, no topology, or slices of unequal size: flat
    collectives are then right and the best schedule)."""
    sm = axis_slice_map(mesh, axis, slice_map)
    if sm is None:
        return None
    slices = sorted(set(sm))
    if len(slices) < 2:
        return None
    per = [sum(1 for s in sm if s == sl) for sl in slices]
    if len(set(per)) != 1:
        return None
    ici_groups = [[i for i, s in enumerate(sm) if s == sl] for sl in slices]
    k = per[0]
    dcn_groups = [[g[j] for g in ici_groups] for j in range(k)]
    return HierAxis(len(slices), k, ici_groups, dcn_groups)


def mesh_spans_slices(mesh, axis: str,
                      slice_map: Optional[Sequence[int]] = None) -> bool:
    return hierarchical_axis(mesh, axis, slice_map) is not None
