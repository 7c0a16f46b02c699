"""Which positions of a mesh axis share a slice.

Port of the slice part of ``paddle_tpu/distributed/topology.py``:
``device_slice_index``, ``HierAxis``, ``axis_slice_map``,
``hierarchical_axis`` and ``mesh_spans_slices``.  A job whose mesh axis
spans slices (groups of devices joined by a fast fabric, the slices by a
slower network) wants two-stage collectives: within each slice first, then
across slices on the 1/per_slice residue.  These helpers answer the one
question the overlap engine (``parallel/overlap.py``) asks: does axis A
span slices, and if so which of its positions share one?

A CUDA device exposes no slice index, as JAX's CPU devices expose none, so
``hierarchical="auto"`` resolves no hierarchy here: an explicit
``slice_map`` (one slice id per axis position) is the one way to arm the
two-stage schedule.  The rest of the JAX module (the hybrid communicate
group) belongs to ROADMAP A6.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


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
