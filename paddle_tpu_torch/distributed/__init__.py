"""Distributed helpers of the port (mirror of ``paddle_tpu/distributed``):
so far the slice topology the overlap engine asks about
(``topology.py``)."""

from .topology import (HierAxis, axis_slice_map, device_slice_index,
                       hierarchical_axis, mesh_spans_slices)

__all__ = ["HierAxis", "axis_slice_map", "device_slice_index",
           "hierarchical_axis", "mesh_spans_slices"]
