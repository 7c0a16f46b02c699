"""Distributed helpers of the port (mirror of ``paddle_tpu/distributed``):
the hybrid topology and the slice topology (``topology.py``), the comm
watchdog (``watchdog.py``), the elastic restart policy
(``fleet/elastic.py``), the store rendezvous helpers (``store.py``), the
checkpoints (``checkpoint/``), the training health guardian
(``health.py``) and the resilient train loop (``resilience.py``)."""

from .topology import (AxisGroup, CommunicateTopology, HierAxis,
                       HybridCommunicateGroup, axis_slice_map,
                       device_slice_index, hierarchical_axis,
                       mesh_spans_slices)

__all__ = ["AxisGroup", "CommunicateTopology", "HierAxis",
           "HybridCommunicateGroup", "axis_slice_map", "device_slice_index",
           "hierarchical_axis", "mesh_spans_slices"]
