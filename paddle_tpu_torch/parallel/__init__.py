"""Parallel training blocks of the port (mirror of ``paddle_tpu/parallel``):
the named mesh and placement vocabulary (``specs.py``), the collectives
over one mesh axis (``compat.py``), the partitioning schedule with the
shard-major flat-update layout (``schedule.py``), the memory engine
(``memory.py``) and the single-device MoE block with its capacity and
dropless train steps (``expert.py``)."""

from .compat import all_gather, all_to_all, pbroadcast, ppermute, psum, \
    psum_scatter
from .schedule import (TACTICS, FlatUpdateLayout, PartitionSchedule,
                       Tactic, canonical_key, hybrid_leaf_spec,
                       tactics_for_mesh)
from .specs import (EXPERT_AXIS, REPLICATED, Mesh, NamedSharding, P,
                    ShardedTensor, SpecLayout, TensorSpec, activation_spec,
                    axis_dim_picks, batch_entry, batch_partition_spec,
                    expert_leaf_spec, filter_divisible_spec,
                    filter_spec_to_mesh, init_mesh, is_expert_leaf,
                    layout_from_arrays, layout_from_plan, layout_mesh_axes,
                    lead_batch_spec, mesh_axis_sizes, mesh_device_ids,
                    microbatched, pick_batch_axes, spec_to_dim_axes,
                    tensor_spec_from_array, token_batch_spec)

__all__ = ["EXPERT_AXIS", "FlatUpdateLayout", "Mesh", "NamedSharding", "P",
           "PartitionSchedule", "REPLICATED", "ShardedTensor", "SpecLayout",
           "TACTICS", "Tactic", "TensorSpec", "activation_spec",
           "all_gather", "all_to_all", "axis_dim_picks", "batch_entry",
           "batch_partition_spec", "canonical_key", "expert_leaf_spec",
           "filter_divisible_spec", "filter_spec_to_mesh",
           "hybrid_leaf_spec", "init_mesh", "is_expert_leaf",
           "layout_from_arrays", "layout_from_plan", "layout_mesh_axes",
           "lead_batch_spec", "mesh_axis_sizes", "mesh_device_ids",
           "microbatched", "pbroadcast", "pick_batch_axes", "ppermute",
           "psum", "psum_scatter", "spec_to_dim_axes", "tactics_for_mesh",
           "tensor_spec_from_array", "token_batch_spec"]
