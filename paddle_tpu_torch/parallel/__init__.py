"""Parallel training blocks of the port (mirror of ``paddle_tpu/parallel``):
the named mesh and placement vocabulary (``specs.py``), the collectives
over one mesh axis (``compat.py``), the partitioning schedule with the
shard-major flat-update layout, the stack schedule and the joint tuner
(``schedule.py``), the communication-overlap engine (``overlap.py``), the
inter-slice collective codec (``codec.py``), the memory engine
(``memory.py``), expert parallelism (``expert.py``), ring attention
(``ring_attention.py``) and Ulysses ``sep`` attention (``sep.py``) over a
sequence cut across ranks, and the pipeline schedules and executors
(``schedules.py``, ``pipelining.py``)."""

from .codec import CollectiveCodec
from .compat import all_gather, all_to_all, pbroadcast, ppermute, psum, \
    psum_scatter
from .memory import (JointConfig, MemoryConfig, joint_memory_codec_lattice,
                     tune_memory_config)
from .overlap import OverlapConfig
from .pipelining import pipeline_apply, pipeline_train_step
from .ring_attention import ring_flash_attention
from .schedule import (TACTICS, FlatUpdateLayout, JointScheduleConfig,
                       PartitionPoint, PartitionSchedule, StackSchedule,
                       Tactic, canonical_key, choose_joint_config,
                       hybrid_leaf_spec, joint_schedule_lattice,
                       tactics_for_mesh, tune_schedule_config)
from .specs import (EXPERT_AXIS, REPLICATED, Mesh, NamedSharding, P,
                    ShardedTensor, SpecLayout, TensorSpec, activation_spec,
                    axis_dim_picks, batch_entry, batch_partition_spec,
                    expert_leaf_spec, filter_divisible_spec,
                    filter_spec_to_mesh, init_mesh, is_expert_leaf,
                    layout_from_arrays, layout_from_plan, layout_mesh_axes,
                    lead_batch_spec, mesh_axis_sizes, mesh_device_ids,
                    microbatched, pick_batch_axes, spec_to_dim_axes,
                    tensor_spec_from_array, token_batch_spec)
from .sep import ulysses_attention

__all__ = ["CollectiveCodec", "EXPERT_AXIS", "FlatUpdateLayout",
           "JointConfig", "JointScheduleConfig", "MemoryConfig", "Mesh",
           "NamedSharding", "OverlapConfig", "joint_memory_codec_lattice",
           "tune_memory_config",
           "P", "PartitionPoint", "PartitionSchedule", "REPLICATED",
           "ShardedTensor", "SpecLayout", "StackSchedule", "TACTICS",
           "Tactic", "TensorSpec", "activation_spec", "choose_joint_config",
           "joint_schedule_lattice", "tune_schedule_config",
           "all_gather", "all_to_all", "axis_dim_picks", "batch_entry",
           "batch_partition_spec", "canonical_key", "expert_leaf_spec",
           "filter_divisible_spec", "filter_spec_to_mesh",
           "hybrid_leaf_spec", "init_mesh", "is_expert_leaf",
           "layout_from_arrays", "layout_from_plan", "layout_mesh_axes",
           "lead_batch_spec", "mesh_axis_sizes", "mesh_device_ids",
           "microbatched", "pbroadcast", "pick_batch_axes",
           "pipeline_apply", "pipeline_train_step", "ppermute", "psum",
           "psum_scatter", "ring_flash_attention", "spec_to_dim_axes",
           "tactics_for_mesh", "tensor_spec_from_array", "token_batch_spec",
           "ulysses_attention"]
