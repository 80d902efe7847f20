"""Parallelism axes, the device mesh, the pipeline schedule, sharded train
state and the train-step wrapper: the port of ``ray_tpu/parallel``."""

from ray_tpu_torch.parallel.mesh import (AXIS_NAMES, DEFAULT_RULES, Mesh,
                                         MeshSpec, NamedSharding,
                                         PartitionSpec, batch_sharding,
                                         current_mesh, logical_to_placements,
                                         logical_to_spec, make_mesh,
                                         named_sharding, partition,
                                         pytree_sharding, shard_pytree,
                                         use_mesh)
from ray_tpu_torch.parallel.pipeline import PIPE_AXIS, pipeline_apply
from ray_tpu_torch.parallel.train_state import (create_sharded_state,
                                                jit_train_step)

__all__ = ["AXIS_NAMES", "DEFAULT_RULES", "Mesh", "MeshSpec",
           "NamedSharding", "PIPE_AXIS", "PartitionSpec", "batch_sharding",
           "create_sharded_state", "current_mesh", "jit_train_step",
           "logical_to_placements", "logical_to_spec", "make_mesh",
           "named_sharding", "partition", "pipeline_apply", "pytree_sharding",
           "shard_pytree", "use_mesh"]
