"""Parallelism axes, the ambient mesh and the train-step wrapper: the port
of ``ray_tpu/parallel`` (mesh and train_state so far)."""

from ray_tpu_torch.parallel.mesh import (AXIS_NAMES, Mesh, MeshSpec,
                                         current_mesh, make_mesh, use_mesh)
from ray_tpu_torch.parallel.train_state import jit_train_step

__all__ = ["AXIS_NAMES", "Mesh", "MeshSpec", "current_mesh",
           "jit_train_step", "make_mesh", "use_mesh"]
