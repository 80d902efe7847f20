"""The train-step wrapper: the port of ``ray_tpu/parallel/train_state.py``.

``jit_train_step`` keeps the JAX signature. PyTorch runs eagerly, so there
is nothing to compile: the wrapper only installs ``mesh`` as the ambient mesh
around each call, which is what the context-parallel attention
(``attn_impl="ring"`` or ``"ulysses"``) reads. ``donate_state`` is accepted
and has no effect: the port's step already updates the parameters and the
optimizer state in place (``models/gpt2.py:make_train_step``).

``create_sharded_state`` is not ported yet: it places parameters on a mesh
of devices, which waits for processes and a device mesh (ROADMAP Queue 1
item 3).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

from ray_tpu_torch.parallel.mesh import MeshLike, make_mesh, use_mesh


def jit_train_step(step_fn: Callable, donate_state: bool = True,
                   mesh: Optional[MeshLike] = None) -> Callable:
    """``step_fn`` itself without a mesh; with one, ``step_fn`` called under
    ``use_mesh(mesh)``. The mesh is validated here, at wrap time."""
    del donate_state
    if mesh is None:
        return step_fn
    mesh = make_mesh(mesh)

    @functools.wraps(step_fn)
    def call(*args, **kwargs):
        with use_mesh(mesh):
            return step_fn(*args, **kwargs)

    return call
