"""Sharded train state and the train-step wrapper: the port of
``ray_tpu/parallel/train_state.py``.

``create_sharded_state`` initialises parameters straight into their sharded
layout on a device mesh: each rank draws the leaves in the model's order
from the same seeded generator, one at a time, keeps its shard as a DTensor
and drops the rest, so no rank holds the whole tree, and the shards are cut
from the very numbers the single-process ``init_params(config, seed)``
draws. The optimizer state is ``optimizer.init`` of the sharded parameters,
so each moment is sharded like its parameter (ZeRO).

``jit_train_step`` keeps the JAX signature. PyTorch runs eagerly, so there
is nothing to compile: the wrapper only installs ``mesh`` as the ambient mesh
around each call, which is what the context-parallel attention
(``attn_impl="ring"`` or ``"ulysses"``) reads. ``donate_state`` is accepted
and has no effect: the port's step already updates the parameters and the
optimizer state in place (``optim.make_step``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.parallel.mesh import (MeshLike, _is_logical, distribute,
                                         logical_to_placements, make_mesh,
                                         use_mesh)


def _paths(tree, prefix=()) -> List[Tuple]:
    """The leaf paths of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not _is_logical(tree)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (i,))]
    return [prefix]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def create_sharded_state(init_fn: Callable, logical: Any, mesh: MeshLike,
                         seed: int = 0, optimizer=None,
                         rules: Optional[Dict] = None) -> Tuple[Any, Any]:
    """``(params, opt_state)`` with every leaf a DTensor on ``mesh`` placed
    as its logical axes say. ``init_fn(seed, device=, place=)`` is a model's
    ``init_params`` with its config bound; it hands each leaf to ``place``
    as it draws it. A first pass learns which leaf each draw is (a model
    need not draw in its tree's order) and keeps nothing; the second keeps
    each rank's shard. ``opt_state`` is ``optimizer.init(params)``, or None
    without an optimizer."""
    mesh = make_mesh(mesh)
    if mesh.device_mesh is None:
        raise ValueError("create_sharded_state needs a mesh over processes; "
                         "a seq-only mesh folded onto one device is one "
                         "device (use init_params)")
    device = mesh.device_mesh.device_type
    draws = iter(range(1 << 62))
    index = init_fn(seed, device=device, place=lambda _: next(draws))
    by_draw = {_at(index, p): p for p in _paths(index)}
    drawn = iter(range(len(by_draw)))

    def place(t):
        axes = _at(logical, by_draw[next(drawn)])
        if len(axes) != t.ndim:
            raise ValueError(f"logical axes {axes} for a leaf of shape "
                             f"{tuple(t.shape)}")
        return distribute(t, mesh, logical_to_placements(axes, mesh, rules))

    params = init_fn(seed, device=device, place=place)
    return params, None if optimizer is None else optimizer.init(params)


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
