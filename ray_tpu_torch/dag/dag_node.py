"""Lazy DAG-building API (the counterpart of ``ray_tpu/dag/dag_node.py``;
ref: python/ray/dag/dag_node.py:184, input_node.py, function_node.py,
class_node.py).

``fn.bind(x)`` / ``Actor.bind()`` / ``actor.method.bind(x)`` build a DAG of
lazy nodes.  ``node.execute(*args)`` runs it interpreted (each node becomes a
normal task / actor call, diamonds deduped).  ``node.experimental_compile()``
lowers it onto fixed thread actors with typed channels (compiled_dag.py).
Edges into or out of process actors need the reference's shared-memory
channels, which are not ported yet (ROADMAP.md, Queue 1 item 11b-2).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Tuple


class DAGNode:
    """Base lazy node. Child classes define _execute_impl."""

    def __init__(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- traversal ---------------------------------------------------------

    def _upstream(self) -> List["DAGNode"]:
        ups = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                ups.append(a)
        return ups

    def _topo(self) -> List["DAGNode"]:
        """All transitive upstream nodes + self, topologically ordered."""
        order: List[DAGNode] = []
        seen = set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for u in n._upstream():
                visit(u)
            order.append(n)

        visit(self)
        return order

    # -- interpreted execution --------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Run the DAG now; returns ObjectRef(s) (ref: dag_node.py execute)."""
        cache: Dict[int, Any] = {}
        return self._eval(cache, input_args, input_kwargs)

    def _eval(self, cache: Dict[int, Any], input_args, input_kwargs):
        if id(self) in cache:
            return cache[id(self)]
        result = self._execute_impl(cache, input_args, input_kwargs)
        cache[id(self)] = result
        return result

    def _resolve_bound(self, cache, input_args, input_kwargs):
        args = [
            a._eval(cache, input_args, input_kwargs) if isinstance(a, DAGNode) else a
            for a in self._bound_args
        ]
        kwargs = {
            k: (v._eval(cache, input_args, input_kwargs) if isinstance(v, DAGNode) else v)
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    def _execute_impl(self, cache, input_args, input_kwargs):
        raise NotImplementedError

    def experimental_compile(self, **kwargs):
        from ray_tpu_torch.dag.compiled_dag import CompiledDAG

        return CompiledDAG(self, **kwargs)


class InputNode(DAGNode):
    """The DAG's runtime input placeholder (ref: dag/input_node.py).

    Usable as a context manager: ``with InputNode() as inp: ...``.
    ``inp[0]`` / ``inp.key`` yield InputAttributeNodes selecting a positional
    or keyword element of the runtime input.
    """

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def __getattr__(self, name: str) -> "InputAttributeNode":
        if name.startswith("_"):
            raise AttributeError(name)
        return InputAttributeNode(self, name)

    def _execute_impl(self, cache, input_args, input_kwargs):
        if input_kwargs and not input_args:
            return input_kwargs
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        return tuple(input_args)


class InputAttributeNode(DAGNode):
    """inp[i] / inp.name selection (ref: dag/input_node.py InputAttributeNode)."""

    def __init__(self, input_node: InputNode, key):
        super().__init__((input_node,), {})
        self._key = key

    def _execute_impl(self, cache, input_args, input_kwargs):
        if isinstance(self._key, int):
            return input_args[self._key]
        return input_kwargs[self._key]


class FunctionNode(DAGNode):
    """fn.bind(...) (ref: dag/function_node.py). Interpreted-only, as in
    the reference, whose compiled graphs require actor methods."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, cache, input_args, input_kwargs):
        args, kwargs = self._resolve_bound(cache, input_args, input_kwargs)
        return self._remote_fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """Actor.bind(...) — lazy actor creation (ref: dag/class_node.py).

    The instantiated handle is cached on the node, so repeated execute()
    calls and compilation reuse one actor.
    """

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None
        self._handle_lock = threading.Lock()

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return _UnboundMethod(self, name)

    def _get_or_create_handle(self, cache=None, input_args=(), input_kwargs=None):
        with self._handle_lock:
            if self._handle is None:
                cache = cache if cache is not None else {}
                args, kwargs = self._resolve_bound(cache, input_args, input_kwargs or {})
                self._handle = self._actor_cls.remote(*args, **kwargs)
            return self._handle

    def _execute_impl(self, cache, input_args, input_kwargs):
        return self._get_or_create_handle(cache, input_args, input_kwargs)


class _UnboundMethod:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method_name, args, kwargs)


class ClassMethodNode(DAGNode):
    """actor.method.bind(...) (ref: dag/class_node.py ClassMethodNode).

    ``target`` is either a ClassNode (lazy actor) or a live ActorHandle
    (the ActorMethodNode path from actor.py).
    """

    def __init__(self, target, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._target = target
        self._method_name = method_name
        self._tensor_transport = None

    def with_tensor_transport(self, device=None) -> "ClassMethodNode":
        """Mark this node's outputs as device tensors: compiled edges out of
        it become DeviceChannels that place its ``torch.Tensor``s on
        ``device`` at write time (ref: torch_tensor_type.py
        with_tensor_transport, where it selects NCCL).  ``None`` is the
        current CUDA device, and raises without one; pass ``device="cpu"``
        for the host."""
        import torch

        from ray_tpu_torch._private.device import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._tensor_transport = dev
        return self

    def _upstream(self) -> List[DAGNode]:
        ups = super()._upstream()
        if isinstance(self._target, ClassNode):
            ups.append(self._target)
        return ups

    def _resolve_handle(self):
        if isinstance(self._target, ClassNode):
            return self._target._get_or_create_handle()
        return self._target

    def _execute_impl(self, cache, input_args, input_kwargs):
        if isinstance(self._target, ClassNode):
            handle = self._target._eval(cache, input_args, input_kwargs)
        else:
            handle = self._target
        args, kwargs = self._resolve_bound(cache, input_args, input_kwargs)
        return getattr(handle, self._method_name).remote(*args, **kwargs)


def ActorMethodNode(handle, method_name: str, args, kwargs) -> ClassMethodNode:
    """Node for a method bound on a live ActorHandle (actor.py bind())."""
    return ClassMethodNode(handle, method_name, args, kwargs)


class MultiOutputNode(DAGNode):
    """Terminal node returning a list of outputs (ref: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_impl(self, cache, input_args, input_kwargs):
        return [
            o._eval(cache, input_args, input_kwargs) if isinstance(o, DAGNode) else o
            for o in self._bound_args
        ]
