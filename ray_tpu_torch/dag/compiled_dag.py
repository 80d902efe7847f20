"""Compiled graphs: lower a DAG onto fixed actors with typed channels (the
counterpart of ``ray_tpu/dag/compiled_dag.py``; ref:
python/ray/dag/compiled_dag_node.py CompiledDAG:711, dag_node_operation.py).

Why compile: interpreted ``execute()`` pays per-call submission (TaskSpec,
mailbox, ref bookkeeping) on every node.  A compiled DAG does that work once:
each participating actor gets a *resident executor loop* (submitted as one
long-running actor task, so the actor's mailbox thread is dedicated to the
DAG, the same exclusivity the reference enforces) and every edge becomes a
pre-built typed channel (dag/channel.py).  Steady-state cost per execute is
pure channel traffic.

Scheduling: every actor executes its nodes in global-topological order each
iteration, which is deadlock-free for any acyclic graph with buffered SPSC
edges.  Error semantics match the reference: an exception in a node is
wrapped, forwarded through downstream channels instead of computed values,
and re-raised at ``CompiledDAGRef.get()``.

The port compiles DAGs over thread actors, whose instances share the
driver's heap: an edge is a ``Channel``, or a ``DeviceChannel`` when its
producer set ``with_tensor_transport``.  A loop runs on its actor's mailbox
thread under the actor's lease, on the card the lease names.  Edges to or
from a process actor need the shared-memory arena's channels and raise
(ROADMAP.md, Queue 1 item 11b-2), as the reference raises when its store
has no arena.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.dag.channel import Channel, ChannelClosed, DeviceChannel
from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

#: How long compilation waits for an actor's asynchronous construction.
_READY_TIMEOUT_S = 120.0


class _DagErr:
    """In-band error marker flowing through channels."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _extract_input(key, payload):
    args, kwargs = payload
    if key is None:
        if kwargs and not args:
            return kwargs
        if len(args) == 1 and not kwargs:
            return args[0]
        return tuple(args)
    if isinstance(key, int):
        return args[key]
    return kwargs[key]


class _ArgSource:
    """How one bound argument of a compiled node gets its value each step."""

    CONST, CHANNEL, INPUT = 0, 1, 2

    def __init__(self, kind, value=None, channel=None, input_key=None):
        self.kind = kind
        self.value = value
        self.channel = channel
        self.input_key = input_key  # None = whole input


class _CompiledOp:
    def __init__(self, node: ClassMethodNode, method_name: str):
        self.node = node
        self.method_name = method_name
        self.arg_sources: List[_ArgSource] = []
        self.kwarg_sources: Dict[str, _ArgSource] = {}
        self.out_channels: List[Channel] = []
        self.reads_input = False

    def input_channel(self) -> Optional[Channel]:
        for s in list(self.arg_sources) + list(self.kwarg_sources.values()):
            if s.kind == _ArgSource.INPUT:
                return s.channel
        return None


def _leased_device():
    """``torch.cuda.device`` of the card the calling actor task's lease
    names, or a null context (no torch loaded, no GPU lease)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return contextlib.nullcontext()
    from ray_tpu_torch._private.device import local_gpu_index
    from ray_tpu_torch._private.runtime import current_task_context

    ctx = current_task_context()
    ids = list(ctx.gpu_ids) if ctx is not None else []
    if not ids:
        return contextlib.nullcontext()
    return torch.cuda.device(local_gpu_index(ids[0]))


def _actor_exec_loop(instance, ops: List[_CompiledOp]) -> None:
    """Resident executor body run as one long actor task (ref:
    compiled_dag_node.py do_exec_tasks), on the actor's card."""
    with _leased_device():
        _exec_ops(instance, ops)


def _exec_ops(instance, ops: List[_CompiledOp]) -> None:
    while True:
        try:
            for op in ops:
                payload = None
                if op.reads_input:
                    payload = op.input_channel().read()
                err: Optional[_DagErr] = None

                def resolve(src: _ArgSource):
                    nonlocal err
                    if src.kind == _ArgSource.CONST:
                        return src.value
                    if src.kind == _ArgSource.INPUT:
                        if isinstance(payload, _DagErr):
                            err = payload
                            return None
                        return _extract_input(src.input_key, payload)
                    v = src.channel.read()
                    if isinstance(v, _DagErr):
                        err = v
                        return None
                    return v

                args = [resolve(s) for s in op.arg_sources]
                kwargs = {k: resolve(s) for k, s in op.kwarg_sources.items()}
                if err is None:
                    try:
                        result = getattr(instance, op.method_name)(*args, **kwargs)
                    except BaseException as e:  # noqa: BLE001 — in-band to get()
                        result = _DagErr(e)
                else:
                    result = err
                for ch in op.out_channels:
                    ch.write(result)
        except ChannelClosed:
            return


class CompiledDAGRef:
    """Future for one compiled execution (ref: compiled_dag_ref.py)."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._consumed = False

    def get(self, timeout: Optional[float] = None):
        if self._consumed:
            raise ValueError("CompiledDAGRef.get() may only be called once")
        value = self._dag._fetch(self._seq, timeout)  # timeout leaves it gettable
        self._consumed = True
        return value

    def __repr__(self):
        return f"CompiledDAGRef(seq={self._seq})"


def _actor_state(runtime, node: ClassMethodNode):
    """The node's actor, constructed: a thread actor's instance exists once
    this returns.  A process actor raises (its edges need the arena)."""
    handle = node._resolve_handle()
    state = runtime.get_actor_state(handle._ray_actor_id)
    if state is None:
        raise ValueError(
            f"actor for {node._method_name!r} not found for compiled DAG")
    spec = state.spec
    if spec.isolation == "process" or spec.runtime_env:
        raise ValueError(
            f"actor for {node._method_name!r} runs in a worker process; "
            "compiled-DAG edges across processes need the shared-memory "
            "channels, which are not ported yet (ROADMAP.md, Queue 1 item "
            "11b-2)")
    # Construction is async: wait it out so the loop binds the instance.
    # Worker threads and __init__ can take long on a loaded box, so the
    # bound is generous and expiry is loud.
    deadline = time.monotonic() + _READY_TIMEOUT_S
    while (state.instance is None and state.state != "DEAD"
           and time.monotonic() < deadline):
        time.sleep(0.002)
    if state.state == "DEAD":
        raise ValueError(
            f"actor for {node._method_name!r} is DEAD "
            f"(cause: {state.death_cause!r}); cannot compile a DAG over it")
    if state.instance is None:
        raise TimeoutError(
            f"actor for {node._method_name!r} not ready within "
            f"{_READY_TIMEOUT_S:.0f}s; cannot compile a DAG over it")
    return handle, state


class CompiledDAG:
    def __init__(self, output_node: DAGNode, max_buffered: int = 16):
        self._output_node = output_node
        self._max_buffered = max_buffered
        # Separate submit/fetch locks: execute() may block on a full input
        # channel, and only get() drains the pipeline — one shared lock would
        # deadlock the driver (submit blocked on write, fetch blocked on the
        # lock).  Matches the reference's split of execute vs result buffer.
        self._submit_lock = threading.Lock()
        self._fetch_lock = threading.Lock()
        self._seq = 0
        self._read_seq = 0
        self._results: Dict[int, Any] = {}
        self._staged: List[List[Any]] = []  # per-output-channel partial reads
        self._input_channels: List[Channel] = []
        self._output_channels: List[Channel] = []
        self._all_channels: List[Channel] = []
        self._loop_refs: List[Any] = []
        #: (instance, loop attribute) of each resident loop, dropped at
        #: teardown so an actor keeps no reference to the DAG's channels.
        self._loop_attrs: List[Tuple[Any, str]] = []
        self._torn_down = False
        self._compile()

    # -- compilation -------------------------------------------------------

    def _compile(self) -> None:
        from ray_tpu_torch._private.ids import TaskID
        from ray_tpu_torch._private.runtime import get_runtime
        from ray_tpu_torch._private.task_spec import TaskSpec

        runtime = get_runtime()
        topo = self._output_node._topo()
        out_node = self._output_node
        leaves = (
            [n for n in out_node._bound_args]
            if isinstance(out_node, MultiOutputNode)
            else [out_node]
        )
        compute_nodes: List[ClassMethodNode] = []
        for n in topo:
            if isinstance(n, FunctionNode):
                raise ValueError(
                    "Compiled graphs only support actor methods "
                    "(fn.bind() tasks run interpreted), as in the reference."
                )
            if isinstance(n, ClassMethodNode):
                compute_nodes.append(n)
        if not compute_nodes:
            raise ValueError("Compiled DAG has no actor-method nodes")
        for leaf in leaves:
            if not isinstance(leaf, ClassMethodNode):
                raise ValueError("Compiled DAG outputs must be actor-method nodes")

        # Every actor constructed (and on the thread tier) before any
        # channel exists: a process actor refuses the whole DAG up front.
        states = {id(n): _actor_state(runtime, n) for n in compute_nodes}

        ops: Dict[int, _CompiledOp] = {}
        for n in compute_nodes:
            ops[id(n)] = _CompiledOp(n, n._method_name)

        def make_channel(producer: Optional[ClassMethodNode]) -> Channel:
            transport = (getattr(producer, "_tensor_transport", None)
                         if producer is not None else None)
            if transport is not None:
                ch = DeviceChannel(device=transport, maxsize=self._max_buffered)
            else:
                ch = Channel(maxsize=self._max_buffered)
            self._all_channels.append(ch)
            return ch

        # Wire args.  Each op gets at most ONE input channel, shared by all
        # its InputNode/InputAttributeNode args (the driver writes the whole
        # (args, kwargs) payload once per op per execute).
        for n in compute_nodes:
            op = ops[id(n)]
            op_input_ch: List[Channel] = []

            def wire(a) -> _ArgSource:
                if isinstance(a, (InputNode, InputAttributeNode)):
                    if not op_input_ch:
                        ch = make_channel(None)
                        self._input_channels.append(ch)
                        op_input_ch.append(ch)
                    key = a._key if isinstance(a, InputAttributeNode) else None
                    return _ArgSource(
                        _ArgSource.INPUT, channel=op_input_ch[0], input_key=key
                    )
                if isinstance(a, ClassMethodNode):
                    ch = make_channel(a)
                    ops[id(a)].out_channels.append(ch)
                    return _ArgSource(_ArgSource.CHANNEL, channel=ch)
                if isinstance(a, DAGNode):
                    raise ValueError(f"Unsupported node type in compiled DAG: {type(a)}")
                return _ArgSource(_ArgSource.CONST, value=a)

            op.arg_sources = [wire(a) for a in n._bound_args]
            op.kwarg_sources = {k: wire(v) for k, v in n._bound_kwargs.items()}
            op.reads_input = any(
                s.kind == _ArgSource.INPUT
                for s in op.arg_sources + list(op.kwarg_sources.values())
            )

        # Driver-facing output channels, one per leaf, in leaf order.
        for leaf in leaves:
            ch = make_channel(leaf)
            ops[id(leaf)].out_channels.append(ch)
            self._output_channels.append(ch)

        self._is_multi_output = isinstance(out_node, MultiOutputNode)
        self._staged = [[] for _ in self._output_channels]

        # Group ops per actor in global topo order and start resident loops.
        per_actor: Dict[Any, Tuple[Any, Any, List[_CompiledOp]]] = {}
        topo_index = {id(n): i for i, n in enumerate(topo)}
        for n in sorted(compute_nodes, key=lambda n: topo_index[id(n)]):
            handle, state = states[id(n)]
            entry = per_actor.setdefault(handle._ray_actor_id,
                                         (handle, state, []))
            entry[2].append(ops[id(n)])

        loop_attr = f"__ray_tpu_dag_loop_{id(self):x}__"
        for actor_id, (handle, state, schedule) in per_actor.items():
            # The runtime dispatches an actor task by attribute, so the
            # resident loop rides the actor's mailbox as one long task.
            setattr(state.instance, loop_attr,
                    functools.partial(_actor_exec_loop, state.instance,
                                      schedule))
            self._loop_attrs.append((state.instance, loop_attr))
            spec = TaskSpec(
                task_id=TaskID.from_random(),
                name=f"{type(state.instance).__name__}.compiled_dag_loop",
                func=None,
                args=(),
                kwargs={},
                num_returns=1,
                resources={},
                max_retries=0,
                actor_id=actor_id,
                method_name=loop_attr,
            )
            self._loop_refs.append(runtime.submit_actor_task(actor_id, spec))

    # -- execution ---------------------------------------------------------

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        with self._submit_lock:
            if self._torn_down:
                raise ValueError("Compiled DAG was torn down")
            # Unconsumed-results cap: past this point the pipeline's buffers
            # are full and an un-drained execute would block forever (ref:
            # compiled_dag_node.py max buffered results guard).
            if self._seq - self._read_seq >= 2 * self._max_buffered:
                raise ValueError(
                    f"{self._seq - self._read_seq} executions in flight and "
                    f"none consumed; call .get() on earlier CompiledDAGRefs "
                    f"(buffer limit {2 * self._max_buffered})"
                )
            payload = (args, kwargs)
            for ch in self._input_channels:
                ch.write(payload)
            seq = self._seq
            self._seq += 1
            return CompiledDAGRef(self, seq)

    def _fetch(self, seq: int, timeout: Optional[float]):
        with self._fetch_lock:
            while seq not in self._results:
                # Stage per-channel reads so a timeout mid-row leaves already
                # read elements buffered, not dropped — otherwise the output
                # channels desync permanently.
                for idx, ch in enumerate(self._output_channels):
                    if len(self._staged[idx]) == 0:
                        self._staged[idx].append(ch.read(timeout=timeout))
                outs = [buf.pop(0) for buf in self._staged]
                value = outs if self._is_multi_output else outs[0]
                self._results[self._read_seq] = value
                self._read_seq += 1
            value = self._results.pop(seq)
        errs = value if isinstance(value, list) else [value]
        for v in errs:
            if isinstance(v, _DagErr):
                raise v.exc
        return value

    def teardown(self) -> None:
        """Close every edge, wait for the resident loops to return (each
        actor's mailbox thread is free again), and release what the edges
        still buffer."""
        with self._fetch_lock:
            if self._torn_down:
                return
            self._torn_down = True
            for ch in self._all_channels:
                ch.close()
        from ray_tpu_torch._private.runtime import runtime_or_none

        runtime = runtime_or_none()
        for ref in self._loop_refs:
            if runtime is None:
                break
            try:
                runtime.get(ref, timeout=5)
            except Exception:  # noqa: BLE001 — a dead actor's loop is gone too
                pass
        for instance, attr in self._loop_attrs:
            try:
                delattr(instance, attr)
            except AttributeError:
                pass
        self._loop_attrs = []
        for ch in self._all_channels:
            if isinstance(ch, DeviceChannel):
                ch.drain()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
