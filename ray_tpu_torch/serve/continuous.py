"""Iteration-level continuous batching — ``@serve.continuous_batch`` (the
counterpart of ``ray_tpu/serve/continuous.py``).

Orca-style (Yu et al., OSDI '22) scheduling for streaming token
generation: instead of interleaving whole per-request generator calls, N
concurrent streams share forward passes.  The replica runs one generation
loop per decorated method; each loop *iteration* steps every in-flight
sequence once, new streaming requests are admitted into the batch at
iteration boundaries, and finished sequences retire without stalling the
rest.

The decorated function is the **iteration step**, not a generator.  It is
called with a list of :class:`SequenceSlot` (one per in-flight stream) and
must return a list of the same length — the per-sequence emission for this
iteration:

- any value       -> emitted as the next item on that stream
- ``None``        -> no emission this iteration (e.g. chunked prefill)
- ``serve.EOS``   -> the sequence is finished; its stream ends
- ``Emissions``   -> several items emitted in one iteration (speculative
                     decoding banks k+1 tokens per verify pass; draining
                     them one iteration apiece would re-serialize the win
                     behind every other stream's device burn), optionally
                     ending the stream in the same step (``eos=True``)
- an ``Exception``-> that stream errors; the others continue (per-request
                     error isolation)

Callers invoke the decorated method with a single request argument and get
back an async iterator of emitted items — so a continuous-batched
``__call__`` is a streaming ingress like any generator endpoint, and the
HTTP proxy and ``handle.options(stream=True)`` work unchanged.

Requires thread-tier (async) replicas: the engine loop lives on the
replica's event loop (the process tier is not ported yet).
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.serve._sync import run_in_executor
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing as _tracing

INFLIGHT_SEQUENCES_GAUGE = _metrics.Gauge(
    "serve_continuous_inflight_sequences",
    "In-flight sequences in the continuous-batching loop",
    tag_keys=("deployment", "method"))


class _EOSType:
    """Sentinel a step returns to retire a finished sequence."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "serve.EOS"

    def __reduce__(self):  # pickles to the same singleton
        return (_EOSType, ())


EOS = _EOSType()


class Emissions:
    """Multi-item emission for one sequence in one iteration.

    A step that produced several tokens for a stream (speculative decoding
    accepts up to k+1 per verify pass) returns ``Emissions(tokens)`` and
    every token lands on the stream THIS iteration — consumers see them
    back-to-back instead of one per device burn.  ``eos=True`` retires the
    sequence right after the last item (no extra drain iteration)."""

    __slots__ = ("items", "eos")

    def __init__(self, items: List[Any], eos: bool = False):
        self.items = items
        self.eos = eos

    def __repr__(self) -> str:
        return f"serve.Emissions({len(self.items)} items, eos={self.eos})"


class SequenceSlot:
    """One in-flight sequence in the generation loop.

    ``request`` is the caller's argument (e.g. the HTTP Request or prompt);
    ``state`` is a scratch dict the step function owns (KV cache handle,
    tokens-emitted counter, ...).  The engine never touches ``state``.
    """

    __slots__ = ("request", "state", "_out", "_live", "_cancelled",
                 "_enq_t", "_trace_ctx", "_started")

    def __init__(self, request: Any):
        self.request = request
        self.state: Dict[str, Any] = {}
        self._out: asyncio.Queue = asyncio.Queue()
        self._live = True
        self._cancelled = False
        #: admit-wait attribution: set at submit, consumed when the slot is
        #: first stepped (queue-wait span + histogram).
        self._enq_t = time.time()
        self._trace_ctx = _tracing.current_context()
        self._started = False

    def __repr__(self) -> str:
        return f"SequenceSlot({self.request!r}, live={self._live})"


class _Engine:
    """One generation loop: admit -> step -> route -> retire.

    (ref: Orca's iteration-level scheduler; the reference's analogue is
    serve/batching.py's streaming _BatchQueue, which cannot admit
    mid-flight — admission here happens every iteration boundary.)
    """

    def __init__(self, step_func: Callable, self_arg: Any,
                 cfg: Dict[str, Any]):
        self._step = step_func
        self._self_arg = self_arg
        self._cfg = cfg
        from ray_tpu_torch.serve.batching import _deployment_tag

        self._tags = {"deployment": _deployment_tag(),
                      "method": getattr(step_func, "__name__", "step")}
        self._admit: asyncio.Queue = asyncio.Queue()
        self._loop = asyncio.get_running_loop()
        # detached_ok: iteration loop lives until the replica's event loop dies
        self._task = self._loop.create_task(self._run())

    def submit(self, request: Any) -> SequenceSlot:
        slot = SequenceSlot(request)
        self._admit.put_nowait(slot)
        return slot

    def _record_admitted(self, steppable: List[SequenceSlot]) -> None:
        """Admit-wait per sequence: submit -> first step inclusion."""
        from ray_tpu_torch.serve import metrics as serve_metrics

        now = time.time()
        for slot in steppable:
            if slot._started:
                continue
            slot._started = True
            serve_metrics.QUEUE_WAIT.observe(
                now - slot._enq_t, tags=self._tags,
                exemplar=serve_metrics.trace_exemplar(slot._trace_ctx))
            if slot._trace_ctx is not None:
                _tracing.record_span("serve.queue_wait", slot._enq_t, now,
                                     parent=slot._trace_ctx,
                                     attributes=dict(self._tags))

    def _record_step(self, step_start: float, batch_size: int) -> None:
        from ray_tpu_torch.serve import metrics as serve_metrics

        serve_metrics.EXECUTION.observe(
            time.time() - step_start, tags=self._tags,
            exemplar=None)

    # ------------------------------------------------------------ the loop
    @staticmethod
    def _retire(slot: SequenceSlot, kind: str, value: Any) -> None:
        slot._live = False
        slot._out.put_nowait((kind, value))

    async def _run(self) -> None:
        slots: List[SequenceSlot] = []
        max_batch = lambda: int(self._cfg["max_batch_size"])  # noqa: E731
        max_buf = lambda: int(self._cfg["max_buffered_per_stream"])  # noqa: E731
        while True:
            # --- admission, at the iteration boundary only
            if not slots:
                # Idle: park until a request arrives (no spin).
                slots.append(await self._admit.get())
            while len(slots) < max_batch() and not self._admit.empty():
                slots.append(self._admit.get_nowait())
            # Drop sequences whose consumer vanished (client disconnect
            # cancels the wrapper generator, which flags the slot).
            slots = [s for s in slots if not s._cancelled]
            INFLIGHT_SEQUENCES_GAUGE.set(len(slots), tags=self._tags)
            if not slots:
                continue
            # --- per-stream backpressure: a consumer that stopped pulling
            # must not buffer unboundedly; its sequence pauses (it is not
            # stepped) until the client drains or disconnects.
            steppable = [s for s in slots if s._out.qsize() < max_buf()]
            if not steppable:
                await asyncio.sleep(0.005)
                continue
            # --- one shared forward pass for every steppable sequence
            self._record_admitted(steppable)
            args = ((steppable,) if self._self_arg is None
                    else (self._self_arg, steppable))
            step_start = time.time()
            try:
                if inspect.iscoroutinefunction(self._step):
                    outs = await self._step(*args)
                else:
                    # Sync steps (the forward pass on the GPU) run on a
                    # worker thread; the loop keeps admitting and serving
                    # pulls.
                    outs = await run_in_executor(self._step, *args)
                self._record_step(step_start, len(steppable))
                if not isinstance(outs, (list, tuple)) \
                        or len(outs) != len(steppable):
                    got = (f"length {len(outs)}"
                           if isinstance(outs, (list, tuple))
                           else type(outs).__name__)
                    raise TypeError(
                        f"@serve.continuous_batch step "
                        f"{self._tags['method']!r} must return a list with "
                        f"one emission per slot (expected "
                        f"{len(steppable)}, got {got})")
            except Exception as e:  # noqa: BLE001 — whole-step failure
                for slot in steppable:
                    self._retire(slot, "err", e)
                slots = [s for s in slots if s._live]
                continue
            # --- route emissions and retire finished sequences
            for slot, out in zip(steppable, outs):
                if slot._cancelled:
                    slot._live = False
                elif out is EOS:
                    self._retire(slot, "done", None)
                elif isinstance(out, Emissions):
                    for v in out.items:
                        slot._out.put_nowait(("item", v))
                    if out.eos:
                        self._retire(slot, "done", None)
                elif isinstance(out, Exception):
                    self._retire(slot, "err", out)
                elif out is not None:
                    slot._out.put_nowait(("item", out))
            slots = [s for s in slots if s._live]


def continuous_batch(_func: Optional[Callable] = None, *,
                     max_batch_size: int = 8,
                     max_buffered_per_stream: int = 256):
    """``@serve.continuous_batch`` — turn an iteration step into a
    continuously-batched streaming endpoint (see module doc).

    Args:
        max_batch_size: max concurrent sequences per loop iteration;
            additional streams wait for a retirement.
        max_buffered_per_stream: per-stream emission buffer bound — a slow
            consumer's sequence pauses instead of buffering unboundedly.
    """

    def decorate(step_func: Callable):
        if inspect.isgeneratorfunction(step_func) \
                or inspect.isasyncgenfunction(step_func):
            raise TypeError(
                "@serve.continuous_batch wraps an iteration STEP function "
                "(slots -> emissions), not a generator; yield per-iteration "
                "values by returning them from the step")
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        cfg: Dict[str, Any] = {
            "max_batch_size": int(max_batch_size),
            "max_buffered_per_stream": int(max_buffered_per_stream),
        }
        engines: Dict[Any, _Engine] = {}

        @functools.wraps(step_func)
        async def wrapped(*args, **kwargs):
            from ray_tpu_torch.serve.batching import _split_call_args

            self_arg, request = _split_call_args(args, kwargs,
                                                 step_func.__name__)
            loop = asyncio.get_running_loop()
            eng = engines.get(id(self_arg))
            if eng is None or eng._loop is not loop or eng._task.done():
                eng = engines[id(self_arg)] = _Engine(step_func, self_arg,
                                                      cfg)
            slot = eng.submit(request)
            try:
                while True:
                    kind, value = await slot._out.get()
                    if kind == "done":
                        return
                    if kind == "err":
                        raise value
                    yield value
            finally:
                # Consumer went away (client disconnect -> aclose(), or
                # natural end): flag the slot so the engine retires it at
                # the next iteration boundary instead of stepping a
                # sequence nobody is reading.
                slot._cancelled = True

        wrapped._continuous_config = cfg
        wrapped._continuous_engines = engines  # introspection / tests
        return wrapped

    if _func is not None:
        return decorate(_func)
    return decorate
