"""Backpressured streaming execution for training ingest (the counterpart
of ``ray_tpu/data/ingest/executor.py``).

Two pieces the higher-level ``StreamingIngest`` composes:

* :func:`shard_plans` — split a lazy logical plan into independent
  per-source sub-plans (one per read task / input block) so workers can
  claim and execute sources individually.  Only per-block map chains are
  shardable; a plan with an all-to-all stage (shuffle/sort/groupby/...)
  degrades to a single shard — the whole pipeline is then one claim, still
  streamed with backpressure but not work-stealable.
* :func:`stream_blocks` — pull block refs through the existing
  plan executor (``ray_tpu_torch.data.executor.execute``) with a bounded
  fetch-ahead buffer (reusing :class:`ResourceBudget`'s learned-block-size
  byte cap), materializing each block through :func:`fetch_block`, the
  retrying fault-point-instrumented object-store get.

The stream is pull-based end to end: a slow training step stops new read
tasks at the next cap check, so host memory stays bounded at
``window_bytes`` regardless of dataset size (ref: the reference's
streaming_executor resource budgets + backpressure policies).
"""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.data import executor as ex
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.ingest import metrics as ingest_metrics
from ray_tpu_torch.data.plan import AbstractMap, InputData, LogicalOp, Read
from ray_tpu_torch.exceptions import GetTimeoutError, RayTpuError, WorkerCrashedError
from ray_tpu_torch.util import tracing

#: Bounded retries for a lost/failed block fetch before surfacing the
#: error to the training loop.
FETCH_RETRIES = 3

#: Ceiling on one fetch attempt; a block that hasn't materialized by then
#: is treated as lost (its shard claim rolls back with the attempt).
FETCH_TIMEOUT_S = 60.0


class IngestAborted(RayTpuError):
    """The owning session was stopped while the pipeline was stalled.

    Raised instead of waiting out a full fetch timeout on objects that
    died with a preempted node — elastic teardown must release the
    worker (and its gang-scheduled CPU) promptly so the shrunken attempt
    can reserve its placement group.  The aborted shard's claim stays
    provisional and is requeued by the rollback.
    """


def shardable(op: LogicalOp) -> bool:
    """True when every op past the source is a task-pool per-block map —
    the ops whose semantics are preserved under per-source splitting.
    Actor-pool maps share a stateful pool (one pool per sub-plan would
    multiply actors), and all-to-all ops need the whole stream."""
    chain = op.chain()
    if not isinstance(chain[0], (Read, InputData)):
        return False
    return all(isinstance(o, AbstractMap) and o.compute.kind == "tasks"
               for o in chain[1:])


def shard_plans(op: LogicalOp) -> List[LogicalOp]:
    """Split ``op`` into one sub-plan per source shard (read task / input
    block), each a shallow rewiring of the downstream map chain.  Falls
    back to ``[op]`` when the plan is not shardable."""
    if not shardable(op):
        return [op]
    chain = op.chain()
    root, rest = chain[0], chain[1:]
    if isinstance(root, Read):
        sources: List[LogicalOp] = [Read([t], schema_hint=root.schema_hint)
                                    for t in root.read_tasks]
    else:
        sources = [InputData([b]) for b in root.blocks]
    return [_rewire(src, rest) for src in sources]


def _rewire(source: LogicalOp, rest: Iterable[LogicalOp]) -> LogicalOp:
    cur = source
    for o in rest:
        clone = copy.copy(o)
        clone.input_op = cur
        cur = clone
    return cur


def plan_locality(plan: LogicalOp) -> Optional[str]:
    """Object-plane address where a shard sub-plan's input objects live,
    for locality-aware claiming: ``""`` means the reading node itself,
    an address string names the remote node holding the copies, ``None``
    means no locality information (``Read`` roots — the data is not an
    object yet — or raw in-memory blocks, or mixed placements).

    Spill-aware: a locally-spilled object still classifies as local
    (``_remote_owner_addr`` consults the authoritative location table,
    not residency) — restoring from this node's spill files is cheaper
    than any network fetch, so spilled shards must not lose their
    locality preference."""
    root = plan.chain()[0]
    if not isinstance(root, InputData):
        return None
    try:
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
    except Exception:  # noqa: BLE001 — no runtime, no locality
        return None
    addrs = set()
    for b in root.blocks:
        if getattr(b, "id", None) is None:
            return None  # raw in-memory block: no placement to honor
        try:
            addrs.add(rt._remote_owner_addr(b))
        except Exception:  # noqa: BLE001
            return None
    return addrs.pop() if len(addrs) == 1 else None


def block_source(ref) -> str:
    """Where a block ref's bytes come from at fetch time: ``local``
    (this node's store), ``spilled`` (local store, restored from this
    node's spill files — still no network), or ``remote``."""
    oid = getattr(ref, "id", None)
    if oid is None:
        return "local"
    try:
        from ray_tpu_torch._private.runtime import get_runtime

        rt = get_runtime()
        if rt._remote_owner_addr(ref):
            return "remote"
        if rt.store.state_of(oid) == "SPILLED":
            return "spilled"
    except Exception:  # noqa: BLE001 — classification is best-effort
        pass
    return "local"


@ray_tpu_torch.remote(num_cpus=0)
def _fused_shard_task(read_task, transforms):
    block = read_task()
    for t in transforms:
        block = t(block)
    return block


@ray_tpu_torch.remote(num_cpus=0)
def _fused_block_task(block, transforms):
    for t in transforms:
        block = t(block)
    return block


def _exec_subplan(plan: LogicalOp) -> Iterator[Any]:
    """Yield block refs for one shard sub-plan.

    A shardable sub-plan (single source + task-map chain) fuses into ONE
    zero-CPU task: read + every map transform in a single hop.  Zero CPU
    is load-bearing, not an optimization — training gang-reserves whole
    cores via its placement group, and on a cluster with no spare cores a
    1-CPU read task would deadlock the input pipeline against the very
    workers waiting on it.  The I/O-bound data plane rides along instead
    of competing.  Non-shardable fallbacks (all-to-all stages) keep the
    general executor and its resource accounting.
    """
    chain = plan.chain()
    root = chain[0]
    if all(isinstance(o, AbstractMap) and o.compute.kind == "tasks"
           for o in chain[1:]):
        transforms = [ex.make_block_transform(o) for o in chain[1:]]
        if isinstance(root, Read) and len(root.read_tasks) == 1:
            yield _fused_shard_task.remote(root.read_tasks[0], transforms)
            return
        if isinstance(root, InputData) and len(root.blocks) == 1:
            yield _fused_block_task.remote(root.blocks[0], transforms)
            return
    yield from ex.execute(plan)


def _get_abortable(ref, should_stop: Optional[Callable[[], bool]]):
    """ray_tpu_torch.get that aborts a STALLED fetch once the session stops.

    Healthy fetches never observe the stop — the check only runs after a
    poll times out, so a graceful grow stop still drains in-flight
    claimed shards cleanly."""
    deadline = time.monotonic() + FETCH_TIMEOUT_S
    while True:
        remaining = deadline - time.monotonic()
        try:
            return ray_tpu_torch.get(ref, timeout=min(2.0, max(0.05, remaining)))
        except GetTimeoutError:
            if should_stop is not None and should_stop():
                raise IngestAborted(
                    "session stopped while a block fetch was stalled "
                    "(object likely lost with a preempted node)")
            if remaining <= 0:
                raise


def fetch_block(ref, retries: int = FETCH_RETRIES,
                should_stop: Optional[Callable[[], bool]] = None):
    """Materialize a block ref with bounded retries.

    The ``data_ingest_fetch`` fault point models the fetch failing
    transiently (the producing task's node died and the object must be
    reconstructed, or chaos injected it); training never observes the
    failure unless every retry burns — a torn batch is impossible because
    nothing is yielded until the whole block materialized."""
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        source = block_source(ref)  # classify BEFORE the get pulls it local
        try:
            fault_injection.check("data_ingest_fetch")
            block = _get_abortable(ref, should_stop)
        except IngestAborted:
            raise
        except WorkerCrashedError as e:
            last = e
            ingest_metrics.FETCH_RETRIES.inc()
            continue
        acc = BlockAccessor(block)
        ingest_metrics.ROWS.inc(acc.num_rows())  # inc(0) is a no-op
        try:
            nbytes = acc.size_bytes()
            ingest_metrics.BYTES.inc(nbytes)
            # Locality accounting: cross-node bytes are what the
            # locality-aware claimer minimizes; a local spill restore
            # counts as local traffic (and is tallied as a spill refetch).
            if source == "remote":
                ingest_metrics.CROSS_NODE_BYTES.inc(nbytes)
            else:
                ingest_metrics.LOCAL_BYTES.inc(nbytes)
                if source == "spilled":
                    ingest_metrics.SPILL_REFETCHES.inc()
        except Exception:
            pass
        return block
    raise last  # type: ignore[misc]


def stream_blocks(plans: Iterator[Tuple[Any, LogicalOp]],
                  budget: Optional[ex.ResourceBudget] = None,
                  on_shard_end: Optional[Callable[[Any, int], None]] = None,
                  should_stop: Optional[Callable[[], bool]] = None,
                  ) -> Iterator[Tuple[Any, Any]]:
    """Yield ``(shard_key, block)`` across a lazy sequence of sub-plans.

    ``plans`` is pulled lazily — advancing it is what claims the next
    source shard, so claim order tracks consumption, not construction.
    Up to ``budget.cap()`` produced-but-unfetched block refs are buffered
    ahead (the byte-aware cap tightens as block sizes are learned);
    ``on_shard_end(key, n_blocks)`` fires once a shard's last block has
    been *yielded* downstream.  One retroactive ``data.ingest`` span per
    shard covers first-pull -> last-block-yield.
    """
    if budget is None:
        budget = ex.ResourceBudget()
    refs: deque = deque()  # fetched-ahead (key, ref)
    outstanding: dict = {}  # key -> blocks yielded to go (count in refs)
    totals: dict = {}  # key -> blocks produced so far (monotonic)
    produced: dict = {}  # key -> total blocks produced (shard done)
    started: dict = {}  # key -> first-pull timestamp (span start)
    gen: Optional[Iterator[Any]] = None
    cur_key: Any = None
    exhausted = False

    def _shard_done(key) -> None:
        n = produced.pop(key)
        totals.pop(key, None)
        outstanding.pop(key, None)
        ingest_metrics.SHARDS.inc()
        t0 = started.pop(key, None)
        if t0 is not None:
            tracing.record_span("data.ingest", t0, time.time(),
                                attributes={"shard": key, "blocks": n})
        if on_shard_end is not None:
            on_shard_end(key, n)

    while True:
        while not exhausted and len(refs) < budget.cap():
            if gen is None:
                try:
                    cur_key, plan = next(plans)
                except StopIteration:
                    exhausted = True
                    break
                started[cur_key] = time.time()
                outstanding[cur_key] = 0
                gen = _exec_subplan(plan)
            try:
                ref = next(gen)
            except StopIteration:
                # Record the shard's full block count, not the in-flight
                # depth — blocks already yielded downstream decremented
                # ``outstanding``, so it undercounts whenever the shard
                # outlasts the fetch-ahead window.
                produced[cur_key] = totals.get(cur_key, 0)
                if outstanding.get(cur_key, 0) == 0:
                    _shard_done(cur_key)  # all blocks already yielded
                gen = None
                continue
            budget.observe_ref(ref)
            totals[cur_key] = totals.get(cur_key, 0) + 1
            outstanding[cur_key] = outstanding.get(cur_key, 0) + 1
            refs.append((cur_key, ref))
        if not refs:
            if exhausted:
                return
            continue
        key, ref = refs.popleft()
        yield key, fetch_block(ref, should_stop=should_stop)
        outstanding[key] -= 1
        if outstanding[key] == 0 and key in produced:
            _shard_done(key)
