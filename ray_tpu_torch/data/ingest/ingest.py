"""StreamingIngest: the Trainer's streaming input path (the counterpart of
``ray_tpu/data/ingest/ingest.py``).

One ``StreamingIngest`` per named dataset lives on the controller (thread
tier, like the elastic ``SampleLedger`` it builds on) and outlives
individual attempts.  Per epoch it derives a seeded permutation of the
plan's source shards (shard-level shuffle) and a ``SampleLedger`` *over
shard indices*: workers claim shards one at a time through their
:class:`IngestShard` view and stream each claimed shard through

    backpressured executor -> windowed shuffle -> rebatch -> host
    prefetch [-> device double-buffer]

so an epoch is never materialized and host memory stays bounded by the
window budget (the reference's docs/data-ingestion.md).

Exactly-once under elastic shrink/grow works exactly like the sized-
dataset ledger, at shard granularity: a claim is provisional (tagged
``PROVISIONAL_STEP``) until the worker has pulled the shard's last block
out of its shuffle window — then it is retagged with the session's
current checkpoint step and seals when a checkpoint at/past that step
commits.  A preemption rolls incomplete shards back into the queue for
survivors; claiming IS the resplit, so a grow at an epoch boundary
distributes the next epoch over the new world with no repartition step.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

from ray_tpu_torch.data import executor as ex
from ray_tpu_torch.data.ingest import executor as ingest_ex
from ray_tpu_torch.data.ingest import metrics as ingest_metrics
from ray_tpu_torch.data.ingest.prefetch import DeviceBatchIterator, HostPrefetcher
from ray_tpu_torch.data.ingest.shuffle import epoch_rng, window_shuffle
from ray_tpu_torch.train.elastic import PROVISIONAL_STEP, SampleLedger
from ray_tpu_torch.util import tracing

#: Live StreamingIngest instances (weak — an abandoned ingest must not be
#: kept alive by the registry).  The cluster autoscaler's signal collector
#: probes :func:`pending_shards` through sys.modules, so a cluster that
#: never ingests never imports this module.
_LIVE_INGESTS: "weakref.WeakSet[StreamingIngest]" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def pending_shards() -> int:
    """Unclaimed source shards summed across every live ingest's epochs —
    the autoscaler's train-pressure signal (also exported as the
    ``ray_tpu_data_ingest_pending_shards`` gauge)."""
    with _LIVE_LOCK:
        ingests = list(_LIVE_INGESTS)
    total = sum(st.ledger.remaining()
                for ing in ingests for st in ing._states())
    ingest_metrics.PENDING_SHARDS.set(total)
    return total


class _GaugeCounter:
    """Tiny thread-safe resident-bytes counter feeding a gauge + peak."""

    def __init__(self, gauge):
        self._gauge = gauge
        self._lock = threading.Lock()
        self._value = 0  # guarded_by: _lock
        self._peak = 0  # guarded_by: _lock

    def add(self, delta: int) -> None:
        with self._lock:
            self._value += delta
            if self._value > self._peak:
                self._peak = self._value
            value = self._value
        self._gauge.set(value)

    def value(self) -> int:
        with self._lock:
            return self._value

    def peak(self) -> int:
        with self._lock:
            return self._peak


class _ResidentBytes:
    """One epoch's share of the shared window counter, releasable.

    Adds flow through to the gauge; ``release()`` atomically zeroes the
    epoch's balance and returns it to the gauge, so an epoch abandoned
    mid-stream (elastic stop, IngestAborted, a consumer breaking out of
    ``iter_batches``) cannot leave its resident blocks counted in
    WINDOW_BYTES/peak_window_bytes forever.  Called from both the
    pipeline's thread (the prefetch pump's teardown) and the consumer
    thread (``_iter_epoch``'s finally) — whichever side runs last
    releases what the other missed; double release is a no-op.
    """

    def __init__(self, window: _GaugeCounter):
        self._window = window
        self._lock = threading.Lock()
        self._bytes = 0  # guarded_by: _lock

    def add(self, n: int) -> None:
        with self._lock:
            self._bytes += n
        self._window.add(n)

    def release(self) -> None:
        with self._lock:
            n, self._bytes = self._bytes, 0
        if n:
            self._window.add(-n)


class _EpochState:
    """Shared per-epoch claim state: shard permutation + shard ledger."""

    def __init__(self, n_shards: int, rng, seal_on_claim: bool):
        order = list(range(n_shards))
        rng.shuffle(order)
        #: claim position -> plan index (the shard-level shuffle)
        self.order = order
        self.ledger = SampleLedger(order, seal_on_claim=seal_on_claim)


class _ShardTracker:
    """Per-worker completion tracking: a claimed shard is 'consumed' when
    the batch holding its LAST row is yielded to the training loop — at
    that moment the claim is retagged from PROVISIONAL_STEP to the
    session's current checkpoint step (or sealed outright without a
    session/coordinator).  The timing is load-bearing: at yield time
    ``current_checkpoint_step()`` is the step the consumer's next report
    gets, i.e. the first checkpoint whose state contains those rows — tag
    earlier and a restore to a committed step could seal rows it never
    trained (silent loss); tag later and a fully-consumed shard would
    requeue on a grow (double-train).  Rows yielded but never followed by
    a report stay provisional and requeue — the safe direction.

    Threading: with prefetch on (the default) ``entered()`` and
    ``shard_produced()`` run on the pump thread while ``block_done()``
    runs on the consumer thread — the shuffle window can emit a shard's
    early blocks for consumption while its later blocks are still
    entering — so the counters are lock-guarded and the consumed
    transition is decided under the lock (exactly one side observes it).
    """

    def __init__(self, ledger: SampleLedger, session=None):
        self._ledger = ledger
        self._session = session
        self._lock = threading.Lock()
        #: pos -> blocks in flight past entry, not yet consumed
        self._blocks: Dict[int, int] = {}  # guarded_by: _lock
        #: pos -> total blocks, once the shard fully produced
        self._produced: Dict[int, int] = {}  # guarded_by: _lock

    def entered(self, pos: int) -> None:
        with self._lock:
            self._blocks[pos] = self._blocks.get(pos, 0) + 1

    def shard_produced(self, pos: int, n_blocks: int) -> None:
        with self._lock:
            self._produced[pos] = n_blocks
            consumed = self._consumed_locked(pos)
        if consumed:
            self._retag(pos)

    def block_done(self, pos: int) -> None:
        with self._lock:
            self._blocks[pos] -= 1
            consumed = self._consumed_locked(pos)
        if consumed:
            self._retag(pos)

    def _consumed_locked(self, pos: int) -> bool:
        if self._blocks.get(pos, 0) != 0 or pos not in self._produced:
            return False
        self._blocks.pop(pos, None)
        del self._produced[pos]
        return True

    def _retag(self, pos: int) -> None:
        step = (self._session.current_checkpoint_step()
                if self._session is not None else None)
        self._ledger.retag((pos,), step)


def _rebatch_tracked(stream, batch_size: Optional[int], batch_format: str):
    """``ray_tpu_torch.data.block.rebatch`` with row provenance: yields
    ``(done, batch)`` where ``done`` lists shard positions whose every row
    is contained in batches yielded so far (this one included).  The
    trailing flush can yield ``(done, None)`` when positions finish with
    no rows left to batch (empty blocks at stream end)."""
    from ray_tpu_torch.data.block import BlockAccessor, concat_blocks

    carry: List[Any] = []
    carry_rows = 0
    fifo: deque = deque()  # (pos, rows still unemitted) in row order
    done: List[int] = []

    def emit(n: int) -> tuple:
        while n:
            pos, rows = fifo[0]
            take = min(rows, n)
            rows -= take
            n -= take
            if rows == 0:
                fifo.popleft()
                done.append(pos)
            else:
                fifo[0] = (pos, rows)
        out = tuple(done)
        done.clear()
        return out

    for pos, block in stream:
        nrows = block.num_rows
        if nrows == 0:
            done.append(pos)
            continue
        fifo.append((pos, nrows))
        if batch_size is None:
            yield emit(nrows), BlockAccessor(block).to_batch(batch_format)
            continue
        carry.append(block)
        carry_rows += nrows
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            acc = BlockAccessor(merged)
            yield (emit(batch_size),
                   BlockAccessor(acc.slice(0, batch_size))
                   .to_batch(batch_format))
            rest = acc.slice(batch_size, acc.num_rows())
            carry = [rest] if rest.num_rows > 0 else []
            carry_rows = acc.num_rows() - batch_size
    if carry_rows:
        yield (emit(carry_rows),
               BlockAccessor(concat_blocks(carry)).to_batch(batch_format))
    if done:
        yield tuple(done), None


class StreamingIngest:
    """Controller-side streaming input for one named dataset."""

    def __init__(self, dataset, *, window_blocks: int = 16,
                 window_bytes: int = 128 << 20,
                 seed: Optional[int] = None,
                 prefetch_batches: int = 2,
                 seal_on_claim: bool = True):
        self._plans = ingest_ex.shard_plans(dataset._op)
        self._window_blocks = max(1, window_blocks)
        self._window_bytes = max(1 << 20, window_bytes)
        self._seed = seed
        self._prefetch_batches = max(0, prefetch_batches)
        self._seal_on_claim = seal_on_claim
        self._lock = threading.Lock()
        self._epochs: Dict[int, _EpochState] = {}  # guarded_by: _lock
        self._window = _GaugeCounter(ingest_metrics.WINDOW_BYTES)
        #: plan index -> object locality ("" local / addr / None unknown),
        #: computed once — input placements don't move under the epoch.
        self._localities: Optional[List[Optional[str]]] = None
        with _LIVE_LOCK:
            _LIVE_INGESTS.add(self)

    # ------------------------------------------------------------- shape
    def num_shards(self) -> int:
        return len(self._plans)

    def _plan_localities(self) -> List[Optional[str]]:
        """Per-plan object locality, computed lazily once (a soft hint:
        a stale entry costs one remote fetch, never correctness)."""
        with self._lock:
            if self._localities is None:
                self._localities = [ingest_ex.plan_locality(p)
                                    for p in self._plans]
            return self._localities

    @property
    def peak_window_bytes(self) -> int:
        """High-water mark of bytes resident in shuffle windows + fetch
        buffers across all workers — the soak test's RSS-bound proxy."""
        return self._window.peak()

    @property
    def resident_window_bytes(self) -> int:
        """Bytes currently counted resident across all epochs/workers;
        returns to zero once every epoch finishes or is released."""
        return self._window.value()

    def make_shard(self, session=None) -> "IngestShard":
        return IngestShard(self, session)

    # -------------------------------------------------- per-epoch state
    def _epoch_state(self, epoch: int) -> _EpochState:
        with self._lock:
            st = self._epochs.get(epoch)
            if st is None:
                st = _EpochState(len(self._plans),
                                 epoch_rng(self._seed, epoch),
                                 self._seal_on_claim)
                self._epochs[epoch] = st
            return st

    def _states(self) -> List[_EpochState]:
        with self._lock:
            return list(self._epochs.values())

    # ------------------------------------- ledger protocol (controller)
    # The trainer drives these exactly like a sized dataset's ledger —
    # delegation across every epoch touched so far.
    def seal(self, committed_step: int) -> int:
        return sum(st.ledger.seal(committed_step) for st in self._states())

    def finish(self) -> int:
        """Clean finish: seal every claim that actually trained (retagged
        with a real step at the yield of its last batch) and roll back
        claims still tagged PROVISIONAL_STEP — shards the prefetch pump
        claimed whose batches the user loop never consumed (e.g. a
        fixed-steps loop breaking out of ``iter_batches`` mid-epoch) must
        not audit as trained.  A blanket ``seal_all`` here would report
        never-trained shards as trained.  Returns how many never-consumed
        claims were rolled back."""
        return sum(st.ledger.rollback(PROVISIONAL_STEP - 1)
                   for st in self._states())

    def rollback(self, restore_step: Optional[int]) -> int:
        return sum(st.ledger.rollback(restore_step)
                   for st in self._states())

    def exhausted(self) -> bool:
        return all(st.ledger.exhausted() for st in self._states())

    def reset(self) -> None:
        """Non-elastic restart: the attempt re-runs the user loop from its
        own epoch 0, so ingest epochs must start fresh too."""
        with self._lock:
            self._epochs = {}

    # --------------------------------------------------------- auditing
    def audit(self, epoch: int = 0) -> Dict[str, Any]:
        """Exactly-once accounting for one epoch, in shard-id space."""
        with self._lock:
            st = self._epochs.get(epoch)
        if st is None:
            return {"trained_counts": {}, "double_trained": [],
                    "untrained": list(range(len(self._plans)))}
        counts = st.ledger.trained_counts()
        return {
            "trained_counts": {st.order[p]: c for p, c in counts.items()},
            "double_trained": [st.order[p]
                               for p in st.ledger.double_trained()],
            "untrained": [st.order[p] for p in st.ledger.untrained()],
        }

    def epochs_started(self) -> List[int]:
        with self._lock:
            return sorted(self._epochs)

    # ------------------------------------------------------ worker side
    def _iter_epoch(self, epoch: int, session, batch_size: Optional[int],
                    batch_format: str, prefetch_batches: Optional[int],
                    device=None) -> Iterator[Dict[str, Any]]:
        from ray_tpu_torch.data.block import BlockAccessor

        st = self._epoch_state(epoch)
        tracker = _ShardTracker(st.ledger, session)
        fence = session.stop_requested if session is not None else None
        resident = _ResidentBytes(self._window)

        # Locality-aware claiming: prefer shards whose object copies live
        # on the reading node ("" = local), so a scale-out does not turn
        # the data plane into a cross-node fetch storm.  Purely a claim
        # ORDER preference — every shard is still claimed exactly once.
        localities = self._plan_localities()
        has_locality = any(a is not None for a in localities)

        def _prefer_local(pos: int) -> bool:
            return localities[st.order[pos]] == ""

        def plan_iter():
            while True:
                t0 = time.time()
                got = st.ledger.claim(
                    1, step=PROVISIONAL_STEP, fence=fence,
                    prefer=_prefer_local if has_locality else None)
                if got is None:
                    ingest_metrics.PENDING_SHARDS.set(st.ledger.remaining())
                    return
                pos = got[0]
                if not has_locality:
                    outcome = "blind"
                else:
                    outcome = "local" if localities[st.order[pos]] == "" \
                        else "remote"
                ingest_metrics.LOCALITY_CLAIMS.inc(
                    1, tags={"locality": outcome})
                tracing.record_span(
                    "data.locality_claim", t0, time.time(),
                    attributes={"preferred": has_locality,
                                "local": outcome == "local"})
                ingest_metrics.PENDING_SHARDS.set(st.ledger.remaining())
                yield pos, self._plans[st.order[pos]]

        should_stop = fence.is_set if fence is not None else None
        budget = ex.ResourceBudget(mem_budget=self._window_bytes)
        stream = ingest_ex.stream_blocks(
            plan_iter(), budget, on_shard_end=tracker.shard_produced,
            should_stop=should_stop)

        def into_window():
            for pos, block in stream:
                try:
                    nbytes = BlockAccessor(block).size_bytes()
                except Exception:
                    nbytes = 0
                tracker.entered(pos)
                resident.add(nbytes)
                yield pos, block, nbytes

        salt = (session.context.world_rank + 1) if session is not None else 0
        shuffled = window_shuffle(
            into_window(), self._window_blocks,
            epoch_rng(self._seed, epoch, salt=salt),
            size_of=lambda t: t[2], max_bytes=self._window_bytes)

        def blocks_out():
            for pos, block, nbytes in shuffled:
                resident.add(-nbytes)
                yield pos, block

        def released(it):
            # Runs on the chain's own thread (the prefetch pump when
            # prefetch is on): whether the pipeline ends normally
            # (residual already 0), raises, or is closed after an
            # abandoned epoch, this epoch's residual leaves the gauge.
            try:
                yield from it
            finally:
                resident.release()

        tagged = released(_rebatch_tracked(blocks_out(), batch_size,
                                           batch_format))
        depth = (self._prefetch_batches if prefetch_batches is None
                 else prefetch_batches)
        prefetcher = HostPrefetcher(tagged, depth=depth,
                                    should_stop=should_stop) \
            if depth > 0 else tagged
        src: Any = prefetcher
        if device is not None:
            # Align each transferred batch with its provenance: the device
            # iterator pulls one batch ahead, so `done` sets queue up and
            # pop in yield order — retag still lands at the batch's yield,
            # never at its early transfer dispatch.
            dones: deque = deque()

            def only_batches(it):
                for done, batch in it:
                    if batch is None:
                        for pos in done:
                            tracker.block_done(pos)
                        continue
                    dones.append(done)
                    yield batch

            src = ((dones.popleft(), batch) for batch in
                   DeviceBatchIterator(only_batches(prefetcher),
                                       device=device))
        try:
            for done, batch in src:
                for pos in done:
                    tracker.block_done(pos)
                if batch is not None:
                    yield batch
        finally:
            if isinstance(prefetcher, HostPrefetcher):
                prefetcher.close()
            # Consumer-side backstop: without prefetch the chain runs on
            # THIS thread and is merely suspended here, so its own finally
            # has not fired; with prefetch the pump's teardown release may
            # lag — drain what is resident now, the pump releases the rest
            # at its exit (release() is an atomic drain, never double).
            resident.release()


class IngestShard:
    """A worker's view of a shared :class:`StreamingIngest` — what
    ``train.get_dataset_shard()`` returns on the streaming path.  Like
    ``DataIterator`` it is re-iterable: each ``iter_batches()`` call
    consumes one fresh epoch (shared across workers via the per-epoch
    shard ledger)."""

    def __init__(self, ingest: StreamingIngest, session=None):
        self._ingest = ingest
        self._session = session
        self._epoch = 0

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     prefetch_batches: Optional[int] = None,
                     device=None) -> Iterator[Dict[str, Any]]:
        """One epoch's batches.  ``device`` (a torch device, where the
        reference takes ``device_sharding``) hands them over as tensors on
        it through :class:`DeviceBatchIterator`; ``None`` keeps them on
        the host as numpy."""
        epoch = self._epoch
        self._epoch += 1
        return self._ingest._iter_epoch(
            epoch, self._session, batch_size, batch_format,
            prefetch_batches, device)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for batch in self.iter_batches(batch_size=None):
            n = len(next(iter(batch.values()))) if batch else 0
            for i in range(n):
                yield {k: v[i] for k, v in batch.items()}

    def num_shards(self) -> int:
        return self._ingest.num_shards()
