"""Elastic data plane: the exactly-once sample ledger (the counterpart of
``ray_tpu/train/elastic.py``: ``PROVISIONAL_STEP``, ``SampleLedger``, which
the elastic Trainer and streaming ingest claim through, and the worker's
view of it, ``ElasticDatasetShard``).

The reshard guarantee: across any sequence of preemptions, shrinks and
grows inside one ``fit()``, every sample is trained by exactly one worker
exactly once — none double-trained, none dropped — where "trained" means
*its gradient contributed to the state the run finished with*.

Mechanism: workers do not own static shards.  A single controller-side
``SampleLedger`` hands out exclusive batches; a claim is *provisional*,
tagged with the checkpoint step the worker is about to train, until a
checkpoint at or past that step commits — then it is sealed (permanently
trained).  On a preemption the model rolls back to the last committed step
S, so every provisional claim past S describes an update the restored model
never saw: those samples are requeued (front of the queue, original order)
and handed to a surviving worker.  Claims at or below S sealed with the
restore.  Shrink and grow need no repartitioning step at all: exclusive
claiming IS the reshard.

Without an async-checkpoint coordinator there is no committed-step signal;
``seal_on_claim=True`` degrades to claim-is-trained (a failure loses those
samples' contribution instead of retraining them — still never
double-trained).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

#: Claim tag for work whose final training step is not known at claim time
#: (streaming ingest claims a whole source shard up front and only learns
#: the step its last batch trained at once the shard drains).  Larger than
#: any real checkpoint step, so seal(committed) never seals it by accident;
#: ``retag()`` replaces it once the true step is known, and ``rollback()``
#: requeues anything still provisional, exactly like a normal claim.
PROVISIONAL_STEP = 1 << 62


class SampleLedger:
    """Controller-owned exactly-once dispenser over a sized dataset."""

    def __init__(self, dataset: Sequence, seal_on_claim: bool = False):
        self._dataset = dataset
        self._lock = threading.Lock()
        self._pending: deque = deque(range(len(dataset)))  # guarded_by: _lock
        #: provisional claims in claim order: (step, (idx, ...))
        self._inflight: List[Tuple[int, Tuple[int, ...]]] = []  # guarded_by: _lock
        #: idx -> times sealed (>1 would mean a double-train)
        self._trained: Dict[int, int] = {}  # guarded_by: _lock
        self.seal_on_claim = seal_on_claim

    def __len__(self) -> int:
        return len(self._dataset)

    # ------------------------------------------------------------- claims
    def claim(self, n: int, step: Optional[int] = None,
              fence=None, prefer=None) -> Optional[Tuple[int, ...]]:
        """Exclusively claim up to ``n`` sample indices for checkpoint
        step ``step``; None once the queue is empty.

        ``fence`` (a threading.Event, the session's stop_requested): a
        zombie worker thread — its actor killed by a preemption but its
        Python thread still running — must not claim after the controller
        rolls the ledger back, or the claim's samples would be counted
        trained in a discarded lineage.  The fence is checked under the
        ledger lock and the controller always sets it BEFORE rolling
        back, so every interleaving either rejects the claim or lands it
        in _inflight where the rollback requeues it.

        ``prefer`` (``idx -> bool``): soft locality preference — indices
        the predicate accepts are claimed first (in queue order), the
        rest fill from the queue head as usual.  Purely an ordering hint:
        exactly-once accounting, rollback and exhaustion are unchanged,
        and no index is ever skipped (the streaming-ingest locality path,
        docs/cluster-autoscaling.md)."""
        with self._lock:
            if fence is not None and fence.is_set():
                return None
            if not self._pending:
                return None
            take = min(n, len(self._pending))
            if prefer is not None:
                chosen: List[int] = []
                for i in self._pending:
                    if len(chosen) >= take:
                        break
                    if prefer(i):
                        chosen.append(i)
                for i in chosen:
                    self._pending.remove(i)
                while len(chosen) < take:
                    chosen.append(self._pending.popleft())
                indices = tuple(chosen)
            else:
                indices = tuple(self._pending.popleft()
                                for _ in range(take))
            if self.seal_on_claim or step is None:
                for i in indices:
                    self._trained[i] = self._trained.get(i, 0) + 1
            else:
                self._inflight.append((step, indices))
            return indices

    def fetch(self, indices: Tuple[int, ...]):
        """Materialize claimed samples (numpy fancy-indexing when the
        dataset supports it, else item-by-item)."""
        try:
            return self._dataset[list(indices)]
        except TypeError:
            return [self._dataset[i] for i in indices]

    def retag(self, indices: Tuple[int, ...], step: Optional[int]) -> int:
        """Replace the claim step of in-flight ``indices`` (claimed at
        ``PROVISIONAL_STEP``) with the step they actually finished training
        at — the streaming-ingest path, where a shard's step is only known
        once its last batch has been consumed.  ``step=None`` seals the
        indices immediately (no coordinator to commit against).  Indices no
        longer in flight (already requeued by a rollback) are skipped;
        returns how many were retagged/sealed."""
        want = set(indices)
        with self._lock:
            moved = 0
            keep: List[Tuple[int, Tuple[int, ...]]] = []
            for s, idxs in self._inflight:
                hit = [i for i in idxs if i in want]
                if not hit:
                    keep.append((s, idxs))
                    continue
                moved += len(hit)
                rest = tuple(i for i in idxs if i not in want)
                if rest:
                    keep.append((s, rest))
                if step is None:
                    for i in hit:
                        self._trained[i] = self._trained.get(i, 0) + 1
                else:
                    keep.append((step, tuple(hit)))
            self._inflight = keep
            return moved

    # ------------------------------------------------- commit/rollback
    def seal(self, committed_step: int) -> int:
        """A checkpoint at ``committed_step`` committed: claims trained at
        or before it are now permanent.  Returns how many were sealed."""
        with self._lock:
            return self._seal_locked(committed_step)

    def _seal_locked(self, committed_step: int) -> int:
        sealed = 0
        keep: List[Tuple[int, Tuple[int, ...]]] = []
        for step, indices in self._inflight:
            if step <= committed_step:
                for i in indices:
                    self._trained[i] = self._trained.get(i, 0) + 1
                sealed += len(indices)
            else:
                keep.append((step, indices))
        self._inflight = keep
        return sealed

    def seal_all(self) -> int:
        """Clean finish: nothing will roll back, every provisional claim
        is trained."""
        with self._lock:
            sealed = 0
            for _, indices in self._inflight:
                for i in indices:
                    self._trained[i] = self._trained.get(i, 0) + 1
                sealed += len(indices)
            self._inflight = []
            return sealed

    def rollback(self, restore_step: Optional[int]) -> int:
        """The model restored to ``restore_step`` (None = from scratch):
        provisional claims past it describe rolled-back updates — requeue
        them, front of the queue, original claim order, so a surviving
        worker retrains each exactly once.  Claims at or below the restore
        step seal.  Returns how many samples were requeued."""
        with self._lock:
            if restore_step is not None:
                self._seal_locked(restore_step)
            requeue: List[int] = []
            for _, indices in self._inflight:
                requeue.extend(indices)
            self._inflight = []
            for i in reversed(requeue):
                self._pending.appendleft(i)
            return len(requeue)

    # --------------------------------------------------------- inspection
    def remaining(self) -> int:
        with self._lock:
            return len(self._pending)

    def inflight(self) -> int:
        with self._lock:
            return sum(len(ix) for _, ix in self._inflight)

    def exhausted(self) -> bool:
        """No work left to hand out AND nothing provisional that a
        rollback could still requeue."""
        with self._lock:
            return not self._pending and not self._inflight

    def trained_counts(self) -> Dict[int, int]:
        """idx -> times permanently trained (the per-sample ledger the
        chaos acceptance test asserts on)."""
        with self._lock:
            return dict(self._trained)

    def double_trained(self) -> List[int]:
        return [i for i, c in self.trained_counts().items() if c > 1]

    def untrained(self) -> List[int]:
        counts = self.trained_counts()
        return [i for i in range(len(self._dataset)) if counts.get(i, 0) == 0]


class ElasticDatasetShard:
    """A worker's view of the shared ledger, handed out by
    ``train.get_dataset_shard()`` when elastic training is on.

    Batches are claimed tagged with the session's next checkpoint step —
    the step whose ``report()`` has not happened yet — so the ledger can
    tell exactly which claims a restore to step S rolls back.
    """

    def __init__(self, ledger: SampleLedger, session=None):
        self._ledger = ledger
        self._session = session

    def next_batch(self, batch_size: int):
        """(indices, samples) for an exclusively claimed batch, or None
        when every sample has been handed out (or this attempt is being
        torn down — see the fence note on SampleLedger.claim)."""
        from ray_tpu_torch.train import profiler as _profiler

        step = fence = None
        if self._session is not None:
            step = self._session.current_checkpoint_step()
            fence = self._session.stop_requested
        # Claim + fetch is the worker's input-pipeline time on the elastic
        # path: the step profiler's data_wait bucket.
        w0 = time.time()
        try:
            indices = self._ledger.claim(batch_size, step, fence=fence)
            if indices is None:
                return None
            return indices, self._ledger.fetch(indices)
        finally:
            _profiler.record("data_wait", w0, time.time())

    def iter_batches(self, batch_size: int):
        while True:
            batch = self.next_batch(batch_size)
            if batch is None:
                return
            yield batch

    def __len__(self) -> int:
        return len(self._ledger)
