"""CheckpointCoordinator: sharded two-phase commit + replica registry (the
counterpart of ``ray_tpu/checkpoint/coordinator.py``).

The coordinator is the single writer of *commit* state.  Shard writers
(writer.py) run phase 1 — each persists its shard under the step's
``.tmp`` directory and reports ``shard_complete`` — and the coordinator
runs phase 2 when the last shard lands: global manifest + ``COMMIT``
marker + atomic rename (layout.commit_step_dir).  A save whose writer
dies mid-flight simply never completes its shard set; the ``.tmp`` dir is
swept on the next save and restore only ever sees committed steps.

It doubles as the registry for the in-memory replica tier (Gemini, SOSP
'23): writers put their host snapshots into the object store and register
the refs here; the last ``replica_steps`` committed steps stay resident,
optionally mirrored into a ReplicaHolder actor on a *different* node so
one node loss cannot take out both the workers and their fast-restore
copies.

Run it as an actor
(``ray_tpu_torch.remote(CheckpointCoordinator).remote(...)``)
for multi-worker training, or instantiate it directly for single-process
use — the writer handles both transparently.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.checkpoint import layout
from ray_tpu_torch.checkpoint import metrics as ckpt_metrics
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)


class CheckpointCoordinator:
    def __init__(self, root: str, keep: Optional[int] = None,
                 replica_steps: int = 2, replicate_to_peer: bool = True):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = keep
        self.replica_steps = max(0, int(replica_steps))
        self.replicate_to_peer = replicate_to_peer
        self._lock = threading.RLock()
        #: step -> {"num_shards", "epoch", "done": {shard: manifest}, "t0"}
        self._pending: Dict[int, Dict[str, Any]] = {}  # guarded_by: _lock
        #: (step, epoch) pairs whose save aborted: a sibling shard arriving
        #: after the abort must not resurrect the pending entry.
        self._aborted: set = set()  # guarded_by: _lock
        #: steps whose phase-2 commit is in flight (pending entry already
        #: removed, rename not yet done): the stale-tmp sweep and
        #: shard_failed must treat their .tmp dirs as live.
        self._committing: set = set()  # guarded_by: _lock
        # Restart-safe: rebuild committed state from disk (the same scan
        # CheckpointManager does) so a driver restart resumes seamlessly.
        self._committed: List[int] = layout.list_committed_steps(self.root)  # guarded_by: _lock
        self._last_commit_time: Optional[float] = None  # guarded_by: _lock
        self._epoch = 0  # guarded_by: _lock
        #: step -> {shard_id: ObjectRef} (refs held here pin the objects)
        self._replicas: Dict[int, Dict[int, Any]] = {}  # guarded_by: _lock
        self._peer = None
        #: monotonic time before which no peer (re)start is attempted —
        #: inf disables peer replication, 0 means "try on next use".  A
        #: dead holder (its node preempted) schedules a RETRY instead of
        #: latching unavailable forever: elastic training outlives any
        #: one peer node.
        self._peer_retry_at = float("inf") if not replicate_to_peer else 0.0
        self._sweep_stale_tmp()

    # ------------------------------------------------------------ phase 1
    def new_epoch(self) -> int:
        """Called by the training controller at each attempt start: pending
        saves from a previous (crashed) attempt must never mix shards with
        the new one, so their epochs divorce them."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    def begin_save(self, step: int, num_shards: int, epoch: int = 0) -> str:
        with self._lock:
            if step in self._committed or step in self._committing:
                raise ValueError(f"step {step} is already committed")
            if (step, epoch) in self._aborted:
                raise RuntimeError(
                    f"step {step} was aborted (a sibling shard failed)")
            pending = self._pending.get(step)
            tmp = layout.tmp_dir(self.root, step)
            if pending is not None and pending["epoch"] != epoch:
                # Stale attempt's half-written save: discard it wholesale.
                shutil.rmtree(tmp, ignore_errors=True)
                pending = None
            if pending is None:
                self._sweep_stale_tmp()
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
                self._pending[step] = {"num_shards": num_shards, "epoch": epoch,
                                       "done": {}, "t0": time.monotonic()}
            elif pending["num_shards"] != num_shards:
                raise ValueError(
                    f"step {step} began with num_shards={pending['num_shards']}, "
                    f"got {num_shards}")
            return tmp

    def shard_complete(self, step: int, shard_id: int, manifest: dict,
                       epoch: int = 0) -> bool:
        """Phase-1 completion for one shard; commits (phase 2) when it is
        the last one.  Returns True iff this call committed the step."""
        with self._lock:
            pending = self._pending.get(step)
            if pending is None or pending["epoch"] != epoch:
                return False  # stale writer from a torn-down attempt
            pending["done"][shard_id] = manifest
            if len(pending["done"]) < pending["num_shards"]:
                return False
            # Hand the step from _pending to _committing without a gap:
            # a concurrent begin_save's stale-tmp sweep must keep seeing
            # this step as owned, or it rmtrees the .tmp dir mid-commit.
            del self._pending[step]
            self._committing.add(step)
        try:
            self._commit(step, pending)
        finally:
            with self._lock:
                self._committing.discard(step)
        return True

    def shard_failed(self, step: int, shard_id: int, error: str = "",
                     epoch: int = 0) -> None:
        """Abort a pending save: the step can never commit with a missing
        shard, so drop it and reclaim the tmp dir."""
        with self._lock:
            if step in self._committing:
                # Every shard already landed and phase 2 owns the tmp dir;
                # a duplicate/stale failure report must not rmtree it.
                return
            pending = self._pending.get(step)
            if pending is not None and pending["epoch"] != epoch:
                return
            self._pending.pop(step, None)
            self._aborted.add((step, epoch))
            self._replicas.pop(step, None)
        shutil.rmtree(layout.tmp_dir(self.root, step), ignore_errors=True)
        ckpt_metrics.SAVE_FAILURES.inc(tags={"phase": "shard_write"})
        logger.warning("checkpoint step %s aborted (shard %s failed: %s)",
                       step, shard_id, error)

    # ------------------------------------------------------------ phase 2
    def _commit(self, step: int, pending: Dict[str, Any]) -> None:
        t0 = time.monotonic()
        try:
            with tracing.span("checkpoint.commit",
                              attributes={"step": step,
                                          "num_shards": pending["num_shards"]}):
                fault_injection.check("ckpt_commit")
                layout.commit_step_dir(self.root, step, pending["done"])
        except BaseException:
            ckpt_metrics.SAVE_FAILURES.inc(tags={"phase": "commit"})
            shutil.rmtree(layout.tmp_dir(self.root, step), ignore_errors=True)
            with self._lock:
                self._replicas.pop(step, None)
            raise
        now = time.time()
        with self._lock:
            self._committed.append(step)
            self._committed.sort()
            if self._last_commit_time is not None:
                ckpt_metrics.STALENESS_SECONDS.set(now - self._last_commit_time)
            self._last_commit_time = now
            # Aborted steps at or below the new latest can never be retried
            # (writers allocate monotonically increasing step ids), so the
            # poison set stays bounded in a long-lived coordinator.
            latest = self._committed[-1]
            self._aborted = {(s, e) for (s, e) in self._aborted if s > latest}
            self._apply_retention()
            self._trim_replicas()
        ckpt_metrics.COMMITS.inc()
        ckpt_metrics.COMMIT_SECONDS.observe(time.monotonic() - t0)

    def _apply_retention(self) -> None:  # requires_lock: _lock
        if self.keep is None or self.keep <= 0:
            return
        while len(self._committed) > self.keep:
            victim = self._committed.pop(0)
            shutil.rmtree(layout.final_dir(self.root, victim),
                          ignore_errors=True)
            self._replicas.pop(victim, None)

    def _sweep_stale_tmp(self) -> None:  # requires_lock: _lock
        """Reclaim ``.tmp`` dirs no live pending save owns (crashed saves
        from this or a previous process)."""
        for path in layout.list_stale_tmp_dirs(self.root):
            name = os.path.basename(path)
            step = layout.parse_step(name[: -len(layout.TMP_SUFFIX)])
            if step not in self._pending and step not in self._committing:
                shutil.rmtree(path, ignore_errors=True)

    # --------------------------------------------------------- inspection
    def latest_committed(self) -> Optional[int]:
        with self._lock:
            return self._committed[-1] if self._committed else None

    def committed_steps(self) -> List[int]:
        with self._lock:
            return list(self._committed)

    def committed_path(self, step: int) -> str:
        return layout.final_dir(self.root, step)

    def latest_committed_path(self) -> Optional[str]:
        step = self.latest_committed()
        return None if step is None else layout.final_dir(self.root, step)

    # ------------------------------------------------------- replica tier
    def put_replica(self, step: int, shard_id: int, wrapped_ref: dict) -> None:
        """Register one shard's in-memory snapshot (``{"ref": ObjectRef}``
        — nested so the actor call does not materialize it).  Holding the
        ref here pins the snapshot in the object store; when a peer node
        exists, the holder actor there keeps a second copy."""
        if self.replica_steps <= 0:
            return
        ref = wrapped_ref["ref"]
        with self._lock:
            self._replicas.setdefault(step, {})[shard_id] = ref
            self._trim_replicas()
        peer = self._ensure_peer()
        if peer is not None:
            try:
                peer.hold.remote(step, shard_id, {"ref": ref})
            except Exception:
                self._drop_peer()

    def _trim_replicas(self) -> None:  # requires_lock: _lock
        # Keep the last replica_steps *committed* steps plus anything still
        # pending (its commit may be in flight).
        keep = set(self._committed[-self.replica_steps:]) if self.replica_steps else set()
        keep |= set(self._pending)
        keep |= self._committing
        for step in [s for s in self._replicas if s not in keep]:
            del self._replicas[step]
        committed_resident = [s for s in self._replicas if s in set(self._committed)]
        ckpt_metrics.REPLICA_STEPS.set(len(committed_resident))
        peer = self._peer
        if peer is not None:
            try:
                peer.trim.remote(sorted(self._replicas))
            except Exception:
                pass

    def _drop_peer(self, retry_after_s: float = 5.0) -> None:
        """Forget a failed/dead peer and schedule a revival attempt."""
        self._peer = None
        if self._peer_retry_at != float("inf"):
            self._peer_retry_at = time.monotonic() + retry_after_s

    def _peer_alive(self) -> bool:
        """Best-effort liveness of the holder actor (fire-and-forget
        ``hold`` calls never surface a dead peer on their own)."""
        peer = self._peer
        if peer is None:
            return False
        try:
            from ray_tpu_torch._private.runtime import get_runtime

            state = get_runtime().get_actor_state(peer._ray_actor_id)
        except Exception:
            return True  # cannot tell — assume alive
        return state is not None and state.state != "DEAD"

    def _ensure_peer(self):
        if self._peer is not None:
            if self._peer_alive():
                return self._peer
            # The holder's node was preempted out from under it: drop it
            # and fall through into the revival path immediately.
            self._drop_peer(retry_after_s=0.0)
        if time.monotonic() < self._peer_retry_at:
            return None
        try:
            from ray_tpu_torch.checkpoint.replica import start_peer_holder

            self._peer = start_peer_holder()
        except Exception:
            self._peer = None
        if self._peer is None:
            # No peer node available right now (single-node cluster, or
            # capacity preempted away) — retry later, don't latch off.
            self._drop_peer(retry_after_s=15.0)
            return None
        self._mirror_to_peer(self._peer)
        return self._peer

    def _mirror_to_peer(self, peer) -> None:
        """Seed a fresh holder with every resident replica shard so a
        revived peer is immediately useful for recovery."""
        with self._lock:
            resident = [(step, sid, ref)
                        for step, shards in self._replicas.items()
                        for sid, ref in shards.items()]
        for step, sid, ref in resident:
            try:
                peer.hold.remote(step, sid, {"ref": ref})
            except Exception:
                self._drop_peer()
                return

    def peer_payloads(self, step: Optional[int] = None) -> Optional[dict]:
        """Fetch a full shard-payload set for ``step`` (default: latest
        committed) from the peer holder — the recovery tier that survives
        the WRITERS' node dying.  Bounded wait; None when there is no
        peer, it died, or it holds only a partial set (caller falls back
        to disk — never hangs)."""
        peer = self._peer
        if peer is None:
            return None
        if step is None:
            step = self.latest_committed()
        if step is None:
            return None
        try:
            import ray_tpu_torch

            payloads = ray_tpu_torch.get(peer.fetch.remote(step), timeout=20)
        except Exception:
            self._drop_peer()
            return None
        want = self._num_shards_of(step)
        if want is None or len(payloads) < want:
            return None
        return {"step": step, "payloads": payloads}

    def replica_refs(self, step: Optional[int] = None) -> Optional[dict]:
        """{"step", "refs": {shard_id: {"ref": ObjectRef}}} for the newest
        committed step with a full replica set (or the given step), else
        None.  Refs ride nested in dicts so neither the actor return nor a
        later call materializes them prematurely."""
        with self._lock:
            candidates = [step] if step is not None else list(reversed(self._committed))
            for s in candidates:
                refs = self._replicas.get(s)
                if not refs:
                    continue
                want = self._num_shards_of(s)
                if want is not None and len(refs) >= want:
                    return {"step": s,
                            "refs": {sid: {"ref": r} for sid, r in refs.items()}}
        return None

    def _num_shards_of(self, step: int) -> Optional[int]:
        path = os.path.join(layout.final_dir(self.root, step),
                            layout.GLOBAL_MANIFEST)
        try:
            import json

            with open(path) as f:
                return int(json.load(f)["num_shards"])
        except Exception:
            return None

    def restore_source(self) -> Optional[dict]:
        """What a restarting trainer should restore from: the latest
        committed step, preferring the in-memory replica tier."""
        step = self.latest_committed()
        if step is None:
            return None
        return {"step": step,
                "path": layout.final_dir(self.root, step),
                "replicas": self.replica_refs(step)}

    def stats(self) -> dict:
        with self._lock:
            return {
                "committed_steps": list(self._committed),
                "pending_steps": sorted(self._pending),
                "committing_steps": sorted(self._committing),
                "aborted_entries": len(self._aborted),
                "replica_steps": sorted(self._replicas),
                "epoch": self._epoch,
                "peer_replication": self._peer is not None,
            }
