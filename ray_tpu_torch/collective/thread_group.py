"""Thread-tier collective group: ranks that are threads of one process.

The counterpart of ``ray_tpu/collective/xla_group.py`` (``XLACollectiveGroup``;
ref: python/ray/util/collective/collective_group/nccl_collective_group.py).
The ranks rendezvous in-process (``_Rendezvous``, kept as the reference has
it): each contributes its tensor, the last rank to arrive runs the op once
with torch on the contributions' device (sum, product, min and max; gather;
reduce-scatter; broadcast; send and recv), and every rank gets its own
result on its own tensor's device.

The ranks' threads share the process's CUDA context. Each issues work on
its current stream, and a contribution may come off any stream (a
``DeviceBatchIterator`` side stream, say): each rank records an event on
its stream as it contributes, the op's stream waits on every one before it
reads, and each rank's stream waits on the op's event before it reads its
result. Reading a gradient before its backward finished would be wrong
silently.

The group's devices are the node's cards. When ``world_size`` exceeds them
the ranks share cards (``_oversubscribed``, with a loud warning, as in the
reference), and the op still runs on the card. Ranks on the host (no card)
run their ops there.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.util import watchdog as _watchdog


def _profiler_record(bucket: str, start: float, end: float) -> None:
    """Attribute an interval to the train step profiler when one is active
    on this thread (each rank's contribute runs on its worker thread).
    Probed via sys.modules: the collective layer must not import the train
    package (the trainer imports collective, not the reverse), and if the
    profiler module was never imported, none can be active."""
    mod = sys.modules.get("ray_tpu_torch.train.profiler")
    if mod is not None:
        mod.record(bucket, start, end)


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


class _Rendezvous:
    """Collects one contribution per rank, runs the op once, fans results out.

    The in-process analogue of the reference's NCCL rendezvous (unique-id via
    a named actor, nccl_util.py) — here a barrier across the ranks' threads.
    """

    def __init__(self, world_size: int, timeout_s: float = 300.0):
        self.world_size = world_size
        self.timeout_s = timeout_s
        self.lock = threading.Lock()
        self.slots: Dict[int, Any] = {}
        self.arrivals = 0  # counted at lookup under the group lock
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def contribute(self, rank: int, value: Any, run_fn, participants=None,
                   on_timeout=None) -> Any:
        # Contribute-to-result wall time is this rank's collective-sync
        # cost: waiting for stragglers plus (on the last rank) the op
        # itself — the step profiler's "collective" bucket.  The hang
        # watchdog tracks the same window as a bounded phase: a rank held
        # inside the rendezvous past the stall threshold is a wedge the
        # liveness poll cannot see (the thread is alive, just waiting).
        w0 = time.time()
        _watchdog.phase_enter(f"collective:rank{rank}", "rendezvous")
        try:
            return self._contribute(rank, value, run_fn, participants,
                                    on_timeout)
        finally:
            _watchdog.phase_exit(f"collective:rank{rank}")
            _profiler_record("collective", w0, time.time())

    def _contribute(self, rank: int, value: Any, run_fn, participants=None,
                    on_timeout=None) -> Any:
        members = participants if participants is not None else list(range(self.world_size))
        with self.lock:
            if rank in self.slots:
                raise ValueError(f"rank {rank} contributed twice to collective")
            self.slots[rank] = value
            is_last = len(self.slots) == len(members)
        if is_last:
            try:
                self.result = run_fn({r: self.slots[r] for r in members})
            except BaseException as e:  # noqa: BLE001 — raised on every rank
                self.error = e
            finally:
                self.done.set()
        else:
            if not self.done.wait(timeout=self.timeout_s):
                # Withdraw our contribution so a retry of this round is clean
                # instead of hitting "contributed twice" on a wedged group.
                with self.lock:
                    self.slots.pop(rank, None)
                if on_timeout is not None:
                    on_timeout(self)
                raise TimeoutError(
                    f"collective rendezvous timed out: {len(self.slots)}/"
                    f"{len(members)} participants arrived")
        if self.error is not None:
            raise self.error
        return self.result


# ------------------------------------------------------------ stream order
def as_tensor(value: Any):
    """A tensor as it is, anything else (numpy, lists, scalars) as one."""
    import torch

    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


class _Part:
    """One rank's contribution: its tensor, the stream it was made on and
    an event recorded there as it arrived (None on the host)."""

    __slots__ = ("tensor", "stream", "event")

    def __init__(self, value: Any):
        import torch

        t = as_tensor(value)
        self.tensor = t
        self.stream = self.event = None
        if t.is_cuda:
            self.stream = torch.cuda.current_stream(t.device)
            self.event = torch.cuda.Event()
            self.event.record(self.stream)

    def read(self, device):
        """The tensor on ``device``, ordered after the contributor's work on
        the running thread's stream."""
        import torch

        t = self.tensor
        if self.event is not None:
            cur = torch.cuda.current_stream(t.device)
            cur.wait_event(self.event)
            if cur != self.stream:
                t.record_stream(cur)
        return t.to(device)


def _hand_out(tensors: Dict[int, Any], parts: Dict[int, "_Part"]
              ) -> Dict[int, Tuple[Any, Any, Any]]:
    """Per rank: its result on its own tensor's device, a private copy, and
    the event its stream must wait on."""
    import torch

    out = {}
    for r, t in tensors.items():
        mine = t.to(parts[r].tensor.device, copy=True)
        event = stream = None
        if mine.is_cuda:
            stream = torch.cuda.current_stream(mine.device)
            event = torch.cuda.Event()
            event.record(stream)
        out[r] = (mine, stream, event)
    return out


def _take(result: Tuple[Any, Any, Any]):
    """A rank's side of ``_hand_out``: wait on the op's event in this
    thread's stream, and keep the tensor's memory until that stream is done
    with it."""
    import torch

    t, stream, event = result
    if event is not None:
        cur = torch.cuda.current_stream(t.device)
        cur.wait_event(event)
        if cur != stream:
            t.record_stream(cur)
    return t


def _reduce(stacked, op: str):
    if op == ReduceOp.SUM:
        return stacked.sum(dim=0, dtype=stacked.dtype)
    if op == ReduceOp.MAX:
        return stacked.amax(dim=0)
    if op == ReduceOp.MIN:
        return stacked.amin(dim=0)
    if op == ReduceOp.PRODUCT:
        # Exact for negative and zero inputs (no exp(sum(log))).
        return stacked.prod(dim=0, dtype=stacked.dtype)
    raise ValueError(f"Unknown reduce op: {op}")


def _cards():
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


class ThreadCollectiveGroup:
    def __init__(self, group_name: str, world_size: int,
                 devices: Optional[List[Any]] = None,
                 timeout_s: Optional[float] = None):
        import torch

        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        #: Rendezvous bound: a lost rank fails the OTHERS after this long
        #: instead of holding them hostage.
        self.timeout_s = float(timeout_s if timeout_s is not None
                               else GLOBAL_CONFIG.collective_timeout_s)
        cards = list(devices) if devices is not None else _cards()
        if not cards:
            # Ranks on the host: each runs where its tensors are.
            self.devices = [torch.device("cpu")] * world_size
            self._oversubscribed = False
        elif world_size > len(cards):
            # More ranks than cards (two thread ranks on one card, or a
            # wide group in tests): ranks share cards and every op runs on
            # one of them. Loud, because a quiet fallback here let a
            # one-card host "pass" without exercising one card per rank.
            import warnings

            warnings.warn(
                f"collective group '{group_name}': world_size {world_size} > "
                f"{len(cards)} devices — ranks share devices; one device "
                f"per rank is NOT exercised", RuntimeWarning, stacklevel=2)
            self.devices = [cards[i % len(cards)] for i in range(world_size)]
            self._oversubscribed = True
        else:
            self.devices = list(cards[:world_size])
            self._oversubscribed = False
        self.group_name = group_name
        self.world_size = world_size
        self._rendezvous: Dict[Tuple[str, int], _Rendezvous] = {}
        self._rv_lock = threading.Lock()
        self._op_seq: Dict[str, int] = {}
        self._destroyed = False

    def _rendezvous_for(self, op: str, n_participants: Optional[int] = None) -> _Rendezvous:
        n = n_participants if n_participants is not None else self.world_size
        with self._rv_lock:
            if self._destroyed:
                raise RuntimeError(
                    f"collective group '{self.group_name}' was destroyed")
            seq = self._op_seq.get(op, 0)
            key = (op, seq)
            rv = self._rendezvous.get(key)
            if rv is None:
                rv = _Rendezvous(self.world_size, self.timeout_s)
                self._rendezvous[key] = rv
            rv.arrivals += 1
            if rv.arrivals == n:
                # Full round assembled: next lookup starts a fresh round.
                self._op_seq[op] = seq + 1
                self._rendezvous.pop((op, seq - 2), None)  # GC old rounds
            return rv

    def _on_rv_timeout(self, rv: _Rendezvous) -> None:
        with self._rv_lock:
            rv.arrivals = max(0, rv.arrivals - 1)

    def _round(self, op: str, rank: int, value: Any, compute,
               participants: Optional[List[int]] = None) -> Any:
        """One rendezvous round: ``compute(parts)`` runs once, on the last
        rank to arrive, and returns each participant's result tensor."""
        rv = self._rendezvous_for(
            op, None if participants is None else len(participants))

        def run(slots: Dict[int, _Part]):
            return _hand_out(compute(slots), slots)

        results = rv.contribute(rank, _Part(value), run,
                                participants=participants,
                                on_timeout=self._on_rv_timeout)
        return _take(results[rank])

    def _stacked(self, parts: Dict[int, _Part], order: List[int]):
        import torch

        dev = parts[order[0]].tensor.device
        return torch.stack([parts[r].read(dev) for r in order])

    # ------------------------------------------------------------ collectives
    def allreduce(self, rank: int, array: Any, op: str = ReduceOp.SUM) -> Any:
        ranks = list(range(self.world_size))

        def compute(parts):
            out = _reduce(self._stacked(parts, ranks), op)
            return {r: out for r in ranks}

        return self._round(f"allreduce-{op}", rank, array, compute)

    def allgather(self, rank: int, array: Any) -> Any:
        ranks = list(range(self.world_size))

        def compute(parts):
            out = self._stacked(parts, ranks)
            return {r: out for r in ranks}

        return self._round("allgather", rank, array, compute)

    def reducescatter(self, rank: int, array: Any, op: str = ReduceOp.SUM) -> Any:
        """Each rank contributes shape (world, ...); receives its reduced shard."""
        t = as_tensor(array)
        if t.shape[0] != self.world_size:
            raise ValueError(
                f"reducescatter input dim0 ({t.shape[0]}) must equal world_size "
                f"({self.world_size})")
        ranks = list(range(self.world_size))

        def compute(parts):
            reduced = _reduce(self._stacked(parts, ranks), op)  # (world, ...)
            return {r: reduced[r] for r in ranks}

        return self._round(f"reducescatter-{op}", rank, t, compute)

    def broadcast(self, rank: int, array: Any, src_rank: int = 0) -> Any:
        ranks = list(range(self.world_size))

        def compute(parts):
            src = parts[src_rank]
            out = src.read(src.tensor.device)
            return {r: out for r in ranks}

        return self._round(f"broadcast-{src_rank}", rank, array, compute)

    def barrier(self, rank: int) -> None:
        rv = self._rendezvous_for("barrier")
        rv.contribute(rank, 0, lambda slots: [None] * self.world_size,
                      on_timeout=self._on_rv_timeout)

    def send_recv(self, rank: int, array: Any, perm: List[Tuple[int, int]]) -> Any:
        """Paired send/recv as one round: ``perm`` is [(src, dst), ...]; a
        participant that receives nothing gets zeros (the reference's
        ppermute semantics)."""
        import torch

        # Only the ranks named in perm participate — a 2-party send/recv in an
        # 8-rank group must not wait for the other 6.
        participants = sorted({r for pair in perm for r in pair})
        if rank not in participants:
            raise ValueError(f"rank {rank} is not part of perm {perm}")

        def compute(parts):
            template = parts[participants[0]].tensor
            out = {r: torch.zeros_like(parts[r].tensor) for r in participants}
            for src, dst in perm:
                out[dst] = parts[src].read(template.device)
            return out

        return self._round(f"sendrecv-{tuple(perm)}", rank, array, compute,
                           participants=participants)

    def destroy(self) -> None:
        # Poison in-flight rounds so blocked participants wake immediately
        # instead of sitting out the rendezvous timeout (the controller
        # destroys the group when a worker fails), and refuse later ones: a
        # rank that arrives after must not wait for partners that stopped.
        with self._rv_lock:
            self._destroyed = True
            rvs = list(self._rendezvous.values())
            self._rendezvous.clear()
        for rv in rvs:
            if not rv.done.is_set():
                rv.error = RuntimeError(
                    f"collective group '{self.group_name}' was destroyed")
                rv.done.set()
