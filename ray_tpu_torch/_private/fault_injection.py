"""Fault injection for chaos testing (the counterpart of
``ray_tpu/_private/fault_injection.py``; ref: src/ray/rpc/rpc_chaos.h:22
RpcFailure driven by RAY_testing_rpc_failure).

Internal operations consult the injector at named failure points and
probabilistically raise a transient ``InjectedFailure`` (a subclass of
WorkerCrashedError, so retry machinery treats it as a system fault, not an
app error).

Enable via config (env RAY_TPU_TESTING_RPC_FAILURE or _system_config):
    testing_rpc_failure = "serve_autoscale=0.3,forensics_dump=1.0:4"
Each entry is <point>=<probability>[:<max_failures>]; max_failures caps how
many times the point fires (unbounded if omitted).  The reference's
injected delays come with the port's chaos tests (ROADMAP.md, Queue 1).

Every failure point the port consults is declared in :data:`FAULT_POINTS`;
the reference's other points come with the modules that consult them
(ROADMAP.md, Queue 1).  Tests may use ad-hoc points against a local
``FaultInjector``.

Deterministic across runs for a fixed ``seed``.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch.exceptions import WorkerCrashedError


class InjectedFailure(WorkerCrashedError):
    """Raised by a chaos failure point (transient, retryable)."""


#: Failure points the port consults: name -> where it fires / what failure
#: it simulates.
FAULT_POINTS: Dict[str, str] = {
    "serve_autoscale": "autoscaler apply site (controller _autoscale_tick, "
                       "before set_target_num) — an injected scale-decision "
                       "failure leaves the target unchanged; no replica is "
                       "started or drained",
    "forensics_dump": "flight-recorder postmortem dump entry — the dump "
                      "fails; every trigger site absorbs it (a forensics "
                      "failure must never worsen the failure being "
                      "recorded)",
    "data_ingest_fetch": "block materialization in the ingest stream — the "
                         "fetch retries (bounded) before surfacing to the "
                         "training loop",
    "data_ingest_prefetch": "host->device batch transfer dispatch — retried "
                            "once before surfacing",
    "train_worker_run": "train worker step boundary (run entry + every "
                        "report()) — the attempt fails and the trainer "
                        "restarts it from the newest checkpoint, within "
                        "FailureConfig.max_failures; the elastic controller "
                        "shrinks and resumes",
    "preempt_node": "trainer controller tick — a whole worker-group node is "
                    "preempted (actors killed + node removed), simulating a "
                    "node vanishing",
    # checkpoint subsystem (tests/test_torch_checkpoint_chaos.py)
    "ckpt_shard_write": "shard persist in the writer thread — kills a save "
                        "mid-flight; the pending step aborts",
    "ckpt_commit": "coordinator commit phase, before the atomic rename — "
                   "the step stays uncommitted, restore skips it",
    "ckpt_restore": "restore entry (restore_pytree) — retryable",
    # device telemetry (tests/test_torch_device_telemetry.py)
    "device_telemetry_snapshot": "device-telemetry snapshot assembly — every "
                                 "embedding site (forensics bundle, "
                                 "serve.status, run registry) absorbs a "
                                 "telemetry failure rather than worsening "
                                 "the event being observed",
}


class FaultInjector:
    def __init__(self, spec: str, seed: Optional[int] = None):
        #: point -> (probability, remaining_budget or None)
        self._points: Dict[str, Tuple[float, Optional[int]]] = {}  # guarded_by: _lock
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        for entry in filter(None, (e.strip() for e in spec.split(","))):
            point, _, rest = entry.partition("=")
            prob_s, _, budget_s = rest.partition(":")
            self._points[point.strip()] = (
                float(prob_s), int(budget_s) if budget_s else None)
        # The set of configured points is fixed after construction (budgets
        # decrement but entries never appear/disappear), so enabled-ness is
        # immutable.
        self._enabled = bool(self._points)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def fires(self, point: str) -> bool:
        """Evaluate a failure point (consumes budget when it fires), in one
        locked read-evaluate-update."""
        with self._lock:
            entry = self._points.get(point)
            if entry is None:
                return False
            prob, budget = entry
            if (budget is not None and budget <= 0) \
                    or self._rng.random() >= prob:
                return False
            if budget is not None:
                self._points[point] = (prob, budget - 1)
            return True

    def check(self, point: str) -> None:
        """Raise InjectedFailure if the point fires."""
        if self.fires(point):
            raise InjectedFailure(f"chaos: injected failure at '{point}'")


_injector: Optional[FaultInjector] = None  # guarded_by: _injector_lock
_injector_lock = threading.Lock()


def get_injector() -> FaultInjector:
    """The process-wide injector, built from GLOBAL_CONFIG on first use
    (rebuilt by reset_injector() after config changes)."""
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                from ray_tpu_torch._private.config import GLOBAL_CONFIG

                _injector = FaultInjector(GLOBAL_CONFIG.testing_rpc_failure)
    return _injector


def reset_injector() -> None:
    global _injector
    with _injector_lock:
        _injector = None


def check(point: str) -> None:
    """Module-level convenience: no-op unless chaos is configured."""
    inj = get_injector()
    if inj.enabled:
        inj.check(point)
