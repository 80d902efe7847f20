"""Runtime configuration flag table (the counterpart of
``ray_tpu/_private/config.py``; ref: src/ray/common/ray_config_def.h).

Every flag has a typed default and can be overridden by a ``RAY_TPU_<NAME>``
environment variable or the ``_system_config`` dict passed to
``ray_tpu_torch.init``. The thread tier's flags (and the chaos flag of
``_private/fault_injection.py``), the placement policies' and the
serialized object tier's are here: the object transfer, worker-node and
memory-monitor flags come with real worker nodes (ROADMAP.md, Queue 1 item
13.8b).
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

_ENV_PREFIX = "RAY_TPU_"


@dataclass
class Config:
    #: Bumped by apply_overrides so config-derived caches invalidate.
    generation: int = 0

    #: Bytes the node advertises as its ``memory`` resource (0 = 30% of
    #: the host's RAM, the reference's default).
    object_store_memory: int = 0
    #: Directory for spilled objects (object spilling under memory pressure,
    #: ref: raylet/local_object_manager.h:41); the port's own, beside the
    #: reference's ``/tmp/ray_tpu_spill``.
    spill_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_spill"))
    #: Start spilling when the serialized tier is this full (ref:
    #: object_spilling_threshold).
    object_spilling_threshold: float = 0.8
    #: Args and results larger than this ride the shared-memory arena to and
    #: from process workers instead of the pipe.
    plasma_handoff_threshold: int = 128 * 1024

    # --- scheduling ---
    #: Pack-then-spread crossover used by the hybrid policy
    #: (ref: hybrid_scheduling_policy.h:50 spread_threshold=0.5).
    scheduler_spread_threshold: float = 0.5
    #: Top-k random tie-break among candidate nodes (ref: scheduler_top_k_fraction).
    scheduler_top_k_fraction: float = 0.2

    # --- tasks ---
    #: Max times a task is retried on system failure (per task:
    #: options(max_retries=...)).
    task_max_retries: int = 3

    # --- collectives ---
    #: Seconds a rank waits in a thread-tier collective rendezvous before it
    #: withdraws and raises, so a lost rank cannot hold the others hostage
    #: (per group: init_collective_group's timeout_s).
    collective_timeout_s: float = 300.0

    # --- events ---
    #: Keep at most this many task events.
    max_task_events: int = 100_000

    # --- testing / chaos (ref: rpc/rpc_chaos.h:22, RAY_testing_rpc_failure) ---
    #: "<point>=<probability>[:<max_failures>]" comma list; the named failure
    #: points raise a transient error (_private/fault_injection.py).
    testing_rpc_failure: str = ""

    # --- control-plane persistence (ref: gcs_kv_manager.h) ---
    #: Persist the internal KV to a WAL under session_dir, so deployed serve
    #: applications survive a restart of the process.
    kv_persist: bool = False
    session_dir: str = field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch_session"))

    def apply_overrides(self, system_config: Optional[Dict[str, Any]] = None) -> None:
        for f in fields(self):
            if f.name == "generation":
                continue
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is not None:
                setattr(self, f.name, _coerce(env, f.type))
        for key, val in (system_config or {}).items():
            if not hasattr(self, key):
                raise ValueError(f"Unknown system config key: {key}")
            setattr(self, key, val)
        self.generation += 1


def _coerce(value: str, typ: Any) -> Any:
    typ = str(typ)
    if "bool" in typ:
        return value.lower() in ("1", "true", "yes")
    if "int" in typ:
        return int(value)
    if "float" in typ:
        return float(value)
    return value


GLOBAL_CONFIG = Config()


def session_subdir(name: str, env_var: str, *, export: bool = False) -> str:
    """Resolve <session_dir>/<name>, unless ``env_var`` names a directory
    (e.g. ``RAY_TPU_POSTMORTEM_DIR``), and create it. ``export=True``
    resolves from the live config and publishes that path in ``env_var``
    before the driver spawns process workers, which see only the config's
    defaults: a later runtime with another ``session_dir`` exports its own."""
    env = os.environ.get(env_var)
    if env and not export:
        os.makedirs(env, exist_ok=True)
        return env
    d = os.path.join(GLOBAL_CONFIG.session_dir, name)
    os.makedirs(d, exist_ok=True)
    if export:
        os.environ[env_var] = d
    return d
