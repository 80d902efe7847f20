"""joblib backend over ray_tpu_torch (the counterpart of
``ray_tpu/util/joblib.py``; ref: python/ray/util/joblib/ — register_ray +
RayBackend): `register_ray()` then
`with joblib.parallel_backend("ray_tpu"): ...` runs scikit-learn-style
Parallel() workloads as cluster tasks.

joblib is imported when the backend class is first needed
(``register_ray()`` or the attribute ``RayTpuBackend``), not when this
module is: joblib loads psutil, which no module of the port loads at import.
Without joblib (the card's machine has none) the class takes the
placeholder bases below, so the module imports and the class builds there.
"""

from __future__ import annotations

from typing import Optional

import ray_tpu_torch


def register_ray() -> None:
    """Register the 'ray_tpu' joblib parallel backend."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu", _backend_class())


class _AutoBatchingMixin:
    """Distinct placeholder bases — aliasing all three to ``object``
    would raise 'duplicate base class' at class creation."""


class _PoolManagerMixin:
    pass


def _bases() -> tuple:
    try:  # keep the class buildable without joblib
        from joblib._parallel_backends import (
            AutoBatchingMixin,
            ParallelBackendBase,
            PoolManagerMixin,
        )
    except ImportError:
        return (_PoolManagerMixin, _AutoBatchingMixin, object)
    return (PoolManagerMixin, AutoBatchingMixin, ParallelBackendBase)


class _RayTpuBackendMethods:
    """Each joblib batch becomes one cluster task, dispatched through the
    multiprocessing Pool shim (ref: util/joblib RayBackend, which wraps
    ray.util.multiprocessing.Pool the same way)."""

    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def effective_n_jobs(self, n_jobs: Optional[int]) -> int:
        if n_jobs == 1:
            return 1
        cpus = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        if n_jobs is None or n_jobs == -1:
            return cpus
        return min(n_jobs, cpus) if n_jobs > 0 else cpus

    def configure(self, n_jobs: int = 1, parallel=None, prefer=None,
                  require=None, **memmapping_args) -> int:
        from ray_tpu_torch.util.multiprocessing import Pool

        ray_tpu_torch.init(ignore_reinit_error=True)
        n_jobs = self.effective_n_jobs(n_jobs)
        self.parallel = parallel
        self._pool = Pool(processes=n_jobs)
        return n_jobs


_BACKEND: Optional[type] = None


def _backend_class() -> type:
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = type("RayTpuBackend", (_RayTpuBackendMethods, *_bases()),
                        {"__module__": __name__,
                         "__doc__": _RayTpuBackendMethods.__doc__})
    return _BACKEND


def __getattr__(name: str):
    if name == "RayTpuBackend":
        return _backend_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
