"""The compile tap of the port (the counterpart of ``InstrumentedJit`` and
``instrumented_jit`` in ``ray_tpu/_private/jax_compat.py``).

The reference times each trace/lower/compile of a jitted step and records
it into the device-telemetry plane with a classified trigger. The port runs
eagerly and has no such compile; what takes its place is a step function's
first call at a new abstract signature: the call that builds the kernels it
reaches, picks cuBLAS algorithms and grows the caching allocator.
:func:`instrumented_step` wraps a step function, keys its calls by the
reference's signature rules, and times and records each first call
(waiting for the devices it ran on); later calls at a seen signature go
straight through.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple


class InstrumentedStep:
    """A step function with a compile tap: the first call at each abstract
    signature is timed (to the end of its device work) and recorded into
    :mod:`ray_tpu_torch.util.device_telemetry` with a classified trigger
    (first_compile / shape_change / sharding_change). Positional arguments
    only, as the repo calls its steps."""

    def __init__(self, fn: Callable, *, label: Optional[str] = None):
        self._fn = fn
        self.label = label or getattr(fn, "__name__", "step_fn")
        #: the signatures seen, as (shapes, devices) pairs
        self._cache: List[Tuple[Any, Any]] = []

    @staticmethod
    def _signature(args) -> Tuple[Any, Any]:
        """(shapes, devices) of the positional args: tensor and array
        leaves by shape and dtype (plus the pytree structure), Python
        scalars by type (a changed value is not a changed signature), and
        each tensor's device where the reference keys the sharding."""
        import torch
        from torch.utils import _pytree

        leaves, spec = _pytree.tree_flatten(args)
        shapes, devices = [], []
        for leaf in leaves:
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            if shape is None or dtype is None:
                shapes.append(type(leaf).__name__)
                devices.append(None)
            else:
                shapes.append((tuple(shape), dtype))
                devices.append(leaf.device if isinstance(leaf, torch.Tensor)
                               else None)
        return (tuple(shapes), spec), tuple(devices)

    def __call__(self, *args):
        key = self._signature(args)
        if key in self._cache:
            return self._fn(*args)
        t0 = time.perf_counter()
        out = self._fn(*args)
        _synchronize(key[1])
        seconds = time.perf_counter() - t0
        self._cache.append(key)
        from ray_tpu_torch.util import device_telemetry

        device_telemetry.record_compile(self.label, shapes=key[0],
                                        shardings=key[1], compile_s=seconds)
        return out


def _synchronize(devices) -> None:
    """Wait for the CUDA devices among ``devices``."""
    import torch

    for dev in {d for d in devices if d is not None and d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def instrumented_step(fn: Callable, *, label: Optional[str] = None
                      ) -> InstrumentedStep:
    """Wrap ``fn`` so that each first call at a new abstract signature is
    recorded into the device-telemetry plane (see :class:`InstrumentedStep`)."""
    return InstrumentedStep(fn, label=label)
