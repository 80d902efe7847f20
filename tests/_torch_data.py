"""Running one Ray Data case on the reference (``ray_tpu.data``) and on the
port (``ray_tpu_torch.data``), and reducing what each observed to plain
Python values that compare exactly.

A case is a function of the package and its ``data`` module that returns
what it observed. The two runtimes never run at once: the reference's half
runs first, under ``gc_paused`` (tests/_torch_runtimes.py says why), then
the port's.
"""

import importlib
import math

import numpy as np

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init, gc_paused


def run_case(pkg, case, *args, **init_kwargs):
    data = importlib.import_module(pkg.__name__ + ".data")
    fresh_init(pkg, **({"num_cpus": 4} | init_kwargs))
    try:
        return case(pkg, data, *args)
    finally:
        pkg.shutdown()


def both(case, *args, ref_args=None, port_args=None, **kwargs):
    """(reference's observation, port's observation); ``ref_args`` and
    ``port_args`` replace ``args`` for one side (its own tmp directory)."""
    with gc_paused():
        ref = run_case(ray_tpu, case, *(ref_args or args), **kwargs)
    port = run_case(ray_tpu_torch, case, *(port_args or args), **kwargs)
    return norm(ref), norm(port)


def norm(x):
    """Numpy scalars and arrays to Python values, NaN to the string "nan"
    (so that NaN equals NaN), tuples to lists, dict keys kept in order."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return {"dtype": str(x.dtype) if x.dtype != object else "object",
                "shape": list(x.shape), "values": norm(x.tolist())}
    if isinstance(x, np.generic):
        return norm(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def raises(fn):
    """The class name and message of what ``fn`` raises (None if it
    returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return type(e).__name__, str(e)
    return None
