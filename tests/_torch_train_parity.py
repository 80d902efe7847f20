"""Running one Train-library case on the reference (``ray_tpu``) and on the
port (``ray_tpu_torch``), each in a runtime of its own.

A case is a function of the package that returns what it observed; its
bodies that run in ranks are defined inside it, so both packages send them
by value. The two runtimes never run at once: the reference's half runs
first, under ``gc_paused`` (tests/_torch_runtimes.py says why), then the
port's. ``observe`` reduces tensors and arrays to numpy so the two halves
compare with ``assert_same``: integers and dtypes exactly, floats within
``atol``.
"""

import numpy as np
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused

CASE_S = 240  # seconds one package's half of a case may take


def run(pkg, case, *args, init=None):
    fresh_init(pkg, **(init or {"num_cpus": 4}))
    try:
        return observe(bounded(lambda: case(pkg, *args), CASE_S))
    finally:
        pkg.shutdown()


def both(case, *args, init=None):
    """(reference's observation, port's observation)."""
    with gc_paused():
        ref = run(ray_tpu, case, *args, init=init)
    return ref, run(ray_tpu_torch, case, *args, init=init)


def observe(x):
    if isinstance(x, dict):
        return {k: observe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [observe(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, (str, bytes)):
        return np.asarray(x)
    return x


def assert_same(ref, port, atol=1e-6, path="obs"):
    """Equal structure; arrays of the same dtype and shape, integers and
    booleans exactly, floats within ``atol``."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(ref) == list(port), path
        for k in ref:
            assert_same(ref[k], port[k], atol, f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(ref) == len(port), path
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, atol, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        port = np.asarray(port)
        assert (ref.dtype, ref.shape) == (port.dtype, port.shape), \
            (path, ref.dtype, ref.shape, port.dtype, port.shape)
        if ref.dtype.kind == "f":
            np.testing.assert_allclose(port, ref, rtol=0, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(port, ref, err_msg=path)
    elif isinstance(ref, float):
        assert abs(ref - port) <= atol, (path, ref, port)
    else:
        assert ref == port, (path, ref, port)


def raises(fn):
    """The class name of what ``fn`` raises (None if it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return type(e).__name__
    return None
