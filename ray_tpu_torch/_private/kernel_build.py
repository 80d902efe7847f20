"""Builds the hand-written CUDA kernels in ``ray_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, which Python loads with ``ctypes``. Libraries land
in ``ray_tpu_torch/_build/<digest>/``, where the digest covers the sources
and the flags, so an edited source is rebuilt and an unchanged one is not.
Several sources are compiled at once, one ``nvcc`` each.

There is no fallback: a missing ``nvcc`` or a failed compile raises.
``NVCC_RUNS`` counts this process's compiles and ``LOAD_SECONDS`` the time
each library took to become usable in it (its build included): a process
worker loads the libraries the process that spawned it built and compiles
none. When the device-telemetry plane is loaded, each successful ``nvcc``
run is recorded there as a compile (label ``kernel:<name>``, its wall
seconds, the build digest as its signature); a load from an existing build
records none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"

# sm_90a: wgmma and setmaxnreg exist only for that target.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

#: nvcc processes this process started.
NVCC_RUNS = 0
#: Seconds from the first ``load(name)`` to the library being loaded.
LOAD_SECONDS: Dict[str, float] = {}


def find_nvcc() -> str:
    """Path of ``nvcc`` on PATH or under ``$CUDA_HOME/bin``
    (default ``/usr/local/cuda``); raises if there is none."""
    cuda_bin = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    nvcc = shutil.which("nvcc") or shutil.which("nvcc", path=cuda_bin)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
            "ray_tpu_torch are built from source and need the CUDA toolkit")
    return nvcc


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """``_build/<digest of every source under csrc/ and the flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def nvcc_command(nvcc: str, source: Path, output: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compiles the named kernels (default: all) that are not built yet, all
    at once, and returns each one's library path. Raises with the compiler's
    output if any compile fails."""
    names = list(kernel_names() if names is None else names)
    out_dir = build_dir()
    libs = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n in names if not libs[n].exists()]
    if not todo:
        return libs
    global NVCC_RUNS
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        src = CSRC_DIR / f"{n}.cu"
        if not src.exists():
            raise FileNotFoundError(f"no kernel source {src}")
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            nvcc_command(nvcc, src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        NVCC_RUNS += 1
    # One waiter per nvcc, so each run's wall time ends when it does.
    ended: Dict[str, tuple] = {}

    def wait(n, started, proc):
        log, _ = proc.communicate()
        ended[n] = (log, time.perf_counter() - started)

    waiters = [threading.Thread(target=wait, args=(n, started, proc))
               for n, (_tmp, started, proc) in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failed = []
    for n, (tmp, _started, proc) in procs.items():
        log, seconds = ended[n]
        (out_dir / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[n])
            _record_build(n, out_dir.name, seconds)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def _record_build(name: str, digest: str, seconds: float) -> None:
    """One nvcc run into the device-telemetry plane, if it is loaded (a
    probe: this module imports nothing of the port)."""
    telemetry = sys.modules.get("ray_tpu_torch.util.device_telemetry")
    if telemetry is not None:
        telemetry.record_compile(f"kernel:{name}", shapes=digest,
                                 compile_s=seconds)


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory use) for a built kernel."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
            LOAD_SECONDS[name] = time.perf_counter() - t0
        return lib
