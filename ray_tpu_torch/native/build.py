"""Builds the port's native C++ components into shared libraries (the
counterpart of ``ray_tpu/native/build.py``).

A library is compiled with ``g++ -O2 -shared -fPIC`` at first use, keyed by
a hash of its sources, into ``ray_tpu_torch/_build/native/``, so an edited
source is rebuilt and an unchanged one is loaded as built. The output is
written under a name with the builder's pid and moved into place with one
``os.replace``, so several processes (test workers, a driver and its process
workers) can build at once. There is no fallback: a missing ``g++`` or a
failed compile raises with the compiler's message.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build", "native")
_LOCK = threading.Lock()

FLAGS = ("-O2", "-g", "-std=c++17", "-Wall", "-Werror", "-pthread",
         "-shared", "-fPIC")


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library(name: str, sources) -> str:
    """Compile ``sources`` (paths relative to src/) into
    ``lib<name>-<digest>.so`` and return its path; a no-op when that build
    exists. Stale builds of the same library are removed, never another
    process's output in flight."""
    srcs = [os.path.join(_SRC, s) for s in sources]
    prefix = f"lib{name}-"
    out = os.path.join(_BUILD, f"{prefix}{_source_hash(srcs)}.so")
    if os.path.exists(out):
        return out
    with _LOCK:
        if os.path.exists(out):
            return out
        os.makedirs(_BUILD, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        cmd = ["g++", *FLAGS, "-o", tmp, *srcs]
        try:
            # blocking_ok: compile-once cache; the lock serialises builders
            done = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"cannot build the shared-memory arena: {cmd[0]!r} failed "
                f"to start ({e}); the object store needs g++") from e
        if done.returncode != 0:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise RuntimeError(
                f"building {os.path.basename(out)} failed (exit "
                f"{done.returncode}):\n{done.stderr.strip()}")
        os.replace(tmp, out)
        for f in os.listdir(_BUILD):
            if f.startswith(prefix) and f != os.path.basename(out) \
                    and ".tmp" not in f:
                try:
                    os.unlink(os.path.join(_BUILD, f))
                except OSError:
                    pass
    return out


def plasma_library() -> str:
    return build_library("torchplasma", ["plasma.cc"])
