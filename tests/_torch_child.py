"""Running one half of a parity case in a child interpreter.

The reference's process-tier lanes read its shared-memory arena from
threads that can outlive the arena at shutdown, and its arena's close frees
the native handle under a blocking get: a segfault there would take down
the whole test process, and with it every test it was to run. The cases
that drive those lanes run the reference's half through ``in_child``: a
fresh interpreter (``JAX_PLATFORMS=cpu``) imports the test module, runs
one of its functions and prints the JSON observation, so a crash fails
that one case.
"""

import json
import os
import subprocess
import sys

_MARK = "@@observation "


def in_child(module: str, func: str, *args, timeout: float = 240.0):
    """``module.func(*args)`` in a child interpreter; its JSON-able return
    value, or AssertionError with the child's exit code and stderr."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import json, sys\n"
        f"sys.path[:0] = {[here, os.path.dirname(here)]!r}\n"
        f"import {module} as m\n"
        f"out = m.{func}(*{list(args)!r})\n"
        f"print({_MARK!r} + json.dumps(out), flush=True)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)
    for line in done.stdout.splitlines():
        if line.startswith(_MARK):
            return json.loads(line[len(_MARK):])
    raise AssertionError(
        f"{module}.{func} in a child interpreter exited {done.returncode} "
        f"without an observation:\n{done.stderr[-4000:]}")


def as_json(value):
    """``value`` as the child's observation arrives (tuples as lists)."""
    return json.loads(json.dumps(value))
