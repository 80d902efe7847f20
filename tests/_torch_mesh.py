"""A world of gloo processes for the port's device-mesh tests.

``world(n)`` gives n rank processes joined in one ``torch.distributed``
process group over gloo on the CPU, started once per test process and
reused by the cases that ask for the same size in a row (a case builds its
own mesh, so nothing carries over but the process group). ``World.run(fn,
*args)`` calls ``fn(*args)`` in every rank and returns the ranks' results
in rank order; ``fn`` is a module-level function of ``_torch_mesh_cases``
or ``_torch_cp_cases``, which import torch and the port and never JAX.

The ranks are forked from a forkserver that has imported torch and the
port and run nothing, so a world starts in about a second after the
server's first start; a rank that raises fails the call with its
traceback, and a call that does not end within ``CALL_S`` seconds (a rank
waiting in a collective that another never reached) kills the world.
"""

import atexit
import multiprocessing as mp
import os
import signal
import socket
import time
import traceback
from multiprocessing.connection import wait

CALL_S = 300.0
_PRELOAD = ["torch", "torch.distributed", "numpy", "ray_tpu_torch.models.gpt2",
            "ray_tpu_torch.models.llama", "ray_tpu_torch.models.vit",
            "ray_tpu_torch.models.moe", "ray_tpu_torch.parallel",
            "_torch_mesh_cases", "_torch_cp_cases"]
_worlds = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, port: int, conn) -> None:
    import faulthandler
    import signal

    import torch
    import torch.distributed as dist

    faulthandler.register(signal.SIGUSR1, all_threads=False)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args = msg
            try:
                conn.send(("ok", fn(*args)))
            except BaseException:  # noqa: BLE001 — sent to the test
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int):
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(_PRELOAD)
        port = _free_port()
        self.n = n
        self._conns, self._procs = [], []
        for rank in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(rank, n, port, child),
                            daemon=True)
            p.start()
            self._conns.append(parent)
            self._procs.append(p)

    def run(self, fn, *args):
        for c in self._conns:
            c.send((fn, args))
        out = {}
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + CALL_S
        while pending:
            ready = wait(list(pending.values()),
                         max(0.0, deadline - time.monotonic()))
            if not ready:
                for rank in pending:  # their stacks, to the test's stderr
                    os.kill(self._procs[rank].pid, signal.SIGUSR1)
                time.sleep(1.0)
                self.kill()
                raise TimeoutError(f"ranks {sorted(pending)} gave no result "
                                   f"of {fn.__name__} within {CALL_S} s")
            for rank, c in list(pending.items()):
                if c in ready:
                    status, value = c.recv()
                    if status == "error":
                        self.kill()
                        raise AssertionError(f"rank {rank}: {value}")
                    out[rank] = value
                    del pending[rank]
        return [out[r] for r in range(self.n)]

    def kill(self) -> None:
        _worlds.pop(self.n, None)
        for p in self._procs:
            p.kill()
            p.join(5)

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(None)
            except OSError:
                pass
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()


def world(n: int) -> World:
    """The world of ``n`` ranks; one world at a time is kept (about 180 MB
    a rank), so asking for another size closes the one before."""
    w = _worlds.get(n)
    if w is None or not all(p.is_alive() for p in w._procs):
        _close_all()
        w = _worlds[n] = World(n)
    return w


@atexit.register
def _close_all() -> None:
    for w in list(_worlds.values()):
        w.close()
    _worlds.clear()

