"""Sync-to-executor dispatch shared by the serve data plane (the
counterpart of ``ray_tpu/serve/_sync.py``).

Replica request handlers run as asyncio tasks on the replica's event loop;
a sync (non-async) user callable executed inline would stall every
concurrent request on that replica (ref: the reference runs sync callables
in a thread via ``run_user_code`` executor dispatch — replica.py
UserCallableWrapper._run_user_code).  Everything here funnels sync user
code onto worker threads while propagating the caller's contextvars, so
``serve.context`` (the replica context) stays visible inside the
dispatched call.
"""

from __future__ import annotations

import asyncio
import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

#: Fallback pool for call sites with no per-replica executor.
_DEFAULT_POOL: Optional[ThreadPoolExecutor] = None  # guarded_by: _POOL_LOCK
_POOL_LOCK = threading.Lock()


def default_pool() -> ThreadPoolExecutor:
    global _DEFAULT_POOL
    with _POOL_LOCK:
        if _DEFAULT_POOL is None:
            _DEFAULT_POOL = ThreadPoolExecutor(
                max_workers=32, thread_name_prefix="serve-sync")
        return _DEFAULT_POOL


async def run_in_executor(fn: Callable, *args: Any,
                          executor: Optional[ThreadPoolExecutor] = None,
                          **kwargs: Any) -> Any:
    """Run ``fn(*args, **kwargs)`` on a worker thread, awaitably.

    ``loop.run_in_executor`` does NOT propagate contextvars (unlike
    ``asyncio.to_thread``), so the caller's context is captured and the
    call is replayed inside it — user code dispatched off-loop still sees
    the serve replica context.
    """
    ctx = contextvars.copy_context()
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        executor or default_pool(), lambda: ctx.run(fn, *args, **kwargs))
