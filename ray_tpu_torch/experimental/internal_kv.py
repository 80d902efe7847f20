"""Internal KV API (the counterpart of ``ray_tpu/experimental/internal_kv.py``;
ref: python/ray/experimental/internal_kv.py — _internal_kv_get/put/del/
exists/list over the GCS KV tier).

One store per driver, created at first use; in a process worker the calls
go over the worker's backchannel to the driver's store (the reference's one
KV tier per cluster). Persistence is opt-in via
``RAY_TPU_KV_PERSIST=1`` (or ``_system_config={"kv_persist": True}``),
which writes a WAL under the session dir so control-plane metadata (the
serve controller's applications) survives a restart.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Union

from ray_tpu_torch._private.kv_store import KVStore

_store: Optional[KVStore] = None
_lock = threading.Lock()


def _get_store() -> KVStore:
    global _store
    with _lock:
        if _store is None:
            from ray_tpu_torch._private.config import GLOBAL_CONFIG

            path = None
            if GLOBAL_CONFIG.kv_persist:
                path = os.path.join(GLOBAL_CONFIG.session_dir, "internal_kv.jsonl")
            _store = KVStore(persist_path=path)
        return _store


def _remote_call():
    """The driver-routing callable when this process is a worker (its
    runtime proxies the nested API), else None (this is the driver)."""
    from ray_tpu_torch._private.runtime import runtime_or_none

    return getattr(runtime_or_none(), "kv_call", None)


def _internal_kv_reset() -> None:
    """Testing hook: drop the in-memory store (the WAL, if any, remains —
    a fresh store replays it, which is exactly the restart path)."""
    global _store
    with _lock:
        if _store is not None:
            _store.close()
        _store = None


def _as_bytes(v: Union[str, bytes]) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


def _internal_kv_initialized() -> bool:
    return True  # no external service to wait for


def _internal_kv_get(key: Union[str, bytes], *, namespace: str = "") -> Optional[bytes]:
    call = _remote_call()
    if call is not None:
        return call("get", _as_bytes(key), namespace)
    return _get_store().get(_as_bytes(key), namespace=namespace)


def _internal_kv_put(key: Union[str, bytes], value: Union[str, bytes],
                     overwrite: bool = True, *, namespace: str = "") -> bool:
    """Returns True when the key ALREADY EXISTED (whether or not it was then
    overwritten) — the reference's inverted contract, where GCS Put reports
    added=0 for any existing key."""
    call = _remote_call()
    if call is not None:
        return call("put", _as_bytes(key), _as_bytes(value), overwrite,
                    namespace)
    newly_added = _get_store().put(_as_bytes(key), _as_bytes(value),
                                   overwrite=overwrite, namespace=namespace)
    return not newly_added


def _internal_kv_del(key: Union[str, bytes], *, namespace: str = "") -> int:
    call = _remote_call()
    if call is not None:
        return call("del", _as_bytes(key), namespace)
    return _get_store().delete(_as_bytes(key), namespace=namespace)


def _internal_kv_exists(key: Union[str, bytes], *, namespace: str = "") -> bool:
    call = _remote_call()
    if call is not None:
        return call("exists", _as_bytes(key), namespace)
    return _get_store().exists(_as_bytes(key), namespace=namespace)


def _internal_kv_list(prefix: Union[str, bytes], *, namespace: str = "") -> List[bytes]:
    call = _remote_call()
    if call is not None:
        return call("list", _as_bytes(prefix), namespace)
    return _get_store().keys(_as_bytes(prefix), namespace=namespace)
