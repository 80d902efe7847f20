"""Internal key-value store with optional on-disk persistence (the
counterpart of ``ray_tpu/_private/kv_store.py``).

The analogue of the reference's GCS KV tier: the API mirrors
``ray.experimental.internal_kv`` (ref: python/ray/experimental/
internal_kv.py — _internal_kv_get/put/del/exists/keys over namespaces)
backed by the control plane's pluggable storage
(ref: src/ray/gcs/gcs_server/gcs_kv_manager.h GcsKvManager;
src/ray/gcs/store_client/ — InMemoryStoreClient vs RedisStoreClient for a
restartable head).  Here the persistence tier is an append-only JSONL WAL
under the session dir: every mutation appends, a fresh runtime replays it,
and compaction rewrites the live set when the log grows past a threshold —
so control-plane metadata (function exports, serve/app configs, workflow
indices, user keys) survives a head restart the way the reference's
Redis-backed GCS does.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Dict, List, Optional


class KVStore:
    """Namespaced bytes->bytes store; thread-safe; optionally persistent."""

    def __init__(self, persist_path: Optional[str] = None,
                 compact_threshold: int = 10_000):
        self._data: Dict[str, Dict[bytes, bytes]] = {}
        self._lock = threading.RLock()
        self._persist_path = persist_path
        self._wal = None  # persistent append handle (one open, not per-write)
        self._mutations = 0
        self._compact_threshold = compact_threshold
        if persist_path:
            os.makedirs(os.path.dirname(persist_path) or ".", exist_ok=True)
            if os.path.exists(persist_path):
                self._replay()
            self._wal = open(persist_path, "a")

    # ----------------------------------------------------------------- basic
    def get(self, key: bytes, namespace: str = "") -> Optional[bytes]:
        with self._lock:
            return self._data.get(namespace, {}).get(bytes(key))

    def put(self, key: bytes, value: bytes, overwrite: bool = True,
            namespace: str = "") -> bool:
        """Returns True iff the key was NEWLY added (matching the GCS Put
        contract: an overwrite of an existing key reports added=0)."""
        key, value = bytes(key), bytes(value)
        with self._lock:
            ns = self._data.setdefault(namespace, {})
            existed = key in ns
            if not overwrite and existed:
                return False
            ns[key] = value
            self._log({"op": "put", "ns": namespace,
                       "k": _b64(key), "v": _b64(value)})
            return not existed

    def delete(self, key: bytes, namespace: str = "") -> int:
        key = bytes(key)
        with self._lock:
            ns = self._data.get(namespace, {})
            if key in ns:
                del ns[key]
                self._log({"op": "del", "ns": namespace, "k": _b64(key)})
                return 1
            return 0

    def exists(self, key: bytes, namespace: str = "") -> bool:
        with self._lock:
            return bytes(key) in self._data.get(namespace, {})

    def keys(self, prefix: bytes = b"", namespace: str = "") -> List[bytes]:
        prefix = bytes(prefix)
        with self._lock:
            return [k for k in self._data.get(namespace, {})
                    if k.startswith(prefix)]

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {ns: len(kv) for ns, kv in self._data.items()}

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                try:
                    self._wal.close()
                finally:
                    self._wal = None

    # ------------------------------------------------------------ durability
    def _log(self, record: dict) -> None:
        """Caller holds the lock."""
        if self._wal is None:
            return
        self._wal.write(json.dumps(record) + "\n")
        self._wal.flush()
        self._mutations += 1
        if self._mutations >= self._compact_threshold:
            self._compact()

    def _replay(self) -> None:
        with open(self._persist_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write from a crash: ignore
                ns = self._data.setdefault(rec.get("ns", ""), {})
                if rec["op"] == "put":
                    ns[_unb64(rec["k"])] = _unb64(rec["v"])
                elif rec["op"] == "del":
                    ns.pop(_unb64(rec["k"]), None)

    def _compact(self) -> None:
        """Rewrite the WAL as the live set (caller holds the lock)."""
        tmp = self._persist_path + ".tmp"
        with open(tmp, "w") as f:
            for ns, kv in self._data.items():
                for k, v in kv.items():
                    f.write(json.dumps({"op": "put", "ns": ns,
                                        "k": _b64(k), "v": _b64(v)}) + "\n")
        self._wal.close()
        os.replace(tmp, self._persist_path)
        self._wal = open(self._persist_path, "a")
        self._mutations = 0


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)
