"""Worker-side runtime proxy: the full API from inside a process worker (the
counterpart of ``ray_tpu/_private/client_runtime.py``, its nested-API half;
the ``ray://`` client of ``util/client`` is not ported).

The reference's nested-task support: every worker
process embeds a core worker that can submit tasks back to the cluster
(ref: src/ray/core_worker/core_worker.h:166 — task submission from any
worker; python/ray/util/client/ — the proxy pattern).  Here the child
process installs a ``ClientRuntime`` as its global runtime; API calls
(`remote`/`get`/`put`/`wait`/actor ops) become request/response messages
over a dedicated backchannel pipe to the driver, which executes them
against the real Runtime.

One request is in flight per worker at a time (child-side lock); the driver
services each worker's backchannel on its own daemon thread, so a child
blocking in ``get`` never wedges the driver's dispatcher.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Sequence

from ray_tpu_torch._private import serialization
from ray_tpu_torch._private.process_pool import recv_bytes


class _ProxiedRefGenerator:
    """Worker-side face of a driver-hosted ObjectRefGenerator: each pull is
    one nested-API round trip returning the next yielded ObjectRef (streaming
    submission from process workers; ref: _raylet.pyx streaming generator
    protocol)."""

    def __init__(self, call, token: str):
        self._call = call
        self._token = token
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        kind, ref = self._call("gen_next", self._token)
        if kind == "done":
            self._done = True
            raise StopIteration
        return ref

    def cancel(self) -> None:
        if not self._done:
            self._done = True
            try:
                self._call("gen_cancel", self._token)
            except Exception:
                pass

    def __del__(self):
        try:
            self.cancel()
        except Exception:
            pass


class ClientRuntime:
    """Installed as the global runtime inside process workers."""

    def __init__(self, conn, worker_id: str = "", namespace: str = "default"):
        self._conn = conn
        self._lock = threading.Lock()
        self.worker_id = worker_id or "proc-worker"
        self.namespace = namespace

    # ------------------------------------------------------------- transport
    def _call(self, kind: str, *payload) -> Any:
        # In-band: the head deserializes while this call blocks, inside the
        # sender's handle lifetime — wire pins would be pure overhead.
        req = serialization.dumps_inband((kind, payload))
        with self._lock:
            self._conn.send_bytes(req)
            status, blob = serialization.loads(recv_bytes(self._conn))
        if status == "err":
            exc, tb = serialization.loads(blob)
            raise exc
        return serialization.deserialize_flat(memoryview(blob))

    # ------------------------------------------------------------ public API
    def submit_task(self, spec) -> Any:
        if spec.generator:
            token = self._call("submit_task_gen",
                               serialization.dumps_inband(spec))
            return _ProxiedRefGenerator(self._call, token)
        return self._call("submit_task", serialization.dumps_inband(spec))

    def submit_actor_task(self, actor_id, spec) -> Any:
        if spec.generator:
            token = self._call("submit_actor_task_gen", actor_id,
                               serialization.dumps_inband(spec))
            return _ProxiedRefGenerator(self._call, token)
        return self._call("submit_actor_task", actor_id,
                          serialization.dumps_inband(spec))

    def create_actor(self, spec) -> None:
        return self._call("create_actor", serialization.dumps_inband(spec))

    def put(self, value: Any) -> Any:
        return self._call("put", serialization.dumps_inband(value))

    def get(self, refs: Any, timeout: Optional[float] = None) -> Any:
        return self._call("get", serialization.dumps_inband(refs), timeout)

    def wait(self, refs: Sequence, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True):
        refs = list(refs)
        ready_idx, rest_idx = self._call(
            "wait", serialization.dumps_inband(refs), num_returns, timeout)
        return [refs[i] for i in ready_idx], [refs[i] for i in rest_idx]

    def kill_actor(self, actor_id, no_restart: bool = True) -> None:
        return self._call("kill_actor", actor_id, no_restart)

    def cancel(self, ref, force: bool = False) -> None:
        return self._call("cancel", serialization.dumps_inband(ref), force)

    def get_named_actor(self, name: str, namespace: Optional[str] = None):
        return self._call("get_named_actor", name, namespace)

    def cluster_resources(self):
        return self._call("cluster_resources")

    def available_resources(self):
        return self._call("available_resources")

    def nodes(self):
        return self._call("nodes")

    def list_task_events(self):
        return self._call("list_task_events")

    def kv_call(self, op: str, *args) -> Any:
        """Route an internal-KV operation to the driver's store so the KV
        tier is one per cluster, as the reference's GCS KV is (a
        worker-local store would silently diverge from the driver's)."""
        return self._call("internal_kv", op, *args)

    def get_actor_state(self, actor_id):
        # Worker-side callers (ray_tpu.get_actor) need .spec.cls and
        # .spec.max_task_retries plus .state — return a lightweight shim.
        cls, max_task_retries, state_name = self._call("actor_info", actor_id)

        class _Spec:
            pass

        class _State:
            pass

        spec = _Spec()
        spec.cls = cls
        spec.max_task_retries = max_task_retries
        shim = _State()
        shim.spec = spec
        shim.state = state_name
        return shim

    def shutdown(self) -> None:
        """A process worker never closes its backchannel: the driver owns
        that lifecycle, and a user task calling shutdown() inside a pooled
        worker would otherwise wedge the worker."""


def serve_backchannel(conn, describe: str = "") -> None:
    """Driver-side loop: service one worker's nested-API requests.

    Runs on a daemon thread per worker; exits when the worker's pipe closes.
    """
    from ray_tpu_torch._private.runtime import runtime_or_none

    # Refs handed to the child are BORROWED: the driver must keep them alive
    # or the refcounter frees results the moment the reply tuple is GC'd
    # (ref: reference_count.h borrower protocol — here the borrow lives until
    # the worker disconnects, which clears this dict).
    borrowed: dict = {}
    state: dict = {"gens": {}}  # live proxied generators, per connection
    while True:
        try:
            msg = recv_bytes(conn)
        except (EOFError, OSError):
            return
        try:
            kind, payload = serialization.loads(msg)
            runtime = runtime_or_none()
            if runtime is None:
                raise RuntimeError(
                    "driver runtime is gone; nested call cannot be served")
            result = _handle(runtime, kind, payload, state=state)
            sobj = serialization.serialize(result)
            if kind != "gen_next":
                # gen_next replies are pinned by their stream's token entry
                # (released when the stream ends) — parking them here too
                # would hold every streamed item for the CONNECTION's life.
                for r in sobj.contained_refs:
                    borrowed[r.id] = r
            reply = ("ok", sobj.to_bytes())
        except BaseException as e:  # noqa: BLE001 — errors cross the boundary
            import traceback

            tb = traceback.format_exc()
            try:
                blob = serialization.dumps((e, tb))
            except Exception:
                blob = serialization.dumps((RuntimeError(repr(e)), tb))
            reply = ("err", blob)
        try:
            conn.send_bytes(serialization.dumps(reply))
        except (EOFError, OSError, BrokenPipeError):
            return


def _handle(runtime, kind: str, payload: tuple, state: dict = None) -> Any:
    if kind == "submit_task":
        return runtime.submit_task(serialization.loads(payload[0]))
    if kind == "submit_actor_task":
        return runtime.submit_actor_task(payload[0],
                                         serialization.loads(payload[1]))
    if kind in ("submit_task_gen", "submit_actor_task_gen"):
        # Streaming submission: host the driver-side ObjectRefGenerator,
        # hand back a pull token (the worker iterates via gen_next).
        import uuid

        if state is None:
            raise RuntimeError("streaming submission needs per-connection "
                               "state (gen tokens)")
        if kind == "submit_task_gen":
            gen = runtime.submit_task(serialization.loads(payload[0]))
        else:
            gen = runtime.submit_actor_task(
                payload[0], serialization.loads(payload[1]))
        token = uuid.uuid4().hex[:16]
        # refs: driver-side handles for yielded items, holding them alive
        # until the STREAM ends (not the connection — a long-lived worker
        # must not pin every item it ever streamed).
        state.setdefault("gens", {})[token] = {"gen": gen, "refs": []}
        return token
    if kind == "gen_next":
        entry = (state or {}).get("gens", {}).get(payload[0])
        if entry is None:
            raise ValueError(f"unknown or finished generator {payload[0]!r}")
        try:
            ref = next(entry["gen"])
            entry["refs"].append(ref)
            return ("item", ref)
        except StopIteration:
            state["gens"].pop(payload[0], None)
            return ("done", None)
        except BaseException:
            state["gens"].pop(payload[0], None)
            raise
    if kind == "gen_cancel":
        (state or {}).get("gens", {}).pop(payload[0], None)
        return None
    if kind == "create_actor":
        return runtime.create_actor(serialization.loads(payload[0]))
    if kind == "put":
        return runtime.put(serialization.loads(payload[0]))
    if kind == "get":
        return runtime.get(serialization.loads(payload[0]), timeout=payload[1])
    if kind == "wait":
        refs = serialization.loads(payload[0])
        ready, rest = runtime.wait(refs, num_returns=payload[1],
                                   timeout=payload[2])
        ready_ids = {r.id for r in ready}
        ready_idx = [i for i, r in enumerate(refs) if r.id in ready_ids]
        rest_idx = [i for i, r in enumerate(refs) if r.id not in ready_ids]
        return ready_idx, rest_idx
    if kind == "kill_actor":
        return runtime.kill_actor(payload[0], no_restart=payload[1])
    if kind == "cancel":
        return runtime.cancel(serialization.loads(payload[0]), force=payload[1])
    if kind == "get_named_actor":
        return runtime.get_named_actor(payload[0], payload[1])
    if kind == "cluster_resources":
        return runtime.cluster_resources()
    if kind == "available_resources":
        return runtime.available_resources()
    if kind == "nodes":
        return runtime.nodes()
    if kind == "list_task_events":
        return runtime.list_task_events()
    if kind == "internal_kv":
        # Runs in the head process, where _remote_call() is None, so these
        # hit the head's real store (no recursion).
        from ray_tpu_torch.experimental import internal_kv as kv

        op = payload[0]
        if op == "get":
            return kv._internal_kv_get(payload[1], namespace=payload[2])
        if op == "put":
            return kv._internal_kv_put(payload[1], payload[2],
                                       overwrite=payload[3],
                                       namespace=payload[4])
        if op == "del":
            return kv._internal_kv_del(payload[1], namespace=payload[2])
        if op == "exists":
            return kv._internal_kv_exists(payload[1], namespace=payload[2])
        if op == "list":
            return kv._internal_kv_list(payload[1], namespace=payload[2])
        raise ValueError(f"unknown internal_kv op: {op!r}")
    if kind == "actor_info":
        state = runtime.get_actor_state(payload[0])
        if state is None:
            raise ValueError(f"unknown actor {payload[0]}")
        return state.spec.cls, state.spec.max_task_retries, state.state
    raise ValueError(f"unknown nested-API request: {kind!r}")
