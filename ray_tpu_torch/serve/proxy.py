"""HTTP ingress proxy on the standard library (the counterpart of
``ray_tpu/serve/proxy.py``).

(ref: python/ray/serve/_private/proxy.py — ProxyActor:1142 runs uvicorn;
HTTPProxy:763 matches the route table (long-poll refreshed) and forwards to
the app's ingress deployment via a handle.) The reference serves with
aiohttp; this one is an HTTP/1.1 server of its own on
``asyncio.start_server`` that writes the same status codes, content types
and bodies: JSON, text or bytes for unary answers; chunked transfer
encoding for streams, framed as server-sent events when the client accepts
``text/event-stream``; 404 for an unknown route, 500 for a failed request,
503 with ``Retry-After`` when the deployment sheds or recovers.
Connections are kept alive (HTTP/1.1) unless the client asks to close.
"""

from __future__ import annotations

import asyncio
import contextvars
import email.utils
import http
import json
import sys
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.serve import metrics as serve_metrics
from ray_tpu_torch.serve.config import HTTPOptions
from ray_tpu_torch.serve.handle import DeploymentHandle
from ray_tpu_torch.serve.long_poll import LongPollClient
from ray_tpu_torch.util import tracing as _tracing

_SERVER = f"Python/{sys.version_info[0]}.{sys.version_info[1]} ray_tpu_torch"
_TEXT = "text/plain; charset=utf-8"
_JSON = "application/json; charset=utf-8"
_OCTETS = "application/octet-stream"
#: Largest request body the proxy reads (bytes).
MAX_BODY_BYTES = 64 << 20


async def _run_in_executor_ctx(loop, fn):
    """Executor hop that KEEPS the caller's contextvars — a raw
    ``loop.run_in_executor`` drops them, which would orphan the router's
    route span from the proxy's root span."""
    ctx = contextvars.copy_context()
    return await loop.run_in_executor(None, lambda: ctx.run(fn))


class Request:
    """Minimal request object handed to user callables (ref: Serve passes
    starlette.requests.Request; same duck-typed surface for the basics)."""

    def __init__(self, method: str, path: str, query_params: Dict[str, str],
                 headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query_params = query_params
        self.headers = headers
        self._body = body

    async def body(self) -> bytes:
        return self._body

    async def json(self) -> Any:
        return json.loads(self._body or b"null")

    def __repr__(self) -> str:
        return f"Request({self.method} {self.path})"


class _BadRequest(Exception):
    pass


class _Response:
    """A whole (unary) HTTP response."""

    __slots__ = ("status", "content_type", "body", "headers")

    def __init__(self, status: int, body: bytes, content_type: str,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def _text(status: int, text: str, **headers: str) -> _Response:
    return _Response(status, text.encode(), _TEXT,
                     {k.replace("_", "-"): v for k, v in headers.items()})


class _Connection:
    """One client connection: what the proxy needs of its request and its
    socket."""

    __slots__ = ("reader", "writer", "version", "keep_alive", "method",
                 "target", "headers")

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.version = "HTTP/1.1"
        self.keep_alive = True
        self.method = ""
        self.target = ""
        self.headers: Dict[str, str] = {}

    def header(self, name: str, default: str = "") -> str:
        name = name.lower()
        for k, v in self.headers.items():
            if k.lower() == name:
                return v
        return default

    def disconnected(self) -> bool:
        """The client closed its side (EOF read) or the socket is closing."""
        return self.reader.at_eof() or self.writer.is_closing()

    def head(self, status: int, headers: List[Tuple[str, str]]) -> bytes:
        lines = [f"{self.version} {status} {http.HTTPStatus(status).phrase}"]
        lines += [f"{k}: {v}" for k, v in headers]
        lines.append(f"Date: {email.utils.formatdate(usegmt=True)}")
        lines.append(f"Server: {_SERVER}")
        if not self.keep_alive:
            lines.append("Connection: close")
        elif self.version == "HTTP/1.0":
            lines.append("Connection: keep-alive")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class HTTPProxy:
    """HTTP server thread routing HTTP → ingress deployment handles."""

    #: Per-item pull bound for streaming responses (the unary path's
    #: result() uses 60 s the same way).
    STREAM_PULL_TIMEOUT_S = 60.0

    def __init__(self, controller_handle, options: HTTPOptions):
        self._controller = controller_handle
        self._options = options
        self._route_table: Dict[str, Dict[str, str]] = {}
        self._handles: Dict[str, DeploymentHandle] = {}
        self._long_poll: Optional[LongPollClient] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._connections: set = set()
        self._inflight_counts: Dict[str, int] = {}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Bind and serve; raises if the port cannot be bound."""
        self._thread = threading.Thread(target=self._serve_thread, daemon=True,
                                        name="serve-http-proxy")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("HTTP proxy failed to start within 10 s")
        if self._start_error is not None:
            self._thread.join(timeout=5)
            raise self._start_error
        self._long_poll = LongPollClient(
            self._controller, {"route_table": self._update_routes})

    def _update_routes(self, table: Dict[str, Dict[str, str]]) -> None:
        self._route_table = dict(table or {})

    def _serve_thread(self) -> None:
        asyncio.run(self._serve())

    async def _serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        try:
            server = await asyncio.start_server(
                self._on_connection, self._options.host, self._options.port)
        except OSError as e:
            self._start_error = e
            self._started.set()
            return
        # Resolve the actual port (port=0 asks for an ephemeral one).
        self._options.port = server.sockets[0].getsockname()[1]
        self._started.set()
        try:
            await self._stop.wait()
        finally:
            server.close()
            for task in list(self._connections):
                task.cancel()
            if self._connections:
                await asyncio.gather(*self._connections,
                                     return_exceptions=True)
            await server.wait_closed()

    def stop(self) -> None:
        if self._long_poll:
            self._long_poll.stop()
        if self._loop is not None and self._stop is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop.set)
            except RuntimeError:
                pass  # the loop already ended
        if self._thread:
            self._thread.join(timeout=10)

    @property
    def address(self) -> str:
        return f"http://{self._options.host}:{self._options.port}"

    # ----------------------------------------------------------- connection
    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        conn = _Connection(reader, writer)
        try:
            while conn.keep_alive:
                try:
                    body = await self._read_request(conn)
                except _BadRequest as e:
                    conn.keep_alive = False
                    await self._write(conn, _text(400, f"Bad request: {e}"))
                    break
                if body is None:
                    break  # the client closed an idle connection
                await self._handle(conn, body)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._connections.discard(task)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, conn: _Connection) -> Optional[bytes]:
        """Reads one request's line, headers and body into ``conn``;
        returns the body, or None at EOF before a request."""
        line = await self._readline(conn.reader)
        while line in (b"\r\n", b"\n"):  # tolerate blank lines between requests
            line = await self._readline(conn.reader)
        if not line:
            return None
        try:
            method, target, version = line.decode("latin-1").split()
        except ValueError:
            raise _BadRequest(f"malformed request line {line[:80]!r}") from None
        if version not in ("HTTP/1.0", "HTTP/1.1"):
            raise _BadRequest(f"unsupported version {version!r}")
        conn.method, conn.target, conn.version = method, target, version
        reader = conn.reader
        headers: Dict[str, str] = {}
        while True:
            raw = await self._readline(reader)
            if not raw:
                raise asyncio.IncompleteReadError(b"", None)
            if raw in (b"\r\n", b"\n"):
                break
            name, sep, value = raw.decode("latin-1").partition(":")
            if not sep:
                raise _BadRequest(f"malformed header {raw[:80]!r}")
            headers.setdefault(name.strip(), value.strip())
        conn.headers = headers
        connection = conn.header("Connection").lower()
        conn.keep_alive = (connection != "close" if version == "HTTP/1.1"
                           else connection == "keep-alive")
        if conn.header("Expect").lower() == "100-continue":
            conn.writer.write(f"{version} 100 Continue\r\n\r\n".encode())
        if "chunked" in conn.header("Transfer-Encoding").lower():
            return await self._read_chunked(reader)
        try:
            length = int(conn.header("Content-Length", "0"))
        except ValueError:
            raise _BadRequest("bad Content-Length") from None
        if not 0 <= length <= MAX_BODY_BYTES:
            raise _BadRequest(f"Content-Length {length} out of range")
        return await reader.readexactly(length) if length else b""

    @staticmethod
    async def _readline(reader: asyncio.StreamReader) -> bytes:
        try:
            return await reader.readline()
        except ValueError:  # a line past the reader's limit (64 KiB)
            raise _BadRequest("request line or header too long") from None

    @classmethod
    async def _read_chunked(cls, reader: asyncio.StreamReader) -> bytes:
        parts: List[bytes] = []
        total = 0
        while True:
            size_line = await cls._readline(reader)
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError:
                raise _BadRequest("bad chunk size") from None
            if size < 0:
                raise _BadRequest("bad chunk size")
            if size == 0:
                while (await cls._readline(reader)) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return b"".join(parts)
            total += size
            if total > MAX_BODY_BYTES:
                raise _BadRequest("request body too large")
            parts.append(await reader.readexactly(size))
            await reader.readexactly(2)  # CRLF after the chunk

    async def _write(self, conn: _Connection, resp: _Response) -> None:
        headers = [("Content-Type", resp.content_type),
                   ("Content-Length", str(len(resp.body)))]
        headers += list(resp.headers.items())
        conn.writer.write(conn.head(resp.status, headers) + resp.body)
        await conn.writer.drain()

    # -------------------------------------------------------------- request
    def _match_route(self, path: str):
        """Longest-prefix route match (ref: proxy_router.py
        LongestPrefixRouter.match_route)."""
        best = None
        for prefix, target in self._route_table.items():
            norm = prefix.rstrip("/") or ""
            if path == norm or path.startswith(norm + "/") or prefix == "/":
                if best is None or len(prefix) > len(best[0]):
                    best = (prefix, target)
        return best

    async def _handle(self, conn: _Connection, body: bytes) -> None:
        split = urllib.parse.urlsplit(conn.target)
        path = urllib.parse.unquote(split.path) or "/"
        match = self._match_route(path)
        if match is None:
            await self._write(conn, _text(
                404, f"No application at {path}. "
                     f"Routes: {sorted(self._route_table)}"))
            return
        prefix, target = match
        query: Dict[str, str] = {}
        for k, v in urllib.parse.parse_qsl(split.query,
                                           keep_blank_values=True):
            query.setdefault(k, v)
        req = Request(conn.method, path, query, dict(conn.headers), body)
        # Root span of the request's trace: every downstream span (route,
        # execute) shares its trace_id.
        serve_metrics.HTTP_INFLIGHT.set(
            self._inflight_delta(prefix, +1), tags={"route": prefix})
        try:
            with _tracing.span("serve.http_request",
                               attributes={"route": prefix,
                                           "method": conn.method,
                                           "path": path,
                                           "app": target["app_name"]}):
                await self._handle_matched(conn, req, target)
        finally:
            serve_metrics.HTTP_INFLIGHT.set(
                self._inflight_delta(prefix, -1), tags={"route": prefix})

    def _inflight_delta(self, route: str, delta: int) -> int:
        n = max(0, self._inflight_counts.get(route, 0) + delta)
        self._inflight_counts[route] = n
        return n

    async def _handle_matched(self, conn: _Connection, req: Request,
                              target: Dict[str, Any]) -> None:
        app_name, ingress = target["app_name"], target["ingress"]
        handle = self._handles.get(app_name)
        if handle is None:
            handle = self._handles[app_name] = DeploymentHandle(
                ingress, app_name, self._controller)
        if target.get("streaming"):
            # Generator ingress: chunked (or SSE) response, one HTTP chunk
            # per yielded item — tokens reach the client as they are
            # produced (ref: proxy.py:532 streaming ASGI send).
            await self._handle_streaming(conn, handle, req)
            return
        loop = asyncio.get_running_loop()
        try:
            result = await _run_in_executor_ctx(
                loop, lambda: handle.remote(req).result(timeout_s=60.0))
        except Exception as e:  # noqa: BLE001 — answered as an HTTP error
            await self._write(conn, self._error_response(e))
            return
        await self._write(conn, self._to_http_response(result))

    @classmethod
    def _error_response(cls, e: BaseException) -> _Response:
        """503 + Retry-After for shedding (a BackPressureError from this
        proxy's router, or wrapped in a TaskError by a downstream
        deployment's handle call) and for a replica death that survived
        the handle's retries (the reconciler is already starting a
        replacement); 500 for anything else."""
        from ray_tpu_torch.exceptions import ActorDiedError, TaskError
        from ray_tpu_torch.serve.exceptions import BackPressureError

        shed = e if isinstance(e, BackPressureError) else None
        if isinstance(e, TaskError) and isinstance(
                getattr(e, "cause", None), BackPressureError):
            shed = e.cause
        if shed is not None:
            return _text(503, f"Service overloaded: {shed}",
                         Retry_After=str(max(1, int(shed.retry_after_s))))
        if isinstance(e, ActorDiedError):
            return _text(503, f"Replica died; recovery in progress: {e!r}",
                         Retry_After="1")
        return _text(500, f"Internal error: {e!r}")

    async def _handle_streaming(self, conn: _Connection, handle, req) -> None:
        """Drive a replica stream into a chunked HTTP response.

        Item mapping: bytes pass through; str encodes utf-8; anything else
        is JSON + newline (ndjson).  When the client asked for
        ``text/event-stream``, items are framed as SSE ``data:`` events.
        A mid-stream replica error ends the (already started) body early —
        the status line is gone, as in the reference. A client that
        disconnects cancels the replica-side stream so nothing leaks.
        """
        loop = asyncio.get_running_loop()
        try:
            # Stream assignment can block (replica-set wait during a
            # rolling update) — keep it off the event loop.
            gen = await _run_in_executor_ctx(
                loop, lambda: handle.options(stream=True).remote(req))
        except Exception as e:  # noqa: BLE001 — answered as an HTTP error
            await self._write(conn, self._error_response(e))
            return
        sse = "text/event-stream" in conn.header("Accept")
        # HTTP/1.0 has no chunked encoding: the body ends with the
        # connection.
        chunked = conn.version == "HTTP/1.1"
        if not chunked:
            conn.keep_alive = False
        head = [("Content-Type", "text/event-stream" if sse else _OCTETS),
                ("Cache-Control", "no-cache")]
        if chunked:
            head.append(("Transfer-Encoding", "chunked"))
        writer = conn.writer
        started = False
        emit_start = None
        num_items = 0
        try:
            while True:
                try:
                    # Bound each pull like the unary path bounds its
                    # result(): a wedged replica must not pin the
                    # connection + stream slot forever.
                    item = await asyncio.wait_for(
                        gen.__anext__(), timeout=self.STREAM_PULL_TIMEOUT_S)
                except StopAsyncIteration:
                    break
                if conn.disconnected():
                    raise ConnectionResetError("client disconnected")
                if not started:
                    writer.write(conn.head(200, head))
                    started = True
                    emit_start = time.time()
                num_items += 1
                if isinstance(item, bytes):
                    chunk = item
                elif isinstance(item, str):
                    chunk = item.encode()
                else:
                    chunk = json.dumps(item).encode() + b"\n"
                if sse:
                    chunk = b"data: " + chunk.rstrip(b"\n") + b"\n\n"
                if chunk:  # a zero-length chunk would end the body
                    writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk)
                                 if chunked else chunk)
                    await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            # Client went away (or the proxy stops): release the
            # replica-side iterator, also when no pull resolved its id.
            gen.abandon()
            conn.keep_alive = False
            raise
        except Exception as e:  # noqa: BLE001 — replica raised mid-stream
            gen.abandon()
            if not started:
                await self._write(conn, self._error_response(e))
                return
            # Headers already sent: nothing to do but end the body early.
        if emit_start is not None:
            # One span covering the emission window (first chunk -> EOF).
            _tracing.record_span("serve.stream_emit", emit_start, time.time(),
                                 attributes={"items": num_items})
        if not started:
            writer.write(conn.head(200, head))  # empty stream: headers + EOF
        if chunked:
            writer.write(b"0\r\n\r\n")
        await writer.drain()

    @staticmethod
    def _to_http_response(result: Any) -> _Response:
        if isinstance(result, bytes):
            return _Response(200, result, _OCTETS)
        if isinstance(result, str):
            return _Response(200, result.encode(), _TEXT)
        return _Response(200, json.dumps(result).encode(), _JSON)
