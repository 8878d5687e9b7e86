"""The client half of HTTP/1.1 on asyncio streams: what the fleet router
sends to its replicas.

Standard library only, like its server half (``httpframe.py``): the
router depends on no aiohttp, and this module's import closure loads no
torch.  One :class:`ClientPool` keeps a pool of keep-alive connections per
``host:port``.  A request has two timeouts with the meaning of
``aiohttp.ClientTimeout(total, sock_connect)``: ``connect`` bounds the TCP
connect alone, ``total`` the whole exchange from the connect to the last
byte of the body.  Response bodies come by ``Content-Length``, chunked, or
to the close; an event stream is read as it arrives, line by line
(:meth:`ClientResponse.iter_lines`), with nothing held back.

Errors: a connect that fails or times out raises :class:`ConnectFailed`; a
connection that breaks or closes before the answer is whole (a replica
killed mid-body) raises :class:`ServerDisconnected`; a spent ``total``
raises :class:`TimeoutError`.  Both of the first two are
``ConnectionError``, so the router's ``_UPSTREAM_ERRORS`` catch them.  A
pooled connection that fails before any byte of the answer is retried once
on a fresh connection only for an idempotent method (aiohttp's set): the
server may have read a POST and acted on it before it died, so such a
failure raises :class:`ServerDisconnected`, never :class:`ConnectFailed`,
even when the reconnect would be refused.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, AsyncIterator, NamedTuple
from urllib.parse import urlencode, urlsplit

MAX_HEADER_LINES = 128
IDLE_PER_HOST = 32  # keep-alive connections kept idle for one host:port
# Methods whose failure on a pooled connection is retried once on a fresh
# one (aiohttp's ``IDEMPOTENT_METHODS``).
IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "OPTIONS", "TRACE", "PUT", "DELETE"})


class ClientTimeout(NamedTuple):
    """``total``: seconds for the whole exchange; ``connect``: seconds for
    the TCP connect alone (None: no bound of its own)."""

    total: float | None = None
    connect: float | None = None


class ConnectFailed(ConnectionError):
    """The TCP connect was refused, unreachable or timed out: the request
    provably never reached the server."""


class ServerDisconnected(ConnectionError):
    """The connection broke or closed before the answer was whole: the
    server may have received (and acted on) the request."""


class ClientResponse:
    """One answer: ``status``, ``headers`` (lowercased names) and the body,
    read whole (:meth:`read`, :meth:`json`) or as it arrives
    (:meth:`iter_chunks`, :meth:`iter_lines`).  Use it as an async context
    manager: leaving returns a fully read connection to the pool and closes
    any other."""

    def __init__(self, pool: "ClientPool", key: tuple[str, int], reader, writer,
                 status: int, headers: dict[str, str], deadline: float | None, method: str):
        self._pool = pool
        self._key = key
        self._reader = reader
        self._writer = writer
        self.status = status
        self.headers = headers
        self._deadline = deadline
        self._done = False        # the body has been read to its end
        self._closed = False
        te = headers.get("transfer-encoding", "").lower()
        self._chunked = "chunked" in te
        cl = headers.get("content-length")
        self._remaining = int(cl) if cl is not None and not self._chunked else None
        self._reusable = headers.get("connection", "").lower() != "close"
        if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
            self._remaining = 0
            self._chunked = False
        if self._remaining == 0:
            self._done = True
        elif self._remaining is None and not self._chunked:
            self._reusable = False  # the body runs to the close

    def _left(self) -> float | None:
        if self._deadline is None:
            return None
        left = self._deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("request timed out (total)")
        return left

    async def _io(self, aw):
        try:
            return await asyncio.wait_for(aw, self._left())
        except asyncio.TimeoutError:
            raise TimeoutError("request timed out (total)") from None
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, OSError) as e:
            raise ServerDisconnected(f"connection lost mid-body: {type(e).__name__}: {e}") from e

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        """The body's bytes as they arrive, one piece per read; raises
        :class:`ServerDisconnected` when the connection ends before the
        body does."""
        try:
            while not self._done:
                if self._chunked:
                    line = await self._io(self._reader.readline())
                    if not line:
                        raise ServerDisconnected("connection closed inside a chunked body")
                    try:
                        n = int(line.split(b";", 1)[0].strip(), 16)
                    except ValueError:
                        raise ServerDisconnected(f"bad chunk size line {line[:40]!r}") from None
                    if n == 0:
                        while True:  # trailers, then the blank line
                            t = await self._io(self._reader.readline())
                            if t in (b"\r\n", b"\n", b""):
                                break
                        self._done = True
                        return
                    data = await self._io(self._reader.readexactly(n))
                    await self._io(self._reader.readexactly(2))  # the chunk's CRLF
                    yield data
                elif self._remaining is not None:
                    data = await self._io(self._reader.read(min(self._remaining, 1 << 16)))
                    if not data:
                        raise ServerDisconnected(f"connection closed with {self._remaining} "
                                                 "body bytes unread")
                    self._remaining -= len(data)
                    if self._remaining == 0:
                        self._done = True
                    yield data
                else:
                    data = await self._io(self._reader.read(1 << 16))
                    if not data:
                        self._done = True
                        return
                    yield data
        except BaseException:
            self.close()
            raise

    async def iter_lines(self) -> AsyncIterator[bytes]:
        """The body line by line (each with its ``\\n``), each as soon as it
        is whole; a last line without one comes at the end."""
        buf = b""
        async for data in self.iter_chunks():
            buf += data
            while True:
                i = buf.find(b"\n")
                if i < 0:
                    break
                yield buf[:i + 1]
                buf = buf[i + 1:]
        if buf:
            yield buf

    async def read(self) -> bytes:
        parts = [data async for data in self.iter_chunks()]
        return b"".join(parts)

    async def json(self) -> Any:
        return json.loads(await self.read())

    def close(self) -> None:
        """Drop the connection (a body left unread cannot be reused)."""
        if not self._closed:
            self._closed = True
            self._writer.close()

    def release(self) -> None:
        """Back to the pool when the body was read whole, else closed."""
        if self._closed:
            return
        if self._done and self._reusable:
            self._closed = True
            self._pool._put(self._key, self._reader, self._writer)
        else:
            self.close()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


class ClientPool:
    """Keep-alive connections per ``host:port``, at most ``IDLE_PER_HOST``
    idle ones kept.  Confined to one event loop."""

    def __init__(self):
        self._idle: dict[tuple[str, int], list] = {}  # guarded-by: event-loop
        self._closed = False

    def _put(self, key, reader, writer) -> None:
        idle = self._idle.setdefault(key, [])
        if self._closed or len(idle) >= IDLE_PER_HOST or reader.at_eof():
            writer.close()
            return
        idle.append((reader, writer))

    def _take(self, key):
        idle = self._idle.get(key) or []
        while idle:
            reader, writer = idle.pop()
            if not reader.at_eof() and not writer.is_closing():
                return reader, writer
            writer.close()
        return None

    async def _connect(self, host: str, port: int, timeout: ClientTimeout, deadline):
        bound = [t for t in (timeout.connect, None if deadline is None
                             else deadline - time.monotonic()) if t is not None]
        try:
            return await asyncio.wait_for(asyncio.open_connection(host, port),
                                          min(bound) if bound else None)
        except asyncio.TimeoutError:
            raise ConnectFailed(f"connect to {host}:{port} timed out") from None
        except OSError as e:
            raise ConnectFailed(f"cannot connect to {host}:{port}: {e}") from e

    async def request(self, method: str, url: str, *, data: bytes | None = None,
                      json_body: Any = None, headers: dict[str, str] | None = None,
                      params: dict[str, str] | None = None,
                      timeout: ClientTimeout = ClientTimeout()) -> ClientResponse:
        """Send one request and read its status line and headers; the body
        is the answer's to read.  Use the answer as an async context
        manager."""
        if self._closed:
            raise RuntimeError("client pool is closed")
        parts = urlsplit(url)
        host, port = parts.hostname or "127.0.0.1", parts.port or 80
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        if params:
            target += ("&" if "?" in target else "?") + urlencode(params)
        if json_body is not None:
            data = json.dumps(json_body).encode()
        body = data or b""
        head = {"Host": f"{host}:{port}", "Connection": "keep-alive"}
        if json_body is not None:
            head["Content-Type"] = "application/json"
        for k, v in (headers or {}).items():
            head[k] = str(v)
        if body or method in ("POST", "PUT", "PATCH"):
            head["Content-Length"] = str(len(body))
        wire = (f"{method} {target} HTTP/1.1\r\n"
                + "".join(f"{k}: {v}\r\n" for k, v in head.items()) + "\r\n").encode("latin-1")
        deadline = None if timeout.total is None else time.monotonic() + timeout.total
        key = (host, port)
        pooled = self._take(key)
        while True:
            fresh = pooled is None
            reader, writer = pooled if pooled is not None else await self._connect(
                host, port, timeout, deadline)
            try:
                return await self._exchange(key, reader, writer, wire + body, deadline, method)
            except _StaleConnection:
                if fresh or method not in IDEMPOTENT_METHODS:
                    raise ServerDisconnected(f"{host}:{port} closed the connection without "
                                             "an answer") from None
                pooled = None  # an idle connection the server had closed: once again

    async def _exchange(self, key, reader, writer, payload: bytes, deadline, method: str):
        def left():
            if deadline is None:
                return None
            rest = deadline - time.monotonic()
            if rest <= 0:
                raise TimeoutError("request timed out (total)")
            return rest

        try:
            writer.write(payload)
            await asyncio.wait_for(writer.drain(), left())
            status_line = await asyncio.wait_for(reader.readline(), left())
            if not status_line:
                raise _StaleConnection()
            parts = status_line.decode("latin-1").split(None, 2)
            if len(parts) < 2 or not parts[0].startswith("HTTP/"):
                raise ServerDisconnected(f"malformed status line {status_line[:60]!r}")
            status = int(parts[1])
            headers: dict[str, str] = {}
            for _ in range(MAX_HEADER_LINES):
                h = await asyncio.wait_for(reader.readline(), left())
                if h in (b"\r\n", b"\n"):
                    break
                if not h:
                    raise ServerDisconnected("connection closed inside the answer's headers")
                k, sep, v = h.decode("latin-1").partition(":")
                if sep:
                    headers[k.strip().lower()] = v.strip()
            else:
                raise ServerDisconnected("too many header lines")
        except asyncio.TimeoutError:
            writer.close()
            raise TimeoutError("request timed out (total)") from None
        except _StaleConnection:
            writer.close()
            raise
        except (ConnectionError, OSError) as e:
            writer.close()
            if isinstance(e, ServerDisconnected):
                raise
            raise _StaleConnection() from e
        except BaseException:
            writer.close()
            raise
        return ClientResponse(self, key, reader, writer, status, headers, deadline, method)

    async def close(self) -> None:
        self._closed = True
        for idle in self._idle.values():
            for _, writer in idle:
                writer.close()
        self._idle.clear()


class _StaleConnection(Exception):
    """The connection failed before any byte of the answer."""
