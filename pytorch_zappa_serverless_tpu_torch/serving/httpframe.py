"""HTTP/1.1 framing on asyncio streams, shared by the server and the
acceptor workers.

Standard library only: the acceptor worker processes import it, and their
import closure stays free of torch.  Requests carry ``Content-Length``
bodies (a chunked request body is 411); the connection stays open unless
the client sends ``Connection: close`` or speaks HTTP/1.0.
"""

from __future__ import annotations

import asyncio
import json
import time
from http import HTTPStatus
from typing import Any, NamedTuple

MAX_BODY_BYTES = 64 * 1024 * 1024


class HttpError(Exception):
    """A request that cannot be framed: its status and message."""

    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


class RawBody(NamedTuple):
    """A response body sent as it is, under its own Content-Type (a binary
    lane answer frame)."""

    data: bytes
    ctype: str


async def read_request(reader: asyncio.StreamReader, max_body: int = MAX_BODY_BYTES,
                       stamps: dict | None = None):
    """(method, path, query, version, headers, body), or None at a clean
    EOF.  Header names are lowercased.  ``stamps["t_head"]`` is set to the
    ``perf_counter`` time the request line arrived: the payload read runs
    from there to the return."""
    line = await reader.readline()
    if not line:
        return None
    if stamps is not None:
        stamps["t_head"] = time.perf_counter()
    parts = line.decode("latin-1").split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/"):
        raise HttpError(400, "malformed request line")
    method, target, version = parts
    headers: dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        key, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise HttpError(400, "malformed header line")
        headers[key.strip().lower()] = value.strip()
    if "transfer-encoding" in headers:
        raise HttpError(411, "send the body with a Content-Length")
    try:
        n = int(headers.get("content-length", "0"))
    except ValueError:
        raise HttpError(400, "bad Content-Length") from None
    if n < 0:
        raise HttpError(400, "bad Content-Length")
    if n > max_body:
        raise HttpError(413, f"body of {n} bytes exceeds {max_body}")
    body = await reader.readexactly(n) if n else b""
    path, _, query = target.partition("?")
    return method, path, query, version, headers, body


def keep_alive(version: str, headers: dict[str, str]) -> bool:
    """Whether the connection stays open after this request's answer."""
    return version == "HTTP/1.1" and headers.get("connection", "").lower() != "close"


def head(status: int, framing: list[str], headers: dict[str, str], keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {HTTPStatus(status).phrase}", *framing,
             f"Connection: {'keep-alive' if keep_alive else 'close'}",
             *(f"{k}: {v}" for k, v in headers.items())]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def encode(status: int, obj: Any, headers: dict[str, str], keep_alive: bool) -> bytes:
    """A JSON body, a ``str`` as Prometheus text exposition 0.0.4, or a
    :class:`RawBody` as it is."""
    if isinstance(obj, RawBody):
        data, ctype = obj.data, obj.ctype
    elif isinstance(obj, str):
        data, ctype = obj.encode(), "text/plain; version=0.0.4; charset=utf-8"
    else:
        data = json.dumps(obj, separators=(",", ":")).encode()
        ctype = "application/json; charset=utf-8"
    return head(status, [f"Content-Type: {ctype}", f"Content-Length: {len(data)}"],
                headers, keep_alive) + data
