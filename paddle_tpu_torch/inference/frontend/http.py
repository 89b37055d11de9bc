"""Hand-rolled asyncio HTTP/1.1: exactly what a streaming LLM endpoint
needs, nothing else.

The stdlib's ``http.server`` is thread-per-connection and can't stream
from an asyncio loop; aiohttp/fastapi are not in the image.  A serving
frontend needs a small, auditable subset of HTTP/1.1 — parse a request
(line + headers + Content-Length body), write a response, and stream
Server-Sent Events with chunked transfer-encoding so curl and any
OpenAI-style client can consume token streams over keep-alive
connections.  That subset lives here, over plain
``asyncio.StreamReader/StreamWriter``.

Limits are explicit DoS guards: header lines are capped (asyncio's
readline limit), header count and body size are bounded, and a
malformed request maps to a 400 close rather than an exception escaping
the connection handler.
"""
from __future__ import annotations

from dataclasses import dataclass
from urllib.parse import parse_qs, urlsplit

__all__ = ["HTTPError", "HTTPRequest", "read_request", "response_bytes",
           "SSEWriter", "STATUS_TEXT"]

MAX_HEADERS = 64
MAX_BODY = 4 << 20                    # 4 MiB of JSON prompt is plenty

STATUS_TEXT = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 503: "Service Unavailable",
}


class HTTPError(Exception):
    """Protocol-level rejection → one response, then close."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = int(status)
        self.message = str(message)


@dataclass
class HTTPRequest:
    method: str
    path: str                          # path only, query stripped
    query: dict                        # parsed query string (first values)
    headers: dict                      # lower-cased names
    body: bytes = b""

    def header(self, name: str, default=None):
        return self.headers.get(name.lower(), default)


async def read_request(reader, *, max_body: int = MAX_BODY):
    """Parse one HTTP/1.1 request from the stream.  Returns None on a
    clean EOF before any bytes (client closed between requests); raises
    HTTPError on a malformed/oversized request."""
    try:
        line = await reader.readline()
    except (ConnectionError, ValueError) as e:
        raise HTTPError(400, f"bad request line: {e}") from e
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").split(None, 2)
    except ValueError as e:
        raise HTTPError(400, "malformed request line") from e
    if not version.strip().startswith("HTTP/1."):
        raise HTTPError(400, f"unsupported version {version.strip()!r}")

    headers = {}
    for _ in range(MAX_HEADERS + 1):
        try:
            line = await reader.readline()
        except (ConnectionError, ValueError) as e:
            raise HTTPError(400, f"bad header line: {e}") from e
        if line in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= MAX_HEADERS:
            raise HTTPError(400, "too many headers")
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep:
            raise HTTPError(400, f"malformed header {line[:40]!r}")
        headers[name.strip().lower()] = value.strip()

    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError as e:
            raise HTTPError(400, "bad content-length") from e
        if n < 0 or n > max_body:
            raise HTTPError(413, f"body of {n} bytes > {max_body}")
        if n:
            try:
                body = await reader.readexactly(n)
            except Exception as e:
                raise HTTPError(400, f"truncated body: {e}") from e
    elif headers.get("transfer-encoding", "").lower() == "chunked":
        raise HTTPError(400, "chunked request bodies not supported")

    parts = urlsplit(target)
    query = {k: v[0] for k, v in parse_qs(parts.query).items()}
    return HTTPRequest(method=method.upper(), path=parts.path or "/",
                       query=query, headers=headers, body=body)


def response_bytes(status: int, body: bytes, *,
                   content_type: str = "application/json",
                   extra_headers: dict | None = None,
                   keep_alive: bool = True) -> bytes:
    """One complete non-streaming response, Content-Length framed."""
    reason = STATUS_TEXT.get(status, "Unknown")
    lines = [f"HTTP/1.1 {status} {reason}",
             f"Content-Type: {content_type}",
             f"Content-Length: {len(body)}",
             f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


class SSEWriter:
    """Server-Sent Events over chunked transfer-encoding.

    ``start()`` commits the 200 + streaming headers; each ``event(data)``
    is one ``data: ...\\n\\n`` frame in its own HTTP chunk (flushed —
    token latency IS the product); ``done()`` sends the OpenAI-style
    ``data: [DONE]`` sentinel and the zero-length terminal chunk, which
    keeps the connection reusable.  Write failures surface as
    ConnectionError so the route handler can abort the request.
    """

    def __init__(self, writer):
        self._w = writer
        self.started = False

    async def start(self) -> None:
        self._w.write(b"HTTP/1.1 200 OK\r\n"
                      b"Content-Type: text/event-stream\r\n"
                      b"Cache-Control: no-cache\r\n"
                      b"Connection: keep-alive\r\n"
                      b"Transfer-Encoding: chunked\r\n\r\n")
        await self._w.drain()
        self.started = True

    async def _chunk(self, payload: bytes) -> None:
        self._w.write(f"{len(payload):x}\r\n".encode("latin-1")
                      + payload + b"\r\n")
        await self._w.drain()

    async def event(self, data: str) -> None:
        await self._chunk(f"data: {data}\n\n".encode("utf-8"))

    async def done(self) -> None:
        await self.event("[DONE]")
        self._w.write(b"0\r\n\r\n")
        await self._w.drain()
