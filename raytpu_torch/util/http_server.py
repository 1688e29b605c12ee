"""HTTP/1.1 on the standard library's asyncio streams: the request
reader, the reply writer and the route matching that serve's HTTP proxy,
the dashboard and the job server share (the chip machine has no aiohttp,
which the JAX package's three servers are written on).

It holds aiohttp's observable behaviour where the JAX package's clients
and tests read it: a query or a header (``first_values``) keeps the
*first* value of a repeated key (a header name keeps the case the client
sent), the path and the query are percent-decoded as aiohttp decodes
them, a route's ``{name}`` matches one path segment and the first route
registered that matches wins, and a reply carries aiohttp's
Content-Type (``text/plain; charset=utf-8`` for text,
``application/json; charset=utf-8`` for JSON). Keep-alive,
``Content-Length`` and chunked request bodies are read; a reply is
framed with its length (chunked only where a stream writes it).

:class:`HttpServer` runs :class:`Routes` on an event loop of its own
thread; each handler gets the :class:`HttpRequest` and its path's
parameters and returns a :class:`Reply` (a plain function runs on the
loop's executor, a coroutine function on the loop).
"""

from __future__ import annotations

import asyncio
import codecs
import concurrent.futures
import http
import inspect
import json
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote

# What a request head may hold: its lines, each at most the stream
# reader's limit (64 KiB).
MAX_HEADERS = 128
TEXT = "text/plain; charset=utf-8"
JSON = "application/json; charset=utf-8"
HTML = "text/html; charset=utf-8"
# How long HttpServer.start waits for its socket.
START_TIMEOUT_S = 15.0
# Threads for a server's plain handlers: a slow one (a profile window)
# holds no other request.
HANDLER_THREADS = 16


class BadRequest(Exception):
    """A request this server cannot parse: answered 400, then closed."""


_HEX = re.compile(r"[0-9A-Fa-f]{2}")


def query_string(raw: str) -> str:
    """The query string as aiohttp gives it (yarl's ``query_string``):
    percent-decoded as UTF-8 and ``+`` read as a space, except that an
    escape of ``+ = & ;`` stays escaped (so the string still parses) and
    an escape that is not valid UTF-8 stays as it was sent."""
    out: List[str] = []
    decoder = codecs.getincrementaldecoder("utf-8")()
    pending = ""  # escapes of a UTF-8 sequence not yet complete
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == "%" and _HEX.fullmatch(raw[i + 1:i + 3]):
            esc = raw[i:i + 3]
            i += 3
            try:
                text = decoder.decode(bytes([int(esc[1:], 16)]))
            except UnicodeDecodeError:
                out.append(pending + esc)
                pending = ""
                decoder.reset()
                continue
            if not text:
                pending += esc
                continue
            pending = ""
            out.append(f"%{ord(text):02X}" if text in "+=&;" else text)
            continue
        if pending:
            out.append(pending)
            pending = ""
            decoder.reset()
        out.append(" " if ch == "+" else ch)
        i += 1
    return "".join(out) + pending


def first_values(pairs: List[Tuple[str, str]],
                 case_insensitive: bool) -> Dict[str, str]:
    """``dict()`` of an aiohttp multidict: every key as it was sent, each
    mapped to the first value of its key (case-insensitively for
    headers)."""
    first: Dict[str, str] = {}
    for k, v in pairs:
        first.setdefault(k.lower() if case_insensitive else k, v)
    return {k: first[k.lower() if case_insensitive else k] for k, _ in pairs}


class HttpRequest:
    """One parsed request: method, target, version, headers (as sent,
    in order) and body."""

    __slots__ = ("method", "target", "version", "headers", "body")

    def __init__(self, method: str, target: str, version: str,
                 headers: List[Tuple[str, str]]):
        self.method = method
        self.target = target
        self.version = version
        self.headers = headers
        self.body = b""

    def header(self, name: str, default: str = "") -> str:
        name = name.lower()
        for k, v in self.headers:
            if k.lower() == name:
                return v
        return default

    @property
    def raw_path(self) -> str:
        return self.target.split("?", 1)[0]

    @property
    def raw_query(self) -> str:
        return self.target.split("?", 1)[1] if "?" in self.target else ""

    @property
    def path(self) -> str:
        return unquote(self.raw_path)

    @property
    def query(self) -> Dict[str, str]:
        """aiohttp's ``request.query`` as a dict: each key's first value."""
        return first_values(parse_qsl(self.raw_query, keep_blank_values=True),
                            False)

    def json(self) -> Any:
        return json.loads(self.body or b"null")

    @property
    def keep_alive(self) -> bool:
        conn = self.header("Connection").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


async def read_request(reader: asyncio.StreamReader
                       ) -> Optional[HttpRequest]:
    """The next request on a connection; None at its end."""
    line = await reader.readline()
    if not line:
        return None
    try:
        method, target, version = line.decode("latin-1").rstrip(
            "\r\n").split(" ")
    except ValueError:
        raise BadRequest(f"bad request line {line[:80]!r}") from None
    if not method.isalpha() or version not in ("HTTP/1.0", "HTTP/1.1"):
        raise BadRequest(f"bad request line {line[:80]!r}")
    headers: List[Tuple[str, str]] = []
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n"):
            break
        if not line or len(headers) >= MAX_HEADERS:
            raise BadRequest("request head incomplete or too long")
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise BadRequest(f"bad header line {line[:80]!r}")
        headers.append((name, value.strip()))
    req = HttpRequest(method, target, version, headers)
    req.body = await _read_body(reader, req)
    return req


async def _read_body(reader: asyncio.StreamReader,
                     req: HttpRequest) -> bytes:
    chunked = req.header("Transfer-Encoding")
    length = req.header("Content-Length")
    if chunked and length:
        raise BadRequest("Transfer-Encoding can't be present with "
                         "Content-Length")
    if chunked:
        if chunked.lower() != "chunked":
            raise BadRequest(f"unsupported Transfer-Encoding {chunked!r}")
        parts = []
        while True:
            size = (await reader.readline()).split(b";", 1)[0].strip()
            try:
                n = int(size, 16)
            except ValueError:
                raise BadRequest(f"bad chunk size {size[:20]!r}") from None
            if n == 0:
                break
            parts.append(await reader.readexactly(n))
            await reader.readexactly(2)  # the chunk's CRLF
        while (await reader.readline()) not in (b"\r\n", b"\n", b""):
            pass  # trailers
        return b"".join(parts)
    if length:
        if not length.isdigit():
            raise BadRequest(f"bad Content-Length {length!r}")
        return await reader.readexactly(int(length))
    return b""


def _status_line(status: int) -> bytes:
    try:
        reason = http.HTTPStatus(status).phrase
    except ValueError:
        reason = ""
    return f"HTTP/1.1 {status} {reason}\r\n".encode("latin-1")


def head(status: int, headers: List[Tuple[str, str]]) -> bytes:
    """A response's status line and headers."""
    return _status_line(status) + "".join(
        f"{k}: {v}\r\n" for k, v in headers).encode("latin-1") + b"\r\n"


def chunk(data: bytes) -> bytes:
    """One chunk of a chunked body."""
    return b"%x\r\n%s\r\n" % (len(data), data)


class Reply:
    """A whole response: status, headers, body, as aiohttp frames them
    (no body and no length for 1xx, 204 and 304)."""

    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, body: bytes = b"",
                 headers: Optional[List[Tuple[str, str]]] = None):
        self.status = status
        self.body = body
        self.headers = list(headers or [])

    @classmethod
    def text(cls, status: int, text: str, content_type: str = TEXT,
             headers: Optional[List[Tuple[str, str]]] = None) -> "Reply":
        """aiohttp's ``web.Response(text=..., content_type=...)``."""
        return cls(status, text.encode(),
                   [("Content-Type", content_type), *(headers or [])])

    @classmethod
    def json(cls, data: Any, status: int = 200) -> "Reply":
        """aiohttp's ``web.json_response``."""
        return cls(status, json.dumps(data).encode(),
                   [("Content-Type", JSON)])

    def frame(self, keep_alive: bool) -> bytes:
        headers = list(self.headers)
        body = self.body
        if self.status in (204, 304) or 100 <= self.status < 200:
            body = b""
        else:
            headers.append(("Content-Length", str(len(body))))
        if not keep_alive:
            headers.append(("Connection", "close"))
        return head(self.status, headers) + body


def match_route(route_table: Dict[str, tuple], path: str
                ) -> Optional[Tuple[str, str, str]]:
    """Longest-prefix route match shared by every ingress transport (HTTP
    + gRPC must agree on trailing-slash normalization)."""
    best = None
    for prefix, (app_name, ingress) in route_table.items():
        norm = prefix.rstrip("/") or "/"
        if path == norm or path.startswith(norm + "/") or norm == "/":
            if best is None or len(norm) > len(best[0]):
                best = (norm, app_name, ingress)
    return best


Handler = Callable[..., Any]


class Routes:
    """aiohttp's router for the servers here: ``add(method, pattern,
    handler)`` in order; a ``{name}`` in a pattern matches one non-empty
    path segment and is passed to the handler by name. The first route
    that matches the path and the method wins; a path that some route
    matches under another method is 405, any other 404 (aiohttp's
    bodies)."""

    def __init__(self):
        self._routes: List[Tuple[str, "re.Pattern", Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^{}/]+)",
                       re.escape(pattern))
        self._routes.append((method, re.compile(regex + r"\Z"), handler))

    def get(self, pattern: str, handler: Handler) -> None:
        self.add("GET", pattern, handler)

    def post(self, pattern: str, handler: Handler) -> None:
        self.add("POST", pattern, handler)

    def resolve(self, method: str, path: str
                ) -> Tuple[Optional[Handler], Dict[str, str], int]:
        """(handler, its parameters, 200), or (None, {}, 404 or 405)."""
        status = 404
        for m, regex, handler in self._routes:
            found = regex.match(path)
            if found is None:
                continue
            if m == method:
                return handler, found.groupdict(), 200
            status = 405
        return None, {}, status


async def serve_connection(reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           respond: Callable[..., Any]) -> None:
    """Read requests from one connection until it closes, each answered
    by ``await respond(req, reader, writer, keep_alive)``, which returns
    False when the connection must close. A request that does not parse
    is answered 400 and closes it."""
    try:
        while True:
            try:
                req = await read_request(reader)
            except BadRequest as exc:
                writer.write(Reply.text(400, str(exc)).frame(False))
                await writer.drain()
                return
            if req is None:
                return
            if not await respond(req, reader, writer, req.keep_alive):
                return
    except (ConnectionError, asyncio.IncompleteReadError,
            asyncio.LimitOverrunError, ValueError):
        return  # the client went away, or sent a head past the limit
    finally:
        writer.close()


class HttpServer:
    """:class:`Routes` served on ``host:port`` (0: a free port) from an
    event loop on a daemon thread of its own: ``start()`` returns
    ``http://host:port``, ``stop()`` closes the socket and every
    connection and ends the thread. A plain handler runs on the loop's
    executor; an exception in a handler is a 500 with its type and
    message."""

    def __init__(self, routes: Routes, host: str = "127.0.0.1",
                 port: int = 0, name: str = "raytpu-torch-http"):
        self.routes = routes
        self.host = host
        self.port = port
        self.url: Optional[str] = None
        self._name = name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> str:
        started = threading.Event()
        failed: List[BaseException] = []

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(
                max_workers=HANDLER_THREADS, thread_name_prefix=self._name))
            try:
                self._server = loop.run_until_complete(asyncio.start_server(
                    self._connection, self.host, self.port,
                    reuse_address=True))
            except OSError as exc:
                failed.append(exc)
                started.set()
                loop.close()
                return
            self._loop = loop
            self.port = self._server.sockets[0].getsockname()[1]
            self.url = f"http://{self.host}:{self.port}"
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.run_until_complete(loop.shutdown_default_executor())
                loop.close()

        self._thread = threading.Thread(target=run, name=self._name,
                                        daemon=True)
        self._thread.start()
        if not started.wait(START_TIMEOUT_S):
            raise RuntimeError(f"{self._name} did not start in "
                               f"{START_TIMEOUT_S} s")
        if failed:
            raise failed[0]
        return self.url

    def stop(self) -> None:
        loop = self._loop
        if loop is None:
            return
        self._loop = None

        async def close() -> None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            loop.stop()

        asyncio.run_coroutine_threadsafe(close(), loop)
        self._thread.join(timeout=10)

    async def _connection(self, reader, writer) -> None:
        self._writers.add(writer)
        try:
            await serve_connection(reader, writer, self._respond)
        finally:
            self._writers.discard(writer)

    async def _respond(self, req: HttpRequest, reader, writer,
                       keep: bool) -> bool:
        handler, params, status = self.routes.resolve(req.method, req.path)
        if handler is None:
            reply = Reply.text(status, "404: Not Found" if status == 404
                               else "405: Method Not Allowed")
        else:
            try:
                if inspect.iscoroutinefunction(handler):
                    reply = await handler(req, **params)
                else:
                    reply = await asyncio.get_running_loop().run_in_executor(
                        None, lambda: handler(req, **params))
            except Exception as exc:  # a handler's fault answers, not kills
                reply = Reply.text(500, f"{type(exc).__name__}: {exc}")
        writer.write(reply.frame(keep))
        await writer.drain()
        return keep
