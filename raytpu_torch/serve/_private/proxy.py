"""HTTP proxy: the front door routing HTTP requests to deployment
replicas; the port of :mod:`raytpu.serve._private.proxy`.

``ProxyActor`` is an async actor (the named detached actor
``SERVE_PROXY``, started with a high ``max_concurrency``) whose server
lives on its worker's event loop, started by the coroutine ``ready()``.
Routing: longest-prefix match of the path against the app route table
(long-polled from the controller), then power-of-two-choices replica
selection through the handle.

Request → handler contract: the ingress callable receives a
:class:`Request` (method, path, query, headers, body bytes, ``json()``,
``text``). Returning bytes/str → raw body; dict/list → JSON;
``(status, body)`` respected. A client that accepts
``text/event-stream`` gets a streaming handler's chunks as server-sent
events, each written the moment it exists, then ``data: [DONE]`` (a
failure mid-stream arrives in band as ``event: error``). A deployment
with an ASGI app (``@serve.ingress``) gets the raw request instead.

What differs from the JAX package: the server is written on the
standard library's ``asyncio`` streams (HTTP/1.1: keep-alive,
``Content-Length`` and chunked request bodies, chunked SSE), not on
aiohttp, and holds aiohttp's observable behaviour: ``Request.query`` and
``Request.headers`` keep the *first* value of a repeated key (a header
name keeps the case the client sent), the path and the query are
percent-decoded as aiohttp decodes them, and every response carries
aiohttp's Content-Type. A client that drops an SSE stream closes it, so
the replica's handler is closed (an LLM replica frees the sequence's
pages); the JAX proxy leaves such a stream running (ROADMAP.md, Queue
3).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json as _json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl

from raytpu_torch import runtime
from raytpu_torch.serve._private.controller import get_controller
from raytpu_torch.serve.handle import DeploymentHandle
from raytpu_torch.util.http_server import (JSON, HttpRequest, Reply, chunk,
                                           first_values, head, match_route,
                                           query_string, serve_connection)

# Threads for the proxy's blocking hops (routing, a stream's next chunk,
# the route table's long poll): one a stream in flight at most.
PROXY_THREADS = 1024
_SSE_HEADERS = [("Content-Type", "text/event-stream"),
                ("Cache-Control", "no-cache"),
                ("Connection", "keep-alive"),
                ("Transfer-Encoding", "chunked")]


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes = b""
    route_prefix: str = "/"
    extra: Dict[str, Any] = field(default_factory=dict)

    def json(self) -> Any:
        return _json.loads(self.body or b"null")

    @property
    def text(self) -> str:
        return self.body.decode()


def _encode_response(result: Any) -> Tuple[int, bytes, str]:
    status = 200
    if isinstance(result, tuple) and len(result) == 2 and \
            isinstance(result[0], int):
        status, result = result
    if isinstance(result, bytes):
        return status, result, "application/octet-stream"
    if isinstance(result, str):
        return status, result.encode(), "text/plain; charset=utf-8"
    return status, _json.dumps(result).encode(), "application/json"


def _sse_frame(chunk: Any) -> bytes:
    if isinstance(chunk, bytes):
        data = chunk.decode("utf-8", "replace")
    elif isinstance(chunk, str):
        data = chunk
    else:
        data = _json.dumps(chunk)
    # SSE framing: every line of a multi-line chunk needs its own "data:"
    # field or clients drop the extra lines.
    return ("".join(f"data: {ln}\n" for ln in data.split("\n"))
            + "\n").encode()



class ProxyActor:
    """Async actor: runs the HTTP server on its worker's event loop."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._controller = get_controller()
        self._route_table: Dict[str, tuple] = {}
        self._route_version = -1
        self._handles: Dict[str, DeploymentHandle] = {}
        self._asgi: Dict[str, bool] = {}  # deployment key -> transport
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set = set()  # open connections, closed at shutdown
        self._poll_task: Optional[asyncio.Task] = None
        self._ready = False

    async def ready(self) -> bool:
        if not self._ready:
            await self._start()
        return True

    async def _start(self):
        loop = asyncio.get_running_loop()
        # Every blocking hop runs on the loop's default executor (the
        # handle's async bridges use it too): one thread a stream in
        # flight, not the default handful.
        loop.set_default_executor(concurrent.futures.ThreadPoolExecutor(
            max_workers=PROXY_THREADS, thread_name_prefix="serve-proxy"))
        self._server = await asyncio.start_server(
            self._serve_connection, self._host, self._port,
            reuse_address=True)
        self._poll_task = asyncio.ensure_future(self._poll_routes())
        self._ready = True

    async def _poll_routes(self):
        loop = asyncio.get_running_loop()
        while True:
            try:
                updates = await loop.run_in_executor(None, functools.partial(
                    runtime.get, self._controller.submit(
                        "listen_for_change",
                        {"route_table": self._route_version})))
            except asyncio.CancelledError:
                raise
            except Exception:  # a controller stopping or stopped
                await asyncio.sleep(0.2)
                continue
            if "route_table" in updates:
                upd = updates["route_table"]
                self._route_table = dict(upd.object_snapshot)
                self._route_version = upd.snapshot_id
                # Redeploys can switch a key between ASGI and plain
                # transports; re-probe on the next request.
                self._asgi.clear()

    def _match_route(self, path: str) -> Optional[Tuple[str, str, str]]:
        return match_route(self._route_table, path)

    # -- connections -------------------------------------------------------

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            await serve_connection(reader, writer, self._respond)
        finally:
            self._writers.discard(writer)

    async def _respond(self, req: HttpRequest, reader, writer,
                       keep: bool) -> bool:
        """Answer one request; False when the connection must close."""
        reply = await self._handle_http(req, reader, writer, keep)
        if reply is None:  # streamed: the SSE path wrote it
            return keep and not reader.at_eof()
        writer.write(reply.frame(keep))
        await writer.drain()
        return keep

    async def _handle_http(self, req: HttpRequest, reader, writer,
                           keep: bool) -> Optional[Reply]:
        path = req.path
        if path == "/-/healthz":
            return Reply.text(200, "ok")
        if path == "/-/routes":
            return Reply(200, _json.dumps(
                {p: list(v) for p, v in self._route_table.items()}).encode(),
                [("Content-Type", JSON)])
        match = self._match_route(path)
        if match is None:
            return Reply.text(404, "no deployment at this path")
        prefix, app_name, ingress = match
        key = f"{app_name}#{ingress}"
        handle = self._handles.get(key)
        if handle is None:
            handle = self._handles[key] = DeploymentHandle(ingress, app_name)
        request = Request(
            method=req.method,
            path=path,
            query=first_values(
                parse_qsl(req.raw_query, keep_blank_values=True), False),
            headers=first_values(req.headers, True),
            body=req.body,
            route_prefix=prefix,
        )
        model_id = req.header("serve_multiplexed_model_id")
        if model_id:
            handle = handle.options(multiplexed_model_id=model_id)
        # ASGI ingress (@serve.ingress(app)): probe the deployment's
        # transport once, then forward raw scope+body so real web
        # frameworks run unmodified inside the replica.
        loop = asyncio.get_running_loop()
        if key not in self._asgi:
            try:
                # Cache only successful probes: a replica-startup timeout
                # must not pin the wrong transport forever.
                self._asgi[key] = await loop.run_in_executor(
                    None, handle.is_asgi)
            except Exception:
                return Reply.text(503, "deployment starting; retry")
        if self._asgi[key]:
            return await self._handle_asgi(req, handle, prefix)
        # SSE contract: a client that accepts text/event-stream gets the
        # handler's chunks as they are produced.
        if "text/event-stream" in req.header("Accept"):
            await self._handle_sse(reader, writer, handle, request, keep)
            return None
        try:
            result = await handle.remote_async(request)
        except TimeoutError:
            return Reply.text(503, "deployment unavailable")
        except Exception as e:
            return Reply.text(500, f"{type(e).__name__}: {e}")
        status, payload, ctype = _encode_response(result)
        return Reply(status, payload, [("Content-Type", ctype.split(";")[0])])

    async def _handle_asgi(self, req: HttpRequest, handle,
                           prefix: str) -> Reply:
        path = req.path
        root = "" if prefix == "/" else prefix
        scope = {
            "type": "http",
            "asgi": {"version": "3.0", "spec_version": "2.3"},
            "http_version": "1.1",
            "method": req.method,
            "scheme": "http",
            "path": path[len(root):] or "/",
            "root_path": root,
            "raw_path": path,
            "query_string": query_string(req.raw_query),
            "headers": [(k.lower(), v) for k, v in req.headers],
            "client": None,
            "server": None,
        }
        loop = asyncio.get_running_loop()
        try:
            # Dispatch (replica selection) off-loop; the response itself
            # is awaitable.
            dresp = await loop.run_in_executor(
                None, lambda: handle.remote_asgi(scope, req.body))
            resp = await dresp
        except Exception as e:
            return Reply.text(500, f"{type(e).__name__}: {e}")
        # Duplicate headers (two Set-Cookie) survive; the length is ours.
        headers = [(k, v) for k, v in resp.get("headers", [])
                   if k.lower() not in ("content-length",
                                        "transfer-encoding")]
        status = resp.get("status", 200)
        body = resp.get("body", b"")
        if body and not any(k.lower() == "content-type" for k, _ in headers):
            headers.append(("Content-Type", "application/octet-stream"))
        return Reply(status, body, headers)

    async def _handle_sse(self, reader, writer, handle, request: Request,
                          keep: bool) -> None:
        """Stream the handler's chunks as server-sent events, one
        chunked-encoding write a frame, ending with ``[DONE]``. A client
        that goes away closes the stream (its replica's handler is
        closed at the next chunk)."""
        headers = list(_SSE_HEADERS)
        if not keep:
            headers[2] = ("Connection", "close")
        writer.write(head(200, headers))
        await writer.drain()
        loop = asyncio.get_running_loop()
        gen = None
        try:
            gen = await loop.run_in_executor(
                None, lambda: handle.remote_streaming(request))
            async for item in gen:  # the async bridge lives on the generator
                if reader.at_eof():
                    return  # the client is gone: close the stream
                writer.write(chunk(_sse_frame(item)))
                await writer.drain()
            writer.write(chunk(b"data: [DONE]\n\n"))
        except (ConnectionError, asyncio.CancelledError):
            raise
        except Exception as e:  # surface mid-stream failures in-band
            writer.write(chunk(
                f"event: error\ndata: {type(e).__name__}: {e}\n\n".encode()))
        finally:
            if gen is not None:
                gen.close()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def shutdown(self):
        if self._poll_task is not None:
            self._poll_task.cancel()
            self._poll_task = None
        if self._server is not None:
            self._server.close()
            for writer in list(self._writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
            self._ready = False
