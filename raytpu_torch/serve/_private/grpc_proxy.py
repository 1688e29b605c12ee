"""gRPC ingress — the second proxy transport; the port of
:mod:`raytpu.serve._private.grpc_proxy`.

A GENERIC byte service, so no protoc plugin is needed anywhere:

- ``/raytpu.serve/Call``   (unary-unary):  request bytes -> response bytes
- ``/raytpu.serve/Stream`` (unary-stream): request bytes -> chunk stream

The target deployment is chosen by the ``route`` metadata entry (same
route prefixes as HTTP). Handlers see the standard proxy ``Request``
(method="GRPC", body=payload); non-bytes results are JSON-encoded, and
streaming handlers (generators) drive the Stream method chunk by chunk.
``grpc`` is imported when the proxy starts (``ready()``), as in the JAX
package: where it is not installed, starting the proxy raises its
``ImportError``. The server (``grpc.aio``) runs on the actor's event
loop.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import json
from typing import Dict, Optional, Tuple

from raytpu_torch import runtime
from raytpu_torch.serve._private.controller import get_controller
from raytpu_torch.serve._private.proxy import (PROXY_THREADS, Request,
                                               match_route)
from raytpu_torch.serve.handle import DeploymentHandle

UNARY_METHOD = "/raytpu.serve/Call"
STREAM_METHOD = "/raytpu.serve/Stream"


def _encode(result) -> bytes:
    if isinstance(result, bytes):
        return result
    if isinstance(result, str):
        return result.encode()
    return json.dumps(result).encode()


class GrpcProxyActor:
    """Async actor hosting a grpc.aio server with generic handlers; route
    table kept fresh via the controller's long-poll (same protocol as the
    HTTP proxy)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        self._host = host
        self._port = port
        self._controller = get_controller()
        self._route_table: Dict[str, tuple] = {}
        self._route_version = -1
        self._handles: Dict[str, DeploymentHandle] = {}
        self._server = None
        self._poll_task: Optional[asyncio.Task] = None
        self._ready = False

    async def ready(self) -> bool:
        if not self._ready:
            await self._start()
        return True

    async def _start(self):
        import grpc

        proxy = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, call_details):
                if call_details.method == UNARY_METHOD:
                    return grpc.unary_unary_rpc_method_handler(
                        proxy._call_unary)
                if call_details.method == STREAM_METHOD:
                    return grpc.unary_stream_rpc_method_handler(
                        proxy._call_stream)
                return None

        asyncio.get_running_loop().set_default_executor(
            concurrent.futures.ThreadPoolExecutor(
                max_workers=PROXY_THREADS,
                thread_name_prefix="serve-grpc-proxy"))
        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((Handler(),))
        bound = self._server.add_insecure_port(
            f"{self._host}:{self._port}")
        if bound == 0:  # grpc reports bind failure via 0, not an exception
            raise OSError(
                f"gRPC proxy cannot bind {self._host}:{self._port}")
        await self._server.start()
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

    # -- dispatch ----------------------------------------------------------

    def _resolve(self, context) -> Tuple[Optional[DeploymentHandle], str]:
        route = ""
        for key, value in (context.invocation_metadata() or ()):
            if key == "route":
                route = value
        if not route.startswith("/"):
            route = "/" + route
        match = match_route(self._route_table, route)
        if match is None:
            return None, route
        _, app_name, ingress = match
        key = f"{app_name}#{ingress}"
        handle = self._handles.get(key)
        if handle is None:
            handle = self._handles[key] = DeploymentHandle(ingress,
                                                           app_name)
        return handle, route

    def _request(self, payload: bytes, route: str, context) -> Request:
        headers = {k: str(v)
                   for k, v in (context.invocation_metadata() or ())}
        return Request(method="GRPC", path=route, query={},
                       headers=headers, body=payload)

    async def _call_unary(self, payload: bytes, context) -> bytes:
        handle, route = self._resolve(context)
        if handle is None:
            import grpc

            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no deployment at route {route!r}")
        req = self._request(payload, route, context)
        result = await handle.remote_async(req)
        return _encode(result)

    async def _call_stream(self, payload: bytes, context):
        handle, route = self._resolve(context)
        if handle is None:
            import grpc

            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no deployment at route {route!r}")
        req = self._request(payload, route, context)
        loop = asyncio.get_running_loop()
        gen = await loop.run_in_executor(
            None, lambda: handle.remote_streaming(req))
        try:
            async for chunk in gen:
                yield _encode(chunk)
        finally:
            gen.close()  # a client that cancels ends the replica's stream

    async def shutdown(self) -> None:
        if self._poll_task is not None:
            self._poll_task.cancel()
            self._poll_task = None
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None
            self._ready = False
