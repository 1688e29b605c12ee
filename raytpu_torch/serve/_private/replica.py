"""Replica actor: hosts one copy of the user callable; the port of
:mod:`raytpu.serve._private.replica`.

The replica wraps the user class or function, tracks queued and ongoing
request counts (the autoscaler's input), enforces
``max_ongoing_requests``, and exposes health checks and ``reconfigure``.
It is the body of a worker process of the port's runtime started with a
high ``max_concurrency``: its coroutine methods run on the worker's event
loop, its sync probes (``get_queue_len``, ``get_metrics``,
``get_prefix_summary``) on the worker's threads, so a probe answers while
streams are open. A streamed request is ``handle_request_streaming``, an
async generator the runtime streams chunk by chunk; a sync generator
handler (``LLMDeployment.generate``) drains on the replica's executor with
the request context carried in, and a client's close reaches it through
the runtime's cancel: the handler is closed at once, or, when its
``next()`` is in flight on the executor, right after that ``next()``
returns.

An ASGI deployment (``@serve.ingress(app)``) runs its app here, next to
the model: the proxy ships each request's wire-safe scope (str headers,
query and raw path) and body to ``handle_request_asgi``, which
rehydrates them to ASGI's bytes and buffers the app's reply.

What differs from the JAX package: the target arrives pickled by name (no
``cloudpickle``).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextvars
import inspect
import pickle
import time
from typing import Any, Dict, Optional

from raytpu_torch.util import serve_slo, task_events

# Ambient per-request context (reference: serve.context._serve_request_context)
_request_context: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "raytpu_torch_serve_request_context", default={}
)


def get_request_context() -> Dict[str, Any]:
    return _request_context.get()


class TooManyQueuedRequests(Exception):
    pass


class Replica:
    """Generic replica actor body. Started by the controller as a worker
    of the port's runtime with ``max_concurrency`` high; concurrency is
    governed by the deployment's ``max_ongoing_requests`` instead
    (reference replica does the same)."""

    def __init__(self, replica_id: str, replica_config):
        self._replica_id = replica_id
        self._config = replica_config
        dep_cfg = self._config.deployment_config
        target = pickle.loads(self._config.serialized_callable)
        if inspect.isclass(target):
            self._callable = target(
                *self._config.init_args, **self._config.init_kwargs
            )
        else:
            self._callable = target
        self._num_ongoing = 0
        self._num_queued = 0
        self._total_handled = 0
        self._max_ongoing = dep_cfg.max_ongoing_requests
        self._max_queued = dep_cfg.max_queued_requests
        self._sem = asyncio.Semaphore(self._max_ongoing)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(4, min(self._max_ongoing, 64)),
            thread_name_prefix=f"replica-{replica_id}",
        )
        self._shutting_down = False
        # Window of (timestamp, ongoing) samples for autoscaling metrics.
        self._metric_samples: list = []
        if dep_cfg.user_config is not None:
            self._apply_user_config(dep_cfg.user_config)

    # -- control plane ----------------------------------------------------

    def _apply_user_config(self, user_config: Any) -> None:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is None:
            raise AttributeError(
                "deployment got user_config but the class has no "
                "reconfigure(user_config) method"
            )
        fn(user_config)

    async def reconfigure(self, user_config: Any) -> None:
        self._apply_user_config(user_config)

    async def check_health(self) -> Dict[str, Any]:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            out = fn()
            if inspect.isawaitable(out):
                await out
        # Piggyback the prefix-cache advertisement on the health reply:
        # the controller already pays this round-trip every
        # health_check_period_s, so the broadcast path costs zero extra
        # RPCs. The controller also accepts the legacy bare-bool reply
        # (mid-upgrade replicas keep their health checks).
        return {"healthy": True,
                "prefix_summary": self.get_prefix_summary()}

    async def prepare_for_shutdown(self, wait_loop_s: float, timeout_s: float) -> None:
        """Drain: refuse new work, wait for ongoing requests to finish."""
        self._shutting_down = True
        deadline = time.monotonic() + timeout_s
        while self._num_ongoing > 0 and time.monotonic() < deadline:
            await asyncio.sleep(wait_loop_s)

    # -- data plane --------------------------------------------------------

    def get_queue_len(self) -> int:
        """Probe used by the power-of-two-choices router."""
        return self._num_ongoing + self._num_queued

    def get_prefix_summary(self) -> Optional[Dict[str, Any]]:
        """Routing probe: the deployment's prefix-cache digest summary
        (see serve/_private/prefix_router.py). Bypasses the request
        queue/semaphore like ``get_queue_len`` so a saturated replica
        can still advertise its cache; returns None for deployments
        that don't expose one. Never raises — a broken summary must
        degrade routing to blind power-of-two, not fail the request."""
        fn = getattr(self._callable, "prefix_summary", None)
        if not callable(fn):
            return None
        try:
            return fn()
        except Exception:
            return None

    def get_metrics(self) -> Dict[str, float]:
        now = time.monotonic()
        self._metric_samples = [
            (t, v) for (t, v) in self._metric_samples if now - t < 10.0
        ]
        if self._metric_samples:
            avg = sum(v for _, v in self._metric_samples) / len(self._metric_samples)
        else:
            avg = float(self._num_ongoing + self._num_queued)
        out = {
            "replica_id": self._replica_id,
            "ongoing": float(self._num_ongoing),
            "queued": float(self._num_queued),
            "avg_ongoing": avg,
            "total_handled": float(self._total_handled),
        }
        # Deployments that expose engine-level load (LLMDeployment's
        # engine_pressure) get their gauges forwarded as engine_* so
        # the controller can autoscale on engine pressure, not just
        # request count. Never let a user callable's bug break the
        # metrics path the autoscaler depends on.
        pressure_fn = getattr(self._callable, "engine_pressure", None)
        if callable(pressure_fn):
            try:
                for k, v in dict(pressure_fn()).items():
                    out[f"engine_{k}"] = float(v)
            except Exception:
                pass
        return out

    async def handle_request(
        self,
        method_name: str,
        request_args: tuple,
        request_kwargs: dict,
        request_meta: Optional[dict] = None,
    ) -> Any:
        if self._shutting_down:
            raise RuntimeError(f"replica {self._replica_id} is draining")
        if self._max_queued >= 0 and self._num_queued >= self._max_queued:
            raise TooManyQueuedRequests(
                f"replica {self._replica_id}: {self._num_queued} queued >= "
                f"max_queued_requests={self._max_queued}"
            )
        self._num_queued += 1
        dequeued = False
        try:
            async with self._sem:
                self._num_queued -= 1
                dequeued = True
                self._num_ongoing += 1
                self._metric_samples.append(
                    (time.monotonic(), self._num_ongoing + self._num_queued)
                )
                try:
                    token = _request_context.set(dict(request_meta or {}))
                    try:
                        return await self._invoke(
                            method_name, request_args, request_kwargs
                        )
                    finally:
                        _request_context.reset(token)
                finally:
                    self._num_ongoing -= 1
                    self._total_handled += 1
        finally:
            if not dequeued:
                # The semaphore acquire itself failed/cancelled: undo enqueue.
                self._num_queued -= 1

    def is_asgi(self) -> bool:
        """Whether this deployment wraps an ASGI app (``@serve.ingress``);
        probed once by the proxy to pick the transport."""
        return getattr(type(self._callable), "__raytpu_asgi_app__",
                       None) is not None or \
            getattr(self._callable, "__raytpu_asgi_app__", None) is not None

    async def handle_request_asgi(self, scope: dict, body: bytes,
                                  request_meta: Optional[dict] = None
                                  ) -> dict:
        """Run one HTTP request through the deployment's ASGI app. The
        proxy ships (scope, body); the reply carries status, headers and
        body (a multi-chunk body is buffered; token streaming takes the
        SSE path instead)."""
        app = getattr(self._callable, "__raytpu_asgi_app__", None) or \
            getattr(type(self._callable), "__raytpu_asgi_app__", None)
        if app is None:
            raise RuntimeError(
                f"deployment {self._config.deployment_name} has no ASGI "
                "app (missing @serve.ingress)")
        if self._shutting_down:
            raise RuntimeError(f"replica {self._replica_id} is draining")
        if self._max_queued >= 0 and self._num_queued >= self._max_queued:
            raise TooManyQueuedRequests(
                f"replica {self._replica_id}: {self._num_queued} queued >= "
                f"max_queued_requests={self._max_queued}"
            )
        self._num_queued += 1
        dequeued = False
        try:
            async with self._sem:
                self._num_queued -= 1
                dequeued = True
                self._num_ongoing += 1
                self._metric_samples.append(
                    (time.monotonic(), self._num_ongoing + self._num_queued)
                )
                token = _request_context.set(dict(request_meta or {}))
                try:
                    return await self._run_asgi(app, scope, body)
                finally:
                    _request_context.reset(token)
                    self._num_ongoing -= 1
                    self._total_handled += 1
        finally:
            if not dequeued:
                self._num_queued -= 1

    @staticmethod
    async def _run_asgi(app, scope: dict, body: bytes) -> dict:
        # Rehydrate wire-safe scope fields into the ASGI byte types.
        scope = dict(scope)
        scope["headers"] = [(k.encode("latin-1"), v.encode("latin-1"))
                            for k, v in scope.get("headers", [])]
        scope["query_string"] = scope.get("query_string", "").encode()
        scope["raw_path"] = scope.get("raw_path", "/").encode()
        sent = {"status": 500, "headers": [], "chunks": []}
        received = {"done": False}

        async def receive():
            if received["done"]:
                return {"type": "http.disconnect"}
            received["done"] = True
            return {"type": "http.request", "body": body,
                    "more_body": False}

        async def send(message):
            if message["type"] == "http.response.start":
                sent["status"] = int(message["status"])
                sent["headers"] = [
                    (k.decode("latin-1"), v.decode("latin-1"))
                    for k, v in message.get("headers", [])]
            elif message["type"] == "http.response.body":
                chunk = message.get("body", b"")
                if chunk:
                    sent["chunks"].append(bytes(chunk))

        await app(scope, receive, send)
        return {"status": sent["status"], "headers": sent["headers"],
                "body": b"".join(sent["chunks"])}

    async def handle_request_streaming(
        self,
        method_name: str,
        request_args: tuple,
        request_kwargs: dict,
        request_meta: Optional[dict] = None,
    ):
        """Streaming twin of :meth:`handle_request` — an async generator
        yielding the handler's chunks. Invoked with
        ``num_returns="streaming"`` so each chunk becomes an object the
        caller can consume while the handler still runs (reference: Serve
        StreamingResponse over ObjectRefGenerator)."""
        if self._shutting_down:
            raise RuntimeError(f"replica {self._replica_id} is draining")
        if self._max_queued >= 0 and self._num_queued >= self._max_queued:
            raise TooManyQueuedRequests(
                f"replica {self._replica_id}: {self._num_queued} queued >= "
                f"max_queued_requests={self._max_queued}"
            )
        meta = dict(request_meta or {})
        rid = str(meta.get("request_id") or "")
        dep = str(meta.get("deployment") or "")
        tenant = str(meta.get("tenant") or "")
        self._num_queued += 1
        enqueue_t = time.monotonic()
        if task_events.request_events_enabled() and rid:
            task_events.emit_request(
                rid, task_events.RequestTransition.QUEUED,
                deployment=dep, tenant=tenant,
                data={"queued": self._num_queued,
                      "ongoing": self._num_ongoing})
        dequeued = False
        try:
            async with self._sem:
                self._num_queued -= 1
                dequeued = True
                self._num_ongoing += 1
                if rid:
                    # Queue wait = enqueue → semaphore grant, once per
                    # request, under the request's own deployment tags.
                    serve_slo.observe_queue(
                        time.monotonic() - enqueue_t, dep, tenant)
                self._metric_samples.append(
                    (time.monotonic(), self._num_ongoing + self._num_queued)
                )
                token = _request_context.set(meta)
                try:
                    result = await self._invoke_stream(
                        method_name, request_args, request_kwargs
                    )
                    if hasattr(result, "__aiter__"):
                        async for chunk in result:
                            yield chunk
                    elif hasattr(result, "__next__") or hasattr(
                            result, "__iter__"):
                        # Drain sync generators on the executor: each
                        # next() may block (an LLM replica waits a full
                        # decode step per token) and must not stall the
                        # event loop — concurrent streams and health
                        # checks keep running between chunks.
                        it = iter(result)
                        # A generator body only runs at next() — on the
                        # executor thread, which does not inherit
                        # contextvars. Carry the request context over
                        # explicitly so the handler (and the engine
                        # underneath it) sees the router-stamped request
                        # id; sequential ctx.run() re-entry is legal.
                        ctx = contextvars.copy_context()
                        pending = None  # the next() on the executor

                        def _next_chunk():
                            try:
                                return True, next(it)
                            except StopIteration:
                                return False, None

                        try:
                            while True:
                                pending = self._executor.submit(
                                    ctx.run, _next_chunk)
                                ok, chunk = await asyncio.wrap_future(
                                    pending)
                                if not ok:
                                    break
                                yield chunk
                        finally:
                            # Consumer went away mid-stream: push
                            # GeneratorExit into the handler so its
                            # finally blocks (request abort, KV-page
                            # free) run now. If next() is mid-flight on
                            # the executor the close raises ValueError:
                            # the handler is closed the moment that
                            # next() returns (an error of that close is
                            # logged by concurrent.futures).
                            close_fn = getattr(it, "close", None)
                            if close_fn is not None:
                                try:
                                    close_fn()
                                except ValueError:
                                    pending.add_done_callback(
                                        lambda _: close_fn())
                    else:  # non-streaming handler: one chunk
                        yield result
                finally:
                    try:
                        _request_context.reset(token)
                    except ValueError:
                        # A stream closed from another Context (an
                        # asyncgen finalizer): the var set in the
                        # original one died with it; nothing to reset.
                        pass
                    self._num_ongoing -= 1
                    self._total_handled += 1
        finally:
            if not dequeued:
                self._num_queued -= 1

    async def _invoke_stream(self, method_name: str, args: tuple,
                             kwargs: dict) -> Any:
        target = self._resolve_target(method_name)
        fn = target if (inspect.isfunction(target)
                        or inspect.ismethod(target)) else getattr(
            target, "__call__", target)
        if inspect.isasyncgenfunction(fn) or inspect.isgeneratorfunction(fn):
            # Generator functions return their (a)sync generator instantly;
            # the stream loop drains it off-loop.
            return target(*args, **kwargs)
        # Plain handler used with the streaming path: same executor /
        # coroutine semantics as the non-streaming invoke (single chunk).
        return await self._invoke(method_name, args, kwargs)

    def _resolve_target(self, method_name: str):
        if method_name == "__call__":
            target = self._callable
            if not callable(target):
                raise AttributeError(
                    f"deployment {self._config.deployment_name} is not callable"
                )
            return target
        target = getattr(self._callable, method_name, None)
        if target is None:
            raise AttributeError(
                f"deployment {self._config.deployment_name} has no method "
                f"{method_name!r}"
            )
        return target

    async def _invoke(self, method_name: str, args: tuple, kwargs: dict) -> Any:
        target = self._resolve_target(method_name)
        if inspect.iscoroutinefunction(target) or (
            not inspect.isfunction(target) and not inspect.ismethod(target)
            and inspect.iscoroutinefunction(
                getattr(target, "__call__", None))
        ):
            return await target(*args, **kwargs)
        # Sync callables run in a thread pool so they can't block the
        # replica's event loop (reference: sync methods execute on the
        # replica's executor; keeps queue-length metrics & health checks
        # live while user code computes).
        loop = asyncio.get_event_loop()
        out = await loop.run_in_executor(
            self._executor, lambda: target(*args, **kwargs)
        )
        if inspect.isawaitable(out):
            out = await out
        return out
