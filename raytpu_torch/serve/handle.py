"""DeploymentHandle: the Python-native way to call a deployment; the port
of :mod:`raytpu.serve.handle`.

``handle.remote(...)`` routes through the power-of-two-choices router;
the response wraps an ObjectRef of the port's runtime and supports
``.result()``, ``await``, and being passed as an argument to another
deployment call. ``handle.method.remote_streaming(...)`` returns an
iterator of the handler's chunks, consumable while the handler still
runs. A handle pickles by name and routes from any process of the tree
(a composed deployment's replica holds its children's handles): its
router looks the controller up by name there.

What differs from the JAX package: a response passed as an argument is
resolved in the caller before the call is sent (the port has no object
store a replica could fetch it from).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Dict, Optional, Tuple

from raytpu_torch import runtime
from raytpu_torch.runtime import ObjectRef
from raytpu_torch.util import serve_slo, task_events

class DeploymentResponse:
    def __init__(self, ref: ObjectRef):
        self._ref = ref

    def result(self, timeout_s: Optional[float] = None) -> Any:
        return runtime.get(self._ref, timeout=timeout_s)

    def __await__(self):
        return asyncio.get_event_loop().run_in_executor(
            None, self.result).__await__()


class DeploymentResponseGenerator:
    """Iterator over a streaming deployment response's *values* (each chunk
    the handler yielded), wrapping the underlying ObjectRefGenerator.

    This is the consumer-side SLO seam: the router stamps the request's
    identity onto the ref generator (``_raytpu_request_meta``), and this
    wrapper books TTFT at the first chunk, TPOT/e2e/delivered exactly
    once at clean exhaustion, and — when the stream dies mid-flight —
    closes the timeline with FAILED and books every chunk already
    received as ``abort`` waste (the consumer restarts from scratch;
    those tokens bought nothing)."""

    def __init__(self, ref_gen):
        self._gen = ref_gen
        self._meta = dict(
            getattr(ref_gen, "_raytpu_request_meta", None) or {})
        self._n = 0
        self._t_start = time.monotonic()
        self._t_first = 0.0
        self._t_last = 0.0
        self._settled = False  # SLOs/waste booked (exactly once)

    @property
    def request_id(self) -> str:
        """Router-stamped identity of this stream's request (empty for
        streams that never crossed a router)."""
        return str(self._meta.get("request_id") or "")

    def __iter__(self) -> "DeploymentResponseGenerator":
        return self

    def __next__(self) -> Any:
        try:
            val = runtime.get(next(self._gen))
        except StopIteration:
            self._settle_ok()
            raise
        except Exception as e:
            self._settle_failed(e)
            raise
        self._n += 1
        now = time.monotonic()
        self._t_last = now
        if self._n == 1:
            self._t_first = now
            if self._meta:
                serve_slo.observe_ttft(now - self._t_start,
                                       self._meta.get("deployment", ""),
                                       self._meta.get("tenant", ""))
        return val

    def _settle_ok(self) -> None:
        if self._settled or not self._meta:
            return
        self._settled = True
        dep = self._meta.get("deployment", "")
        tenant = self._meta.get("tenant", "")
        now = time.monotonic()
        serve_slo.observe_e2e(now - self._t_start, dep, tenant)
        if self._n >= 2:
            # Mean inter-token gap, one observation per request — the
            # per-token loop never touches a histogram.
            serve_slo.observe_tpot(
                (self._t_last - self._t_first) / (self._n - 1),
                dep, tenant)
        else:
            serve_slo.observe_tpot(0.0, dep, tenant)
        serve_slo.delivered(self._n, dep, tenant)

    def _settle_failed(self, exc: BaseException) -> None:
        if self._settled or not self._meta:
            return
        self._settled = True
        dep = self._meta.get("deployment", "")
        tenant = self._meta.get("tenant", "")
        serve_slo.wasted("abort", self._n, dep, tenant)
        if task_events.request_events_enabled():
            task_events.emit_request(
                self.request_id, task_events.RequestTransition.FAILED,
                deployment=dep, tenant=tenant,
                data={"tokens_received": self._n}, error=str(exc))

    def __aiter__(self) -> "DeploymentResponseGenerator":
        return self

    async def __anext__(self) -> Any:
        loop = asyncio.get_event_loop()
        ok, val = await loop.run_in_executor(None, self._pull)
        if not ok:
            raise StopAsyncIteration
        return val

    def _pull(self):
        try:
            return True, next(self)
        except StopIteration:
            return False, None

    def close(self) -> None:
        """Cancel the stream: tells the producer side to stop (its
        generator sees GeneratorExit at the next yield, running any
        ``finally`` cleanup — e.g. an LLM replica freeing the
        sequence's KV pages). Safe to call twice; iteration after
        close raises StopIteration."""
        # A cancelled stream is neither delivered nor failed from the
        # client's side — the replica's abort path owns the timeline
        # (ABORTED); don't let a post-close StopIteration book SLOs.
        self._settled = True
        close_fn = getattr(self._gen, "close", None)
        if close_fn is not None:
            close_fn()

    def __enter__(self) -> "DeploymentResponseGenerator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DeploymentHandle:
    def __init__(
        self,
        deployment_name: str,
        app_name: str = "default",
        method_name: str = "__call__",
        max_ongoing: int = 100,
        _meta: Optional[Dict[str, Any]] = None,
    ):
        self.deployment_name = deployment_name
        self.app_name = app_name
        self._method_name = method_name
        self._max_ongoing = max_ongoing
        self._meta = dict(_meta or {})
        self._router = None

    @property
    def full_name(self) -> str:
        return f"{self.app_name}#{self.deployment_name}"

    def _get_router(self):
        if self._router is None:
            from raytpu_torch.serve._private.router import Router

            self._router = Router(self.full_name, self._max_ongoing)
        return self._router

    def options(self, *, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                **_ignored) -> "DeploymentHandle":
        meta = dict(self._meta)
        if multiplexed_model_id is not None:
            meta["multiplexed_model_id"] = multiplexed_model_id
        h = DeploymentHandle(
            self.deployment_name, self.app_name,
            method_name or self._method_name, self._max_ongoing, meta,
        )
        h._router = self._router
        return h

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        args, kwargs = _resolved(args, kwargs)
        ref = self._get_router().assign_request(
            self._method_name, args, kwargs, request_meta=self._meta
        )
        return DeploymentResponse(ref)

    def is_asgi(self, timeout_s: float = 30.0) -> bool:
        return self._get_router().probe_asgi(timeout_s=timeout_s)

    def remote_asgi(self, scope: dict, body: bytes) -> DeploymentResponse:
        """Route one HTTP request into the deployment's ASGI app."""
        ref = self._get_router().assign_request_asgi(
            scope, body, request_meta=self._meta)
        return DeploymentResponse(ref)

    def remote_streaming(self, *args, **kwargs) -> DeploymentResponseGenerator:
        """Call a streaming handler: returns an iterator of its chunks,
        consumable while the handler still runs (reference: Serve response
        streaming over ObjectRefGenerator)."""
        args, kwargs = _resolved(args, kwargs)
        gen = self._get_router().assign_request_streaming(
            self._method_name, args, kwargs, request_meta=self._meta
        )
        return DeploymentResponseGenerator(gen)

    async def remote_async(self, *args, **kwargs) -> Any:
        loop = asyncio.get_event_loop()
        resp = await loop.run_in_executor(None, lambda: self.remote(*args, **kwargs))
        return await resp

    def __reduce__(self):
        return (
            DeploymentHandle,
            (self.deployment_name, self.app_name, self._method_name,
             self._max_ongoing, self._meta),
        )

    def __eq__(self, other):
        # Structural equality so redeploys of composed apps (whose init
        # args are freshly built handles) don't read as code changes.
        if not isinstance(other, DeploymentHandle):
            return NotImplemented
        return (
            self.deployment_name == other.deployment_name
            and self.app_name == other.app_name
            and self._method_name == other._method_name
            and self._meta == other._meta
        )

    def __hash__(self):
        return hash((self.deployment_name, self.app_name, self._method_name))


def _resolved(args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
    """A call's arguments with every DeploymentResponse among them
    replaced by its value (waited for here)."""
    def value(a):
        return a.result() if isinstance(a, DeploymentResponse) else a

    return (tuple(value(a) for a in args),
            {k: value(v) for k, v in kwargs.items()})
