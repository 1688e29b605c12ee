"""Serve public API: the port of :mod:`raytpu.serve.api`.

``serve.run`` deploys an application (its composed deployments
included) and returns a handle to its ingress; ``status``, ``delete``,
``shutdown``, ``get_deployment_handle`` and ``get_app_handle`` as in the
JAX package, each a call on the controller actor (``SERVE_CONTROLLER``,
a process of its own that the first ``run`` starts:
``_private/controller.py``). ``start`` starts the HTTP proxy (the named
detached actor ``SERVE_PROXY``, ``_private/proxy.py``) and, given a
``grpc_port``, the gRPC proxy (``SERVE_GRPC_PROXY``,
``_private/grpc_proxy.py``), each found by name or created; after a
``start`` (or with ``run(_start_http=True)``) every application's
``route_prefix`` is served over HTTP. ``@serve.ingress(app)`` binds an
ASGI app to a deployment. ``shutdown`` stops the gRPC proxy and the
HTTP proxy, then drains and kills every replica process and the
controller's, leaving no process.

What differs: a deployment whose replica constructor raises makes
``run`` raise at once with that error.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from raytpu_torch import runtime
from raytpu_torch.serve._private.controller import (get_controller,
                                                    get_or_create_controller,
                                                    stop_controller)
from raytpu_torch.serve.config import HTTPOptions
from raytpu_torch.serve.deployment import Application, build_app
from raytpu_torch.serve.handle import DeploymentHandle

PROXY_NAME = "SERVE_PROXY"
GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"
# How long shutdown waits for a proxy to stop serving before its kill.
PROXY_STOP_S = 5.0

_http_options: Optional[HTTPOptions] = None
# One start at a time in a process: a proxy's name is taken before its
# worker is up, so a second start must wait for the first to finish.
_start_lock = threading.Lock()


def start(http_options: Optional[HTTPOptions] = None, **kwargs) -> None:
    """Start the Serve instance (controller + HTTP proxy, and the gRPC
    proxy where ``grpc_port`` is set)."""
    global _http_options
    get_or_create_controller()
    opts = http_options or (HTTPOptions(**kwargs) if kwargs
                            else HTTPOptions())
    with _start_lock:
        _http_options = opts
        from raytpu_torch.serve._private.proxy import ProxyActor

        _start_proxy(PROXY_NAME, ProxyActor, opts.host, opts.port)
        if opts.grpc_port is not None:
            from raytpu_torch.serve._private.grpc_proxy import GrpcProxyActor

            _start_proxy(GRPC_PROXY_NAME, GrpcProxyActor, opts.host,
                         opts.grpc_port)


def _start_proxy(name: str, cls, host: str, port: int) -> None:
    """Find the proxy actor by name, or create it (named, detached), and
    wait until it serves."""
    try:
        proxy = runtime.get_actor(name)
    except ValueError:
        proxy = runtime.remote(cls).options(
            name=name, lifetime="detached",
            max_concurrency=10_000).remote(host, port)
    runtime.get(proxy.ready.remote())


def ingress(asgi_app):
    """Class decorator binding an ASGI app to a deployment
    (``@serve.ingress(app)``): the app runs INSIDE each replica, so any
    ASGI framework (or a bare ``async def app(scope, receive, send)``)
    serves next to the model. The proxy detects the transport and
    forwards the raw request instead of the :class:`Request` contract.
    The class is pickled by name, so it and the app sit at a module's top
    level::

        @serve.deployment
        @serve.ingress(my_asgi_app)
        class Server:
            ...
    """

    def decorator(cls):
        cls.__raytpu_asgi_app__ = staticmethod(asgi_app)
        return cls

    return decorator


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = "/",
    blocking: bool = False,
    _start_http: bool = False,
    wait_for_ready_timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application and return a handle to its ingress, once
    every deployment of it runs. Raises before any process starts where
    the application cannot cross to a replica (``build_app``), and as
    soon as a replica's constructor raises. HTTP ingress is opt-in
    (``_start_http=True`` or a prior ``start()``); handle-only apps skip
    the proxy entirely."""
    ingress_name, configs, dep_configs = build_app(app, name)
    controller = get_or_create_controller()
    if _start_http or _http_options is not None:
        start(_http_options)
    controller.call("deploy_application", name, route_prefix, ingress_name,
                    configs)
    _wait_healthy(controller, name, wait_for_ready_timeout_s)
    handle = DeploymentHandle(
        ingress_name, name,
        max_ongoing=dep_configs[ingress_name].max_ongoing_requests)
    if blocking:  # pragma: no cover - interactive use
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
    return handle


def _wait_healthy(controller, app_name: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = controller.call("status")
        deps = st.get(app_name, {}).get("deployments", {})
        failed = {n: d["message"] for n, d in deps.items()
                  if d["status"] == "DEPLOY_FAILED"}
        if failed:
            raise RuntimeError(f"application {app_name!r}: deployments "
                               f"failed to start: {failed}")
        if deps and all(d["status"] == "RUNNING" for d in deps.values()):
            return
        time.sleep(0.05)
    raise TimeoutError(f"application {app_name!r} not healthy after {timeout_s}s")


def status() -> Dict[str, Any]:
    return get_controller().call("status")


def get_deployment_handle(
    deployment_name: str, app_name: str = "default"
) -> DeploymentHandle:
    return DeploymentHandle(deployment_name, app_name)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    st = get_controller().call("status")
    if name not in st:
        raise KeyError(f"no application named {name!r}")
    return DeploymentHandle(st[name]["ingress"], name)


def delete(name: str) -> None:
    get_controller().call("delete_application", name)


def shutdown() -> None:
    """Stop every router, stop and end the proxies' processes, drain and
    kill every replica process, and end the controller's process. Safe
    to call when serve is not running."""
    global _http_options
    from raytpu_torch.serve._private.router import Router

    Router.reset_all()
    for name in (GRPC_PROXY_NAME, PROXY_NAME):
        try:
            proxy = runtime.get_actor(name)
        except ValueError:
            continue
        try:
            runtime.get(proxy.shutdown.remote(), timeout=PROXY_STOP_S)
        except Exception:  # a proxy that cannot stop is killed all the same
            pass
        runtime.kill(proxy)
    stop_controller()
    _http_options = None
