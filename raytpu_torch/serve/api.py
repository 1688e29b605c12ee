"""Serve public API: the port of :mod:`raytpu.serve.api`.

``serve.run`` deploys an application (its composed deployments
included) and returns a handle to its ingress; ``status``, ``delete``,
``shutdown``, ``get_deployment_handle`` and ``get_app_handle`` as in the
JAX package, each a call on the controller actor (``SERVE_CONTROLLER``,
a process of its own that the first ``run`` starts:
``_private/controller.py``); ``shutdown`` drains and kills every replica
process and then the controller's, leaving no process.

What differs: ``start``, ``ingress`` and ``run(_start_http=True)`` raise
``NotImplementedError``, since the HTTP and gRPC proxies are not ported
(ROADMAP.md); ``route_prefix`` is kept as data. A deployment whose
replica constructor raises makes ``run`` raise at once with that error.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from raytpu_torch.serve._private.controller import (get_controller,
                                                    get_or_create_controller,
                                                    stop_controller)
from raytpu_torch.serve.deployment import Application, build_app
from raytpu_torch.serve.handle import DeploymentHandle

_NO_PROXY = ("the port has no HTTP or gRPC proxy and no ASGI ingress yet "
             "(ROADMAP.md, Queue 1): call deployments through handles")


def start(http_options=None, **kwargs) -> None:
    """Start the HTTP proxy: not in the port."""
    raise NotImplementedError(_NO_PROXY)


def ingress(asgi_app):
    """``@serve.ingress(app)``: not in the port."""
    raise NotImplementedError(_NO_PROXY)


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
    soon as a replica's constructor raises."""
    if _start_http:
        raise NotImplementedError(_NO_PROXY)
    ingress_name, configs, dep_configs = build_app(app, name)
    controller = get_or_create_controller()
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
    """Stop every router, drain and kill every replica process, and end
    the controller's process. Safe to call when serve is not running."""
    from raytpu_torch.serve._private.router import Router

    Router.reset_all()
    stop_controller()
