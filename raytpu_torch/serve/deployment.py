"""Deployment decorator and application building: the port of
:mod:`raytpu.serve.deployment`.

A ``Deployment`` is the declarative unit; ``.bind(*args)`` produces an
application node; ``build_app`` resolves the graph into one
``ReplicaConfig`` a deployment: a bound node in another node's arguments
becomes that deployment's ``DeploymentHandle`` there, and is deployed as
part of the application (composition); a ``DeploymentHandle`` among the
arguments passes as it is. What differs from the JAX package: no
``cloudpickle``; the target is pickled by name (a class or function at a
module's top level), and ``build_app`` refuses, before any process
starts, a target or an init argument that does not pickle, naming it.
"""

from __future__ import annotations

import pickle
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, Dict, List, Optional, Tuple

from raytpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                       ReplicaConfig)

class Deployment:
    def __init__(self, target: Callable, name: str, config: DeploymentConfig):
        self._target = target
        self.name = name
        self.config = config

    def options(self, **kwargs) -> "Deployment":
        cfg_fields = {
            "num_replicas", "max_ongoing_requests", "user_config",
            "graceful_shutdown_timeout_s", "graceful_shutdown_wait_loop_s",
            "health_check_period_s", "health_check_timeout_s",
            "autoscaling_config", "ray_actor_options", "max_queued_requests",
            "role",
        }
        name = kwargs.pop("name", self.name)
        updates = {k: v for k, v in kwargs.items() if k in cfg_fields}
        unknown = set(kwargs) - cfg_fields
        if unknown:
            raise ValueError(f"unknown deployment options: {sorted(unknown)}")
        merged = {**self.config.__dict__, **updates}
        if merged.get("num_replicas") == "auto":
            merged["num_replicas"] = 1
            if merged.get("autoscaling_config") is None:
                merged["autoscaling_config"] = AutoscalingConfig()
        return Deployment(self._target, name, DeploymentConfig(**merged))

    def bind(self, *args, **kwargs) -> "Application":
        return Application(DeploymentNode(self, args, kwargs))

    def __call__(self, *a, **kw):
        raise TypeError(
            f"deployment {self.name} cannot be called directly; deploy it "
            f"with serve.run(...) and call the handle"
        )


class DeploymentNode:
    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Application:
    """A bound ingress node plus (transitively) everything it depends on."""

    def __init__(self, ingress: DeploymentNode):
        self._ingress = ingress

    def _collect(self) -> List[DeploymentNode]:
        """Every node of the graph, each once, a node after those in its
        arguments."""
        seen: Dict[int, DeploymentNode] = {}
        order: List[DeploymentNode] = []

        def visit(node: DeploymentNode):
            if id(node) in seen:
                return
            seen[id(node)] = node
            for a in list(node.args) + list(node.kwargs.values()):
                if isinstance(a, Application):
                    visit(a._ingress)
                elif isinstance(a, DeploymentNode):
                    visit(a)
            order.append(node)

        visit(self._ingress)
        return order


def _check_pickles(what: str, value) -> None:
    """Refuse a value that cannot cross to a replica process, naming it."""
    try:
        ForkingPickler.dumps(value)
    except Exception as exc:
        raise TypeError(f"{what} does not pickle ({type(exc).__name__}: "
                        f"{exc}); a replica process rebuilds it by pickle, "
                        f"so it must be importable by name (a module's top "
                        f"level) or plain data") from exc


def build_app(
    app: Application, app_name: str
) -> Tuple[str, List[ReplicaConfig], Dict[str, DeploymentConfig]]:
    """The application's ingress name, a ``ReplicaConfig`` for each of its
    deployments (nested bound nodes become DeploymentHandles in their
    parent's init arguments; two nodes of one deployment get the names
    ``name`` and ``name_1``), and each ``DeploymentConfig`` by name;
    raises before any process starts."""
    from raytpu_torch.serve.handle import DeploymentHandle

    nodes = app._collect()
    names: Dict[int, str] = {}
    used: Dict[str, int] = {}
    for node in nodes:
        base = node.deployment.name
        n = used.get(base, 0)
        used[base] = n + 1
        names[id(node)] = base if n == 0 else f"{base}_{n}"

    def resolve(what: str, v):
        if isinstance(v, Application):
            v = v._ingress
        if isinstance(v, DeploymentNode):
            return DeploymentHandle(
                names[id(v)], app_name,
                max_ongoing=v.deployment.config.max_ongoing_requests)
        _check_pickles(what, v)
        return v

    configs: List[ReplicaConfig] = []
    dep_configs: Dict[str, DeploymentConfig] = {}
    for node in nodes:
        dep, name = node.deployment, names[id(node)]
        try:
            serialized = pickle.dumps(dep._target)
        except Exception as exc:
            raise TypeError(
                f"deployment {name}: its target {dep._target!r} does not "
                f"pickle by name ({type(exc).__name__}: {exc}); define it "
                f"at a module's top level") from exc
        configs.append(ReplicaConfig(
            deployment_name=name, app_name=app_name,
            serialized_callable=serialized,
            init_args=tuple(
                resolve(f"deployment {name}: init argument {i!r}", a)
                for i, a in enumerate(node.args)),
            init_kwargs={
                k: resolve(f"deployment {name}: init argument {k!r}", v)
                for k, v in node.kwargs.items()},
            deployment_config=dep.config))
        dep_configs[name] = dep.config
    return names[id(app._ingress)], configs, dep_configs


def deployment(
    _target: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Any = 1,
    max_ongoing_requests: int = 100,
    user_config: Optional[Any] = None,
    autoscaling_config: Optional[Any] = None,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    health_check_period_s: float = 2.0,
    health_check_timeout_s: float = 30.0,
    graceful_shutdown_timeout_s: float = 20.0,
    max_queued_requests: int = -1,
    role: Optional[str] = None,
) -> Any:
    """``@serve.deployment`` (reference: ``python/ray/serve/api.py``)."""

    def wrap(target: Callable) -> Deployment:
        nonlocal num_replicas, autoscaling_config
        if num_replicas == "auto":
            num_replicas = 1
            if autoscaling_config is None:
                autoscaling_config = AutoscalingConfig()
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=autoscaling_config,
            ray_actor_options=dict(ray_actor_options or {}),
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            max_queued_requests=max_queued_requests,
            role=role,
        )
        return Deployment(target, name or target.__name__, cfg)

    if _target is not None:
        return wrap(_target)
    return wrap
