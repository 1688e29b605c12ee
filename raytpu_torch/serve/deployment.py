"""Deployment decorator and application building: the port of
:mod:`raytpu.serve.deployment`.

A ``Deployment`` is the declarative unit; ``.bind(*args)`` produces an
application node; ``build_app`` resolves it into one ``ReplicaConfig`` a
deployment. What differs from the JAX package:

- no ``cloudpickle``: the target is pickled by name (a class or function
  at a module's top level), and ``build_app`` refuses, before any process
  starts, a target or an init argument that does not pickle, naming it;
- no composition: a bound node in another node's arguments, or a
  ``DeploymentHandle`` among them, raises ``NotImplementedError`` — the
  port's handles do not cross processes yet (ROADMAP.md).
"""

from __future__ import annotations

import pickle
from multiprocessing.reduction import ForkingPickler
from typing import Any, Callable, Dict, List, Optional, Tuple

from raytpu_torch.serve.config import (AutoscalingConfig, DeploymentConfig,
                                       ReplicaConfig)

_NO_COMPOSITION = (
    "the port's serve does not compose deployments yet: a deployment "
    "handle in a replica's init arguments needs handles across processes "
    "(ROADMAP.md, Queue 1)")


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
    """A bound ingress node (the port composes no others)."""

    def __init__(self, ingress: DeploymentNode):
        self._ingress = ingress


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
    """The application's ingress name, its ``ReplicaConfig``, and its
    ``DeploymentConfig`` by name; raises before any process starts."""
    from raytpu_torch.serve.handle import DeploymentHandle

    node = app._ingress
    dep = node.deployment
    for key, value in [*enumerate(node.args), *node.kwargs.items()]:
        if isinstance(value, (Application, DeploymentNode, DeploymentHandle)):
            raise NotImplementedError(
                f"deployment {dep.name}: init argument {key!r} is a "
                f"{type(value).__name__}: {_NO_COMPOSITION}")
        _check_pickles(f"deployment {dep.name}: init argument {key!r}",
                       value)
    try:
        serialized = pickle.dumps(dep._target)
    except Exception as exc:
        raise TypeError(
            f"deployment {dep.name}: its target {dep._target!r} does not "
            f"pickle by name ({type(exc).__name__}: {exc}); define it at a "
            f"module's top level") from exc
    config = ReplicaConfig(
        deployment_name=dep.name, app_name=app_name,
        serialized_callable=serialized, init_args=tuple(node.args),
        init_kwargs=dict(node.kwargs), deployment_config=dep.config)
    return dep.name, [config], {dep.name: dep.config}


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
