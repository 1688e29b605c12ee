"""Serve configuration schemas: the port of :mod:`raytpu.serve.config`,
field for field.

Plain dataclasses validated at construction. Two things differ from the
JAX package: ``ray_actor_options`` takes what the port's runtime takes
of a replica's resources (``num_cpus``: held in the driver's ledger, and
the replica's torch threads; ``num_gpus``: its share of the card, which
it is bound to; ``resources``: custom ones), any other key raising
``ValueError`` naming it; and ``ReplicaConfig.serialized_callable`` is
the target pickled by name with the standard pickle (no ``cloudpickle``),
so a deployment's class or function sits at a module's top level.
``HTTPOptions`` says where ``serve.start`` binds the HTTP proxy (and the
gRPC proxy, given ``grpc_port``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

# What a replica's ray_actor_options may set: the port's runtime options
# of its resources (max_concurrency the controller sets itself).
ACTOR_OPTIONS = ("num_cpus", "num_gpus", "resources")


@dataclass
class AutoscalingConfig:
    """Queue-metric driven autoscaling (reference:
    ``python/ray/serve/_private/autoscaling_policy.py:12,30`` and
    ``AutoscalingConfig`` in ``python/ray/serve/config.py``)."""

    min_replicas: int = 1
    max_replicas: int = 10
    target_ongoing_requests: float = 2.0
    # Look-back window over which request metrics are averaged.
    metrics_interval_s: float = 0.5
    look_back_period_s: float = 5.0
    # Hysteresis: how long a scale decision must persist before acting.
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 1.0
    initial_replicas: Optional[int] = None
    # Engine-pressure targets (LLM replicas): scale on the inference
    # engine's own load signals, not just ongoing request count. A
    # deployment whose replicas export engine_* metrics (see
    # LLMDeployment.engine_pressure) scales up when the summed engine
    # admission queue exceeds target_engine_waiting per replica, when
    # KV-page occupancy exceeds target_kv_utilization, or when TTFT p95
    # exceeds target_ttft_s (None disables the TTFT term).
    target_engine_waiting: float = 4.0
    target_kv_utilization: float = 0.85
    target_ttft_s: Optional[float] = None

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError("min_replicas must be >= 0")
        if self.max_replicas < max(self.min_replicas, 1):
            raise ValueError("max_replicas must be >= max(min_replicas, 1)")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")
        if self.target_engine_waiting <= 0:
            raise ValueError("target_engine_waiting must be > 0")
        if not 0 < self.target_kv_utilization <= 1:
            raise ValueError("target_kv_utilization must be in (0, 1]")
        if self.target_ttft_s is not None and self.target_ttft_s <= 0:
            raise ValueError("target_ttft_s must be > 0 when set")


@dataclass
class DeploymentConfig:
    """Per-deployment behavior (reference: ``DeploymentConfig`` proto mirror
    in ``python/ray/serve/config.py``)."""

    num_replicas: int = 1
    max_ongoing_requests: int = 100
    user_config: Optional[Any] = None
    graceful_shutdown_timeout_s: float = 20.0
    graceful_shutdown_wait_loop_s: float = 0.1
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    autoscaling_config: Optional[AutoscalingConfig] = None
    # The replica process's runtime options (ACTOR_OPTIONS).
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    max_queued_requests: int = -1  # -1 == unbounded
    # Disaggregated serving role: None (monolithic), "prefill" (serves
    # KV exports, never decodes for clients) or "decode" (pulls its
    # prompt prefixes from a prefill deployment). Published with the
    # replica snapshot so routers and operators can see the topology.
    role: Optional[str] = None

    def __post_init__(self):
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_ongoing_requests <= 0:
            raise ValueError("max_ongoing_requests must be > 0")
        if self.role not in (None, "prefill", "decode"):
            raise ValueError(
                f"role must be None, 'prefill' or 'decode', got {self.role!r}")
        if isinstance(self.autoscaling_config, dict):
            self.autoscaling_config = AutoscalingConfig(**self.autoscaling_config)
        unknown = sorted(set(self.ray_actor_options) - set(ACTOR_OPTIONS))
        if unknown:
            raise ValueError(
                f"ray_actor_options {unknown}: a replica of the port's "
                f"runtime takes only {list(ACTOR_OPTIONS)}")


@dataclass
class HTTPOptions:
    """Proxy options (reference: ``HTTPOptions`` in serve/config.py).
    ``grpc_port`` also starts the gRPC ingress (reference: gRPCOptions)."""

    host: str = "127.0.0.1"
    port: int = 8000
    root_path: str = ""
    grpc_port: Optional[int] = None

    def __post_init__(self):
        if not (0 <= self.port < 65536):
            raise ValueError("port out of range")
        if self.grpc_port is not None and not (0 <= self.grpc_port < 65536):
            raise ValueError("grpc_port out of range")


@dataclass
class ReplicaConfig:
    """Everything a replica actor needs to construct the user callable."""

    deployment_name: str
    app_name: str
    serialized_callable: bytes  # the class or function, pickled by name
    init_args: tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)
    deployment_config: DeploymentConfig = field(default_factory=DeploymentConfig)

    @property
    def full_name(self) -> str:
        return f"{self.app_name}#{self.deployment_name}"
