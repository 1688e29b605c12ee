"""Train's configs, the port of :mod:`raytpu.train.config`: the same
dataclasses, field for field where they apply to one host of CUDA cards.

What changed:

- ``ScalingConfig.device`` takes the place of ``use_tpu`` and
  ``chips_per_worker``: ``"cuda"`` (the default) gives each worker one
  card (a bundle's ``"GPU": 1``; the worker is bound to it and runs on
  ``cuda:0`` of what it sees) and forms the gang's process group on
  NCCL; ``"cpu"`` forms it on gloo. NCCL cannot hold two ranks on one
  card, so :func:`check_cards` refuses a CUDA gang larger than the
  tree's card count.
- The gang runs in a placement group of :meth:`ScalingConfig.bundle_specs`
  (``placement_strategy``, STRICT_PACK by default), as the JAX trainer's
  does; ``resources_per_worker`` takes ``"CPU"`` (held, and the worker's
  torch threads), ``"GPU"`` and custom resources.
- No elasticity and no multi-host: ``elastic=True`` with ``min_workers <
  num_workers`` and a ``coordinator_address`` other than ``None`` or
  ``"auto"`` raise :class:`NotImplementedError`. Both need what the port
  lacks: the cluster's view of live capacity (``raytpu.nodes()``) and
  hosts beyond this one. ``None`` and ``"auto"`` both mean the trainer's
  own rendezvous on this host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from raytpu_torch import resolve_device
from raytpu_torch.runtime.ledger import VALID_STRATEGIES


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    device: str = "cuda"
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "STRICT_PACK"
    coordinator_address: Optional[str] = None
    min_workers: Optional[int] = None
    elastic: bool = False

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers={self.num_workers}: a gang needs "
                             f"at least one worker")
        if self.device not in ("cuda", "cpu"):
            raise ValueError(f"device={self.device!r}: use 'cuda' (one card "
                             f"a worker, NCCL) or 'cpu' (gloo)")
        if self.elastic and self.min_workers \
                and self.min_workers < self.num_workers:
            raise NotImplementedError(
                "an elastic gang (min_workers < num_workers) needs the "
                "cluster's view of live capacity, which the port does not "
                "have; its gang is fixed-size")
        if self.coordinator_address not in (None, "auto"):
            raise NotImplementedError(
                f"coordinator_address={self.coordinator_address!r}: a "
                f"multi-host gang is not ported; the trainer forms its gang "
                f"on this host (None or 'auto')")
        if self.placement_strategy not in VALID_STRATEGIES:
            raise ValueError(f"placement_strategy="
                             f"{self.placement_strategy!r}: one of "
                             f"{VALID_STRATEGIES}")
        if self.device == "cpu" and (self.resources_per_worker or {}).get(
                "GPU"):
            raise ValueError("resources_per_worker asks for a card on a "
                             "gang of device='cpu'")

    @property
    def backend(self) -> str:
        """The process group's backend: NCCL on the card, gloo on the
        CPU."""
        return "nccl" if self.device == "cuda" else "gloo"

    @property
    def cpus_per_worker(self) -> int:
        return int((self.resources_per_worker or {}).get("CPU", 1))

    def bundle_specs(self, world_size: Optional[int] = None
                     ) -> List[Dict[str, float]]:
        """One bundle a worker, as the JAX package's (its ``"TPU"``
        chips a worker are ``"GPU": 1`` on the card); ``world_size``
        overrides ``num_workers``."""
        per = dict(self.resources_per_worker or {})
        per.setdefault("CPU", 1)
        if self.device == "cuda":
            per.setdefault("GPU", 1)
        n = self.num_workers if world_size is None else world_size
        return [dict(per) for _ in range(n)]


def check_cards(scaling: ScalingConfig) -> None:
    """Raise unless the gang can form: a CUDA gang needs a card (the
    port's rule: it never moves to the CPU on its own) and one card a
    worker, of the cards the driver's ledger holds."""
    if scaling.device != "cuda":
        return
    from raytpu_torch.runtime import api

    cards = int(api.cluster_resources().get("GPU", 0))
    if cards == 0:
        resolve_device("cuda")  # raises: no card here
    if scaling.num_workers > cards:
        raise ValueError(
            f"a CUDA gang of {scaling.num_workers} workers needs one card "
            f"each (NCCL holds one rank a card), and this host has {cards}")


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # retries of the whole worker group (gang restart)


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    verbose: int = 0


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    metrics_history: List[Dict[str, Any]]
    checkpoint: Optional[Any]
    path: Optional[str]
    error: Optional[BaseException] = None
    # The trial's hyperparameter config (reference: ``Result.config``).
    config: Optional[Dict[str, Any]] = None
