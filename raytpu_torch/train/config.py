"""Train's configs, the port of :mod:`raytpu.train.config`: the same
dataclasses, field for field where they apply to one host of CUDA cards.

What changed:

- ``ScalingConfig.device`` takes the place of ``use_tpu`` and
  ``chips_per_worker``: ``"cuda"`` (the default) gives each worker one
  card, ``cuda:<local rank>``, and forms the gang's process group on
  NCCL; ``"cpu"`` forms it on gloo. NCCL cannot hold two ranks on one
  card, so :func:`check_cards` refuses a CUDA gang larger than the card
  count.
- No placement groups (the port's runtime has none): no
  ``placement_strategy`` and no ``bundle_specs``.
  ``resources_per_worker`` takes ``{"CPU": n}`` only: the worker's torch
  threads.
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

import torch

from raytpu_torch import resolve_device


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    device: str = "cuda"
    resources_per_worker: Optional[Dict[str, float]] = None
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
        unknown = sorted(set(self.resources_per_worker or {}) - {"CPU"})
        if unknown:
            raise ValueError(f"resources_per_worker {unknown}: the port's "
                             f"workers take only 'CPU' (their threads)")

    @property
    def backend(self) -> str:
        """The process group's backend: NCCL on the card, gloo on the
        CPU."""
        return "nccl" if self.device == "cuda" else "gloo"

    @property
    def cpus_per_worker(self) -> int:
        return int((self.resources_per_worker or {}).get("CPU", 1))


def check_cards(scaling: ScalingConfig) -> None:
    """Raise unless the gang can form: a CUDA gang needs a card (the
    port's rule: it never moves to the CPU on its own) and one card a
    worker."""
    if scaling.device != "cuda":
        return
    resolve_device("cuda")
    cards = torch.cuda.device_count()
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
