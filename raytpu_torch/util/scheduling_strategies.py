"""Scheduling strategy option objects: the port's copy of
:mod:`raytpu.util.scheduling_strategies` (reference:
``python/ray/util/scheduling_strategies.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from raytpu_torch.runtime.placement_group import PlacementGroup


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "PlacementGroup"
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False
