"""Placement groups: the port of :mod:`raytpu.runtime.placement_group`.

A group reserves its bundles in the driver's ledger
(:mod:`raytpu_torch.runtime.ledger`) at creation, from any process of
the tree: the local backend's semantics on one host (PACK, STRICT_PACK
and SPREAD reserve on it; STRICT_SPREAD with more than one bundle, and a
group that does not fit what is available now, raise
:class:`~raytpu_torch.core.errors.PlacementGroupError`). Tasks and
actors run in a bundle with ``placement_group=`` (and
``placement_group_bundle_index=``) or a
:class:`~raytpu_torch.util.scheduling_strategies.PlacementGroupSchedulingStrategy`;
their resources come out of the bundle's reservation, and a bundle's
``"GPU"`` binds the cards the group reserved.

Where the JAX group gives each bundle's ICI coordinates
(``chip_coords``), :meth:`PlacementGroup.info` gives each bundle's card
indices, ``"cards"``, and :meth:`PlacementGroup.cards` one bundle's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from raytpu_torch.core.ids import PlacementGroupID
from raytpu_torch.runtime.ledger import VALID_STRATEGIES


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str):
        self._id = pg_id
        self._bundles = bundles
        self._strategy = strategy

    @property
    def id(self) -> PlacementGroupID:
        return self._id

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    @property
    def strategy(self) -> str:
        return self._strategy

    def ready(self):
        """A ref that resolves to whether the group is reserved (the
        reservation is made at creation, so at once)."""
        from raytpu_torch.runtime import api

        info = self.info()
        return api.put(info is not None and info["state"] == "created")

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        info = self.info()
        return info is not None and info["state"] == "created"

    def info(self) -> Optional[dict]:
        """``{"id", "name", "state", "strategy", "bundles", "cards"}``, or
        None once the group is removed."""
        from raytpu_torch.runtime import api

        return api.ledger_call("group_info", self._id.hex())

    def cards(self, bundle_index: int) -> List[int]:
        """The card indices a bundle reserved (the counterpart of the
        JAX group's ``chip_coords``)."""
        info = self.info()
        return [] if info is None else list(info["cards"][bundle_index])

    def __reduce__(self):
        return (PlacementGroup, (self._id, self._bundles, self._strategy))

    def __eq__(self, other):
        return isinstance(other, PlacementGroup) and other._id == self._id

    def __hash__(self):
        return hash(self._id)


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None
                    ) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty dicts")
    from raytpu_torch.runtime import api

    bundles = [{k: float(v) for k, v in b.items()} for b in bundles]
    pg_id = api.ledger_call("create_group", bundles, strategy, name)
    return PlacementGroup(PlacementGroupID.from_hex(pg_id), bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    from raytpu_torch.runtime import api

    api.ledger_call("remove_group", pg.id.hex())


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The group the calling task or actor runs in, else None."""
    from raytpu_torch.runtime import api, context

    pg_hex = context.current().placement_group_id
    if pg_hex is None:
        return None
    info = api.ledger_call("group_info", pg_hex)
    if info is None:
        return None
    return PlacementGroup(PlacementGroupID.from_hex(pg_hex), info["bundles"],
                          info["strategy"])
