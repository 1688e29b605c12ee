"""Typed resource sets with fixed-point arithmetic: the port's copy of
:mod:`raytpu.core.resources`, with ``"GPU"`` (cards) where the JAX
package counts ``"TPU"`` chips.

Reference analogue: ``src/ray/common/scheduling/resource_set.h:31,141``
(``ResourceSet``/``NodeResourceSet``) and ``fixed_point.h``. Quantities are
stored as integer milli-units so fractional resources (e.g. ``{"CPU": 0.5}``)
compose without float drift — the same trick as the reference's
``FixedPoint`` (1/10000 granularity there; 1/1000 here).

The distinguished resource name ``"GPU"`` counts cards; which card a
grant binds is the driver's ledger's (:mod:`raytpu_torch.runtime.ledger`),
on top of plain counts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

GRANULARITY = 1000  # milli-units

CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


def _to_fixed(v: float) -> int:
    q = round(v * GRANULARITY)
    if q < 0:
        raise ValueError(f"negative resource quantity {v}")
    return q


class ResourceSet:
    """An immutable-ish bag of {resource name: fixed-point quantity}."""

    __slots__ = ("_q",)

    def __init__(self, amounts: Optional[Mapping[str, float]] = None, *,
                 _fixed: Optional[Dict[str, int]] = None):
        if _fixed is not None:
            self._q = {k: v for k, v in _fixed.items() if v != 0}
        else:
            self._q = {k: _to_fixed(v) for k, v in (amounts or {}).items()
                       if _to_fixed(v) != 0}

    def get(self, name: str) -> float:
        return self._q.get(name, 0) / GRANULARITY

    def names(self) -> Iterable[str]:
        return self._q.keys()

    def is_empty(self) -> bool:
        return not self._q

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(other._q.get(k, 0) >= v for k, v in self._q.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._q)
        for k, v in other._q.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet(_fixed=out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        return self.minus(other, allow_negative=False)

    def minus(self, other: "ResourceSet", allow_negative: bool) -> "ResourceSet":
        out = dict(self._q)
        for k, v in other._q.items():
            nv = out.get(k, 0) - v
            if nv < 0 and not allow_negative:
                raise ValueError(f"resource {k} would go negative")
            out[k] = nv
        return ResourceSet(_fixed=out)

    def to_dict(self) -> Dict[str, float]:
        return {k: v / GRANULARITY for k, v in self._q.items()}

    def to_fixed_dict(self) -> Dict[str, int]:
        return dict(self._q)

    @classmethod
    def from_fixed_dict(cls, d: Mapping[str, int]) -> "ResourceSet":
        return cls(_fixed=dict(d))

    def __eq__(self, other) -> bool:
        return isinstance(other, ResourceSet) and other._q == self._q

    def __repr__(self) -> str:
        return f"ResourceSet({self.to_dict()})"


class NodeResources:
    """Total + available resources of one node.

    Reference: ``NodeResourceSet`` (`resource_set.h:141`) plus the
    total/available split tracked by ``ClusterResourceManager``.
    """

    def __init__(self, total: ResourceSet):
        self.total = total
        self.available = ResourceSet(_fixed=total.to_fixed_dict())

    def can_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.available)

    def could_ever_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.total)

    def allocate(self, request: ResourceSet, force: bool = False) -> None:
        """Claim resources. ``force`` permits transient oversubscription — used
        when a task that released its slot while blocked in ``get()`` resumes
        (the reference oversubscribes the same way when blocked workers
        reacquire their CPU)."""
        self.available = self.available.minus(request, allow_negative=force)

    def release(self, request: ResourceSet) -> None:
        self.available = self.available + request
        if not self.available.is_subset_of(self.total):
            raise ValueError("released more than allocated")

    def utilization(self) -> float:
        """Fraction of the critical (most-used) resource in use.

        Drives the hybrid pack/spread policy (reference:
        ``hybrid_scheduling_policy.h:50`` node scoring).
        """
        worst = 0.0
        for name, tot in self.total.to_fixed_dict().items():
            if tot == 0:
                continue
            used = tot - self.available.to_fixed_dict().get(name, 0)
            worst = max(worst, used / tot)
        return worst

    def to_dict(self) -> Dict[str, Dict[str, float]]:
        return {"total": self.total.to_dict(), "available": self.available.to_dict()}
