"""The driver's ledger of the tree's resources: the port's counterpart of
the JAX local backend's node ledger and placement groups
(``raytpu/runtime/local_backend.py:587-650``, ``_try_allocate``).

One :class:`Ledger` lives in the driver. It holds a
:class:`~raytpu_torch.core.resources.NodeResources` of ``"CPU"`` (the
task pool's size), ``"GPU"`` (the cards, detected without touching CUDA
by :func:`~raytpu_torch.core.topology.detect_local_gpus`, or the count
``init(num_gpus=)`` gives) and custom resources, and which share of
each card is held: a grant of ``num_gpus`` binds cards, by index into
the driver's visible cards, and the child it admits sees them through
``CUDA_VISIBLE_DEVICES``. A share of at most one card is packed onto
the first card with room; more than one takes whole free cards.

Every admission of the tree comes here: the task pool's dispatch
(:meth:`Ledger.try_acquire`: a task waits in the pool's queue), an
actor's start (:meth:`Ledger.request`: the request waits here, first in
first out among those that fit, and its callback starts the process
once it is granted), and placement groups, whose bundles reserve their
resources and cards at creation and grant from them. Other processes
reach it over their registry connection (``runtime/api.py``). A request
that can never fit (more than the total, or than its bundle holds)
raises at once; one that fits later waits.

Placement groups follow the local backend on its one host: PACK,
STRICT_PACK and SPREAD all reserve on it (SPREAD puts each bundle's
share on the card with most room, the packing strategies on the first
that fits); STRICT_SPREAD with more than one bundle raises
:class:`PlacementGroupError`, as does a group that does not fit what is
available now. ``info()`` gives each bundle's card indices (``"cards"``)
where the JAX group gives ICI coordinates.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from raytpu_torch.core.errors import PlacementGroupError
from raytpu_torch.core.resources import (CPU, GPU, GRANULARITY,
                                         NodeResources, ResourceSet)

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")
# The options of a task or an actor that place it.
PLACEMENT_OPTIONS = ("scheduling_strategy", "placement_group",
                     "placement_group_bundle_index",
                     "placement_group_capture_child_tasks")
_ONE = GRANULARITY  # one card, in fixed point
# Grant and request ids, unique across the ledgers of one driver's life.
_IDS = itertools.count(1)


def build_resources(options: Dict[str, Any],
                    default_cpus: float) -> Dict[str, float]:
    """A request's resources from its options, as the JAX package builds
    them (``raytpu/runtime/remote_function.py:59-68``), the card counted
    as ``"GPU"``: zero amounts left out."""
    res = dict(options.get("resources") or {})
    for key in (CPU, GPU):
        if key in res:
            raise ValueError(f"resources={{{key!r}: ...}}: use num_cpus / "
                             f"num_gpus")
    num_cpus = options.get("num_cpus")
    res[CPU] = default_cpus if num_cpus is None else float(num_cpus)
    num_gpus = options.get("num_gpus")
    if num_gpus:
        res[GPU] = float(num_gpus)
    for key, value in res.items():
        if not isinstance(value, (int, float)) or value < 0:
            raise ValueError(f"resource {key}={value!r}: a number >= 0")
    gpus = res.get(GPU, 0.0)
    if gpus > 1 and gpus != int(gpus):
        raise ValueError(f"num_gpus={gpus}: a share of one card, or a "
                         f"whole number of cards")
    return {k: float(v) for k, v in res.items() if v}


def placement_of(options: Dict[str, Any]) -> Tuple[Optional[str], int, bool]:
    """(group id, bundle index, capture) of a task's or an actor's
    options, as the JAX package reads them
    (``raytpu/runtime/remote_function.py``'s ``build_scheduling``):
    ``placement_group=`` and its bundle options, a
    :class:`PlacementGroupSchedulingStrategy`, ``"DEFAULT"`` or
    ``"SPREAD"`` (one host: nothing to spread over), or a
    :class:`NodeAffinitySchedulingStrategy` naming this host. Without
    any, the group of a parent started with
    ``placement_group_capture_child_tasks``."""
    from raytpu_torch.runtime import context
    from raytpu_torch.runtime.placement_group import PlacementGroup
    from raytpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

    pg = options.get("placement_group")
    if pg is not None:
        if not isinstance(pg, PlacementGroup):
            raise ValueError(f"placement_group={pg!r}: a PlacementGroup")
        return (pg.id.hex(), int(options.get(
            "placement_group_bundle_index", -1)), bool(options.get(
                "placement_group_capture_child_tasks", False)))
    strat = options.get("scheduling_strategy")
    if isinstance(strat, PlacementGroupSchedulingStrategy):
        return (strat.placement_group.id.hex(),
                int(strat.placement_group_bundle_index),
                bool(strat.placement_group_capture_child_tasks))
    if isinstance(strat, NodeAffinitySchedulingStrategy):
        if strat.node_id != context.node_id().hex() and not strat.soft:
            raise ValueError(f"NodeAffinitySchedulingStrategy: no node "
                             f"{strat.node_id!r} (the one node is "
                             f"{context.node_id().hex()})")
    elif strat not in (None, "DEFAULT", "SPREAD"):
        raise ValueError(f"unknown scheduling strategy: {strat!r}")
    captured = context.captured_group()
    return captured, -1, captured is not None


class Spec:
    """What one request asks for: its resources and, where it runs in a
    placement group, the group's id and the bundle (-1: any that
    fits)."""

    __slots__ = ("resources", "pg", "bundle")

    def __init__(self, resources: Dict[str, float], pg: Optional[str] = None,
                 bundle: int = -1):
        self.resources = dict(resources)
        self.pg = pg
        self.bundle = bundle

    def signature(self) -> tuple:
        return (tuple(sorted(self.resources.items())), self.pg, self.bundle)

    def __reduce__(self):
        return (Spec, (self.resources, self.pg, self.bundle))


class Grant:
    """Resources held: from the node or a bundle's reservation, with the
    cards bound and each card's share taken, and who holds them (None:
    the driver; else the link of the process that asked)."""

    __slots__ = ("gid", "resources", "scope", "shares", "pg", "bundle",
                 "owner")

    def __init__(self, gid: int, resources: ResourceSet, scope: "_Scope",
                 shares: Dict[int, int], pg: Optional[str], bundle: int,
                 owner: Any = None):
        self.gid = gid
        self.resources = resources
        self.scope = scope
        self.shares = shares
        self.pg = pg
        self.bundle = bundle
        self.owner = owner

    @property
    def cards(self) -> List[int]:
        return sorted(self.shares)

    def view(self, ids: List[str]) -> dict:
        """What crosses to the process it admits: the grant's id, its
        resources, its cards and their ``CUDA_VISIBLE_DEVICES`` (None
        without a card), its group and bundle."""
        cards = self.cards
        return {"gid": self.gid, "resources": self.resources.to_dict(),
                "cards": cards,
                "visible": ",".join(ids[c] for c in cards) if cards else None,
                "pg": self.pg, "bundle": self.bundle}


class _Scope:
    """Where grants come from: the node, or one bundle's reservation;
    the free share of each card it holds (fixed point)."""

    def __init__(self, total: ResourceSet, cards: Dict[int, int]):
        self.res = NodeResources(total)
        self.card_free = dict(cards)

    def pick_cards(self, gpus: int, spread: bool = False
                   ) -> Optional[Dict[int, int]]:
        """The shares a request of ``gpus`` (fixed point) would take, or
        None: a share of one card on the first card with room (the one
        with most room when ``spread``), whole free cards for more."""
        if gpus == 0:
            return {}
        if gpus <= _ONE:
            fits = [c for c, free in sorted(self.card_free.items())
                    if free >= gpus]
            if not fits:
                return None
            if spread:
                fits.sort(key=lambda c: -self.card_free[c])
            return {fits[0]: gpus}
        whole = [c for c, free in sorted(self.card_free.items())
                 if free == _ONE]
        n = gpus // _ONE
        return {c: _ONE for c in whole[:n]} if len(whole) >= n else None

    def take(self, req: ResourceSet, shares: Dict[int, int]) -> None:
        self.res.allocate(req)
        for c, share in shares.items():
            self.card_free[c] -= share

    def give(self, req: ResourceSet, shares: Dict[int, int]) -> None:
        self.res.release(req)
        for c, share in shares.items():
            self.card_free[c] += share


class _Group:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str, scopes: List[_Scope],
                 shares: List[Dict[int, int]]):
        self.pg_id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.scopes = scopes
        self.shares = shares  # what each bundle took of the node's cards
        self.state = "created"


class _Waiting:
    __slots__ = ("rid", "spec", "on_grant", "owner", "since")

    def __init__(self, rid: int, spec: Spec, on_grant, owner):
        self.rid = rid
        self.spec = spec
        self.on_grant = on_grant
        self.owner = owner
        self.since = time.monotonic()


class Ledger:
    """The driver's ledger: ``cpus``, the cards ``card_ids`` (each its
    ``CUDA_VISIBLE_DEVICES`` entry) and custom ``resources``."""

    def __init__(self, cpus: float, card_ids: List[str],
                 resources: Optional[Dict[str, float]] = None):
        self.card_ids = list(card_ids)
        total = {CPU: float(cpus), **(resources or {})}
        if self.card_ids:
            total[GPU] = float(len(self.card_ids))
        self._lock = threading.Lock()
        self._node = _Scope(ResourceSet(total),
                            {i: _ONE for i in range(len(self.card_ids))})
        self._groups: Dict[str, _Group] = {}
        self._waiting: deque = deque()
        # Every grant held, by its id.
        self._grants: Dict[int, Grant] = {}
        # The last admissions of waiting requests: (seconds waited,
        # seconds from the release that freed their share to the grant).
        self._admitted: deque = deque(maxlen=64)
        self._listeners: List[Callable[[], None]] = []

    # -- reading ----------------------------------------------------------

    def total(self) -> Dict[str, float]:
        with self._lock:
            return self._node.res.total.to_dict()

    def available(self) -> Dict[str, float]:
        with self._lock:
            return self._node.res.available.to_dict()

    def resources(self) -> dict:
        with self._lock:
            return {"total": self._node.res.total.to_dict(),
                    "available": self._node.res.available.to_dict()}

    def waiting(self) -> int:
        with self._lock:
            return len(self._waiting)

    def holds_grants(self) -> bool:
        with self._lock:
            return bool(self._grants)

    def admissions(self) -> List[dict]:
        """The last admissions of requests that waited: ``waited_s``
        (from the request) and ``after_release_s`` (from the release
        whose pump granted it)."""
        with self._lock:
            return [{"waited_s": w, "after_release_s": r}
                    for w, r in self._admitted]

    def add_listener(self, fn: Callable[[], None]) -> None:
        """``fn()`` after every release (outside the lock): the task
        pool dispatches what now fits."""
        self._listeners.append(fn)

    def resize_cpus(self, cpus: float) -> None:
        """The pool's size, once ``init`` gives it after the ledger was
        made with the host's count."""
        with self._lock:
            node = self._node.res
            old = node.total.get(CPU)
            node.total = node.total.minus(ResourceSet({CPU: old}), True) + \
                ResourceSet({CPU: float(cpus)})
            node.available = node.available.minus(
                ResourceSet({CPU: old}), True) + ResourceSet(
                {CPU: float(cpus)})
        self._pump()

    # -- admission --------------------------------------------------------

    def _scopes(self, spec: Spec) -> List[Tuple[_Scope, int]]:
        """The scopes a request may take from: the node, or its group's
        bundles (the one named, else each in order)."""
        if spec.pg is None:
            return [(self._node, -1)]
        group = self._groups.get(spec.pg)
        if group is None or group.state != "created":
            raise PlacementGroupError(f"placement group {spec.pg} is gone")
        if spec.bundle >= len(group.scopes):
            raise PlacementGroupError(
                f"placement group {spec.pg} has {len(group.scopes)} "
                f"bundles; bundle index {spec.bundle} asked for")
        if spec.bundle >= 0:
            return [(group.scopes[spec.bundle], spec.bundle)]
        return [(s, i) for i, s in enumerate(group.scopes)]

    def _check(self, spec: Spec) -> None:
        """Raise where the request can never fit its scopes."""
        req = ResourceSet(spec.resources)
        if any(req.is_subset_of(s.res.total) for s, _ in self._scopes(spec)):
            return
        where = ("the tree's total" if spec.pg is None
                 else f"placement group {spec.pg}'s bundle")
        totals = [s.res.total.to_dict() for s, _ in self._scopes(spec)]
        error = ValueError if spec.pg is None else PlacementGroupError
        raise error(f"the request {req.to_dict()} can never fit {where} "
                    f"{totals[0] if len(totals) == 1 else totals}")

    def _try(self, spec: Spec, owner: Any = None) -> Optional[Grant]:
        req = ResourceSet(spec.resources)
        gpus = req.to_fixed_dict().get(GPU, 0)
        for scope, index in self._scopes(spec):
            if not scope.res.can_fit(req):
                continue
            shares = scope.pick_cards(gpus)
            if shares is None:
                continue
            scope.take(req, shares)
            grant = Grant(next(_IDS), req, scope, shares, spec.pg, index,
                          owner)
            self._grants[grant.gid] = grant
            return grant
        return None

    def check(self, spec: Spec) -> None:
        """Raise ``ValueError`` (or :class:`PlacementGroupError` for a
        bundle) where ``spec`` can never fit."""
        with self._lock:
            self._check(spec)

    def try_acquire(self, spec: Spec) -> Optional[Grant]:
        """A grant now, or None (the caller keeps the request queued);
        raises where it can never fit, or its group is gone."""
        with self._lock:
            self._check(spec)
            return self._try(spec)

    def request(self, spec: Spec, on_grant: Callable[[Grant], None],
                owner: Any = None) -> Tuple[Optional[Grant], Optional[int]]:
        """``(grant, None)`` where it fits now; else ``(None, rid)``: it
        waits, first in first out among those that fit, and
        ``on_grant(grant)`` runs (on a thread of its own) once it is
        granted, or with the :class:`PlacementGroupError` of a group
        removed while it waited. Raises where it can never fit. ``owner``
        tags the request and its grant for :meth:`drop_owner`."""
        with self._lock:
            self._check(spec)
            grant = self._try(spec, owner)
            if grant is not None:
                return grant, None
            rid = next(_IDS)
            self._waiting.append(_Waiting(rid, spec, on_grant, owner))
            return None, rid

    def cancel(self, rid: int) -> bool:
        """Drop a waiting request; False when it was granted already."""
        with self._lock:
            for w in self._waiting:
                if w.rid == rid:
                    self._waiting.remove(w)
                    return True
        return False

    def release(self, gid: Optional[int]) -> None:
        """Give the grant ``gid`` back (to its bundle, while the group
        lives) and admit what now fits; a grant given back already, or of
        another ledger, is nothing to give."""
        released_at = time.monotonic()
        with self._lock:
            grant = self._grants.pop(gid, None)
            if grant is None:
                return
            self._give(grant)
        self._pump(released_at)

    def _give(self, grant: Grant) -> None:
        gone = (grant.pg is not None
                and (self._groups.get(grant.pg) is None
                     or grant.scope not in self._groups[grant.pg].scopes))
        if not gone:
            grant.scope.give(grant.resources, grant.shares)

    def drop_owner(self, owner: Any) -> None:
        """A process is gone: its waiting requests and its grants go with
        it, at once, so a request granted meanwhile is not left held."""
        released_at = time.monotonic()
        with self._lock:
            for w in [w for w in self._waiting if w.owner is owner]:
                self._waiting.remove(w)
            held = [g for g in self._grants.values() if g.owner is owner]
            for grant in held:
                del self._grants[grant.gid]
                self._give(grant)
        if held:
            self._pump(released_at)

    def _pump(self, released_at: Optional[float] = None) -> None:
        granted = []
        released_at = released_at or time.monotonic()
        with self._lock:
            failed: set = set()
            for w in list(self._waiting):
                sig = w.spec.signature()
                if sig in failed:
                    continue
                try:
                    grant = self._try(w.spec, w.owner)
                except PlacementGroupError as exc:
                    self._waiting.remove(w)
                    granted.append((w, exc))
                    continue
                if grant is None:
                    failed.add(sig)
                    continue
                self._waiting.remove(w)
                granted.append((w, grant))
                now = time.monotonic()
                self._admitted.append((now - w.since, now - released_at))
        for w, grant in granted:
            threading.Thread(target=w.on_grant, args=(grant,),
                             name="raytpu-torch-admit", daemon=True).start()
        for fn in self._listeners:
            fn()

    # -- placement groups -------------------------------------------------

    def create_group(self, bundles: List[Dict[str, float]], strategy: str,
                     name: str = "") -> str:
        """Reserve ``bundles`` now (the local backend's rule: what does
        not fit what is available raises); the group's id."""
        if strategy not in VALID_STRATEGIES:
            raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, "
                             f"got {strategy!r}")
        if not bundles or any(not b for b in bundles):
            raise ValueError("bundles must be a non-empty list of non-empty "
                             "dicts")
        sets = [ResourceSet(b) for b in bundles]
        total = ResourceSet({})
        for rs in sets:
            total = total + rs
        with self._lock:
            if strategy == "STRICT_SPREAD" and len(sets) > 1:
                raise PlacementGroupError(
                    "STRICT_SPREAD with >1 bundle cannot be satisfied on a "
                    "single node")
            node = self._node
            if not total.is_subset_of(node.res.available):
                raise PlacementGroupError(
                    f"placement group infeasible: needs {total.to_dict()}, "
                    f"available {node.res.available.to_dict()}")
            shares, taken = [], []
            for rs in sets:
                gpus = rs.to_fixed_dict().get(GPU, 0)
                got = node.pick_cards(gpus, spread=strategy == "SPREAD")
                if got is None:
                    for rs_done, got_done in taken:
                        node.give(rs_done, got_done)
                    raise PlacementGroupError(
                        f"placement group infeasible: no card has room for "
                        f"a bundle of {rs.to_dict()}")
                node.take(rs, got)
                taken.append((rs, got))
                shares.append(got)
            pg_id = uuid.uuid4().hex
            scopes = [_Scope(rs, got) for rs, got in zip(sets, shares)]
            self._groups[pg_id] = _Group(pg_id, [rs.to_dict() for rs in sets],
                                         strategy, name, scopes, shares)
        return pg_id

    def remove_group(self, pg_id: str) -> None:
        """Give a group's reservation back; what runs in it keeps what it
        holds (its releases then go nowhere), as in the local backend."""
        with self._lock:
            group = self._groups.pop(pg_id, None)
            if group is None:
                return
            group.state = "removed"
            for rs, got in zip(group.scopes, group.shares):
                self._node.give(rs.res.total, got)
            failed = [w for w in self._waiting if w.spec.pg == pg_id]
            for w in failed:
                self._waiting.remove(w)
        for w in failed:
            threading.Thread(target=w.on_grant, args=(PlacementGroupError(
                f"placement group {pg_id} was removed"),),
                name="raytpu-torch-admit", daemon=True).start()
        self._pump()

    def group_info(self, pg_id: str) -> Optional[dict]:
        with self._lock:
            group = self._groups.get(pg_id)
            if group is None:
                return None
            return {"id": pg_id, "name": group.name, "state": group.state,
                    "strategy": group.strategy,
                    "bundles": [dict(b) for b in group.bundles],
                    "cards": [sorted(got) for got in group.shares]}

    def groups(self) -> List[dict]:
        with self._lock:
            ids = list(self._groups)
        return [info for info in map(self.group_info, ids) if info]

    def nodes(self, node_id: str) -> List[dict]:
        """The one node: the driver's host."""
        with self._lock:
            return [{"node_id": node_id, "alive": True,
                     "resources": self._node.res.total.to_dict(),
                     "available": self._node.res.available.to_dict()}]
