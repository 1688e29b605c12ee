"""Long-poll host: push-style config propagation over actor calls; the
port's copy of :mod:`raytpu.serve._private.long_poll`, as it is.

Reference analogue: ``python/ray/serve/_private/long_poll.py`` —
``LongPollHost`` (``:173``) / ``LongPollClient`` (``:64``). A client calls
``listen_for_change({key: last_seen_version})``; the host parks the call on
an ``asyncio.Event`` until any watched key advances past the client's
version, then returns only the changed entries. This turns O(clients)
polling into O(changes) notification — same motivation as the reference.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Tuple


class UpdatedObject:
    __slots__ = ("object_snapshot", "snapshot_id")

    def __init__(self, object_snapshot: Any, snapshot_id: int):
        self.object_snapshot = object_snapshot
        self.snapshot_id = snapshot_id

    def __reduce__(self):
        return (UpdatedObject, (self.object_snapshot, self.snapshot_id))


class LongPollHost:
    """Mixed into the Serve controller. Not thread-safe; all access must
    happen on the hosting actor's event loop."""

    def __init__(self, timeout_s: float = 30.0):
        self._snapshots: Dict[str, Tuple[Any, int]] = {}
        self._events: Dict[str, asyncio.Event] = {}
        self._timeout_s = timeout_s

    def _event(self, key: str) -> asyncio.Event:
        ev = self._events.get(key)
        if ev is None:
            ev = self._events[key] = asyncio.Event()
        return ev

    def notify_changed(self, key: str, snapshot: Any) -> None:
        _, version = self._snapshots.get(key, (None, -1))
        self._snapshots[key] = (snapshot, version + 1)
        ev = self._event(key)
        ev.set()
        self._events[key] = asyncio.Event()  # next waiters get a fresh event

    async def listen_for_change(
        self, keys_to_snapshot_ids: Dict[str, int]
    ) -> Dict[str, UpdatedObject]:
        """Return changed entries; parks until a change or timeout.

        On timeout returns ``{}`` (the client just polls again) — the
        reference returns a sentinel with the same effect.
        """
        stale = {
            key: UpdatedObject(*self._snapshots[key])
            for key, seen in keys_to_snapshot_ids.items()
            if key in self._snapshots and self._snapshots[key][1] > seen
        }
        if stale:
            return stale
        waiters = [self._event(key) for key in keys_to_snapshot_ids]
        done, pending = await asyncio.wait(
            [asyncio.ensure_future(ev.wait()) for ev in waiters],
            timeout=self._timeout_s,
            return_when=asyncio.FIRST_COMPLETED,
        )
        for fut in pending:
            fut.cancel()
        if not done:
            return {}
        return {
            key: UpdatedObject(*self._snapshots[key])
            for key, seen in keys_to_snapshot_ids.items()
            if key in self._snapshots and self._snapshots[key][1] > seen
        }
