"""ActorPool: the port's copy of :mod:`raytpu.util.actor_pool` (reference:
``python/ray/util/actor_pool.py``), on the port's runtime."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending = []  # (fn, value) waiting for an idle actor
        self._result_queue = []

    def submit(self, fn: Callable, value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
        else:
            self._pending.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending)

    def get_next(self, timeout=None) -> Any:
        from raytpu_torch.runtime import api

        if not self.has_next():
            raise StopIteration("no pending results")
        refs = list(self._future_to_actor.keys())
        ready, _ = api.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next timed out")
        ref = ready[0]
        actor = self._future_to_actor.pop(ref)
        self._return_actor(actor)
        return api.get(ref)

    get_next_unordered = get_next

    def map(self, fn: Callable, values: Iterable[Any]):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    map_unordered = map

    def _return_actor(self, actor):
        if self._pending:
            fn, value = self._pending.pop(0)
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
        else:
            self._idle.append(actor)

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor):
        self._return_actor(actor)
