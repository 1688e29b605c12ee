"""Distributed queue backed by an actor: the port's copy of
:mod:`raytpu.util.queue` (reference: ``python/ray/util/queue.py``), on
the port's runtime. The actor's class sits at the module's top level,
so it goes to its worker by name."""

from __future__ import annotations

import time
from typing import Any, List, Optional


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        import collections

        self._maxsize = maxsize
        self._q = collections.deque()

    def put(self, item) -> bool:
        if self._maxsize > 0 and len(self._q) >= self._maxsize:
            return False
        self._q.append(item)
        return True

    def get(self):
        if not self._q:
            return False, None
        return True, self._q.popleft()

    def qsize(self) -> int:
        return len(self._q)

    def empty(self) -> bool:
        return not self._q

    def full(self) -> bool:
        return self._maxsize > 0 and len(self._q) >= self._maxsize


def _make_queue_actor(maxsize: int):
    from raytpu_torch.runtime import api

    return api.remote(_QueueActor).options(num_cpus=0).remote(maxsize)


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self._actor = _make_queue_actor(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        from raytpu_torch.runtime import api as runtime

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok = runtime.get(self._actor.put.remote(item))
            if ok:
                return
            if not block:
                raise Full()
            if deadline is not None and time.monotonic() >= deadline:
                raise Full()
            time.sleep(0.01)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        from raytpu_torch.runtime import api as runtime

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = runtime.get(self._actor.get.remote())
            if ok:
                return item
            if not block:
                raise Empty()
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty()
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def qsize(self) -> int:
        from raytpu_torch.runtime import api as runtime

        return runtime.get(self._actor.qsize.remote())

    def empty(self) -> bool:
        from raytpu_torch.runtime import api as runtime

        return runtime.get(self._actor.empty.remote())

    def full(self) -> bool:
        from raytpu_torch.runtime import api as runtime

        return runtime.get(self._actor.full.remote())

    def put_batch(self, items: List[Any]) -> None:
        for item in items:
            self.put(item)

    def shutdown(self) -> None:
        from raytpu_torch.runtime import api as runtime

        runtime.kill(self._actor)
