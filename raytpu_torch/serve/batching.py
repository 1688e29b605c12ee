"""Request batching decorator; the port's copy of
:mod:`raytpu.serve.batching`.

Reference analogue: ``python/ray/serve/batching.py`` (``@serve.batch``).
Calls accumulate in a queue; a flusher fires when ``max_batch_size`` is
reached or ``batch_wait_timeout_s`` elapses, invoking the wrapped function
once with the list of requests and fanning results back out.

TPU twist: ``pad_batch_to_max=True`` pads every flushed batch to exactly
``max_batch_size`` by repeating the last element. A jit-compiled model then
sees ONE static batch shape — no XLA recompilation per distinct batch size
(recompiles cost tens of seconds on TPU; padding costs microseconds).
Padded results are dropped before fan-out.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float, pad_batch_to_max: bool):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = batch_wait_timeout_s
        self.pad = pad_batch_to_max
        self.queue: List = []  # list of (item, future)
        self._flusher: Optional[asyncio.TimerHandle] = None

    def put(self, item: Any) -> asyncio.Future:
        fut = asyncio.get_event_loop().create_future()
        self.queue.append((item, fut))
        if len(self.queue) >= self.max_batch_size:
            self._cancel_timer()
            asyncio.ensure_future(self._flush())
        elif self._flusher is None:
            loop = asyncio.get_event_loop()
            self._flusher = loop.call_later(
                self.timeout_s,
                lambda: asyncio.ensure_future(self._flush()),
            )
        return fut

    def _cancel_timer(self):
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None

    async def _flush(self):
        self._cancel_timer()
        if not self.queue:
            return
        batch = self.queue[: self.max_batch_size]
        self.queue = self.queue[self.max_batch_size:]
        if self.queue:  # keep draining whatever remains
            loop = asyncio.get_event_loop()
            self._flusher = loop.call_later(
                self.timeout_s, lambda: asyncio.ensure_future(self._flush())
            )
        items = [it for it, _ in batch]
        n_real = len(items)
        if self.pad and n_real < self.max_batch_size:
            items = items + [items[-1]] * (self.max_batch_size - n_real)
        try:
            out = self.fn(items)
            if inspect.isawaitable(out):
                out = await out
            results = list(out)
            expected = len(items) if self.pad else n_real
            if len(results) != expected:
                raise ValueError(
                    f"batched function returned {len(results)} results for "
                    f"{expected} inputs"
                )
            results = results[:n_real]
            for (_, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
    pad_batch_to_max: bool = False,
):
    """Decorator: callers invoke with a single item; the wrapped function
    receives a list and must return a same-length list."""

    def wrap(fn: Callable):
        # One queue per bound instance, keyed by id(self). Entries are
        # removed by a weakref finalizer when the instance is collected
        # (and the queue's fn holds the instance weakly), so the
        # registry can't leak instances and a recycled id() after GC
        # can never reach a stale queue bound to a dead instance.
        queues = {}

        is_method = "self" in inspect.signature(fn).parameters

        @functools.wraps(fn)
        async def wrapper(*args):
            if is_method:
                self_arg, item = args[0], args[1]
                key = id(self_arg)
            else:
                (item,) = args
                self_arg, key = None, None
            q = queues.get(key)
            if q is None:
                from raytpu_torch.serve.multiplex import _bind_weak

                bound = _bind_weak(fn, self_arg, queues, key) \
                    if is_method else fn
                q = queues[key] = _BatchQueue(
                    bound, max_batch_size, batch_wait_timeout_s,
                    pad_batch_to_max,
                )
            return await q.put(item)

        wrapper._queues = queues
        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
