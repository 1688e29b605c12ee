"""Model multiplexing: many models share one replica pool; the port's
copy of :mod:`raytpu.serve.multiplex`, reading the port replica's request
context.

Reference analogue: ``python/ray/serve/multiplex.py`` —
``@serve.multiplexed(max_num_models_per_replica)`` decorating an async
``load_model(model_id)``; the wrapper LRU-caches loaded models per replica
and ``serve.get_multiplexed_model_id()`` reads the id the caller attached
via ``handle.options(multiplexed_model_id=...)``. On TPU this is how many
LoRA/fine-tune variants share one set of chips: the base jit program stays
resident, per-model weights swap in HBM.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
import weakref
from collections import OrderedDict
from typing import Callable, Optional

from raytpu_torch.serve._private.replica import get_request_context


def get_multiplexed_model_id() -> str:
    """Model id attached to the current request (empty string if none)."""
    return get_request_context().get("multiplexed_model_id", "")


class _ModelCache:
    """LRU model cache with single-flight loads: concurrent ``get``s for
    the same missing model share ONE loader call via a per-key pending
    future (model loads are seconds-to-minutes of HBM traffic — a
    duplicated load is both slow and an OOM hazard). A failed load
    propagates to every waiter and clears the pending entry, so the
    next request retries cleanly."""

    def __init__(self, loader: Callable, capacity: int):
        self.loader = loader
        self.capacity = capacity
        self.cache: OrderedDict = OrderedDict()
        self.pending = {}  # model_id -> Future of the in-flight load

    async def get(self, *args) -> object:
        model_id = args[-1] if args else get_multiplexed_model_id()
        if model_id in self.cache:
            self.cache.move_to_end(model_id)
            return self.cache[model_id]
        pending = self.pending.get(model_id)
        if pending is not None:
            return await pending
        fut = asyncio.get_event_loop().create_future()
        self.pending[model_id] = fut
        try:
            while len(self.cache) >= self.capacity:
                _, evicted = self.cache.popitem(last=False)
                unload = getattr(evicted, "unload", None)
                if callable(unload):
                    out = unload()
                    if inspect.isawaitable(out):
                        await out
            model = self.loader(*args)
            if inspect.isawaitable(model):
                model = await model
        except BaseException as e:
            self.pending.pop(model_id, None)
            if not fut.done():
                fut.set_exception(e)
                fut.exception()  # retrieved: no-waiter GC warning averted
            raise
        self.cache[model_id] = model
        self.pending.pop(model_id, None)
        fut.set_result(model)
        return model


def multiplexed(
    _fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3
):
    def wrap(fn: Callable):
        caches = {}  # key -> _ModelCache; entries die with their instance

        is_method = "self" in inspect.signature(fn).parameters

        @functools.wraps(fn)
        async def wrapper(*args):
            key = id(args[0]) if is_method else None
            cache = caches.get(key)
            if cache is None:
                bound = _bind_weak(fn, args[0], caches, key) \
                    if is_method else fn
                cache = caches[key] = _ModelCache(
                    bound, max_num_models_per_replica
                )
            call_args = args[1:] if is_method else args
            return await cache.get(*call_args)

        wrapper._caches = caches
        wrapper._is_serve_multiplexed = True
        return wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap


def _bind_weak(fn: Callable, instance, registry: dict, key):
    """Bind ``fn`` to ``instance`` without a strong reference, and drop
    ``registry[key]`` when the instance is collected. A strong bind
    would chain registry -> entry -> fn -> instance, keeping every
    instance (and its id()-keyed entry) alive for the process — and a
    recycled id() after GC would silently reuse the dead instance's
    entry. Falls back to a strong bind for un-weakref-able instances."""
    try:
        ref = weakref.ref(instance)
        weakref.finalize(instance, registry.pop, key, None)
    except TypeError:
        return functools.partial(fn, instance)

    def bound(*args, **kwargs):
        inst = ref()
        if inst is None:
            raise RuntimeError(
                f"instance bound to {fn.__qualname__} was garbage-collected")
        return fn(inst, *args, **kwargs)

    return bound
