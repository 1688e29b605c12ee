"""Streaming returns: ``num_returns="streaming"``, the port of
:mod:`raytpu.runtime.generator`.

``handle.method.options(num_returns="streaming").remote(...)`` on a
generator method (sync or async) returns an :class:`ObjectRefGenerator`,
in the worker's owner or in any process that holds a copy of its handle.
The worker sends each value the generator yields as its own message the
moment it is produced, on the connection the call came in on, then an
end message, or the error in its place (see
:mod:`raytpu_torch.runtime.api`). Iterating gives a ref for each
value, in order (``get`` of one gives its value, at once), as the JAX
package's generator does. ``close()`` (or dropping the generator) sends a
cancel for the call, which closes the generator in the worker so that its
``finally`` runs. A worker that dies mid-stream ends the iteration with
:class:`ActorDiedError` once the values it sent are taken (seen at that
connection's EOF); a caller's connection that closes (its process
exited) closes that caller's streams in the worker.

What it leaves out: backpressure (``generator_backpressure_num_objects``:
no caller of the port sets it) and the object plane (a value lives in the
caller's buffer until it is taken).
"""

from __future__ import annotations

import time
from typing import Optional

from raytpu_torch.core.errors import ActorDiedError, GetTimeoutError
from raytpu_torch.runtime import api


class ObjectRefGenerator:
    """Iterator of the refs of one streaming call's values.

    ``__next__`` blocks until the next value has arrived and returns a
    ref to it; it raises the stream's error (:class:`TaskError`, or
    :class:`ActorDiedError` when the worker died) where the stream failed,
    and ``StopIteration`` once it has ended or was closed."""

    def __init__(self, worker, call_id: int):
        self._worker = worker
        self._call_id = call_id
        self._ended = False   # the worker sent its end, or an error
        self._closed = False

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> api.ObjectRef:
        return self._next(timeout=None)

    def next_ready(self, timeout: float) -> api.ObjectRef:
        """Like ``__next__`` but raises :class:`GetTimeoutError` if no
        value arrives within ``timeout`` seconds."""
        return self._next(timeout=timeout)

    def completed(self) -> bool:
        return self._ended or self._closed

    def _next(self, timeout: Optional[float]) -> api.ObjectRef:
        if self.completed():
            raise StopIteration
        w = self._worker
        deadline = None if timeout is None else time.monotonic() + timeout
        with api._READY:
            while True:
                if self._closed:  # closed from another thread meanwhile
                    raise StopIteration
                buf = w.streams.get(self._call_id)
                if buf:
                    status, value = buf.popleft()
                    if status == api._ITEM:
                        return api.ObjectRef(value=api._Value(value))
                    self._end()
                    if status == api._END:
                        raise StopIteration
                    raise value
                if w.dead is not None:
                    self._end()
                    raise ActorDiedError(w.name, w.dead)
                if not api._block([w], deadline):
                    raise GetTimeoutError(
                        f"no stream value within {timeout} s "
                        f"({w.name}#{self._call_id})")

    def _end(self) -> None:
        self._ended = True
        with api._READY:
            self._worker.streams.pop(self._call_id, None)

    def close(self) -> None:
        """Stop the stream: the worker closes its generator (its
        ``finally`` runs) and what it sent that was not taken is dropped.
        Safe to call twice; iteration after close raises
        ``StopIteration``."""
        if self._closed:
            return
        self._closed = True
        if not self._ended:
            self._worker.cancel(self._call_id)

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):  # the interpreter's teardown
            pass

    def __reduce__(self):
        raise TypeError("an ObjectRefGenerator does not cross processes")

    def __repr__(self):
        return f"ObjectRefGenerator({self._worker.name}#{self._call_id})"
