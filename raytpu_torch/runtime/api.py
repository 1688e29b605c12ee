"""The port's worker-process layer: actors on ``torch.multiprocessing``.

The calls of :mod:`raytpu.runtime.api` that the RL code uses, with their
shape: ``remote(cls)`` and ``.options(num_cpus=...)``, then
``.remote(*args)`` to start one **spawned** process that holds one
instance; ``handle.method.remote(*args, **kwargs)`` returns an
:class:`ObjectRef`, a future; ``put``, ``get``, ``wait`` and ``kill``.

What it keeps of the JAX package's semantics:

- calls on one handle run in the order they were submitted, one at a time
  (the JAX actor's ``max_concurrency=1``);
- a method that raises gives :class:`TaskError` at ``get``, with the
  worker's traceback in its message, and the worker goes on serving;
- a worker that exits (killed, crashed, or its constructor raised) makes
  every call on it that has no result yet *ready*: ``wait`` returns it,
  and ``get`` raises :class:`ActorDiedError`. The death is seen at the
  pipe's EOF, or, should that not come, from the process's exit code
  after :data:`EXIT_GRACE_S`: never a hang;
- ``get`` with a ``timeout`` raises :class:`GetTimeoutError`; ``wait``
  returns the first ``num_returns`` ready refs in the order given;
- top-level :class:`ObjectRef` arguments are resolved before the call is
  sent;
- ``kill``, dropping the last handle, and interpreter exit all end the
  process (``weakref.finalize``): no child outlives its parent. A child
  whose parent dies reads EOF and exits.

What crosses: arguments and results are pickled with
``multiprocessing``'s pickler, so CPU tensors travel through shared
memory by ``torch.multiprocessing``'s reductions and everything else is
copied through the pipe. ``put`` copies the CPU tensors of its value into
one shared-memory buffer once; every call that takes the ref maps those
same pages, and one file descriptor crosses however many tensors the
value holds.

What it leaves out: no object store (a ref's value lives in the caller,
or in the worker's reply), no tasks (functions), no placement groups, no
retries or restarts, no named or detached actors, no async actors, no
cluster. ``num_cpus`` is the only option: it sets the child's torch
threads; any other option raises. Arguments, results and the class go by
pickle, so a class or function must be importable by name in the child
(defined at a module's top level, and a script that starts workers keeps
its entry point under ``if __name__ == "__main__"``). :func:`call` runs a
module-level function on the instance inside the worker (Ray's
``__ray_call__``), for callers that need to reach into a worker without
adding a method to its class.
"""

from __future__ import annotations

import functools
import inspect
import itertools
import math
import pickle
import threading
import time
import uuid
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.multiprocessing as mp
from multiprocessing.reduction import ForkingPickler

from raytpu_torch.core.errors import ActorDiedError, GetTimeoutError, TaskError

# How long a worker whose process has exited may keep its pipe open
# before it counts as dead all the same (its last replies drain first).
EXIT_GRACE_S = 2.0
# How often a blocked get/wait looks at the processes' exit codes.
_POLL_S = 0.05
# How long kill() waits for the process to be reaped.
_REAP_S = 10.0
OPTIONS = ("num_cpus",)
_ALIGN = 64  # bytes: each packed tensor starts on a cache line

# Every reply lands under this condition; get and wait sleep on it.
_READY = threading.Condition(threading.RLock())


def _dumps(obj) -> bytes:
    return bytes(ForkingPickler.dumps(obj))


# ---- the child ---------------------------------------------------------


def _reply(conn, call_id: int, ok: bool, value) -> bool:
    """Send one reply; a value that does not pickle becomes a TaskError.
    False when the parent is gone."""
    try:
        blob = _dumps(value)
    except Exception as exc:  # the method's result cannot cross
        ok, blob = False, _dumps(TaskError.from_exception(
            f"pickling the result of call {call_id}", exc))
    try:
        conn.send((call_id, ok, blob))
    except (BrokenPipeError, OSError):
        return False
    return True


def _worker_main(conn, name: str, blob: bytes, num_threads: int) -> None:
    """The body of a worker process: build the instance, then serve calls
    in the order they arrive until the parent closes the pipe."""
    torch.set_num_threads(num_threads)
    try:
        cls, args, kwargs = pickle.loads(blob)
        instance = cls(*args, **kwargs)
    except Exception as exc:
        _reply(conn, 0, False, TaskError.from_exception(f"{name}.__init__",
                                                        exc))
        return
    if not _reply(conn, 0, True, None):
        return
    while True:
        try:
            call_id, blob = conn.recv()
        except (EOFError, OSError):
            return  # the parent is gone
        method = f"call {call_id}"
        try:
            method, args, kwargs = pickle.loads(blob)
            args = [_unpacked(a) for a in args]
            kwargs = {k: _unpacked(v) for k, v in kwargs.items()}
            fn = (getattr(instance, method) if isinstance(method, str)
                  else functools.partial(method, instance))
            ok, value = True, fn(*args, **kwargs)
        except Exception as exc:
            label = method if isinstance(method, str) else getattr(
                method, "__name__", repr(method))
            ok, value = False, TaskError.from_exception(f"{name}.{label}",
                                                        exc)
        if not _reply(conn, call_id, ok, value):
            return


# ---- the parent --------------------------------------------------------


class _Worker:
    """The parent's side of one worker process: the pipe, a thread that
    reads every reply as it comes (so the child never blocks on a full
    pipe), and the replies still wanted."""

    def __init__(self, cls, args, kwargs, num_threads: int):
        self.name = f"{cls.__name__}-{uuid.uuid4().hex[:8]}"
        blob = _dumps((cls, args, kwargs))  # a bad argument raises here
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main,
                                args=(child, self.name, blob, num_threads),
                                name=self.name, daemon=True)
        self.proc.start()
        child.close()  # the child's end lives in the child only: EOF
        self._ids = itertools.count(1)
        self._send_lock = threading.Lock()
        self._wanted: set = set()
        self._results: Dict[int, Tuple[bool, Any]] = {}
        self.started: Optional[Tuple[bool, Any]] = None
        self.dead: Optional[str] = None
        self._stop_reason: Optional[str] = None
        self._exit_seen: Optional[float] = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"{self.name}-reader",
                                        daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            try:
                call_id, ok, blob = self._conn.recv()
            except (EOFError, OSError):
                break
            try:
                value = pickle.loads(blob)
            except Exception as exc:  # e.g. a class the parent cannot import
                ok, value = False, TaskError.from_exception(
                    f"{self.name}: unpickling the result of call {call_id}",
                    exc)
            with _READY:
                if call_id == 0:
                    self.started = (ok, value)
                elif call_id in self._wanted:
                    self._results[call_id] = (ok, value)
                _READY.notify_all()
        self.proc.join(timeout=_REAP_S)
        self._mark_dead(None)

    def _mark_dead(self, reason: Optional[str]) -> None:
        with _READY:
            if self.dead is None:
                reason = reason or self._stop_reason
                if reason is None and self.started and not self.started[0]:
                    reason = f"its constructor raised:\n{self.started[1]}"
                self.dead = reason or (f"process {self.proc.pid} exited "
                                       f"with code {self.proc.exitcode}")
            _READY.notify_all()

    def check_exit(self, now: float) -> None:
        """Count the worker dead once its process has been gone for
        EXIT_GRACE_S without the pipe's EOF reaching the reader."""
        if self.dead is not None or self.proc.exitcode is None:
            return
        if self._exit_seen is None:
            self._exit_seen = now
        elif now - self._exit_seen >= EXIT_GRACE_S:
            self._mark_dead(None)

    def submit(self, method, args, kwargs) -> "ObjectRef":
        args = tuple(_resolve(a) for a in args)
        kwargs = {k: _resolve(v) for k, v in kwargs.items()}
        blob = _dumps((method, args, kwargs))  # a bad argument raises here
        with _READY:
            call_id = next(self._ids)
            self._wanted.add(call_id)
        ref = ObjectRef(self, call_id)
        try:
            with self._send_lock:
                self._conn.send((call_id, blob))
        except (BrokenPipeError, OSError):
            pass  # the worker is gone: the reader marks it dead at EOF
        return ref

    def forget(self, call_id: int) -> None:
        with _READY:
            self._wanted.discard(call_id)
            self._results.pop(call_id, None)

    def shutdown(self, reason: str) -> None:
        """End the process now (SIGKILL), reap it, and let the reader see
        the EOF. Safe to call more than once."""
        self._stop_reason = self._stop_reason or reason
        if self.proc.exitcode is None:
            self.proc.kill()
        self.proc.join(timeout=_REAP_S)
        self._mark_dead(None)
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=_REAP_S)
        if not self._reader.is_alive():
            self._conn.close()


class ObjectRef:
    """A future: a value ``put`` holds, or the reply of one call on a
    worker. Hashable by identity."""

    __slots__ = ("_worker", "_call_id", "_value")

    def __init__(self, worker: Optional[_Worker] = None, call_id: int = 0,
                 value: Any = None):
        self._worker = worker
        self._call_id = call_id
        self._value = value

    def _ready(self) -> bool:
        w = self._worker
        return w is None or self._call_id in w._results or w.dead is not None

    def _result(self):
        w = self._worker
        if w is None:
            return self._value.unpack()
        if self._call_id in w._results:
            ok, value = w._results[self._call_id]
            if not ok:
                raise value
            return value
        raise ActorDiedError(w.name, w.dead)

    def __del__(self):
        if self._worker is not None:
            try:
                self._worker.forget(self._call_id)
            except (AttributeError, TypeError):  # the interpreter's teardown
                pass

    def __reduce__(self):
        raise TypeError("an ObjectRef does not cross processes; pass it "
                        "as a top-level argument of a call, which resolves "
                        "it, or get() it first")

    def __repr__(self):
        where = "put" if self._worker is None else \
            f"{self._worker.name}#{self._call_id}"
        return f"ObjectRef({where})"


def _resolve(arg):
    """A top-level argument as it crosses: a put's packed value (unpacked
    in the worker), a call's result, anything else as it is."""
    if not isinstance(arg, ObjectRef):
        return arg
    return arg._value if arg._worker is None else get(arg)


class _Method:
    def __init__(self, worker: _Worker, name: str):
        self._worker = worker
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._worker.submit(self._name, args, kwargs)


class ActorHandle:
    """One worker process holding one instance: ``handle.method.remote(...)``
    submits a call. Dropping the last handle ends the process."""

    def __init__(self, cls, worker: _Worker):
        self._cls = cls
        self._worker = worker
        self._finalizer = weakref.finalize(self, worker.shutdown,
                                           "its handle was dropped")

    def __getattr__(self, name: str) -> _Method:
        if name.startswith("_") or not callable(getattr(self._cls, name,
                                                        None)):
            raise AttributeError(f"{self._cls.__name__} has no method "
                                 f"{name!r}")
        return _Method(self._worker, name)

    @property
    def pid(self) -> Optional[int]:
        return self._worker.proc.pid

    def __reduce__(self):
        raise TypeError("an ActorHandle does not cross processes")

    def __repr__(self):
        return f"ActorHandle({self._worker.name}, pid={self.pid})"


class RemoteClass:
    """What :func:`remote` makes of a class: ``.options(num_cpus=...)``
    and ``.remote(*args, **kwargs)``."""

    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        options = dict(options or {})
        unknown = sorted(set(options) - set(OPTIONS))
        if unknown:
            raise ValueError(f"options {unknown}: the port's runtime takes "
                             f"only {list(OPTIONS)}")
        num_cpus = options.get("num_cpus", 1)
        if not isinstance(num_cpus, (int, float)) or num_cpus < 1:
            raise ValueError(f"num_cpus={num_cpus!r}: a worker needs at "
                             f"least one CPU (it sets its torch threads)")
        self._cls = cls
        self._options = options
        self._threads = int(num_cpus)

    def options(self, **options) -> "RemoteClass":
        return RemoteClass(self._cls, {**self._options, **options})

    def remote(self, *args, **kwargs) -> ActorHandle:
        return ActorHandle(self._cls, _Worker(self._cls, args, kwargs,
                                              self._threads))


def remote(cls) -> RemoteClass:
    """A class whose ``.remote(...)`` starts a worker process holding an
    instance (``.options(num_cpus=...)`` first to set its threads).
    Classes only: the port's runtime has no tasks."""
    if not inspect.isclass(cls):
        raise TypeError(f"remote() takes a class, not {cls!r}: the port's "
                        f"runtime hosts actors only")
    return RemoteClass(cls)


def call(actor: ActorHandle, fn, *args, **kwargs) -> ObjectRef:
    """Run ``fn(instance, *args, **kwargs)`` in the worker, in order with
    its other calls. ``fn`` must be importable by name there."""
    return actor._worker.submit(fn, args, kwargs)


class _Slot:
    """Where a packed tensor stood in its value."""

    def __init__(self, index: int):
        self.index = index


class _Packed:
    """A ``put`` value with its CPU tensors (in dicts, lists and tuples)
    copied into one shared-memory buffer: one file descriptor crosses to a
    worker however many tensors there are (passing one costs a round trip
    to the sender's descriptor server). ``unpack`` gives the value back
    with views into the buffer."""

    def __init__(self, value):
        tensors: List[torch.Tensor] = []
        self.skeleton = self._strip(value, tensors)
        self.slots: List[Tuple[int, torch.dtype, Tuple[int, ...]]] = []
        size = 0
        for t in tensors:
            self.slots.append((size, t.dtype, tuple(t.shape)))
            size += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        self.buffer = (torch.empty(size, dtype=torch.uint8).share_memory_()
                       if tensors else None)
        for slot, t in zip(self.slots, tensors):
            self._view(*slot).copy_(t)

    @classmethod
    def _strip(cls, value, tensors: list):
        if isinstance(value, torch.Tensor):
            if value.device.type != "cpu":
                raise ValueError(f"put() shares CPU tensors; got one on "
                                 f"{value.device}")
            tensors.append(value.detach())
            return _Slot(len(tensors) - 1)
        if isinstance(value, dict):
            return {k: cls._strip(v, tensors) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(cls._strip(v, tensors) for v in value)
        return value

    def _view(self, offset: int, dtype: torch.dtype, shape) -> torch.Tensor:
        nbytes = math.prod(shape) * dtype.itemsize
        return self.buffer[offset:offset + nbytes].view(dtype).view(shape)

    def unpack(self):
        views = [self._view(*slot) for slot in self.slots]

        def fill(x):
            if isinstance(x, _Slot):
                return views[x.index]
            if isinstance(x, dict):
                return {k: fill(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(fill(v) for v in x)
            return x

        return fill(self.skeleton)


def _unpacked(x):
    return x.unpack() if isinstance(x, _Packed) else x


def put(value: Any) -> ObjectRef:
    """A ref to a snapshot of ``value``: its CPU tensors copied into one
    shared-memory buffer, once, which every call that takes the ref maps
    (a write there is seen by every holder); other objects are pickled
    with each call."""
    return ObjectRef(value=_Packed(value))


def _refs(refs) -> List[ObjectRef]:
    out = list(refs)
    for r in out:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"expected ObjectRef(s), got {type(r)}")
    return out


def _block(pending, deadline: Optional[float]) -> bool:
    """Sleep (holding nothing) until a reply lands or a poll is due;
    False once the deadline has passed."""
    now = time.monotonic()
    if deadline is not None and now >= deadline:
        return False
    for r in pending:
        if r._worker is not None:
            r._worker.check_exit(now)
    wait_s = _POLL_S if deadline is None else min(_POLL_S, deadline - now)
    _READY.wait(wait_s)
    return True


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *,
        timeout: Optional[float] = None) -> Any:
    """The values of ``refs`` (one ref, or a list), waiting at most
    ``timeout`` seconds. Raises the first failure in the order given:
    :class:`TaskError`, :class:`ActorDiedError`; or
    :class:`GetTimeoutError`."""
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else _refs(refs)
    deadline = None if timeout is None else time.monotonic() + timeout
    with _READY:
        while True:
            pending = [r for r in ref_list if not r._ready()]
            if not pending:
                break
            if not _block(pending, deadline):
                raise GetTimeoutError(
                    f"get() timed out after {timeout} s: {len(pending)} of "
                    f"{len(ref_list)} results not ready ({pending[0]!r} "
                    f"first)")
        values = [r._result() for r in ref_list]
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    """(ready, not ready): the first ``num_returns`` ready refs in the order
    given, once that many are ready or ``timeout`` has passed. A call on a
    dead worker is ready (its ``get`` raises)."""
    ref_list = _refs(refs)
    if num_returns > len(ref_list):
        raise ValueError("num_returns exceeds the number of refs")
    if len({id(r) for r in ref_list}) != len(ref_list):
        raise ValueError("wait() got duplicate refs")
    deadline = None if timeout is None else time.monotonic() + timeout
    with _READY:
        while True:
            ready = [r for r in ref_list if r._ready()]
            if len(ready) >= num_returns or not _block(
                    [r for r in ref_list if not r._ready()], deadline):
                break
    ready = ready[:num_returns]
    taken = {id(r) for r in ready}
    return ready, [r for r in ref_list if id(r) not in taken]


def kill(actor: ActorHandle) -> None:
    """End the worker's process now; calls on it without a result raise
    :class:`ActorDiedError` at ``get``."""
    actor._finalizer.detach()
    actor._worker.shutdown("killed by kill()")
