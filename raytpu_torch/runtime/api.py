"""The port's worker-process layer: actors on ``torch.multiprocessing``.

The calls of :mod:`raytpu.runtime.api` that the port's libraries use,
with their shape: ``remote(cls)`` and ``.options(num_cpus=...,
max_concurrency=..., name=..., namespace=..., lifetime=...)``, then
``.remote(*args)`` to start one **spawned** process that holds one
instance; ``handle.method.remote(*args, **kwargs)`` returns an
:class:`ObjectRef`, a future;
``handle.method.options(num_returns="streaming").remote(...)`` returns an
:class:`~raytpu_torch.runtime.generator.ObjectRefGenerator`; ``put``,
``get``, ``wait``, ``kill`` and ``get_actor``.

What it keeps of the JAX package's semantics:

- a worker reads every call as it arrives. Sync methods run on a pool of
  ``max_concurrency`` threads; coroutine methods (async generators
  included) on one event loop thread, at most ``max_concurrency`` at a
  time. With ``max_concurrency=1``, the default, calls on one handle run
  in the order they were submitted, one at a time, each on the same
  thread (the JAX actor's default);
- a generator method called with ``num_returns="streaming"`` (sync or
  async) sends each value it yields as its own message the moment it is
  produced, then an end message, or the error in its place; the caller's
  ``close()`` sends a cancel, which closes the generator in the worker so
  that its ``finally`` runs (a sync generator blocked inside ``next()``
  is closed when that ``next()`` returns);
- a method that raises gives :class:`TaskError` at ``get``, with the
  worker's traceback in its message, and the worker goes on serving;
- a worker that exits (killed, crashed, or its constructor raised) makes
  every call on it that has no result yet *ready*: ``wait`` returns it,
  and ``get`` raises :class:`ActorDiedError`; a stream on it ends with
  that error once the values it sent are taken. The death is seen at the
  connection's EOF, or, should that not come, once the process has been
  gone for :data:`EXIT_GRACE_S`: never a hang;
- ``get`` with a ``timeout`` raises :class:`GetTimeoutError`; ``wait``
  returns the first ``num_returns`` ready refs in the order given;
- top-level :class:`ObjectRef` arguments are resolved before the call is
  sent;
- **handles cross processes.** An :class:`ActorHandle` pickles to the
  worker's address (an abstract Unix socket the worker listens on), its
  class and its pid; unpickled in another process of the tree, it
  connects at its first call, with a reader thread of its own, and every
  call, stream, cancel, ``call`` and ``kill`` works from there as from
  the owner. The sockets authenticate with the ``multiprocessing``
  authkey, which spawned children inherit, so only processes of one tree
  reach each other; a worker answers each call on the connection it came
  in on;
- **named actors**: ``.options(name=..., namespace="default")`` registers
  the handle; :func:`get_actor` returns it from any process of the tree.
  The registry lives in the driver's process (the one the runtime did not
  start), whose address every worker is given at spawn. An unknown name
  raises ``ValueError("no actor named ...")``, a name in use
  ``ValueError("actor name ... already taken")``; the name of a worker
  that has died is free again;
- **lifetimes.** The process that started a worker (its owner) governs
  its life: ``kill``, dropping the owner's last handle, and the owner's
  exit all end it (``weakref.finalize``; a worker whose owner dies reads
  EOF on its pipe and exits once its calls in flight end). A copy of the
  handle in another process ends nothing when it is dropped.
  ``lifetime="detached"`` is what the port can give without a cluster:
  the driver starts the worker (also when a worker asks for it) and the
  registry holds its handle, so it outlives the handles of its creator
  and ends at ``kill`` or at the driver's exit. No child outlives the
  driver. Workers start workers of their own (the controller of
  :mod:`raytpu_torch.serve` starts its replicas).

What crosses: arguments and results are pickled with
``multiprocessing``'s pickler, so CPU tensors travel through shared
memory by ``torch.multiprocessing``'s reductions (the descriptor is
fetched from the sender's resource sharer, which every process of the
tree may reach: they share the authkey) and everything else is copied
through the connection. ``put`` copies the CPU tensors of its value into
one shared-memory buffer once; every call that takes the ref maps those
same pages, and one file descriptor crosses however many tensors the
value holds.

What it leaves out: no object store (a ref's value lives in the caller,
or in the worker's reply; an :class:`ObjectRef` does not cross), no
tasks (functions), no placement groups, no retries or restarts, no
streaming backpressure, no cluster. ``num_cpus`` (the child's torch
threads), ``max_concurrency``, ``name``, ``namespace`` and ``lifetime``
are the only options; any other option raises. Arguments, results and
the class go by pickle, so a class or function must be importable by
name in the child (defined at a module's top level, and a script that
starts workers keeps its entry point under ``if __name__ ==
"__main__"``). :func:`call` runs a module-level function on the instance
inside the worker (Ray's ``__ray_call__``), for callers that need to
reach into a worker without adding a method to its class.

Traces cross it as they cross the JAX package's RPC frames: every
message carries the caller's ambient :class:`~raytpu_torch.util.tracing.TraceContext`
in its wire form. With tracing on, the send sits inside an
``rpc.client.<method>`` span (the port's calls are futures, so the span
covers the submission, not the wait); the worker anchors the context
around its dispatch in ``rpc.server.<method>`` and re-anchors it on the
pool thread or the event loop in ``worker.actor_task.run``, the JAX
worker's span names. With tracing off a context that came in is
forwarded unchanged; with none, a call pays one flag check.
:func:`trace_dumps` is the counterpart of the JAX head's ``trace_dump``
fan-out: a process asks every live worker it started for its span
buffer, and each asks its own.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import inspect
import itertools
import math
import os
import pickle
import signal
import socket
import threading
import time
import uuid
import weakref
from collections import deque
from multiprocessing import connection as mpc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.multiprocessing as mp
from multiprocessing.reduction import ForkingPickler

from raytpu_torch.core.errors import ActorDiedError, GetTimeoutError, TaskError
from raytpu_torch.util import tracing

# How long a worker whose process has exited may keep its connection open
# before it counts as dead all the same (its last replies drain first).
EXIT_GRACE_S = 2.0
# How often a blocked get/wait looks at the processes' exit codes.
_POLL_S = 0.05
# How long kill() waits for the process to be reaped.
_REAP_S = 10.0
OPTIONS = ("num_cpus", "max_concurrency", "name", "namespace", "lifetime")
LIFETIMES = (None, "detached")
_ALIGN = 64  # bytes: each packed tensor starts on a cache line
# Connections a worker's socket holds before its instance is built and it
# starts to accept them.
_BACKLOG = 128

# Messages to a worker: (kind, call id, pickled (method, args, kwargs),
# the caller's trace context in its wire form or None). A dump carries
# the seconds its worker may wait on its own workers in the blob's place.
_CALL, _STREAM, _CANCEL, _DUMP = "call", "stream", "cancel", "dump"
# Messages from a worker: (call id, status, pickled value). A call gets
# one _OK or _ERR; a stream any number of _ITEM, then _END or _ERR.
_OK, _ERR, _ITEM, _END = 0, 1, 2, 3

# Every reply lands under this condition; get and wait sleep on it.
_READY = threading.Condition(threading.RLock())
# How long trace_dumps waits for the workers below it to answer.
TRACE_DUMP_TIMEOUT_S = 10.0
# In a worker: the wall-clock times (time.time()) of its start's stages:
# "spawned" (its owner's Process.start), "entered" (the worker's body
# runs: the interpreter, the owner's main module and this module
# imported), "imported" (its class unpickled, with the modules that
# takes) and "constructed" (the instance built).
START_MARKS: Dict[str, float] = {}


def _dumps(obj) -> bytes:
    return bytes(ForkingPickler.dumps(obj))


# ---- sockets -----------------------------------------------------------


def _new_address() -> str:
    """An abstract Unix socket address: no file, gone with its socket."""
    return f"\0raytpu_torch-{uuid.uuid4().hex}"


def _listen(address: str) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(address)
    sock.listen(_BACKLOG)
    return sock


def _accepted(sock: socket.socket) -> mpc.Connection:
    """An accepted socket as a connection, once the peer has proved it
    holds this tree's authkey (and this side has proved it too)."""
    conn = mpc.Connection(sock.detach())
    authkey = mp.current_process().authkey
    try:
        mpc.deliver_challenge(conn, authkey)
        mpc.answer_challenge(conn, authkey)
    except BaseException:
        conn.close()
        raise
    return conn


def _connect(address: str) -> mpc.Connection:
    return mpc.Client(address, family="AF_UNIX",
                      authkey=mp.current_process().authkey)


def _serve_socket(sock: socket.socket, handle: Callable[[mpc.Connection],
                                                        None],
                  name: str) -> None:
    """Accept connections on ``sock`` until it closes; each on a daemon
    thread of its own that authenticates it and runs ``handle``."""

    def one(client: socket.socket) -> None:
        try:
            conn = _accepted(client)
        except Exception:  # a process of another tree, or one that left
            return
        with conn:
            handle(conn)

    while True:
        try:
            client, _ = sock.accept()
        except OSError:
            return
        client.setblocking(True)
        threading.Thread(target=one, args=(client,), name=f"{name}-conn",
                         daemon=True).start()


# ---- the child ---------------------------------------------------------


class _Line:
    """The worker's side of one caller's connection: one lock over its
    sends, and a cancel for every stream of that caller in flight."""

    def __init__(self, conn):
        self.conn = conn
        self.send_lock = threading.Lock()
        self.cancels: Dict[int, Callable[[], Any]] = {}


class _Host:
    """The worker's side: the instance, a pool of ``max_concurrency``
    threads for sync methods, an event loop thread for coroutine methods
    (started at the first one), and the callers' connections: the
    owner's pipe, read on the main thread, and every connection accepted
    on the worker's socket, each read on a thread of its own. A reply
    goes back on the connection its call came in on."""

    def __init__(self, name: str, max_concurrency: int):
        self._name = name
        self._instance = None
        self._max_concurrency = max_concurrency
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_concurrency, thread_name_prefix=f"{name}-call")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_lock = threading.Lock()
        self._slots: Optional[asyncio.Semaphore] = None
        self._tasks: set = set()  # strong refs: the loop holds tasks weakly
        self._cancels_lock = threading.Lock()
        self._lines: set = set()

    def send(self, line: _Line, call_id: int, status: int, value) -> bool:
        """Send one message; a value that does not pickle becomes a
        TaskError (and False, which ends a stream). False also when the
        caller is gone."""
        ok = True
        try:
            blob = _dumps(value)
        except Exception as exc:  # the method's result cannot cross
            ok, status, blob = False, _ERR, _dumps(TaskError.from_exception(
                f"pickling a result of call {call_id}", exc))
        try:
            with line.send_lock:
                line.conn.send((call_id, status, blob))
        except (BrokenPipeError, OSError):
            return False
        return ok

    def serve(self, owner: _Line, listener: socket.socket) -> None:
        """Serve every caller until the owner closes its pipe; then cancel
        every stream and let the calls in flight end."""
        threading.Thread(target=_serve_socket,
                         args=(listener, lambda c: self.read(_Line(c)),
                               self._name),
                         name=f"{self._name}-accept", daemon=True).start()
        self.read(owner)
        listener.close()
        for line in list(self._lines):
            self._cancel_all(line)
        self._pool.shutdown(wait=False, cancel_futures=True)

    def read(self, line: _Line) -> None:
        """Read one caller's calls until its connection closes; then
        close that caller's streams."""
        self._lines.add(line)
        while True:
            try:
                kind, call_id, blob, tc = line.conn.recv()
            except (EOFError, OSError):
                break  # the caller is gone
            if kind == _CANCEL:
                self._cancel(line, call_id)
            elif kind == _DUMP:
                # Off the pool: a busy worker still answers, and asking
                # its own workers must not hold this reader.
                threading.Thread(target=self._dump, args=(line, call_id,
                                                          blob),
                                 name=f"{self._name}-dump",
                                 daemon=True).start()
            else:
                self._dispatch(line, kind, call_id, blob, tc)
        self._cancel_all(line)
        self._lines.discard(line)

    def _cancel_all(self, line: _Line) -> None:
        for call_id in list(line.cancels):
            self._cancel(line, call_id)

    def _cancel(self, line: _Line, call_id: int) -> None:
        with self._cancels_lock:
            cancel = line.cancels.pop(call_id, None)
        if cancel is not None:
            cancel()

    def _dump(self, line: _Line, call_id: int, timeout: float) -> None:
        self.send(line, call_id, _OK, [tracing.dump(), *trace_dumps(timeout)])

    def _dispatch(self, line: _Line, kind: str, call_id: int,
                  blob: bytes, tc) -> None:
        label = f"call {call_id}"
        try:
            method, args, kwargs = pickle.loads(blob)
            label = method if isinstance(method, str) else getattr(
                method, "__name__", repr(method))
            args = [_unpacked(a) for a in args]
            kwargs = {k: _unpacked(v) for k, v in kwargs.items()}
            fn = (getattr(self._instance, method) if isinstance(method, str)
                  else functools.partial(method, self._instance))
        except Exception as exc:
            self.send(line, call_id, _ERR, TaskError.from_exception(
                f"{self._name}.{label}", exc))
            return
        tctx = None if tc is None else tracing.TraceContext.from_wire(tc)
        if tctx is None and not tracing.enabled():
            self._submit(line, kind, call_id, f"{self._name}.{label}", fn,
                         args, kwargs, None)
            return
        token = tracing.set_current_trace(tctx) if tctx is not None else None
        try:
            with tracing.span("rpc.server." + label):
                # The hop to the pool or the loop drops context
                # variables: the call re-anchors this context there.
                self._submit(line, kind, call_id, f"{self._name}.{label}",
                             fn, args, kwargs, tracing.current_trace())
        finally:
            if token is not None:
                tracing.reset_current_trace(token)

    def _submit(self, line, kind, call_id, label, fn, args, kwargs,
                tc) -> None:
        """Run one call on the pool or the loop; ``tc`` (or None: an
        untraced call) is anchored around it there."""
        if kind == _STREAM:
            if inspect.isasyncgenfunction(fn):
                fut = self._on_loop(self._stream_async(line, call_id, label,
                                                       fn, args, kwargs, tc))
                self._register(line, call_id, fut.cancel)
            else:
                stop = threading.Event()
                self._register(line, call_id, stop.set)
                self._on_pool(tc, self._stream_sync, line, call_id, label,
                              stop, fn, args, kwargs)
        elif inspect.iscoroutinefunction(fn):
            self._on_loop(self._call_async(line, call_id, label, fn, args,
                                           kwargs, tc))
        else:
            self._on_pool(tc, self._call_sync, line, call_id, label, fn,
                          args, kwargs)

    def _on_pool(self, tc, fn, *args) -> None:
        if tc is None:
            self._pool.submit(fn, *args)
        else:
            self._pool.submit(tracing.run_with_trace, tc,
                              "worker.actor_task.run", fn, *args)

    def _register(self, line: _Line, call_id: int, cancel) -> None:
        with self._cancels_lock:
            line.cancels[call_id] = cancel

    def _done(self, line: _Line, call_id: int) -> None:
        with self._cancels_lock:
            line.cancels.pop(call_id, None)

    def _on_loop(self, coro) -> concurrent.futures.Future:
        with self._loop_lock:  # every connection's reader may get here
            if self._loop is None:
                self._loop = asyncio.new_event_loop()
                self._slots = asyncio.Semaphore(self._max_concurrency)
                threading.Thread(target=self._loop.run_forever,
                                 name=f"{self._name}-loop",
                                 daemon=True).start()
        return asyncio.run_coroutine_threadsafe(coro, self._loop)

    def _call_sync(self, line, call_id, label, fn, args, kwargs) -> None:
        try:
            status, value = _OK, fn(*args, **kwargs)
        except Exception as exc:
            status, value = _ERR, TaskError.from_exception(label, exc)
        self.send(line, call_id, status, value)

    async def _call_async(self, line, call_id, label, fn, args,
                          kwargs, tc) -> None:
        # A task runs in a context of its own: anchoring here stays in it.
        if tc is not None:
            tracing.set_current_trace(tc)
        self._tasks.add(asyncio.current_task())
        try:
            async with self._slots:
                with tracing.span("worker.actor_task.run"):
                    status, value = _OK, await fn(*args, **kwargs)
        except Exception as exc:
            status, value = _ERR, TaskError.from_exception(label, exc)
        finally:
            self._tasks.discard(asyncio.current_task())
        self.send(line, call_id, status, value)

    def _stream_sync(self, line, call_id, label, stop: threading.Event, fn,
                     args, kwargs) -> None:
        gen = None
        try:
            if stop.is_set():
                return
            gen = fn(*args, **kwargs)
            for value in gen:
                if not self.send(line, call_id, _ITEM, value) or \
                        stop.is_set():
                    return
            self.send(line, call_id, _END, None)
        except Exception as exc:
            self.send(line, call_id, _ERR,
                      TaskError.from_exception(label, exc))
        finally:
            self._done(line, call_id)
            close = getattr(gen, "close", None)
            if close is not None:
                close()  # a cancelled generator's finally runs here

    async def _stream_async(self, line, call_id, label, fn, args,
                            kwargs, tc) -> None:
        if tc is not None:
            tracing.set_current_trace(tc)
        self._tasks.add(asyncio.current_task())
        try:
            async with self._slots:
                with tracing.span("worker.actor_task.run"):
                    await self._drain(line, call_id, fn(*args, **kwargs))
        except asyncio.CancelledError:
            pass  # the caller closed the stream: this task was cancelled
        except Exception as exc:
            self.send(line, call_id, _ERR,
                      TaskError.from_exception(label, exc))
        finally:
            self._done(line, call_id)
            self._tasks.discard(asyncio.current_task())

    async def _drain(self, line, call_id, agen) -> None:
        """Send each value of an async generator, then the end."""
        try:
            async for value in agen:
                if not self.send(line, call_id, _ITEM, value):
                    return
            self.send(line, call_id, _END, None)
        finally:
            await agen.aclose()


def _worker_main(conn, listener: socket.socket, name: str, blob: bytes,
                 num_threads: int, max_concurrency: int,
                 registry: str, spawned: float) -> None:
    """The body of a worker process: build the instance, then serve calls
    until the owner closes its pipe."""
    global _REGISTRY
    START_MARKS.update(spawned=spawned, entered=time.time())
    tracing.set_process_identity("worker", name)
    # A daemonic process may not start children; this flag is the
    # worker's own record of itself (its owner started it as a daemon,
    # which the owner's exit terminates), so clearing it here lets the
    # worker start workers of its own. Its children are daemons of its
    # own and end with it: nothing outlives the driver.
    mp.current_process().daemon = False
    _REGISTRY = registry
    torch.set_num_threads(num_threads)
    host = _Host(name, max_concurrency)
    owner = _Line(conn)
    try:
        cls, args, kwargs = pickle.loads(blob)
        START_MARKS["imported"] = time.time()
        host._instance = cls(*args, **kwargs)
        START_MARKS["constructed"] = time.time()
    except Exception as exc:
        host.send(owner, 0, _ERR,
                  TaskError.from_exception(f"{name}.__init__", exc))
        return
    if host.send(owner, 0, _OK, None):
        host.serve(owner, listener)


# ---- the caller --------------------------------------------------------


class _Caller:
    """A caller's side of one worker: the connection, a thread that reads
    every reply as it comes (so the worker never blocks on a full
    connection), the replies still wanted, and the values of every open
    stream not yet taken. :class:`_Worker` is the owner's (it started the
    process); :class:`_Client` any other process's."""

    def __init__(self, name: str, address: str):
        self.name = name
        self.address = address
        self._ids = itertools.count(1)
        self._send_lock = threading.Lock()
        self._wanted: set = set()
        self._results: Dict[int, Tuple[bool, Any]] = {}
        self.streams: Dict[int, deque] = {}  # call id: (status, value)s
        self.dead: Optional[str] = None
        self._exit_seen: Optional[float] = None

    @property
    def pid(self) -> Optional[int]:
        raise NotImplementedError

    def _read_loop(self, conn) -> None:
        while True:
            try:
                call_id, status, blob = conn.recv()
            except (EOFError, OSError):
                break
            try:
                value = pickle.loads(blob)
            except Exception as exc:  # e.g. a class the caller cannot import
                status, value = _ERR, TaskError.from_exception(
                    f"{self.name}: unpickling a result of call {call_id}",
                    exc)
            with _READY:
                if call_id == 0:
                    self._started(status == _OK, value)
                elif call_id in self.streams:
                    self.streams[call_id].append((status, value))
                elif call_id in self._wanted:
                    self._results[call_id] = (status == _OK, value)
                _READY.notify_all()

    def _started(self, ok: bool, value) -> None:
        """The owner's: the constructor's outcome (call id 0)."""

    def _mark_dead(self, reason: Optional[str]) -> None:
        with _READY:
            if self.dead is None:
                self.dead = reason or self._death()
            _READY.notify_all()

    def _death(self) -> str:
        return f"process {self.pid} exited"

    def _gone(self) -> bool:
        """Whether the worker's process has ended."""
        raise NotImplementedError

    def check_exit(self, now: float) -> None:
        """Count the worker dead once its process has been gone for
        EXIT_GRACE_S without the connection's EOF reaching the reader."""
        if self.dead is not None or not self._gone():
            return
        if self._exit_seen is None:
            self._exit_seen = now
        elif now - self._exit_seen >= EXIT_GRACE_S:
            self._mark_dead(None)

    def submit(self, method, args, kwargs) -> "ObjectRef":
        return ObjectRef(self, self._send_call(_CALL, method, args, kwargs))

    def submit_stream(self, method, args, kwargs):
        from raytpu_torch.runtime.generator import ObjectRefGenerator

        return ObjectRefGenerator(self, self._send_call(_STREAM, method,
                                                        args, kwargs))

    def _send_call(self, kind: str, method, args, kwargs) -> int:
        args = tuple(_resolve(a) for a in args)
        kwargs = {k: _resolve(v) for k, v in kwargs.items()}
        blob = _dumps((method, args, kwargs))  # a bad argument raises here
        call_id = self._new_call(kind)
        tc = tracing.current_trace()
        if not tracing.enabled():
            # An untraced hop in a traced request forwards the context
            # unchanged, so the chain is not severed downstream.
            self._send((kind, call_id, blob,
                        None if tc is None else tc.to_wire()))
            return call_id
        label = method if isinstance(method, str) else getattr(
            method, "__name__", repr(method))
        with tracing.span("rpc.client." + label) as attrs:
            attrs["peer"] = self.name
            self._send((kind, call_id, blob,
                        tracing.current_trace().to_wire()))
        return call_id

    def _new_call(self, kind: str) -> int:
        with _READY:
            call_id = next(self._ids)
            if kind == _STREAM:
                self.streams[call_id] = deque()
            else:
                self._wanted.add(call_id)
        return call_id

    def submit_dump(self, timeout: float) -> "ObjectRef":
        """Ask the worker for its span buffers and those of its workers,
        which it waits on for at most ``timeout`` seconds."""
        call_id = self._new_call(_DUMP)
        self._send((_DUMP, call_id, timeout, None))
        return ObjectRef(self, call_id)

    def _send(self, message) -> None:
        raise NotImplementedError

    def cancel(self, call_id: int) -> None:
        """Close a stream: drop what it sent and has not been taken, and
        tell the worker to close its generator."""
        with _READY:
            if self.streams.pop(call_id, None) is None:
                return
        if self.dead is None:
            self._send((_CANCEL, call_id, None, None))

    def forget(self, call_id: int) -> None:
        with _READY:
            self._wanted.discard(call_id)
            self._results.pop(call_id, None)


class _Worker(_Caller):
    """The owner's side of one worker process: it started the process and
    talks to it over a pipe, whose EOF in the child ends the worker."""

    def __init__(self, cls, args, kwargs, num_threads: int,
                 max_concurrency: int = 1):
        super().__init__(f"{cls.__name__}-{uuid.uuid4().hex[:8]}",
                         _new_address())
        blob = _dumps((cls, args, kwargs))  # a bad argument raises here
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        # The socket listens before the child starts, so a caller that
        # connects early waits in its backlog, never on a missing address.
        listener = _listen(self.address)
        self.proc = ctx.Process(target=_worker_main,
                                args=(child, listener, self.name, blob,
                                      num_threads, max_concurrency,
                                      _registry_address(), time.time()),
                                name=self.name, daemon=True)
        try:
            self.proc.start()
        finally:
            child.close()  # the child's ends live in the child only: EOF
            listener.close()
        self.started: Optional[Tuple[bool, Any]] = None
        self._stop_reason: Optional[str] = None
        self._reader = threading.Thread(target=self._read_and_reap,
                                        name=f"{self.name}-reader",
                                        daemon=True)
        self._reader.start()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def _read_and_reap(self) -> None:
        self._read_loop(self._conn)
        self.proc.join(timeout=_REAP_S)
        self._mark_dead(None)

    def _started(self, ok: bool, value) -> None:
        self.started = (ok, value)

    def _death(self) -> str:
        if self._stop_reason is not None:
            return self._stop_reason
        if self.started and not self.started[0]:
            return f"its constructor raised:\n{self.started[1]}"
        return (f"process {self.proc.pid} exited with code "
                f"{self.proc.exitcode}")

    def _gone(self) -> bool:
        return self.proc.exitcode is not None

    def _send(self, message) -> None:
        try:
            with self._send_lock:
                self._conn.send(message)
        except (BrokenPipeError, OSError):
            pass  # the worker is gone: the reader marks it dead at EOF

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


class _Client(_Caller):
    """Another process's side of a worker: a connection to the worker's
    socket, opened by the reader thread at the first call (calls sent
    before it is open wait in a queue, in order). The worker's death is
    seen at the connection's EOF; dropping a client ends nothing."""

    def __init__(self, name: str, address: str, pid: int):
        super().__init__(name, address)
        self._pid = pid
        self._conn = None
        self._queue: List[tuple] = []
        self._reader: Optional[threading.Thread] = None

    @property
    def pid(self) -> Optional[int]:
        return self._pid

    def connect(self) -> None:
        """Start the reader thread, which opens the connection (at most
        once)."""
        with self._send_lock:
            if self._reader is None:
                self._reader = threading.Thread(
                    target=self._connect_and_read,
                    name=f"{self.name}-client", daemon=True)
                self._reader.start()

    def _connect_and_read(self) -> None:
        try:
            conn = _connect(self.address)
        except Exception as exc:  # gone, or its constructor raised
            self._mark_dead(f"its socket refused the connection ({exc!r}): "
                            f"process {self._pid} has exited")
            self._forget_client()
            return
        with self._send_lock:
            queued, self._queue = self._queue, []
            self._conn = conn
            try:
                for message in queued:
                    conn.send(message)
            except OSError:
                pass  # the worker is gone: EOF follows
        self._read_loop(conn)
        self._mark_dead(None)
        self._forget_client()
        conn.close()

    def _forget_client(self) -> None:
        with _HANDLES_LOCK:
            if _CLIENTS.get(self.address) is self:
                del _CLIENTS[self.address]

    def _death(self) -> str:
        return f"its connection closed: process {self._pid} exited"

    def _gone(self) -> bool:
        try:
            os.kill(self._pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:  # another user's process took the pid
            return True
        return False

    def _send(self, message) -> None:
        self.connect()
        with self._send_lock:
            if self._conn is None:
                if self.dead is None:
                    self._queue.append(message)
                return
            try:
                self._conn.send(message)
            except (BrokenPipeError, OSError):
                pass  # the worker is gone: the reader marks it dead at EOF

    def kill(self, reason: str) -> None:
        """SIGKILL the worker's process from a process that does not own
        it; the owner reaps it at the pipe's EOF."""
        if self.dead is None:
            try:
                os.kill(self._pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self._mark_dead(reason)


class ObjectRef:
    """A future: a value ``put`` holds, or the reply of one call on a
    worker. Hashable by identity."""

    __slots__ = ("_worker", "_call_id", "_value")

    def __init__(self, worker: Optional[_Caller] = None, call_id: int = 0,
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
    in the worker), a stream's value or a call's result, anything else as
    it is."""
    if not isinstance(arg, ObjectRef):
        return arg
    if arg._worker is None and isinstance(arg._value, _Packed):
        return arg._value
    return get(arg)


class _Value:
    """What a ref to a value already in hand (a stream's) holds."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def unpack(self):
        return self.value


class _Method:
    def __init__(self, worker: _Caller, name: str, num_returns=1):
        self._worker = worker
        self._name = name
        self._num_returns = num_returns

    def options(self, **options) -> "_Method":
        """``num_returns=1`` (a future) or ``"streaming"`` (an
        :class:`~raytpu_torch.runtime.generator.ObjectRefGenerator`);
        any other option raises."""
        unknown = sorted(set(options) - {"num_returns"})
        if unknown:
            raise ValueError(f"method options {unknown}: the port's runtime "
                             f"takes only num_returns")
        num_returns = options.get("num_returns", self._num_returns)
        if num_returns not in (1, "streaming"):
            raise ValueError(f"num_returns={num_returns!r}: the port's "
                             f"runtime takes 1 or 'streaming'")
        return _Method(self._worker, self._name, num_returns)

    def remote(self, *args, **kwargs):
        if self._num_returns == "streaming":
            return self._worker.submit_stream(self._name, args, kwargs)
        return self._worker.submit(self._name, args, kwargs)


# The owner's handles by worker address (a handle unpickled where its
# worker was started is that same handle), and the other processes'
# clients, one connection a worker however many copies of its handle
# arrive.
_OWNED: "weakref.WeakValueDictionary[str, ActorHandle]" = \
    weakref.WeakValueDictionary()
_CLIENTS: Dict[str, _Client] = {}
_HANDLES_LOCK = threading.Lock()


class ActorHandle:
    """One worker process holding one instance: ``handle.method.remote(...)``
    submits a call. It pickles, and works in any process of the tree;
    dropping the owner's last handle ends the process."""

    def __init__(self, cls, worker: _Caller):
        self._cls = cls
        self._worker = worker
        self._finalizer = None
        if isinstance(worker, _Worker):
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
        return self._worker.pid

    def __reduce__(self):
        w = self._worker
        return (_rebuild_handle, (self._cls, w.name, w.address, w.pid))

    def __eq__(self, other):
        if not isinstance(other, ActorHandle):
            return NotImplemented
        return self._worker.address == other._worker.address

    def __hash__(self):
        return hash(self._worker.address)

    def __repr__(self):
        return f"ActorHandle({self._worker.name}, pid={self.pid})"


def _rebuild_handle(cls, name: str, address: str, pid: int) -> ActorHandle:
    """An unpickled handle: the owner's own where its worker was started,
    else one on this process's client of the worker."""
    with _HANDLES_LOCK:
        owned = _OWNED.get(address)
        if owned is not None:
            return owned
        client = _CLIENTS.get(address)
        if client is None:
            client = _CLIENTS[address] = _Client(name, address, pid)
    return ActorHandle(cls, client)


class RemoteClass:
    """What :func:`remote` makes of a class: ``.options(num_cpus=...,
    max_concurrency=..., name=..., namespace=..., lifetime=...)`` and
    ``.remote(*args, **kwargs)``."""

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
        max_concurrency = options.get("max_concurrency", 1)
        if not isinstance(max_concurrency, int) or max_concurrency < 1:
            raise ValueError(f"max_concurrency={max_concurrency!r}: a "
                             f"worker runs at least one call at a time")
        name = options.get("name")
        if name is not None and (not isinstance(name, str) or not name):
            raise ValueError(f"name={name!r}: an actor's name is a "
                             f"non-empty string")
        if options.get("lifetime") not in LIFETIMES:
            raise ValueError(f"lifetime={options['lifetime']!r}: the port's "
                             f"runtime takes {list(LIFETIMES)}")
        self._cls = cls
        self._options = options
        self._threads = int(num_cpus)
        self._max_concurrency = max_concurrency

    def options(self, **options) -> "RemoteClass":
        return RemoteClass(self._cls, {**self._options, **options})

    def remote(self, *args, **kwargs) -> ActorHandle:
        name = self._options.get("name")
        namespace = self._options.get("namespace") or "default"
        detached = self._options.get("lifetime") == "detached"
        if detached and _REGISTRY is not None:
            # The driver starts a detached actor: it must not end with
            # this process.
            return _ask_registry("create", self._cls, args, kwargs,
                                 self._options)
        if name is not None:
            _names("reserve", namespace, name)
        try:
            worker = _Worker(self._cls, args, kwargs, self._threads,
                             self._max_concurrency)
        except BaseException:
            if name is not None:
                _names("release", namespace, name)
            raise
        handle = ActorHandle(self._cls, worker)
        with _HANDLES_LOCK:
            _OWNED[worker.address] = handle
        if name is not None:
            _names("commit", namespace, name, handle, detached)
        return handle


def remote(cls) -> RemoteClass:
    """A class whose ``.remote(...)`` starts a worker process holding an
    instance (``.options(num_cpus=..., max_concurrency=..., name=...,
    namespace=..., lifetime=...)`` first to set its threads, how many
    calls it runs at once, its name and its lifetime).
    Classes only: the port's runtime has no tasks."""
    if not inspect.isclass(cls):
        raise TypeError(f"remote() takes a class, not {cls!r}: the port's "
                        f"runtime hosts actors only")
    return RemoteClass(cls)


def call(actor: ActorHandle, fn, *args, **kwargs) -> ObjectRef:
    """Run ``fn(instance, *args, **kwargs)`` in the worker, as a method
    call (in order with its other calls at ``max_concurrency=1``; on the
    event loop when ``fn`` is a coroutine function). ``fn`` must be
    importable by name there."""
    return actor._worker.submit(fn, args, kwargs)


# ---- named actors ------------------------------------------------------

# In a worker: the driver's registry address, given at spawn. None in the
# driver, which holds the registry itself.
_REGISTRY: Optional[str] = None
# The driver's registry: (namespace, name) -> an entry. An entry is None
# while its worker starts, the handle itself where the registry keeps the
# actor alive (detached, or registered by another process: a client,
# which governs nothing), or a weak reference to the owner's handle.
_NAMED: Dict[Tuple[str, str], Any] = {}
_NAMED_LOCK = threading.Lock()
_registry_socket: Optional[Tuple[str, socket.socket]] = None


def _entry_handle(entry) -> Optional[ActorHandle]:
    """The live handle of a registry entry, else None."""
    handle = entry() if isinstance(entry, weakref.ref) else entry
    if handle is None or handle._worker.dead is not None:
        return None
    return handle


def _named(op: str, namespace: str, name: str, handle=None,
           detached: bool = False):
    """The registry's operations, in the driver."""
    key = (namespace, name)
    with _NAMED_LOCK:
        entry = _NAMED.get(key)
        if op == "lookup":
            found = None if entry is None else _entry_handle(entry)
            if found is None:
                if entry is not None:
                    del _NAMED[key]  # its worker has died: the name is free
                raise ValueError(f"no actor named {name!r} in "
                                 f"{namespace!r}")
            return found
        if op == "reserve":
            if key in _NAMED and (entry is None
                                  or _entry_handle(entry) is not None):
                raise ValueError(f"actor name {name!r} already taken")
            _NAMED[key] = None
        elif op == "release":
            if key in _NAMED and entry is None:
                del _NAMED[key]
        elif op == "commit":
            owned = isinstance(handle._worker, _Worker)
            _NAMED[key] = (weakref.ref(handle) if owned and not detached
                           else handle)
            if not owned:
                handle._worker.connect()  # its EOF frees the name
    return None


def _names(op: str, namespace: str, name: str, *rest):
    if _REGISTRY is None:
        return _named(op, namespace, name, *rest)
    return _ask_registry(op, namespace, name, *rest)


def _ask_registry(op: str, *args):
    """One request to the driver's registry, on a connection of its own."""
    with _connect(_REGISTRY) as conn:
        conn.send((op, args))
        ok, value = conn.recv()
    if not ok:
        raise value
    return value


def _answer(conn: mpc.Connection) -> None:
    """Serve one worker's registry request (in the driver)."""
    try:
        op, args = conn.recv()
        if op == "create":
            cls, c_args, c_kwargs, options = args
            value = RemoteClass(cls, options).remote(*c_args, **c_kwargs)
        else:
            value = _named(op, *args)
        reply = (True, value)
    except (EOFError, OSError):
        return
    except Exception as exc:  # the caller raises it
        reply = (False, exc)
    try:
        conn.send(reply)
    except (BrokenPipeError, OSError):
        pass


def _registry_address() -> str:
    """The registry's address, for a worker about to start: the driver's
    own, whose socket this starts at the first worker."""
    global _registry_socket
    if _REGISTRY is not None:
        return _REGISTRY
    with _NAMED_LOCK:
        if _registry_socket is None:
            address = _new_address()
            sock = _listen(address)
            # The process the runtime did not start: its timeline track.
            tracing.set_process_identity("driver")
            threading.Thread(target=_serve_socket,
                             args=(sock, _answer, "registry"),
                             name="raytpu-torch-registry",
                             daemon=True).start()
            _registry_socket = (address, sock)
        return _registry_socket[0]


def trace_dumps(timeout: float = TRACE_DUMP_TIMEOUT_S) -> List[dict]:
    """The span buffers (``tracing.dump()`` payloads) of every live worker
    this process started and of the workers below them, each asked by
    its owner. A dead worker is skipped, as is one that does not answer
    within ``timeout`` seconds; its workers wait half as long on theirs."""
    with _HANDLES_LOCK:
        workers = [h._worker for h in list(_OWNED.values())]
    refs = [w.submit_dump(timeout / 2) for w in workers if w.dead is None]
    if not refs:
        return []
    ready, _ = wait(refs, num_returns=len(refs), timeout=timeout)
    dumps: List[dict] = []
    for ref in ready:
        try:
            dumps.extend(get(ref))
        except (ActorDiedError, TaskError):
            pass  # it died meanwhile: nothing of it to merge
    return dumps


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    """The handle of the live actor registered as ``name`` in
    ``namespace``, from any process of the tree; ``ValueError`` when there
    is none."""
    return _names("lookup", namespace, name)


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


def _block(workers, deadline: Optional[float]) -> bool:
    """Sleep (holding nothing) until a reply lands or a poll is due;
    False once the deadline has passed. ``workers`` are those whose exit
    the wait looks at."""
    now = time.monotonic()
    if deadline is not None and now >= deadline:
        return False
    for w in workers:
        if w is not None:
            w.check_exit(now)
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
            if not _block([r._worker for r in pending], deadline):
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
                    [r._worker for r in ref_list if not r._ready()],
                    deadline):
                break
    ready = ready[:num_returns]
    taken = {id(r) for r in ready}
    return ready, [r for r in ref_list if id(r) not in taken]


def kill(actor: ActorHandle) -> None:
    """End the worker's process now, from its owner or from any process
    that holds a copy of its handle; calls on it without a result raise
    :class:`ActorDiedError` at ``get``."""
    if actor._finalizer is not None:
        actor._finalizer.detach()
        actor._worker.shutdown("killed by kill()")
    else:
        actor._worker.kill("killed by kill()")
