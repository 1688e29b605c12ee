"""The port's worker-process layer: actors and tasks on
``torch.multiprocessing``, with an object store between them.

The calls of :mod:`raytpu.runtime.api` that the port's libraries use,
with their shape: ``remote(cls)`` and ``.options(num_cpus=..., num_gpus=...,
resources=..., max_concurrency=..., name=..., namespace=...,
lifetime=..., max_restarts=..., placement_group=...)``, then
``.remote(*args)`` to start one process that holds one instance
(forked from a server of the starter's environment,
:mod:`raytpu_torch.runtime.starter`);
``handle.method.remote(*args, **kwargs)`` returns an :class:`ObjectRef`,
a future;
``handle.method.options(num_returns="streaming").remote(...)`` returns an
:class:`~raytpu_torch.runtime.generator.ObjectRefGenerator`;
``remote(fn)`` and ``remote(**options)(fn)`` make a remote function
(:mod:`raytpu_torch.runtime.remote_function`), whose calls run as tasks
on the tree's one task pool (:mod:`raytpu_torch.runtime.task_pool`);
``put``, ``get``, ``wait``, ``cancel``, ``kill``, ``get_actor``,
``init``, ``shutdown``, ``is_initialized``, ``cluster_resources``,
``available_resources``, ``nodes``, ``get_runtime_context`` and
``method``.

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
  ``get`` of a call whose value is itself a ref resolves it, one level;
- **refs cross processes** (:mod:`raytpu_torch.runtime.object_ref`): an
  :class:`ObjectRef` pickles to its owner's address and its id, borrows
  are counted (:mod:`raytpu_torch.runtime.refcount`), and a top-level
  ref argument of a call or task is resolved where it runs, from the
  process that holds its value, not in the caller;
- **handles cross processes.** An :class:`ActorHandle` pickles to the
  worker's address (an abstract Unix socket the worker listens on), its
  class and its pid; unpickled in another process of the tree, it
  connects at its first call, with a reader thread of its own, and every
  call, stream, cancel, ``call`` and ``kill`` works from there as from
  the owner. The sockets authenticate with the ``multiprocessing``
  authkey, which the runtime's children inherit, so only processes of
  one tree reach each other; a worker answers each call on the
  connection it came in on;
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

What crosses: a call's arguments, a result and a stream's values are
**sealed** into the object store (:mod:`raytpu_torch.runtime.object_store`)
by the process that has them, owned by the process that will read them:
CPU tensors and large buffers go into one shared-memory segment that the
reader maps, and only a small descriptor rides the connection. ``put``
seals its value once; every call that takes the ref maps those same
pages (a write there is seen by every holder). Functions and classes
that cannot be found by name go by value
(:mod:`raytpu_torch.runtime.serialization`).

- **the card as a resource.** Every actor is admitted by the driver's
  ledger (:mod:`raytpu_torch.runtime.ledger`) before its process starts:
  its ``num_cpus`` (0 by default, as the JAX package's; also the child's
  torch threads, 0 giving one), ``num_gpus`` (a share of one card, or
  whole cards) and custom ``resources``, from the node or from a
  placement group's bundle (``placement_group=``, its bundle index, or a
  ``PlacementGroupSchedulingStrategy``). One that does not fit now waits
  there (the handle returns at once, its calls queue); one that never
  can raises ``ValueError``. A child granted a card is bound to it
  before its first CUDA call (``CUDA_VISIBLE_DEVICES``, its device
  ``cuda:0``); one that asks for none keeps the view it had;
- **restarts.** Under ``max_restarts`` (-1: no limit) a worker that dies
  (a crash, a SIGKILL, ``kill(no_restart=False)``) starts again on the
  same socket, name and grant, as the JAX local backend restarts
  (``raytpu/runtime/local_backend.py:1023-1050``): not after ``kill``
  (from any process), a constructor's error, a dropped handle or
  ``shutdown``. Its calls in flight fail with :class:`ActorDiedError`;
  later ones reach the new process, whose
  ``get_runtime_context().was_current_actor_reconstructed`` is true.
  A copy of the handle in another process sees the death and stays on
  it; a fresh ``get_actor`` reaches the new process.

What it leaves out: streaming backpressure, ``runtime_env``, a cluster.
:func:`call` runs a function on the instance inside the worker (Ray's
``__ray_call__``), for callers that need to reach into a worker without
adding a method to its class (a compiled graph parks its exec loops so).
``.bind(...)`` on a remote class and on a method of a handle (any copy
of it, in any process) gives a node of :mod:`raytpu_torch.dag`, as on a
remote function; :func:`on_shutdown` registers what :func:`shutdown`
runs first (the compiled graphs' teardown).

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
fan-out: the driver asks every live process of the tree for its span
buffer at once (:func:`ask_processes`).

Records (:mod:`raytpu_torch.runtime.records`): with task events on, an
actor's owner records its CREATED and DEAD, and a caller each call's
SUBMITTED and, at its reply or its stream's end, FINISHED (the JAX
package's local mode records actor calls so); a worker ships its events
and metric deltas to the driver's store through the registry socket
(``ship``; a reaped worker's series are tombstoned by ``proc_dead``),
and ``at_driver`` runs a state query in the driver.

The tree's processes: every process the runtime starts (and every one
that joins) opens a connection to the driver's registry at its start
(``hello``, :func:`join_tree`), which the driver keeps in its table
(:func:`tree_processes`) until its EOF; on it the driver asks every live
process at once for a stack dump or a profile (:func:`ask_processes`,
read by :mod:`raytpu_torch.util.stack_dump`). A process outside the
tree joins it with ``init(address=...)``, the driver's
:func:`driver_address` (its registry's socket and the tree's authkey):
it takes an id from the driver, works as a worker of the tree, and is
tombstoned when its connection closes.
"""

from __future__ import annotations

import asyncio
import atexit
import concurrent.futures
import functools
import inspect
import itertools
import os
import signal
import socket
import sys
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.multiprocessing as mp

from raytpu_torch.core import topology
from raytpu_torch.core.errors import (ActorDiedError, GetTimeoutError,
                                      PlacementGroupError, TaskError)
from raytpu_torch.runtime import (context, ledger, object_store, records,
                                  refcount, remote_function, serialization,
                                  starter, task_pool, transport)
from raytpu_torch.runtime.object_ref import (ObjectRef, TopArg, is_ready,
                                             pending_caller, top_arg,
                                             value_of)
from raytpu_torch.util import metrics, profiler, task_events, tracing
from raytpu_torch.util.profiler import profiling_enabled

# How long a worker whose process has exited may keep its connection open
# before it counts as dead all the same (its last replies drain first).
EXIT_GRACE_S = 2.0
# How often a blocked get/wait looks at the processes' exit codes.
_POLL_S = 0.05
# How long kill() waits for the process to be reaped.
_REAP_S = 10.0
OPTIONS = ("num_cpus", "num_gpus", "resources", "max_concurrency", "name",
           "namespace", "lifetime", "max_restarts", *ledger.PLACEMENT_OPTIONS)
LIFETIMES = (None, "detached")
# The exit code of a worker that kill() ended from a process that does not
# own it: its owner restarts no worker that exits so.
EXIT_KILLED = 75

# Messages to a worker: (kind, call id, the sealed (method, args,
# kwargs), the caller's trace context in its wire form or None, the
# caller's pid, who owns what the worker seals for it).
_CALL, _STREAM, _CANCEL, _KILL = "call", "stream", "cancel", "kill"
# Messages from a worker: (call id, status, payload): a sealed value for
# _OK and _ITEM, the error for _ERR. A call gets one _OK or _ERR; a
# stream any number of _ITEM, then _END or _ERR.
_OK, _ERR, _ITEM, _END = 0, 1, 2, 3

# Every reply lands under this condition; get and wait sleep on it.
READY = refcount.READY
# How long trace_dumps waits for the tree's processes to answer.
TRACE_DUMP_TIMEOUT_S = 10.0
# In a worker: the wall-clock times (time.time()) of its start's stages:
# "spawned" (its owner's Process.start), "entered" (the worker's body
# runs: the interpreter, the owner's main module and this module
# imported), "imported" (its class unpickled, with the modules that
# takes) and "constructed" (the instance built).
START_MARKS: Dict[str, float] = {}


# ---- arguments ---------------------------------------------------------


def pack_args(args, kwargs):
    """A call's arguments as they cross: each top-level ref becomes a
    :class:`TopArg`, resolved where the call runs; the refs come back to
    be held by the submission until it ends."""
    keep = [a for a in (*args, *kwargs.values()) if isinstance(a, ObjectRef)]
    if not keep:
        return tuple(args), dict(kwargs), keep
    args = tuple(top_arg(a) if isinstance(a, ObjectRef) else a
                 for a in args)
    kwargs = {k: top_arg(v) if isinstance(v, ObjectRef) else v
              for k, v in kwargs.items()}
    return args, kwargs, keep


def resolve_args(args, kwargs):
    """The values of a call's top-level refs, got where the call runs."""
    if not any(isinstance(a, TopArg) for a in (*args, *kwargs.values())):
        return args, kwargs
    return ([get(a.ref()) if isinstance(a, TopArg) else a for a in args],
            {k: get(v.ref()) if isinstance(v, TopArg) else v
             for k, v in kwargs.items()})


async def _resolved_off_loop(args, kwargs):
    if not any(isinstance(a, TopArg) for a in (*args, *kwargs.values())):
        return args, kwargs
    return await asyncio.to_thread(resolve_args, args, kwargs)


def owned_ref(sealed) -> ObjectRef:
    """A ref owned here to a sealed value (``put``'s, or a stream's that
    its producer sealed)."""
    oid = uuid.uuid4().hex
    refcount.new_entry(oid)
    ref = ObjectRef.owned(oid)
    refcount.complete(oid, sealed)
    return ref


# ---- the child ---------------------------------------------------------


class _Line:
    """The worker's side of one caller's connection: one lock over its
    sends, a cancel for every stream of that caller in flight, and the
    caller's pid (who owns what the worker seals for it)."""

    def __init__(self, conn, pid: int = 0):
        self.conn = conn
        self.pid = pid
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
        """Send one message: a value (a result, or a stream's item) sealed
        into the store for the caller, who owns it; an error as it is. A
        value that does not pickle becomes a TaskError (and False, which
        ends a stream). False also when the caller is gone."""
        ok = True
        if status in (_OK, _ITEM):
            try:
                value = object_store.seal(value, line.pid)
            except Exception as exc:  # the method's result cannot cross
                ok, status, value = False, _ERR, TaskError.from_exception(
                    f"pickling a result of call {call_id}", exc)
        try:
            with line.send_lock:
                transport.send(line.conn, (call_id, status, value))
        except (BrokenPipeError, OSError):
            if status in (_OK, _ITEM):
                refcount.discard(value)
            return False
        return ok

    def serve(self, owner: _Line, listener: socket.socket) -> None:
        """Serve every caller until the owner closes its pipe; then cancel
        every stream and let the calls in flight end."""
        threading.Thread(target=transport.serve_socket,
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
                kind, call_id, blob, tc, line.pid = transport.recv(line.conn)
            except (EOFError, OSError):
                break  # the caller is gone
            if kind == _KILL:
                os._exit(EXIT_KILLED)
            if kind == _CANCEL:
                self._cancel(line, call_id)
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

    def _dispatch(self, line: _Line, kind: str, call_id: int,
                  blob: bytes, tc) -> None:
        label = f"call {call_id}"
        try:
            method, args, kwargs = object_store.unseal(blob)
            label = method if isinstance(method, str) else getattr(
                method, "__name__", repr(method))
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
            args, kwargs = resolve_args(args, kwargs)
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
            args, kwargs = await _resolved_off_loop(args, kwargs)
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
            args, kwargs = resolve_args(args, kwargs)
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
            args, kwargs = await _resolved_off_loop(args, kwargs)
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


def _worker_main(conn, listener: socket.socket, name: str, blob,
                 num_threads: int, max_concurrency: int,
                 registry: str, owner_pid: int, spawned: float,
                 uid: str, start: dict) -> None:
    """The body of a worker process: bind its cards (``start["visible"]``,
    before anything touches CUDA), build the instance, then serve calls
    until the owner closes its pipe; its records ship to the driver on a
    timer (:mod:`raytpu_torch.runtime.records`). ``start`` also holds
    the actor's id, its attempt and its placement group."""
    START_MARKS.update(spawned=spawned, entered=time.time())
    bind_error = None
    if start["visible"] is not None:
        try:
            topology.bind_card(start["visible"])
        except RuntimeError as exc:  # the constructor's error, below
            bind_error = exc
    context.set_process(start["actor_id"], start["attempt"], start["pg"],
                        start["capture"])
    tracing.set_process_identity("worker", name)
    # A daemonic process may not start children; this flag is the
    # worker's own record of itself (its owner started it as a daemon,
    # which the owner's exit terminates), so clearing it here lets the
    # worker start workers of its own. Its children are daemons of its
    # own and end with it: nothing outlives the driver.
    mp.current_process().daemon = False
    set_registry(registry)
    records.set_identity(False, uid)
    join_tree(uid, "actor", name)
    if profiling_enabled():
        profiler.start_continuous()
    torch.set_num_threads(num_threads)
    host = _Host(name, max_concurrency)
    owner = _Line(conn, owner_pid)
    try:
        if bind_error is not None:
            raise bind_error
        cls, args, kwargs = object_store.unseal(blob)
        START_MARKS["imported"] = time.time()
        args, kwargs = resolve_args(args, kwargs)
        host._instance = cls(*args, **kwargs)
        START_MARKS["constructed"] = time.time()
    except Exception as exc:
        host.send(owner, 0, _ERR,
                  TaskError.from_exception(f"{name}.__init__", exc))
        return
    if host.send(owner, 0, _OK, None):
        records.start_shipping()
        host.serve(owner, listener)
        records.stop_shipping()


# ---- the caller --------------------------------------------------------


class _Caller:
    """A caller's side of one worker: the connection, a thread that reads
    every reply as it comes (so the worker never blocks on a full
    connection), the calls still waiting for their replies (each an
    entry of this process's object table), and the values of every open
    stream not yet taken. :class:`_Worker` is the owner's (it started
    the process); :class:`_Client` any other process's."""

    def __init__(self, name: str, address: str):
        self.name = name
        self.address = address
        self._ids = itertools.count(1)
        self._send_lock = threading.Lock()
        self._pending: Dict[int, refcount.Submission] = {}
        self.streams: Dict[int, deque] = {}  # call id: (status, value)s
        self.dead: Optional[str] = None
        self._exit_seen: Optional[float] = None
        # With task events on: call id -> (task id, name) of each call
        # whose FINISHED is still to be recorded.
        self._tids: Dict[int, Tuple[str, str]] = {}

    @property
    def actor_id(self) -> str:
        """The actor's id in the records: its socket's hex."""
        return self.address.rsplit("-", 1)[-1]

    @property
    def pid(self) -> Optional[int]:
        raise NotImplementedError

    def _read_loop(self, conn) -> None:
        while True:
            try:
                call_id, status, payload = transport.recv(conn)
            except (EOFError, OSError):
                break
            with READY:
                if call_id == 0:
                    self._started(status == _OK, payload)
                    continue
                streamed = call_id in self.streams
                if streamed:
                    self.streams[call_id].append((status, payload))
                    READY.notify_all()
                else:
                    sub = self._pending.pop(call_id, None)
            if not streamed or status in (_END, _ERR):
                self._call_finished(call_id)
            if streamed:
                continue
            if sub is None:  # a call nobody waits for any more
                if status in (_OK, _ITEM):
                    refcount.discard(payload)
                continue
            sub.finish()
            if status == _OK:
                refcount.complete(sub.oid, payload)
            else:
                refcount.fail(sub.oid, payload)

    def _started(self, ok: bool, value) -> None:
        """The owner's: the constructor's outcome (call id 0)."""

    def _call_finished(self, call_id: int) -> None:
        """A call's reply, or a stream's end or close: its FINISHED."""
        if task_events.enabled():
            done = self._tids.pop(call_id, None)
            if done is not None:
                task_events.emit("task", done[0],
                                 task_events.TaskTransition.FINISHED,
                                 name=done[1])

    def _mark_dead(self, reason: Optional[str]) -> None:
        with READY:
            first = self.dead is None
            if first:
                self.dead = reason or self._death()
            pending, self._pending = self._pending, {}
            self._tids.clear()  # a call its actor's death fails ends no task
            READY.notify_all()
        if first:
            self._died()
        for sub in pending.values():
            sub.finish()
            refcount.fail(sub.oid, ActorDiedError(self.name, self.dead))

    def _death(self) -> str:
        return f"process {self.pid} exited"

    def _died(self) -> None:
        """Once, when the worker is first seen dead (the owner's records
        its actor's death)."""

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

    def submit(self, method, args, kwargs) -> ObjectRef:
        return self._send_call(_CALL, method, args, kwargs)

    def submit_stream(self, method, args, kwargs):
        from raytpu_torch.runtime.generator import ObjectRefGenerator

        return ObjectRefGenerator(self, self._send_call(_STREAM, method,
                                                        args, kwargs))

    def _send_call(self, kind: str, method, args, kwargs):
        """Send one call: a ref to its result (a stream's call id)."""
        args, kwargs, keep = pack_args(args, kwargs)
        # A bad argument raises here.
        sealed = object_store.seal((method, args, kwargs), os.getpid())
        call_id, ref = self._new_call(
            kind, refcount.Submission(None, keep, sealed))
        if task_events.enabled():
            # An actor call is a task of the records, as in the JAX
            # package's local mode: SUBMITTED here, FINISHED at its reply
            # (a stream's end or close).
            tid = uuid.uuid4().hex if ref is None else ref.hex()
            label = method if isinstance(method, str) else getattr(
                method, "__name__", repr(method))
            task_name = f"{self.name.rsplit('-', 1)[0]}.{label}"
            with READY:
                self._tids[call_id] = (tid, task_name)
            task_events.emit("task", tid,
                             task_events.TaskTransition.SUBMITTED,
                             name=task_name)
        tc = tracing.current_trace()
        if not tracing.enabled():
            # An untraced hop in a traced request forwards the context
            # unchanged, so the chain is not severed downstream.
            self._send((kind, call_id, sealed,
                        None if tc is None else tc.to_wire(), os.getpid()))
            return call_id if ref is None else ref
        label = method if isinstance(method, str) else getattr(
            method, "__name__", repr(method))
        with tracing.span("rpc.client." + label) as attrs:
            attrs["peer"] = self.name
            self._send((kind, call_id, sealed,
                        tracing.current_trace().to_wire(), os.getpid()))
        return call_id if ref is None else ref

    def _new_call(self, kind: str, sub: refcount.Submission):
        """A call id, and (for a call, not a stream) the ref its reply
        completes: failed at once if the worker is already dead."""
        ref = None
        with READY:
            call_id = next(self._ids)
            if kind == _STREAM:
                self.streams[call_id] = deque()
                return call_id, None
            sub.oid = uuid.uuid4().hex
            refcount.new_entry(sub.oid, caller=self, call_id=call_id)
            ref = ObjectRef.owned(sub.oid)
            dead = self.dead
            if dead is None:
                self._pending[call_id] = sub
        if dead is not None:
            sub.finish()
            refcount.fail(sub.oid, ActorDiedError(self.name, dead))
        return call_id, ref

    def _send(self, message) -> None:
        raise NotImplementedError

    def cancel(self, call_id: int) -> None:
        """Close a stream: drop what it sent and has not been taken, and
        tell the worker to close its generator."""
        with READY:
            buf = self.streams.pop(call_id, None)
        if buf is None:
            return
        self._call_finished(call_id)
        for status, payload in buf:
            if status == _ITEM:
                refcount.discard(payload)
        if self.dead is None:
            self._send((_CANCEL, call_id, None, None, os.getpid()))

    def forget(self, call_id: int) -> None:
        """No ref waits for the call's reply any more: its value is
        discarded when it lands (the submission still ends then)."""
        with READY:
            sub = self._pending.get(call_id)
            if sub is not None:
                sub.oid = None


class _Worker(_Caller):
    """The owner's side of one worker process: it asks the driver's ledger
    to admit the actor (``spec``), starts the process once it is granted
    (calls sent meanwhile wait, in order) and talks to it over a pipe,
    whose EOF in the child ends the worker. A worker that dies while
    ``max_restarts`` lasts (not by ``kill``, a constructor's error, a
    dropped handle or shutdown) starts again on the same socket, name
    and grant: the calls it had in flight fail with
    :class:`ActorDiedError`, later ones go to the new process."""

    def __init__(self, cls, args, kwargs, num_threads: int,
                 max_concurrency: int = 1, label: Optional[str] = None,
                 spec: Optional[ledger.Spec] = None, max_restarts: int = 0,
                 capture: bool = False):
        super().__init__(f"{cls.__name__}-{uuid.uuid4().hex[:8]}",
                         transport.new_address())
        # The actor's name in the records (its registered name, else its
        # class's) and its process's id there.
        self.label = label or cls.__name__
        self.uid = records.new_uid()
        args, kwargs, keep = pack_args(args, kwargs)
        # A bad argument raises here.
        self._ctor = refcount.Submission(None, keep, object_store.seal(
            (cls, args, kwargs), os.getpid()))
        self._threads = num_threads
        self._max_concurrency = max_concurrency
        self.max_restarts = max_restarts
        self.restarts = 0
        self._capture = capture
        self.proc = None
        self._conn = None
        self._queue: List[tuple] = []  # calls sent before the start
        # The calls a restart failed (never sent to the new process).
        self._failed: set = set()
        self.started: Optional[Tuple[bool, Any]] = None
        self._stop_reason: Optional[str] = None
        self._reader: Optional[threading.Thread] = None
        self.grant: Optional[dict] = None
        self._released = False
        self._rid = None
        # The socket listens from here on, so a caller that connects
        # before the start waits in its backlog, never on a missing
        # address.
        self._listener: Optional[socket.socket] = transport.listen(
            self.address)
        try:
            view, self._rid = admit(spec or ledger.Spec({}), self._admitted)
        except BaseException:
            self._listener.close()
            self._ctor.finish()
            raise
        if view is not None:
            self._admitted(view)

    @property
    def pid(self) -> Optional[int]:
        return None if self.proc is None else self.proc.pid

    def _admitted(self, view) -> None:
        """The ledger's grant (or the error of a group removed while the
        actor waited): start the process."""
        if isinstance(view, BaseException):
            with self._send_lock:
                listener, self._listener = self._listener, None
            if listener is not None:
                listener.close()
            self._mark_dead(f"its placement failed: {view}")
            self._ctor.finish()
            return
        with self._send_lock:
            self.grant = view
            if self._stop_reason is not None:  # killed while it waited
                stopped = True
            else:
                stopped = False
                self._launch()
        if stopped:
            self._release()
            return
        if self._reader is None:
            self._reader = threading.Thread(target=self._read_and_reap,
                                            name=f"{self.name}-reader",
                                            daemon=True)
            self._reader.start()

    def _launch(self) -> None:
        """Start the process on the grant (under the send lock), then send
        what was queued."""
        self._conn, child = mp.Pipe()
        listener, self._listener = (self._listener or transport.listen(
            self.address)), None
        start = {"visible": self.grant["visible"],
                 "actor_id": self.actor_id, "attempt": self.restarts,
                 "pg": self.grant["pg"], "capture": self._capture}
        self.proc = starter.Process(
            target=_worker_main,
            args=(child, listener, self.name, self._ctor.sealed,
                  self._threads, self._max_concurrency, _registry_address(),
                  os.getpid(), time.time(), self.uid, start),
            name=self.name, daemon=True)
        self._exit_seen = None
        try:
            self.proc.start()
        finally:
            child.close()  # the child's ends live in the child only: EOF
            listener.close()
        queued, self._queue = self._queue, []
        try:
            for message in queued:
                if message[1] not in self._failed:
                    transport.send(self._conn, message)
        except (BrokenPipeError, OSError):
            pass  # the worker is gone: the reader marks it dead at EOF

    def _read_and_reap(self) -> None:
        while True:
            self._read_loop(self._conn)
            self.proc.join(timeout=_REAP_S)
            if not self._restart():
                break
        # Its share is free by the time its death is seen.
        self._release()
        self._mark_dead(None)
        if metrics.enabled() or profiling_enabled():
            records.proc_dead(self.uid)
        self._ctor.finish()
        # What the worker owned (its puts, its calls' results) is gone
        # with it.
        object_store.sweep_owner(self.proc.pid)

    def _restart(self) -> bool:
        """Start the worker again where ``max_restarts`` allows (the JAX
        local backend's rule); False where it stays dead."""
        with self._send_lock:
            if not (self._stop_reason is None
                    and self.proc.exitcode != EXIT_KILLED
                    and self.started is not None and self.started[0]
                    and (self.max_restarts < 0
                         or self.restarts < self.max_restarts)):
                return False
            self.restarts += 1
            reason = self._death()
            old_pid, old_uid = self.proc.pid, self.uid
            self.started = None
            self.uid = records.new_uid()
            # Calls from here on queue for the new process.
            old_conn, self._conn = self._conn, None
            with READY:
                pending, self._pending = self._pending, {}
                # What was sent to the dead process is not sent again.
                self._failed = set(pending) | set(self.streams)
                for buf in self.streams.values():
                    buf.append((_ERR, ActorDiedError(self.name, reason)))
                self._tids.clear()  # a call its death fails ends no task
                READY.notify_all()
        for sub in pending.values():
            sub.finish()
            refcount.fail(sub.oid, ActorDiedError(self.name, reason))
        if task_events.enabled():
            # The JAX local backend's record of a restart: the death,
            # then RESTARTED; CREATED follows at the new start.
            task_events.emit("actor", self.actor_id,
                             task_events.TaskTransition.DEAD,
                             name=self.label, error=reason,
                             worker_id=old_uid)
            task_events.emit("actor", self.actor_id,
                             task_events.TaskTransition.RESTARTED,
                             name=self.label, attempt=self.restarts,
                             error=reason, worker_id=old_uid)
        if metrics.enabled() or profiling_enabled():
            records.proc_dead(old_uid)
        object_store.sweep_owner(old_pid)
        old_conn.close()
        with self._send_lock:
            if self._stop_reason is not None:
                return False  # killed meanwhile
            self._launch()
        return True

    def _release(self) -> None:
        """Give the grant back to the ledger (once), or drop the request
        that still waits there."""
        with self._send_lock:
            grant, released = self.grant, self._released
            self._released = True
        if released:
            return
        if grant is not None:
            release(grant["gid"])
        elif self._rid is not None:
            cancel_admission(self._rid)

    def _started(self, ok: bool, value) -> None:
        self.started = (ok, value)
        if self.max_restarts == 0:
            self._ctor.finish()  # a restart would construct it again
        if ok and task_events.enabled():
            task_events.emit("actor", self.actor_id,
                             task_events.TaskTransition.CREATED,
                             name=self.label, worker_id=self.uid,
                             attempt=self.restarts)

    def _died(self) -> None:
        if task_events.enabled():
            task_events.emit("actor", self.actor_id,
                             task_events.TaskTransition.DEAD,
                             name=self.label, error=self.dead,
                             worker_id=self.uid)

    def _death(self) -> str:
        if self._stop_reason is not None:
            return self._stop_reason
        if self.started and not self.started[0]:
            return f"its constructor raised:\n{self.started[1]}"
        if self.proc is None:
            return "it was never started"
        if self.proc.exitcode == EXIT_KILLED:
            return "killed by kill()"
        return (f"process {self.proc.pid} exited with code "
                f"{self.proc.exitcode}")

    def _gone(self) -> bool:
        return self.proc is not None and self.proc.exitcode is not None

    def _send(self, message) -> None:
        try:
            with self._send_lock:
                if self._conn is None:
                    if self.dead is None:
                        self._queue.append(message)
                    return
                transport.send(self._conn, message)
        except (BrokenPipeError, OSError):
            pass  # the worker is gone: the reader marks it dead at EOF

    def crash(self) -> None:
        """SIGKILL the process, as a crash would end it: the worker
        restarts where ``max_restarts`` allows (``kill(no_restart=False)``)."""
        proc = self.proc
        if proc is not None and proc.exitcode is None:
            proc.kill()

    def shutdown(self, reason: str) -> None:
        """End the process now (SIGKILL), reap it, and let the reader see
        the EOF; a worker still waiting for the ledger never starts. Safe
        to call more than once."""
        with self._send_lock:
            self._stop_reason = self._stop_reason or reason
            proc = self.proc
        if proc is None:  # waiting for the ledger
            with self._send_lock:
                listener, self._listener = self._listener, None
            if listener is not None:
                listener.close()
            self._release()
            self._mark_dead(None)
            self._ctor.finish()
            return
        if proc.exitcode is None:
            proc.kill()
        proc.join(timeout=_REAP_S)
        self._mark_dead(None)
        if self._reader is not None and \
                self._reader is not threading.current_thread():
            self._reader.join(timeout=_REAP_S)
        if self._reader is not None and not self._reader.is_alive() \
                and self._conn is not None:
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
            conn = transport.connect(self.address)
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
                    transport.send(conn, message)
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
        if self._pid is None:  # handed over before its worker started
            return False
        try:
            os.kill(self._pid, 0)
        except ProcessLookupError:
            return True
        except PermissionError:  # another user's process took the pid
            return True
        try:  # exited, and not reaped yet by its owner
            with open(f"/proc/{self._pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except (OSError, IndexError):
            return False

    def _send(self, message) -> None:
        self.connect()
        with self._send_lock:
            if self._conn is None:
                if self.dead is None:
                    self._queue.append(message)
                return
            try:
                transport.send(self._conn, message)
            except (BrokenPipeError, OSError):
                pass  # the worker is gone: the reader marks it dead at EOF

    def kill(self, reason: str, no_restart: bool = True) -> None:
        """End the worker's process from a process that does not own it;
        the owner reaps it at the pipe's EOF. With ``no_restart`` the
        worker exits itself, with :data:`EXIT_KILLED`, which its owner
        restarts no worker for (SIGKILL where it has not exited within
        :data:`EXIT_GRACE_S`); else a SIGKILL, a crash to its owner."""
        if self.dead is None and no_restart:
            self._send((_KILL, 0, None, None, os.getpid()))
            deadline = time.monotonic() + EXIT_GRACE_S
            while not self._gone() and time.monotonic() < deadline:
                time.sleep(_POLL_S)
        if self.dead is None and self._pid is not None:
            try:
                os.kill(self._pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self._mark_dead(reason)


class _Method:
    def __init__(self, worker: _Caller, name: str, num_returns=1,
                 handle: Optional["ActorHandle"] = None):
        self._worker = worker
        self._name = name
        self._num_returns = num_returns
        self._handle = handle

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
        return _Method(self._worker, self._name, num_returns, self._handle)

    def remote(self, *args, **kwargs):
        if self._num_returns == "streaming":
            return self._worker.submit_stream(self._name, args, kwargs)
        return self._worker.submit(self._name, args, kwargs)

    def bind(self, *args, **kwargs):
        """A lazy call of this method (:class:`raytpu_torch.dag.
        ActorMethodNode`), for ``execute`` or ``experimental_compile``."""
        from raytpu_torch.dag.node import ActorMethodNode

        return ActorMethodNode(self._handle, self._name, args, kwargs)


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
        return _Method(self._worker, name, handle=self)

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
    """What :func:`remote` makes of a class: ``.options(...)`` (any of
    :data:`OPTIONS`) and ``.remote(*args, **kwargs)``."""

    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        options = dict(options or {})
        unknown = sorted(set(options) - set(OPTIONS))
        if unknown:
            raise ValueError(f"options {unknown}: the port's runtime takes "
                             f"only {list(OPTIONS)}")
        num_cpus = options.get("num_cpus", 0)
        if not isinstance(num_cpus, (int, float)) or num_cpus < 0:
            raise ValueError(f"num_cpus={num_cpus!r}: a number >= 0 (held "
                             f"in the ledger, and the worker's torch "
                             f"threads; 0 gives one)")
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
        max_restarts = options.get("max_restarts", 0)
        if not isinstance(max_restarts, int) or max_restarts < -1:
            raise ValueError(f"max_restarts={max_restarts!r}: an int >= -1 "
                             f"(-1: no limit)")
        # An actor holds no CPU unless it asks (the JAX package's default).
        self._resources = ledger.build_resources(options, default_cpus=0.0)
        self._cls = cls
        self._options = options
        self._threads = max(1, int(num_cpus))
        self._max_concurrency = max_concurrency

    def options(self, **options) -> "RemoteClass":
        return RemoteClass(self._cls, {**self._options, **options})

    def bind(self, *args, **kwargs):
        """A lazy construction (:class:`raytpu_torch.dag.ClassNode`): its
        actor is created at the DAG's first execution or compilation."""
        from raytpu_torch.dag.node import ClassNode

        return ClassNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> ActorHandle:
        name = self._options.get("name")
        namespace = self._options.get("namespace") or "default"
        detached = self._options.get("lifetime") == "detached"
        if detached and _REGISTRY is not None:
            # The driver starts a detached actor: it must not end with
            # this process.
            return _ask_registry("create", self._cls, args, kwargs,
                                 self._options)
        pg, bundle, capture = ledger.placement_of(self._options)
        spec = ledger.Spec(self._resources, pg, bundle)
        if name is not None:
            _names("reserve", namespace, name)
        try:
            worker = _Worker(self._cls, args, kwargs, self._threads,
                             self._max_concurrency, name, spec,
                             self._options.get("max_restarts", 0), capture)
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


def remote(*args, **options):
    """``remote(cls)`` / ``remote(fn)``, or ``remote(**options)`` as a
    decorator: a class whose ``.remote(...)`` starts a worker process
    holding an instance (:class:`RemoteClass`), or a function whose
    ``.remote(...)`` runs it as a task
    (:class:`~raytpu_torch.runtime.remote_function.RemoteFunction`)."""
    if len(args) == 1 and not options and callable(args[0]):
        return _remote(args[0], {})
    if args:
        raise TypeError("remote() takes a class or a function, or keyword "
                        "options only, e.g. remote(num_cpus=2)")
    return lambda target: _remote(target, options)


def _remote(target, options: Dict[str, Any]):
    if inspect.isclass(target):
        return RemoteClass(target, options)
    return remote_function.RemoteFunction(target, options)


def call(actor: ActorHandle, fn, *args, **kwargs) -> ObjectRef:
    """Run ``fn(instance, *args, **kwargs)`` in the worker, as a method
    call (in order with its other calls at ``max_concurrency=1``; on the
    event loop when ``fn`` is a coroutine function). ``fn`` goes by name,
    or by value where it cannot be found by name."""
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
    with transport.connect(_REGISTRY) as conn:
        transport.send(conn, (op, args))
        ok, value = transport.recv(conn)
    if not ok:
        raise value
    return value


def _answer(conn) -> None:
    """Serve one worker's registry request (in the driver); a ``pool``
    request keeps the connection for that process's tasks."""
    try:
        op, args = transport.recv(conn)
        if op == "pool":
            task_pool.serve_client(conn, _pool, _serve_link, _drop_route)
            return
        if op == "hello":
            _serve_member(conn, *args)
            return
        if op == "ship":
            records.ingest(*args)
            value = None
        elif op == "proc_dead":
            records.tombstone(*args)
            value = None
        elif op == "at_driver":
            value = records.run_at_driver(*args)
        elif op == "create":
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
        transport.send(conn, reply)
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
            object_store.tree()  # before the first child: it inherits it
            address = transport.new_address()
            sock = transport.listen(address)
            # The process the runtime did not start: its timeline track,
            # and its id in the records.
            tracing.set_process_identity("driver")
            records.set_identity(True)
            if profiling_enabled():
                profiler.start_continuous()
            atexit.register(_at_driver_exit)
            threading.Thread(target=transport.serve_socket,
                             args=(sock, _answer, "registry"),
                             name="raytpu-torch-registry",
                             daemon=True).start()
            _registry_socket = (address, sock)
        return _registry_socket[0]


def trace_dumps(timeout: float = TRACE_DUMP_TIMEOUT_S) -> List[dict]:
    """The span buffers (``tracing.dump()`` payloads) of every live
    process of the tree but this one, asked at once by the driver
    (:func:`ask_processes`); a process that dies or does not answer
    within ``timeout`` seconds is skipped."""
    if _REGISTRY is None:
        _registry_address()  # the driver's own id, to leave out
    got = records.at_driver(ask_processes, "trace", (), "trace", timeout,
                            None, (records.identity(),))
    return [entry["trace"] for entry in got.values() if "trace" in entry]


# ---- the tree's processes ----------------------------------------------

# A driver's address, as a user hands it to a process outside the tree
# (``init(address=...)``, the CLI's ``--address``): the registry's
# abstract socket name and the tree's authkey, which the socket asks
# for. It is a credential: whoever holds it can act as the tree's
# processes.
ADDRESS_SCHEME = "raytpu-torch://"
# The variable the job manager sets to the driver's address for a job
# (the JAX package's RAYTPU_ADDRESS names a tcp:// head, which a JAX
# process would try to reach).
ADDRESS_ENV = "RAYTPU_TORCH_ADDRESS"
# How long a joining process waits for the driver's answer.
JOIN_TIMEOUT_S = 30.0


class _Member:
    """The driver's side of one live process of the tree: the connection
    it opened at its start (``hello``), on which the driver asks it for a
    stack dump or a profile and it answers; its EOF is the process's
    end."""

    def __init__(self, conn, uid: str, pid: int, kind: str, name: str):
        self.conn = conn
        self.uid = uid
        self.pid = pid
        self.kind = kind
        self.name = name
        self.closed = False
        self.replies: Dict[int, Tuple[bool, Any]] = {}
        self.cond = threading.Condition()
        self._ids = itertools.count(1)
        self._send_lock = threading.Lock()

    def ask(self, method: str, args: tuple) -> Optional[int]:
        """Send one request; its id, or None when the process is gone."""
        rid = next(self._ids)
        try:
            with self._send_lock:
                transport.send(self.conn, (rid, method, args))
        except OSError:
            return None
        return rid

    def reply(self, rid: int, deadline: float) -> Tuple[bool, Any]:
        """(True, payload), or (False, why not) by ``deadline``."""
        with self.cond:
            while rid not in self.replies:
                left = deadline - time.monotonic()
                if self.closed:
                    return False, f"process {self.pid} exited"
                if left <= 0:
                    return False, (f"process {self.pid} did not answer in "
                                   f"time")
                self.cond.wait(left)
            return self.replies.pop(rid)


# In the driver: every live process of the tree but itself, by its id.
_MEMBERS: Dict[str, _Member] = {}
_MEMBERS_LOCK = threading.Lock()


def _serve_member(conn, uid: Optional[str], pid: int, kind: str,
                  name: str) -> None:
    """The registry's side of a process's ``hello`` (in the driver): give
    a joining process (``uid`` None) its id and the tree's, keep the
    connection in the table and read the process's answers on it until
    it closes. A joined process's series and profile frames are
    tombstoned then, and what it owned is swept (the runtime's own
    children are reaped by their starters, which do the same)."""
    joined = uid is None
    if joined:
        uid = records.new_uid()
    transport.send(conn, (True, (uid, object_store.tree())))
    member = _Member(conn, uid, pid, kind, name)
    with _MEMBERS_LOCK:
        _MEMBERS[uid] = member
    try:
        while True:
            rid, ok, value = transport.recv(conn)
            with member.cond:
                member.replies[rid] = (ok, value)
                member.cond.notify_all()
    except (EOFError, OSError):
        pass  # the process has ended
    finally:
        with _MEMBERS_LOCK:
            if _MEMBERS.get(uid) is member:
                del _MEMBERS[uid]
        with member.cond:
            member.closed = True
            member.cond.notify_all()
        if joined:
            records.tombstone(uid)
            object_store.sweep_owner(pid)


def tree_processes() -> List[dict]:
    """Every live process of the tree (in the driver: its table, itself
    first): its id in the records, pid, kind (``driver``, ``actor``,
    ``task-worker``, ``joined``) and name."""
    if _REGISTRY is not None:
        return records.at_driver(tree_processes)
    _registry_address()  # the driver's own id
    with _MEMBERS_LOCK:
        members = list(_MEMBERS.values())
    return [{"uid": records.identity(), "pid": os.getpid(),
             "kind": "driver", "name": "driver"}] + [
        {"uid": m.uid, "pid": m.pid, "kind": m.kind, "name": m.name}
        for m in members]


def ask_processes(method: str, args: tuple, key: str, timeout: float,
                  worker: Optional[str] = None, exclude=()) -> Dict[str, dict]:
    """In the driver: ``method`` (:func:`raytpu_torch.util.stack_dump.
    answer`) run in every live process of the tree at once, this one
    included, each answer by the process's id as ``{"pid", key: payload}``
    or ``{"pid", "error"}`` for a process that died or said nothing in
    ``timeout`` seconds. ``worker`` narrows to ids with that prefix
    (``"daemon"``: the driver alone, the JAX node daemon's counterpart);
    ids in ``exclude`` are left out (the asking process)."""
    from raytpu_torch.util import stack_dump

    me = tree_processes()[0]["uid"]
    with _MEMBERS_LOCK:
        members = [m for uid, m in _MEMBERS.items() if uid not in exclude
                   and worker != "daemon"
                   and (worker is None or uid.startswith(worker))]
    deadline = time.monotonic() + timeout
    asked = [(m, m.ask(method, args)) for m in members]
    out: Dict[str, dict] = {}
    if me not in exclude and (worker in (None, "daemon")
                              or me.startswith(worker)):
        try:
            out[me] = {"pid": os.getpid(),
                       key: stack_dump.answer(method, args)}
        except Exception as exc:  # reported in its entry, as the JAX node's
            out[me] = {"pid": os.getpid(),
                       "error": f"{type(exc).__name__}: {exc}"}
    for m, rid in asked:
        ok, value = ((False, f"process {m.pid} exited") if rid is None
                     else m.reply(rid, deadline))
        out[m.uid] = ({"pid": m.pid, key: value} if ok
                      else {"pid": m.pid, "error": value})
    return out


def _answer_driver(conn) -> None:
    """A process's side of its ``hello`` connection: each of the
    driver's requests answered on a thread of its own (a profile window
    holds no other), until the driver closes it."""
    from raytpu_torch.util import stack_dump

    lock = threading.Lock()

    def one(rid: int, method: str, args: tuple) -> None:
        try:
            reply = (rid, True, stack_dump.answer(method, args))
        except Exception as exc:  # the driver reports it for this process
            reply = (rid, False, f"{type(exc).__name__}: {exc}")
        try:
            with lock:
                transport.send(conn, reply)
        except OSError:
            pass  # the driver is gone

    while True:
        try:
            rid, method, args = transport.recv(conn)
        except (EOFError, OSError):
            return
        threading.Thread(target=one, args=(rid, method, args),
                         name="raytpu-torch-debug", daemon=True).start()


def join_tree(uid: Optional[str], kind: str, name: str) -> Tuple[str, str]:
    """Open this process's ``hello`` connection to the driver's registry
    (set first): the driver keeps it in its table of the tree's
    processes, asks on it, and sees the process end at its EOF. Returns
    this process's id (``uid``, or one the driver gives a joining
    process) and the tree's."""
    conn = transport.connect(_REGISTRY)
    transport.send(conn, ("hello", (uid, os.getpid(), kind, name)))
    if not conn.poll(JOIN_TIMEOUT_S):
        conn.close()
        raise ConnectionError(f"the driver at its registry did not answer "
                              f"in {JOIN_TIMEOUT_S} s")
    ok, value = transport.recv(conn)
    if not ok:
        conn.close()
        raise value
    threading.Thread(target=_answer_driver, args=(conn,),
                     name="raytpu-torch-hello", daemon=True).start()
    return value


def driver_address() -> str:
    """The driver's address, for a process outside the tree
    (``init(address=...)``, ``python -m raytpu_torch ... --address``, a
    job's :data:`ADDRESS_ENV`): from any process of the tree; in the
    driver it starts the registry."""
    key = bytes(mp.current_process().authkey).hex()
    return f"{ADDRESS_SCHEME}{_registry_address()[1:]}#{key}"


def parse_address(address: str) -> Tuple[str, bytes]:
    """(registry socket address, authkey) of a driver's address."""
    rest = address[len(ADDRESS_SCHEME):] \
        if address.startswith(ADDRESS_SCHEME) else None
    name, sep, key = (rest or "").partition("#")
    try:
        authkey = bytes.fromhex(key)
    except ValueError:
        authkey = b""
    if not name or not sep or not authkey:
        raise ValueError(f"{address!r} is not a driver's address (it "
                         f"looks like {ADDRESS_SCHEME}<socket>#<key>; "
                         f"raytpu_torch.runtime.api.driver_address() "
                         f"gives it)")
    return "\0" + name, authkey


def _own_tree(address: str) -> bool:
    """Whether ``address`` is the driver's of this process's own tree."""
    registry = parse_address(address)[0]
    own = _REGISTRY or (_registry_socket[0] if _registry_socket else None)
    return registry == own


def _join(address: str) -> None:
    """``init(address=...)``: join the tree of the driver at ``address``
    as a process of its own (actors, tasks, ``put``, named actors and
    the state API then work as in a worker of the tree); ship this
    process's records when armed, and the last of them at its exit."""
    registry, authkey = parse_address(address)
    mp.current_process().authkey = authkey
    serialization.main_by_value()
    set_registry(registry)
    try:
        uid, tree = join_tree(None, "joined",
                              os.path.basename(sys.argv[0]) or "python")
    except (OSError, EOFError, ConnectionError) as exc:
        set_registry(None)
        raise ConnectionError(f"no driver reachable at {address}: "
                              f"{exc}") from exc
    object_store.set_tree(tree)
    tracing.set_process_identity("worker", f"joined-{os.getpid()}")
    records.set_identity(False, uid)
    if profiling_enabled():
        profiler.start_continuous()
    records.start_shipping()
    atexit.register(_at_joined_exit)


def _at_joined_exit() -> None:
    """A joined process's exit: its last records, then its own actors."""
    records.stop_shipping()
    shutdown()


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    """The handle of the live actor registered as ``name`` in
    ``namespace``, from any process of the tree; ``ValueError`` when there
    is none."""
    return _names("lookup", namespace, name)


def set_registry(address: Optional[str]) -> None:
    """In a process the runtime started: the driver's registry address."""
    global _REGISTRY
    _REGISTRY = address


def put(value: Any) -> ObjectRef:
    """A ref to a snapshot of ``value``, sealed into the object store
    once (its CPU tensors and large buffers in one shared-memory segment,
    which every call that takes the ref maps: a write there is seen by
    every holder); owned by this process."""
    return owned_ref(object_store.seal(value, os.getpid()))


def _refs(refs) -> List[ObjectRef]:
    out = list(refs)
    for r in out:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"expected ObjectRef(s), got {type(r)}")
    return out


def _block(callers, deadline: Optional[float]) -> bool:
    """Sleep (holding nothing) until a reply lands or a poll is due;
    False once the deadline has passed. ``callers`` are the actor callers
    whose exit the wait looks at."""
    now = time.monotonic()
    if deadline is not None and now >= deadline:
        return False
    for w in callers:
        if w is not None:
            w.check_exit(now)
    wait_s = _POLL_S if deadline is None else min(_POLL_S, deadline - now)
    READY.wait(wait_s)
    return True


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *,
        timeout: Optional[float] = None) -> Any:
    """The values of ``refs`` (one ref, or a list), waiting at most
    ``timeout`` seconds; a value that is itself a ref is resolved, one
    level. Raises the first failure in the order given:
    :class:`TaskError`, :class:`ActorDiedError`, :class:`ObjectLostError`
    ...; or :class:`GetTimeoutError`."""
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else _refs(refs)
    deadline = None if timeout is None else time.monotonic() + timeout
    with READY:
        while True:
            pending = [r for r in ref_list if not is_ready(r)]
            if not pending:
                break
            if not _block([pending_caller(r) for r in pending], deadline):
                raise GetTimeoutError(
                    f"get() timed out after {timeout} s: {len(pending)} of "
                    f"{len(ref_list)} results not ready ({pending[0]!r} "
                    f"first)")
    values = [value_of(r) for r in ref_list]
    for i, value in enumerate(values):
        if isinstance(value, ObjectRef):
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            values[i] = get(value, timeout=left)
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
    if len({r.hex() for r in ref_list}) != len(ref_list):
        raise ValueError("wait() got duplicate refs")
    deadline = None if timeout is None else time.monotonic() + timeout
    with READY:
        while True:
            ready = [r for r in ref_list if is_ready(r)]
            if len(ready) >= num_returns or not _block(
                    [pending_caller(r) for r in ref_list], deadline):
                break
    ready = ready[:num_returns]
    taken = {id(r) for r in ready}
    return ready, [r for r in ref_list if id(r) not in taken]


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """End the worker's process now, from its owner or from any process
    that holds a copy of its handle; calls on it without a result raise
    :class:`ActorDiedError` at ``get``. With ``no_restart=False`` the
    process is killed as a crash would end it, and its owner starts it
    again where ``max_restarts`` allows."""
    if actor._finalizer is not None and not no_restart:
        actor._worker.crash()
    elif actor._finalizer is not None:
        actor._finalizer.detach()
        actor._worker.shutdown("killed by kill()")
    elif no_restart:
        actor._worker.kill("killed by kill()")
    else:
        actor._worker.kill("killed by kill()", no_restart=False)


# ---- the task pool and the ledger -------------------------------------

# In the driver: the tree's task pool, once init() (or the first task)
# started it, and the ledger of the tree's resources, once init() or the
# first admission made it.
_POOL: Optional[task_pool.TaskPool] = None
_POOL_LOCK = threading.Lock()
_LEDGER: Optional[ledger.Ledger] = None
# In any other process: its connection to the driver's pool and ledger.
_LINK: Optional["_PoolLink"] = None


def _new_ledger(num_cpus: Optional[float], num_gpus: Optional[int],
                resources: Optional[Dict[str, float]]) -> ledger.Ledger:
    """The ledger of ``num_cpus`` (the host's count by default), the
    cards (detected without touching CUDA, or ``num_gpus`` of them: the
    detected ones first, pretend ones past them) and ``resources``."""
    cpus = (os.cpu_count() or 1) if num_cpus is None else num_cpus
    ids = topology.detect_local_gpus()["ids"]
    if num_gpus is not None:
        ids = (ids + [str(i) for i in range(len(ids), num_gpus)])[:num_gpus]
    return ledger.Ledger(cpus, ids, resources)


def _ledger() -> ledger.Ledger:
    """The driver's ledger, made at the first need."""
    global _LEDGER
    with _POOL_LOCK:
        if _LEDGER is None:
            _LEDGER = _new_ledger(None, None, None)
        return _LEDGER


def init(num_cpus: Optional[int] = None, *, num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         address: Optional[str] = None, ignore_reinit_error: bool = False,
         **kwargs) -> None:
    """Start the runtime in the driver: the ledger of ``num_cpus`` CPUs
    (``os.cpu_count()`` by default), the cards (detected, or
    ``num_gpus``: the counterpart of the JAX package's ``num_tpus``, for
    a run with pretend cards) and custom ``resources``; and the task
    pool's ``num_cpus`` workers, started at once from a thread while the
    caller goes on. With ``address`` (a driver's :func:`driver_address`),
    join that driver's tree instead, as a process of its own: its tasks
    run on that driver's pool, and it is tombstoned there when it ends;
    an address that no driver answers raises ``ConnectionError`` naming
    it. A second ``init`` raises unless ``ignore_reinit_error``; in a
    process the runtime started (which is already connected to the
    driver's pool) it raises the same way. The address of this
    process's own tree is nothing to join: a no-op. ``runtime_env``
    raises."""
    global _POOL, _LEDGER
    if kwargs.get("runtime_env"):
        raise ValueError("runtime_env: the port's runtime does not take it")
    unknown = sorted(set(kwargs) - {"runtime_env"})
    if unknown:
        raise TypeError(f"init() got unexpected keyword arguments {unknown}")
    if address is not None and _own_tree(address):
        return  # this process's own tree: nothing to join
    with _POOL_LOCK:
        if _POOL is not None or _REGISTRY is not None:
            if ignore_reinit_error:
                return
            raise RuntimeError("runtime.init() called twice (pass "
                               "ignore_reinit_error=True to ignore)")
        if address is not None:
            _join(address)
            return
        size = (os.cpu_count() or 1) if num_cpus is None else int(num_cpus)
        if _LEDGER is None or num_gpus is not None or resources:
            if _LEDGER is not None and _LEDGER.holds_grants():
                raise RuntimeError("init(num_gpus=/resources=) after actors "
                                   "were admitted: call it first")
            _LEDGER = _new_ledger(size, num_gpus, resources)
        else:
            _LEDGER.resize_cpus(size)
        pool = task_pool.TaskPool(size, _registry_address(), _LEDGER)
        pool.start()
        _POOL = pool
    from raytpu_torch.util import usage_stats

    usage_stats.record_library_usage("core_local")


def is_initialized() -> bool:
    """Whether a task pool is there to run tasks: started in the driver,
    or reachable (every process the runtime started)."""
    return _POOL is not None or _REGISTRY is not None


def _pool() -> task_pool.TaskPool:
    """The driver's pool, started at the first need."""
    if _POOL is None:
        init(ignore_reinit_error=True)
    return _POOL


# Called first by shutdown(), while the workers still live (the compiled
# graphs' teardown, :mod:`raytpu_torch.dag.compiled`).
_SHUTDOWN_HOOKS: List[Callable[[], None]] = []


def on_shutdown(hook: Callable[[], None]) -> None:
    """Run ``hook`` at the start of every :func:`shutdown`, and so at the
    driver's exit."""
    if hook not in _SHUTDOWN_HOOKS:
        _SHUTDOWN_HOOKS.append(hook)


def shutdown() -> None:
    """Stop the task pool (its workers are killed, queued tasks fail) and
    every worker this process owns, after the :func:`on_shutdown` hooks.
    In the driver a later ``init`` (or task) starts a fresh pool and
    ledger."""
    global _POOL, _LEDGER
    for hook in list(_SHUTDOWN_HOOKS):
        hook()
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.stop()
    with _HANDLES_LOCK:
        handles = list(_OWNED.values())
    for handle in handles:
        kill(handle)
    if _REGISTRY is None:
        with _POOL_LOCK:
            _LEDGER = None
        from raytpu_torch.util import usage_stats

        usage_stats.report()


def pool_submit(spec: dict) -> None:
    if _REGISTRY is None:
        _pool().submit(task_pool.Task(spec, remote_function.deliver))
    else:
        _link().send(("submit", spec))


def pool_cancel(tid: str, force: bool) -> None:
    if _REGISTRY is None:
        if _POOL is not None:
            _POOL.cancel(tid, force)
    else:
        _link().send(("cancel", tid, force))


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task whose return ``ref`` is (see
    :mod:`raytpu_torch.runtime.task_pool`); a ref of anything else, or of
    a task that has ended, is left as it is."""
    with READY:
        entry = refcount.OWNED.get(ref.hex())
        tid = None if entry is None else entry.task
    if tid is not None:
        pool_cancel(tid, force)


def _driver_admit(spec: ledger.Spec, on_grant: Callable[[Any], None],
                  owner: Any = None):
    """In the driver: ask the ledger to admit ``spec``; ``(view, None)``
    when granted now, else ``(None, rid)`` and ``on_grant(view)`` later
    (or the error of a group removed meanwhile)."""
    led = _ledger()

    def granted(grant) -> None:
        on_grant(grant if isinstance(grant, BaseException)
                 else grant.view(led.card_ids))

    grant, rid = led.request(spec, granted, owner)
    if grant is None:
        return None, rid
    return grant.view(led.card_ids), None


def _serve_link(message: tuple, route) -> None:
    """In the driver: one message of another process's link that is not
    a task's: an admission, a release, or a call of the ledger."""
    kind = message[0]
    if kind == "release":
        if _LEDGER is not None:
            _LEDGER.release(message[1])
        return
    if kind == "cancel_admission":
        if _LEDGER is not None:
            _LEDGER.cancel(message[1])
        return
    rid = message[1]
    try:
        if kind == "admit":
            value = _driver_admit(
                message[2], lambda view: route(("admitted", rid, view)),
                route)
        else:
            value = _ledger_op(message[2], message[3])
        route(("answer", rid, True, value))
    except Exception as exc:  # the asking process raises it
        route(("answer", rid, False, exc))


def _drop_route(route) -> None:
    """A process's connection closed: its queued tasks go (what runs
    ends), and its waiting requests and its grants go back to the
    ledger."""
    pool = _POOL
    if pool is not None:
        pool.drop_route(route)
    if _LEDGER is not None:
        _LEDGER.drop_owner(route)


def admit(spec: ledger.Spec, on_grant: Callable[[Any], None]):
    """Admission of an actor, from any process of the tree: ``(view,
    None)`` or ``(None, rid)`` (see :meth:`ledger.Ledger.request`); raises
    where it can never fit."""
    if _REGISTRY is None:
        return _driver_admit(spec, on_grant)
    return _link().admit(spec, on_grant)


def release(gid: int) -> None:
    """Give a grant back, from any process of the tree."""
    if _REGISTRY is None:
        if _LEDGER is not None:
            _LEDGER.release(gid)
    else:
        _link().send(("release", gid))


def cancel_admission(rid: int) -> None:
    """Drop a request that waits in the ledger."""
    if _REGISTRY is None:
        if _LEDGER is not None:
            _LEDGER.cancel(rid)
    else:
        _link().send(("cancel_admission", rid))


def _ledger_op(op: str, args: tuple):
    """In the driver: one of the ledger's calls that cross processes."""
    led = _ledger()
    if op == "resources":
        return led.resources()
    if op == "nodes":
        return led.nodes(context.node_id().hex())
    if op in ("create_group", "remove_group", "group_info"):
        return getattr(led, op)(*args)
    if op == "check":
        return led.check(ledger.Spec(*args))
    raise ValueError(f"unknown ledger call {op!r}")


def ledger_call(op: str, *args):
    """A call of the driver's ledger, from any process of the tree."""
    if _REGISTRY is None:
        return _ledger_op(op, args)
    return _link().ask(op, args)


def check_request(resources: Dict[str, float]) -> None:
    """Raise ``ValueError`` where ``resources`` (a request's, as
    :func:`ledger.build_resources` makes it) can never fit the tree: a
    library's check before it starts anything."""
    ledger_call("check", resources)


def cluster_resources() -> Dict[str, float]:
    """The tree's resources: the CPUs, the cards (``"GPU"``) and custom
    resources the driver's ledger holds."""
    return ledger_call("resources")["total"]


def available_resources() -> Dict[str, float]:
    """What of them no task, actor or placement group holds."""
    return ledger_call("resources")["available"]


def nodes() -> List[dict]:
    """The one node, the driver's host: its id, and its resources in
    all and available."""
    return ledger_call("nodes")


def get_runtime_context() -> context.RuntimeContext:
    """This process's context: the job, node, task and actor ids (see
    :mod:`raytpu_torch.runtime.context`)."""
    return context.current()


def method(*, num_returns: int = 1, concurrency_group: str = ""):
    """Per-method defaults (``@raytpu.method``): the port's calls take
    ``num_returns=1`` (or ``"streaming"`` through ``.options``) and no
    concurrency groups, so other values raise here."""
    if num_returns != 1 or concurrency_group:
        raise ValueError("method(): the port's runtime takes num_returns=1 "
                         "and no concurrency_group")

    def wrap(fn):
        fn._num_returns = num_returns
        fn._concurrency_group = concurrency_group
        return fn

    return wrap


class _PoolLink:
    """A process's connection to the driver's task pool and ledger
    (through its registry socket): submissions, cancels, admissions and
    ledger calls out; the tasks' messages, grants and answers back, read
    by a thread of its own."""

    def __init__(self):
        self._conn = transport.connect(_REGISTRY)
        transport.send(self._conn, ("pool", ()))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._answers: Dict[int, Any] = {}
        self._on_grant: Dict[int, Callable[[Any], None]] = {}
        threading.Thread(target=self._read, name="raytpu-torch-pool-link",
                         daemon=True).start()

    def send(self, message) -> None:
        with self._lock:
            transport.send(self._conn, message)

    def _wait(self, rid: int):
        with READY:
            while rid not in self._answers:
                READY.wait(_POLL_S)
            ok, value = self._answers.pop(rid)
        if not ok:
            raise value
        return value

    def ask(self, op: str, args: tuple):
        rid = next(self._ids)
        self.send(("ask", rid, op, args))
        return self._wait(rid)

    def admit(self, spec: ledger.Spec, on_grant):
        rid = next(self._ids)
        with READY:
            self._on_grant[rid] = on_grant
        self.send(("admit", rid, spec))
        try:
            view, waiting = self._wait(rid)
        except BaseException:
            with READY:
                self._on_grant.pop(rid, None)
            raise
        if view is not None:
            with READY:
                self._on_grant.pop(rid, None)
        return view, waiting

    def _read(self) -> None:
        while True:
            try:
                message = transport.recv(self._conn)
            except (EOFError, OSError):
                return  # the driver is gone, and this process with it
            kind = message[0]
            if kind == "answer":
                with READY:
                    self._answers[message[1]] = (message[2], message[3])
                    READY.notify_all()
            elif kind == "admitted":
                with READY:
                    on_grant = self._on_grant.pop(message[1], None)
                if on_grant is not None:
                    threading.Thread(target=on_grant, args=(message[2],),
                                     name="raytpu-torch-admit",
                                     daemon=True).start()
            else:
                remote_function.deliver(message)


def _link() -> _PoolLink:
    global _LINK
    with _POOL_LOCK:
        if _LINK is None:
            _LINK = _PoolLink()
        return _LINK


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace task timeline (``raytpu.timeline``,
    ``raytpu/runtime/api.py:298``): one complete event for each task
    attempt the driver's records saw run (RUNNING to its FINISHED or
    FAILED), from any process of the tree; empty unless task events are
    armed."""
    from raytpu_torch import state

    trace = []
    for task in state.list_tasks(detail=True, limit=0):
        start = None
        for ev in task.get("events", []):
            if ev["transition"] == "RUNNING":
                start = ev
            elif ev["transition"] in ("FINISHED", "FAILED") and start:
                trace.append({
                    "name": task["name"], "cat": "task", "ph": "X",
                    "ts": start["ts"] * 1e6,
                    "dur": (ev["ts"] - start["ts"]) * 1e6,
                    "pid": 0, "tid": 0,
                    "args": {"task_id": task["task_id"]}})
                start = None
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def pool_start_split() -> Optional[dict]:
    """The driver's pool's start split (:meth:`TaskPool.start_split`)."""
    return None if _POOL is None else _POOL.start_split()


def pool_workers() -> List[int]:
    """The pids of the driver's task workers."""
    return [] if _POOL is None else _POOL.workers()


def _at_driver_exit() -> None:
    """The driver's exit: its pool's workers, then every segment of the
    tree that nobody freed (their owners are gone with it)."""
    shutdown()
    object_store.sweep_owner()
