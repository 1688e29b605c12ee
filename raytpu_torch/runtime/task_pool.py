"""The task pool: one pool of task worker processes for the whole tree,
the port's counterpart of the JAX package's task scheduling
(``local_backend.py``'s dispatcher and its worker threads).

The driver (the process the runtime did not start) owns the pool. It
starts :data:`size` workers at once (``init(num_cpus=)``, or
``os.cpu_count()`` when the first task starts it) and keeps that many:
a worker that dies is replaced. Any other process of the tree submits
over one connection to the driver's registry socket (``"pool"``), so an
actor's tasks and the driver's share the pool. Each task goes first in,
first out to an idle worker once its ``num_cpus`` fit in the free
slots; a task's result descriptors come back through the pool to its
submitter, who owns them (the bytes stay in the segments the worker
sealed). A task runs in its worker's main thread with ``num_cpus``
torch threads.

- **Retries.** A task whose worker process dies runs again on another
  worker while ``max_retries`` lasts (at the front of the queue); an
  exception from the user's code is retried only where
  ``retry_exceptions`` says so (``True``, or a list of exception
  types). Then the submitter gets :class:`WorkerCrashedError` or the
  :class:`TaskError`. A streaming task is not run again once it has
  sent a value.
- **Cancel.** A queued task is dropped (:class:`TaskCancelledError`); a
  running one, with ``force=True``, has its worker killed (not retried);
  without it, a stream stops at its next value and any other task's
  result becomes :class:`TaskCancelledError`.
- **Start.** Workers are forked, all at once, from a server that has
  imported numpy, torch and the runtime
  (:mod:`raytpu_torch.runtime.starter`, as actors are): a worker starts
  in a fraction of a second, where a spawned interpreter takes seconds
  to import torch; the server's launch is paid once.
  :meth:`TaskPool.start_split` gives the split.

- **Records.** With task events on, the pool records a task's
  SUBMITTED, RETRIED and a dead worker's FAILED; the worker its RUNNING
  and FINISHED or FAILED, which ride its done message with its metric
  deltas (:mod:`raytpu_torch.runtime.records`), so a worker killed
  mid-task loses only that attempt's RUNNING.

- **Resources.** A task is dispatched once the driver's ledger
  (:mod:`raytpu_torch.runtime.ledger`) grants what it asks for (its
  CPUs, a share of the card, custom resources, from a placement group's
  bundle where it runs in one), first in first out among those that
  fit; what can never fit fails at once (:class:`TaskError`). A task
  that asks for a card runs in a worker forked for it and bound to the
  granted card before its first CUDA call (``CUDA_VISIBLE_DEVICES``),
  which exits after that task: a pooled worker may have touched CUDA
  already, and then keeps the cards it saw.

What it leaves out: a task that blocks in ``get`` on tasks it submitted
keeps its grant (with every CPU so held the pool stalls), and no
backpressure on streams.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch
import torch.multiprocessing as mp

from raytpu_torch.core import topology
from raytpu_torch.core.errors import (PlacementGroupError,
                                      TaskCancelledError, TaskError,
                                      WorkerCrashedError)
from raytpu_torch.runtime import (context, ledger, object_store, records,
                                  refcount, serialization, starter,
                                  transport)
from raytpu_torch.util import metrics, profiler, task_events
from raytpu_torch.util.profiler import profiling_enabled

# How long stop() waits for a worker to be reaped.
REAP_S = 10.0
# How long stop() waits for a start in flight (a server's launch: one
# interpreter importing numpy, torch and the runtime).
START_JOIN_S = 120.0


class Task:
    """One submission as the pool sees it: what the worker needs and
    where its messages go."""

    __slots__ = ("tid", "fn", "args", "name", "num_returns", "streaming",
                 "num_cpus", "retries", "retry_exceptions", "owner_pid",
                 "resources", "pg", "bundle", "capture", "route",
                 "cancelled", "sent_items", "attempt", "grant")

    def __init__(self, spec: dict, route: Callable[[tuple], None]):
        for key in ("tid", "fn", "args", "name", "num_returns", "streaming",
                    "num_cpus", "retries", "retry_exceptions", "owner_pid",
                    "resources", "pg", "bundle", "capture"):
            setattr(self, key, spec[key])
        self.route = route
        self.cancelled = False
        self.sent_items = False
        self.attempt = 0
        self.grant: Optional[ledger.Grant] = None

    @property
    def spec(self) -> ledger.Spec:
        return ledger.Spec(self.resources, self.pg, self.bundle)

    @property
    def gpus(self) -> float:
        return self.resources.get("GPU", 0.0)

    def message(self) -> tuple:
        return ("run", self.tid, self.fn, self.args,
                {"name": self.name, "num_returns": self.num_returns,
                 "streaming": self.streaming, "num_cpus": self.num_cpus,
                 "retry_exceptions": self.retry_exceptions,
                 "owner_pid": self.owner_pid, "attempt": self.attempt,
                 "pg": self.pg, "capture": self.capture})


class _Proc:
    def __init__(self, process, conn, spawned: float, uid: str,
                 bound: bool = False):
        self.process = process
        self.conn = conn
        self.uid = uid  # its id in the records
        self.task: Optional[Task] = None
        self.marks = {"spawned": spawned}
        # A worker forked for one task that asks for a card, bound to it:
        # it exits after that task and is not replaced.
        self.bound = bound


class TaskPool:
    """The driver's pool of ``size`` task worker processes."""

    def __init__(self, size: int, registry: str, led: ledger.Ledger):
        if size < 1:
            raise ValueError(f"num_cpus={size}: the task pool needs at "
                             f"least one CPU")
        self.size = int(size)
        self._ledger = led
        led.add_listener(self._kick)
        self._registry = registry
        self._lock = threading.Lock()
        self._procs: List[_Proc] = []
        self._idle: deque = deque()
        self._queue: deque = deque()
        self._running: Dict[str, _Proc] = {}
        self._names = itertools.count()
        self._closed = False
        self._started_at: Optional[float] = None
        self._starter: Optional[threading.Thread] = None
        self._server_s: Optional[float] = None

    # -- workers --------------------------------------------------------

    def start(self) -> None:
        """Start every worker, from a thread: the caller goes on at once
        (tasks submitted meanwhile wait in the queue)."""
        self._started_at = time.time()
        self._starter = threading.Thread(target=self._start_all,
                                         name="raytpu-task-pool", daemon=True)
        self._starter.start()

    def _start_all(self) -> None:
        t0 = time.perf_counter()
        self._spawn()  # the first start may launch a server
        self._server_s = time.perf_counter() - t0
        for _ in range(self.size - 1):
            self._spawn()

    def _spawn(self, task: Optional[Task] = None) -> None:
        """Start a worker for the pool; or, given a task that asks for a
        card, one bound to its grant's cards that runs only it."""
        with self._lock:
            if self._closed:
                closed = True
            else:
                closed = False
        if closed:
            if task is not None:
                self._ledger.release(task.grant.gid)
                task.route(("done", task.tid, False, WorkerCrashedError(
                    "the task pool was shut down")))
            return
        parent, child = mp.Pipe()
        uid = records.new_uid()
        visible = None
        if task is not None:
            visible = task.grant.view(self._ledger.card_ids)["visible"]
        process = starter.Process(
            target=_worker_main,
            args=(child, self._registry, time.time(), uid, visible),
            name=f"raytpu-task-{next(self._names)}", daemon=True)
        spawned = time.time()
        process.start()
        child.close()
        proc = _Proc(process, parent, spawned, uid, bound=task is not None)
        with self._lock:
            self._procs.append(proc)
            closed = self._closed
            if task is not None:
                proc.task = task
                self._running[task.tid] = proc
        if closed:
            process.kill()
        threading.Thread(target=self._read, args=(proc,),
                         name=f"{process.name}-reader", daemon=True).start()

    def start_split(self) -> dict:
        """When the pool's workers started: the first start's seconds
        (with the server's launch and its imports of numpy, torch and the
        runtime, where no server of this environment ran yet), and each
        worker's marks (wall clock): ``spawned`` (its ``Process.start``),
        ``entered`` (its body runs) and ``ready``."""
        with self._lock:
            marks = [dict(p.marks) for p in self._procs]
        return {"started_at": self._started_at, "server_s": self._server_s,
                "workers": marks}

    # -- tasks ----------------------------------------------------------

    def submit(self, task: Task) -> None:
        """Queue a task; one that can never fit (its CPUs, cards or
        custom resources past the ledger's total or its bundle's, or a
        group that is gone) fails at once."""
        try:
            self._ledger.check(task.spec)
        except (ValueError, PlacementGroupError) as exc:
            task.route(("done", task.tid, False,
                        TaskError.from_exception(task.name, exc)))
            return
        with self._lock:
            if not self._closed:
                if task_events.enabled():
                    task_events.emit("task", task.tid,
                                     task_events.TaskTransition.SUBMITTED,
                                     name=task.name, attempt=task.attempt)
                self._queue.append(task)
                starts, failed = self._dispatch()
            else:
                starts, failed = None, None
        if starts is None:
            task.route(("done", task.tid, False, WorkerCrashedError(
                "the task pool was shut down"), False))
            return
        self._after_dispatch(starts, failed)

    def _kick(self) -> None:
        """Dispatch what now fits (the ledger released a grant)."""
        with self._lock:
            if self._closed:
                return
            starts, failed = self._dispatch()
        self._after_dispatch(starts, failed)

    def _dispatch(self) -> tuple:
        """Hand queued tasks to idle workers, first in first out among
        those the ledger grants now; a task that asks for a card gets a
        worker of its own. Under the lock. Returns the tasks whose bound
        workers to start, and those that failed (their group gone), for
        :meth:`_after_dispatch` outside the lock."""
        starts, failed, skipped = [], [], set()
        for task in list(self._queue):
            if not task.gpus and not self._idle:
                continue
            sig = task.spec.signature()
            if sig in skipped:
                continue
            try:
                grant = self._ledger.try_acquire(task.spec)
            except (ValueError, PlacementGroupError) as exc:
                self._queue.remove(task)
                failed.append((task, exc))
                continue
            if grant is None:
                skipped.add(sig)
                continue
            self._queue.remove(task)
            task.grant = grant
            if task.gpus:
                starts.append(task)
                continue
            proc = self._idle.popleft()
            proc.task = task
            self._running[task.tid] = proc
            try:
                transport.send(proc.conn, task.message())
            except OSError:
                pass  # the worker is gone: its reader requeues the task
        return starts, failed

    def _after_dispatch(self, starts, failed) -> None:
        for task, exc in failed:
            task.route(("done", task.tid, False,
                        TaskError.from_exception(task.name, exc)))
        for task in starts:
            threading.Thread(target=self._spawn, args=(task,),
                             name="raytpu-task-bound", daemon=True).start()

    def _read(self, proc: _Proc) -> None:
        while True:
            try:
                message = transport.recv(proc.conn)
            except (EOFError, OSError):
                break
            kind = message[0]
            if kind == "ready":
                proc.marks.update(message[1], ready=time.time())
                if proc.bound:
                    try:
                        transport.send(proc.conn, proc.task.message())
                    except OSError:
                        pass  # the worker is gone: its reader requeues it
                    continue
                with self._lock:
                    self._idle.append(proc)
                self._kick()
            elif kind == "item":
                task = proc.task
                if task is not None:
                    task.sent_items = True
                    task.route(message)
            elif kind == "done":
                self._done(proc, message)
        self._died(proc)

    def _done(self, proc: _Proc, message: tuple) -> None:
        _, tid, ok, payload, retryable, ship = message
        if ship is not None:  # the worker's records, with its done
            records.ingest(ship)
        with self._lock:
            task, proc.task = proc.task, None
            self._running.pop(tid, None)
            grant, task.grant = task.grant, None
            again = (not ok and retryable and task.retries > 0
                     and not task.cancelled and not task.sent_items)
            if again:
                task.retries -= 1
                task.attempt += 1
                if task_events.enabled():
                    task_events.emit("task", task.tid,
                                     task_events.TaskTransition.RETRIED,
                                     name=task.name, attempt=task.attempt)
                self._queue.appendleft(task)
            if not proc.bound:
                self._idle.append(proc)
        if proc.bound:
            proc.conn.close()  # its one task is done: it exits
        self._ledger.release(grant.gid)  # and dispatches what now fits
        if again:
            return
        if task.cancelled and not task.streaming:
            if ok:
                for sealed in payload:
                    refcount.discard(sealed)
            ok, payload = False, TaskCancelledError(
                f"task {task.name} was cancelled")
        task.route(("done", tid, ok, payload))

    def _died(self, proc: _Proc) -> None:
        proc.process.join(timeout=REAP_S)
        object_store.sweep_owner(proc.process.pid)
        if metrics.enabled() or profiling_enabled():
            records.proc_dead(proc.uid)
        grant = None
        with self._lock:
            if proc in self._procs:
                self._procs.remove(proc)
            if proc in self._idle:
                self._idle.remove(proc)
            task, proc.task = proc.task, None
            again = False
            if task is not None:
                self._running.pop(task.tid, None)
                grant, task.grant = task.grant, None
                again = (task.retries > 0 and not task.cancelled
                         and not task.sent_items and not self._closed)
                if task_events.enabled():
                    # The attempt the dead worker never reported, and the
                    # next, as the JAX node records a crashed worker's.
                    task_events.emit(
                        "task", task.tid, task_events.TaskTransition.FAILED,
                        name=task.name, attempt=task.attempt,
                        error=f"WorkerCrashedError: worker process "
                              f"{proc.process.pid} exited with code "
                              f"{proc.process.exitcode}")
                if again:
                    task.retries -= 1
                    task.attempt += 1
                    if task_events.enabled():
                        task_events.emit(
                            "task", task.tid,
                            task_events.TaskTransition.RETRIED,
                            name=task.name, attempt=task.attempt)
                    self._queue.appendleft(task)
            replace = not self._closed and not proc.bound
        self._ledger.release(None if grant is None else grant.gid)
        if task is not None and not again:
            error = (TaskCancelledError(f"task {task.name} was cancelled")
                     if task.cancelled else WorkerCrashedError(
                         f"task {task.name}: its worker process "
                         f"{proc.process.pid} exited with code "
                         f"{proc.process.exitcode}"))
            task.route(("done", task.tid, False, error))
        if replace:
            self._spawn()

    def cancel(self, tid: str, force: bool = False) -> None:
        with self._lock:
            for task in self._queue:
                if task.tid == tid:
                    self._queue.remove(task)
                    break
            else:
                task = None
                proc = self._running.get(tid)
                if proc is None or proc.task is None:
                    return
                proc.task.cancelled = True
                if force:
                    proc.process.kill()
                else:
                    try:
                        transport.send(proc.conn, ("cancel", tid))
                    except OSError:
                        pass
                return
        task.route(("done", tid, False, TaskCancelledError(
            f"task {task.name} was cancelled")))

    def drop_route(self, route) -> None:
        """A submitter is gone: drop its queued tasks; what runs ends."""
        with self._lock:
            for task in [t for t in self._queue if t.route is route]:
                self._queue.remove(task)
            for proc in self._running.values():
                if proc.task is not None and proc.task.route is route:
                    proc.task.cancelled = True

    def live(self) -> List[dict]:
        """The tasks the pool holds now: queued, and running."""
        with self._lock:
            rows = [{"task_id": t.tid, "name": t.name,
                     "state": "PENDING_SCHEDULING", "attempt": t.attempt}
                    for t in self._queue]
            rows += [{"task_id": tid, "name": p.task.name, "state": "RUNNING",
                      "attempt": p.task.attempt}
                     for tid, p in self._running.items()
                     if p.task is not None]
        return rows

    def workers(self) -> List[int]:
        """The pool's workers' pids (a worker forked for one task that
        asks for a card is not the pool's)."""
        with self._lock:
            return [p.process.pid for p in self._procs if not p.bound]

    def stop(self) -> None:
        """Kill every worker and fail what is queued. Safe twice. A stop
        while the workers start waits for the start in flight (the
        server's launch included), so that no worker outlives it."""
        with self._lock:
            self._closed = True
        if self._starter is not None:
            self._starter.join(timeout=START_JOIN_S)
        with self._lock:
            procs = list(self._procs)
            queued = list(self._queue)
            self._queue.clear()
        for proc in procs:
            proc.process.kill()
        for proc in procs:
            proc.process.join(timeout=REAP_S)
        for task in queued:
            task.route(("done", task.tid, False, WorkerCrashedError(
                "the task pool was shut down")))


def serve_client(conn, pool: Callable[[], TaskPool],
                 handle: Callable[[tuple, Callable], None],
                 closed: Callable[[Callable], None]) -> None:
    """One other process's submissions, on its registry connection, until
    it closes; each task's messages go back on it. ``pool()`` gives the
    driver's pool (started at the first submission). The process's other
    messages (admissions and calls of the ledger) go to ``handle(message,
    route)``; ``closed(route)`` at the end drops what it left."""
    lock = threading.Lock()

    def route(message) -> None:
        with lock:
            try:
                transport.send(conn, message)
            except OSError:
                pass  # the submitter is gone

    while True:
        try:
            message = transport.recv(conn)
        except (EOFError, OSError):
            break
        kind = message[0]
        if kind == "submit":
            pool().submit(Task(message[1], route))
        elif kind == "cancel":
            pool().cancel(message[1], message[2])
        else:
            handle(message, route)
    closed(route)


# ---- the worker ----------------------------------------------------------

# Unpickled functions by their blob, for the tasks to come.
_FUNCTIONS: Dict[bytes, Callable] = {}
_MAX_FUNCTIONS = 64


def _function(blob: bytes) -> Callable:
    fn = _FUNCTIONS.get(blob)
    if fn is None:
        fn = serialization.loads(blob)
        if len(_FUNCTIONS) >= _MAX_FUNCTIONS:
            _FUNCTIONS.pop(next(iter(_FUNCTIONS)))
        _FUNCTIONS[blob] = fn
    return fn


def _retryable(exc: BaseException, retry_exceptions) -> bool:
    if retry_exceptions is True:
        return True
    if isinstance(retry_exceptions, (list, tuple)):
        return isinstance(exc, tuple(retry_exceptions))
    return False


def _worker_main(conn, registry: str, spawned: float, uid: str,
                 visible: Optional[str] = None) -> None:
    """A task worker: run the tasks the pool sends, one at a time, in
    this thread; a reader thread takes cancels meanwhile. Its records
    ride each done message. ``visible``: the cards of the one task it
    was forked for, bound before anything touches CUDA."""
    from raytpu_torch.runtime import api
    from raytpu_torch.util import tracing

    marks = {"spawned": spawned, "entered": time.time()}
    if visible is not None:
        topology.bind_card(visible)  # raises: the task is retried or fails
    tracing.set_process_identity("task-worker", str(os.getpid()))
    api.set_registry(registry)
    records.set_identity(False, uid)
    api.join_tree(uid, "task-worker", mp.current_process().name)
    if profiling_enabled():
        profiler.start_continuous()
    mp.current_process().daemon = False  # a task may start actors
    torch.set_num_threads(1)
    runs: "queue.Queue" = queue.Queue()
    cancelled: set = set()

    def read() -> None:
        while True:
            try:
                message = transport.recv(conn)
            except (EOFError, OSError):
                runs.put(None)
                return
            if message[0] == "cancel":
                cancelled.add(message[1])
            else:
                runs.put(message)

    threading.Thread(target=read, name="raytpu-task-reader",
                     daemon=True).start()
    transport.send(conn, ("ready", marks))
    while True:
        message = runs.get()
        if message is None:
            return  # the driver is gone
        _run(conn, message, cancelled)


def _run(conn, message: tuple, cancelled: set) -> None:
    _, tid, fn_blob, args, opts = message
    name, owner, attempt = opts["name"], opts["owner_pid"], opts["attempt"]
    torch.set_num_threads(max(1, int(opts["num_cpus"])))
    context.set_task(tid, opts["pg"], opts["capture"])
    try:
        _run_task(conn, tid, fn_blob, args, opts, cancelled, name, owner,
                  attempt)
    finally:
        context.reset_task_scope()


def _run_task(conn, tid, fn_blob, args, opts, cancelled, name, owner,
              attempt) -> None:
    from raytpu_torch.runtime import api

    if task_events.enabled():
        task_events.emit("task", tid, task_events.TaskTransition.RUNNING,
                         name=name, attempt=attempt)
    try:
        fn = _function(fn_blob)
        call_args, call_kwargs = object_store.unseal(args)
        call_args, call_kwargs = api.resolve_args(call_args, call_kwargs)
        if opts["streaming"]:
            gen = fn(*call_args, **call_kwargs)
            try:
                for value in gen:
                    transport.send(conn, ("item", tid, object_store.seal(
                        value, owner)))
                    if tid in cancelled:
                        break
            finally:
                close = getattr(gen, "close", None)
                if close is not None:
                    close()
            if task_events.enabled():
                task_events.emit("task", tid,
                                 task_events.TaskTransition.FINISHED,
                                 name=name, attempt=attempt)
            transport.send(conn, ("done", tid, True, None, False,
                                  records.collect_ship()))
            return
        out = fn(*call_args, **call_kwargs)
        n = opts["num_returns"]
        values = [out]
        if n != 1:
            values = list(out)
            if len(values) != n:
                raise ValueError(f"task {name} returned {len(values)} "
                                 f"values; num_returns={n}")
        sealed = [object_store.seal(v, owner) for v in values]
    except Exception as exc:
        if task_events.enabled():
            task_events.emit("task", tid, task_events.TaskTransition.FAILED,
                             name=name, attempt=attempt,
                             error=f"{type(exc).__name__}: {exc}")
        transport.send(conn, ("done", tid, False,
                              TaskError.from_exception(name, exc),
                              _retryable(exc, opts["retry_exceptions"]),
                              records.collect_ship()))
        return
    finally:
        cancelled.discard(tid)
    if task_events.enabled():
        task_events.emit("task", tid, task_events.TaskTransition.FINISHED,
                         name=name, attempt=attempt)
    transport.send(conn, ("done", tid, True, sealed, False,
                          records.collect_ship()))
