"""Remote functions, the port of :mod:`raytpu.runtime.remote_function`:
``remote(fn)``, ``remote(**options)(fn)`` and ``.options(...)``, then
``.remote(*args, **kwargs)`` to run ``fn`` as a task on the tree's task
pool (:mod:`raytpu_torch.runtime.task_pool`).

Options, with the JAX package's defaults: ``num_cpus`` (1), ``num_gpus``
(a share of one card, or whole cards), ``resources`` (custom ones), the
placement options (``scheduling_strategy``, ``placement_group``,
``placement_group_bundle_index``,
``placement_group_capture_child_tasks``; see
:mod:`raytpu_torch.runtime.placement_group`), ``num_returns`` (1: one
ref; N > 1: a list of N refs, the function returning N values;
``"streaming"``: an
:class:`~raytpu_torch.runtime.generator.ObjectRefGenerator` of the
values a generator function yields), ``name`` (the function's qualified
name), ``max_retries`` (3, ``cfg.task_max_retries``) and
``retry_exceptions`` (False). Any other option (``runtime_env``
among them) raises ``ValueError`` naming it. The resources are built as
the JAX package builds them; the driver's ledger admits the task
(:mod:`raytpu_torch.runtime.ledger`), and one that can never fit fails
at once with :class:`~raytpu_torch.core.errors.TaskError`.

The function is pickled by value where it cannot be found by name (a
lambda, a closure, a function defined inside another), once for all its
calls. Its arguments are sealed into the object store by the submitter
(:func:`~raytpu_torch.runtime.object_store.seal`): large buffers go into
a segment the worker maps, and a top-level ref argument is resolved in
the worker, from the process that holds its value. The submitter owns
the returns: their refs pickle, borrow and are freed like any other.
"""

from __future__ import annotations

import functools
import os
import threading
from collections import deque
from typing import Any, Dict, Optional

from raytpu_torch.runtime import ledger, object_ref, object_store, refcount

OPTIONS = ("num_cpus", "num_gpus", "resources", "num_returns", "name",
           "max_retries", "retry_exceptions", *ledger.PLACEMENT_OPTIONS)
# The JAX package's cfg.task_max_retries.
TASK_MAX_RETRIES = 3


def check_options(options: Dict[str, Any]) -> None:
    unknown = sorted(set(options) - set(OPTIONS))
    if unknown:
        raise ValueError(f"options {unknown}: a remote function of the "
                         f"port's runtime takes only {list(OPTIONS)}")
    num_returns = options.get("num_returns", 1)
    if num_returns != "streaming" and (
            not isinstance(num_returns, int) or isinstance(num_returns, bool)
            or num_returns < 1):
        raise ValueError(f"num_returns={num_returns!r}: an int >= 1 or "
                         f"'streaming'")
    num_cpus = options.get("num_cpus", 1)
    if not isinstance(num_cpus, (int, float)) or num_cpus < 0:
        raise ValueError(f"num_cpus={num_cpus!r}: a number >= 0")
    retries = options.get("max_retries", TASK_MAX_RETRIES)
    if not isinstance(retries, int) or retries < -1:
        raise ValueError(f"max_retries={retries!r}: an int >= -1 "
                         f"(-1: no limit)")
    ledger.build_resources(options, default_cpus=1.0)  # raises where bad


class _Submitted:
    """A task's returns (or its stream) and its submission, until it
    ends."""

    __slots__ = ("returns", "streaming", "submission")

    def __init__(self, returns, streaming: bool, submission):
        self.returns = returns
        self.streaming = streaming
        self.submission = submission


_SUBMITTED: Dict[str, _Submitted] = {}
_SUBMITTED_LOCK = threading.Lock()


class _TaskStreams:
    """The streams of this process's streaming tasks, with the interface
    :class:`ObjectRefGenerator` reads (an actor caller's, which never
    dies: a worker's death ends a stream with its error)."""

    name = "task"
    dead = None

    def __init__(self):
        self.streams: Dict[str, deque] = {}

    def check_exit(self, now: float) -> None:
        """Nothing to poll: the pool reports a worker's death."""

    def cancel(self, tid: str) -> None:
        from raytpu_torch.runtime import api

        with refcount.READY:
            buf = self.streams.pop(tid, None)
        if buf is None:
            return
        for status, sealed in buf:
            if status == api._ITEM:
                refcount.discard(sealed)
        api.pool_cancel(tid, False)


STREAMS = _TaskStreams()


def deliver(message: tuple) -> None:
    """A message of one of this process's tasks, from the pool."""
    from raytpu_torch.runtime import api

    kind, tid = message[0], message[1]
    if kind == "item":
        with refcount.READY:
            buf = STREAMS.streams.get(tid)
            if buf is not None:
                buf.append((api._ITEM, message[2]))
                refcount.READY.notify_all()
                return
        refcount.discard(message[2])  # closed meanwhile
        return
    _, tid, ok, payload = message
    with _SUBMITTED_LOCK:
        sub = _SUBMITTED.pop(tid, None)
    if sub is None:
        return
    sub.submission.finish()
    if sub.streaming:
        with refcount.READY:
            buf = STREAMS.streams.get(tid)
            if buf is not None:
                buf.append((api._END, None) if ok else (api._ERR, payload))
                refcount.READY.notify_all()
        return
    for i, oid in enumerate(sub.returns):
        if ok:
            refcount.complete(oid, payload[i])
        else:
            refcount.fail(oid, payload)


class RemoteFunction:
    """What :func:`~raytpu_torch.runtime.api.remote` makes of a function."""

    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        options = dict(options or {})
        check_options(options)
        self._function = fn
        self._options = options
        self._blob: Optional[bytes] = None
        self._name = options.get("name") or getattr(
            fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
        functools.update_wrapper(self, fn, updated=())

    def __call__(self, *args, **kwargs):
        raise TypeError(f"remote function {self._name} cannot be called "
                        f"directly; use {self._name}.remote()")

    def options(self, **options) -> "RemoteFunction":
        rf = RemoteFunction(self._function, {**self._options, **options})
        if "name" not in options:
            rf._blob = self._blob
        return rf

    def bind(self, *args, **kwargs):
        """A lazy call (:class:`raytpu_torch.dag.FunctionNode`), for
        ``execute`` or a workflow."""
        from raytpu_torch.dag.node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def _pickled(self) -> bytes:
        if self._blob is None:
            from raytpu_torch.runtime import serialization

            self._blob = serialization.dumps(self._function)
        return self._blob

    def remote(self, *args, **kwargs):
        from raytpu_torch.runtime import api
        from raytpu_torch.runtime.generator import ObjectRefGenerator

        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        fn_blob = self._pickled()
        args, kwargs, keep = api.pack_args(args, kwargs)
        sealed = object_store.seal((args, kwargs), os.getpid())
        tid = object_ref.new_id()
        returns = [] if streaming else [object_ref.new_id()
                                        for _ in range(num_returns)]
        for oid in returns:
            refcount.new_entry(oid, task=tid)
        refs = [object_ref.ObjectRef.owned(oid) for oid in returns]
        if streaming:
            with refcount.READY:
                STREAMS.streams[tid] = deque()
        with _SUBMITTED_LOCK:
            _SUBMITTED[tid] = _Submitted(
                returns, streaming, refcount.Submission(None, keep, sealed))
        retries = opts.get("max_retries", TASK_MAX_RETRIES)
        resources = ledger.build_resources(opts, default_cpus=1.0)
        pg, bundle, capture = ledger.placement_of(opts)
        spec = {"tid": tid, "fn": fn_blob, "args": sealed,
                "name": self._name, "num_returns": 1 if streaming
                else num_returns, "streaming": streaming,
                "num_cpus": resources.get("CPU", 0.0),
                "resources": resources, "pg": pg, "bundle": bundle,
                "capture": capture,
                "retries": (1 << 30) if retries == -1 else retries,
                "retry_exceptions": opts.get("retry_exceptions", False),
                "owner_pid": os.getpid()}
        try:
            api.pool_submit(spec)
        except BaseException:
            with _SUBMITTED_LOCK:
                _SUBMITTED.pop(tid, None)
            raise
        if streaming:
            return ObjectRefGenerator(STREAMS, tid)
        return refs[0] if num_returns == 1 else refs

    def __repr__(self):
        return f"RemoteFunction({self._name})"
