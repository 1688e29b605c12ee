"""Compiled DAGs: pre-allocated channel pipelines across actor processes,
the port of :mod:`raytpu.dag.compiled`.

Compile once; then every ``execute()`` writes the input into a channel
(:mod:`raytpu_torch.runtime.channel`, a ring in shared memory) and each
stage's actor runs read-inputs → invoke-method → write-output with no
per-step call. Compilation walks the DAG, counts the consumers of each
node, makes one channel per node plus the input channel (all owned by
the compiling process) and parks one exec loop in each stage's actor.

Supported topology, as in the JAX package: one ``InputNode``, any DAG of
``ActorMethodNode``s over ``ClassNode``/``ActorHandle`` targets,
optionally a ``MultiOutputNode``; task nodes raise ``TypeError``.

- **Parking the loop.** The JAX worker dispatches a reserved method name
  to its loop. The port parks :func:`_exec_compiled_loop` through
  :func:`raytpu_torch.runtime.api.call`, which runs a function on the
  instance as an ordered method call: the stage's class needs nothing,
  and with ``max_concurrency=1`` the actor's other calls wait behind the
  loop until ``teardown()``.
- **Errors**, as in JAX: an exception in a stage is written downstream as
  an ``_ExecError`` (one that does not pickle as a ``TaskError`` with its
  traceback), every later stage forwards it, and the driver re-raises the
  stage's own exception type from ``get()``; the loops go on.
- **A stage's death** (the port's addition: a stage is a process, and a
  process can die). A ``get()`` or ``execute()`` that waits looks at the
  stages' parked calls every :data:`WATCH_S` seconds and raises the
  actor's :class:`~raytpu_torch.core.errors.ActorDiedError` once one has
  failed; ``teardown()`` closes every channel at once then. A compiled
  graph still alive at :func:`raytpu_torch.runtime.api.shutdown` (and so
  at the driver's exit) is torn down first, while its actors live.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from raytpu_torch.core.errors import TaskError
from raytpu_torch.dag.node import (ActorMethodNode, ClassNode, DAGNode,
                                   InputNode)
from raytpu_torch.runtime import api
from raytpu_torch.runtime.channel import Channel, ChannelClosed
from raytpu_torch.runtime.object_ref import is_ready, pending_caller

# How often a waiting get() or execute() looks for a dead stage.
WATCH_S = 0.2
# How long teardown() lets the pipeline flush before it closes the
# channels.
TEARDOWN_S = 5.0


class MultiOutputNode(DAGNode):
    """Bundle several leaf nodes into one execute() result tuple."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})
        self.outputs = list(outputs)

    def execute(self, input_value: Any = None):
        return [o.execute(input_value) for o in self.outputs]


class _Teardown:
    """Sentinel flushed through the pipeline to stop exec loops."""

    def __reduce__(self):
        return (_teardown_singleton, ())


_TEARDOWN = _Teardown()


def _teardown_singleton():
    return _TEARDOWN


class _ExecError:
    """An exception captured in some upstream node, propagated downstream
    so the driver re-raises it from get()."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _write(out_channel: Channel, result, label: str) -> None:
    """Write a stage's result; one that does not pickle becomes a
    TaskError downstream."""
    try:
        out_channel.write(result)
    except (ChannelClosed, TimeoutError):
        raise
    except Exception as exc:
        out_channel.write(_ExecError(TaskError.from_exception(label, exc)))


def _exec_compiled_loop(instance, method_name: str,
                        in_channels: List[Channel],
                        in_reader_ids: List[int],
                        const_args: tuple, const_kwargs: dict,
                        arg_slots: List,
                        out_channel: Channel) -> str:
    """Parked inside the actor's process as one long-running call.
    ``arg_slots[i]`` says where in_channels[i]'s value goes: an int is a
    positional slot, a str a keyword name; ``const_args``/``const_kwargs``
    fill the rest (None placeholders at channel slots)."""
    method = getattr(instance, method_name)
    label = f"{type(instance).__name__}.{method_name}"
    while True:
        vals = []
        err: Optional[_ExecError] = None
        stop = False
        for ch, rid in zip(in_channels, in_reader_ids):
            try:
                v = ch.read(rid)
            except ChannelClosed:
                stop = True
                break
            if isinstance(v, _Teardown):
                stop = True
                break
            if isinstance(v, _ExecError) and err is None:
                err = v
            vals.append(v)
        if stop:
            try:
                out_channel.write(_TEARDOWN)
            except ChannelClosed:
                pass
            return "stopped"
        if err is not None:
            try:
                _write(out_channel, err, label)
            except ChannelClosed:
                return "stopped"
            continue
        args = list(const_args)
        kwargs = dict(const_kwargs)
        for slot, v in zip(arg_slots, vals):
            if isinstance(slot, str):
                kwargs[slot] = v
            else:
                args[slot] = v
        try:
            result = method(*args, **kwargs)
        except BaseException as e:  # propagate, keep looping
            result = _ExecError(e)
        try:
            _write(out_channel, result, label)
        except ChannelClosed:
            return "stopped"


class CompiledDAGRef:
    """Future for one execute(); reads the output channel in order."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq
        self._value: Any = None
        self._done = False

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._done:
            self._dag._drain_until(self._seq, timeout)
            self._value = self._dag._results.pop(self._seq)
            self._done = True
        value = self._value
        if isinstance(value, _ExecError):
            raise value.exc
        if isinstance(value, list):
            for v in value:
                if isinstance(v, _ExecError):
                    raise v.exc
        return value


# The compiling process's graphs not yet torn down (shutdown tears them
# down).
_LIVE: "weakref.WeakSet[CompiledDAG]" = weakref.WeakSet()


class CompiledDAG:
    def __init__(self, root: DAGNode, buffer_size: int = 16):
        self._root = root
        self._buffer_size = buffer_size
        self._input_channel: Optional[Channel] = None
        self._output_channels: List[Channel] = []
        self._output_reader_ids: List[int] = []
        self._channels: List[Channel] = []
        self._loop_refs: list = []
        # _meta_lock guards counters/flags only (never held while blocking
        # on a channel); _drain_lock serializes output readers, so a parked
        # get() can't deadlock execute()/teardown().
        self._meta_lock = threading.Lock()
        self._drain_lock = threading.Lock()
        self._exec_lock = threading.Lock()  # keeps seq == input-write order
        self._seq = 0            # next execute() sequence number
        self._read_seq = 0       # next sequence to read from outputs
        self._partial_outs: List[Any] = []  # mid-tuple reads after timeout
        self._results: Dict[int, Any] = {}
        self._multi_output = isinstance(root, MultiOutputNode)
        self._torn_down = False
        try:
            self._compile()
        except BaseException:
            self._torn_down = True
            for ch in self._channels:
                ch.close()
            raise
        _LIVE.add(self)

    # -- compilation -------------------------------------------------------

    def _compile(self) -> None:
        leaves = self._root.outputs if self._multi_output else [self._root]
        # node -> its output channel; count consumers first.
        consumers: Dict[int, int] = {}
        nodes: List[ActorMethodNode] = []
        seen: Dict[int, ActorMethodNode] = {}
        input_consumers = 0

        def walk(node: DAGNode):
            nonlocal input_consumers
            if not isinstance(node, ActorMethodNode):
                raise TypeError(
                    "compiled DAGs support actor-method nodes (got "
                    f"{type(node).__name__}); tasks have no persistent "
                    "process to park the exec loop in"
                )
            if id(node) in seen:
                return
            seen[id(node)] = node
            for a in list(node._bound_args) + list(node._bound_kwargs.values()):
                if isinstance(a, InputNode):
                    input_consumers += 1
                elif isinstance(a, ActorMethodNode):
                    consumers[id(a)] = consumers.get(id(a), 0) + 1
                    walk(a)
                elif isinstance(a, DAGNode):
                    raise TypeError(
                        f"unsupported node type in compiled DAG: "
                        f"{type(a).__name__}"
                    )
            nodes.append(node)

        for leaf in leaves:
            walk(leaf)
            consumers[id(leaf)] = consumers.get(id(leaf), 0) + 1  # driver

        self._input_channel = Channel(
            num_readers=max(1, input_consumers),
            capacity=self._buffer_size)
        self._channels.append(self._input_channel)
        channels: Dict[int, Channel] = {}
        for nid, n in consumers.items():
            channels[nid] = Channel(num_readers=n, capacity=self._buffer_size)
            self._channels.append(channels[nid])

        # Launch one exec loop per node (topological order from walk()).
        for node in nodes:
            target = node._target
            if isinstance(target, ClassNode):
                handle = target.execute()
            else:
                handle = target
            in_channels, in_rids, slots = [], [], []
            const_args: List[Any] = []
            const_kwargs: Dict[str, Any] = {}

            def wire(a, slot):
                if isinstance(a, InputNode):
                    in_channels.append(self._input_channel)
                    in_rids.append(self._input_channel.reader_id())
                    slots.append(slot)
                    return None, True
                if isinstance(a, ActorMethodNode):
                    ch = channels[id(a)]
                    in_channels.append(ch)
                    in_rids.append(ch.reader_id())
                    slots.append(slot)
                    return None, True
                return a, False

            for i, a in enumerate(node._bound_args):
                v, _ = wire(a, i)
                const_args.append(v)
            for k, a in node._bound_kwargs.items():
                v, wired = wire(a, k)
                if not wired:
                    const_kwargs[k] = v
            self._loop_refs.append(api.call(
                handle, _exec_compiled_loop, node._method_name, in_channels,
                in_rids, tuple(const_args), const_kwargs, slots,
                channels[id(node)]))

        for leaf in leaves:
            ch = channels[id(leaf)]
            self._output_channels.append(ch)
            self._output_reader_ids.append(ch.reader_id())

    # -- a stage's death ---------------------------------------------------

    def _failed_stage(self) -> Optional[BaseException]:
        """The error of the first stage whose parked loop has failed (its
        actor died), else None."""
        now = time.monotonic()
        for ref in self._loop_refs:
            with api.READY:
                caller = pending_caller(ref)
                if caller is not None:
                    caller.check_exit(now)
                ready = is_ready(ref)
            if ready:
                try:
                    api.get(ref, timeout=0)
                except Exception as exc:
                    return exc
        return None

    def _watched(self, op, deadline: Optional[float]):
        """``op(timeout)`` in slices of WATCH_S, raising a dead stage's
        error between them; TimeoutError once ``deadline`` passes."""
        while True:
            left = None if deadline is None else deadline - time.monotonic()
            try:
                return op(WATCH_S if left is None else max(0.0, min(
                    WATCH_S, left)))
            except TimeoutError:
                if left is not None and left <= WATCH_S:
                    raise
            dead = self._failed_stage()
            if dead is not None:
                raise dead

    # -- execution ---------------------------------------------------------

    def execute(self, input_value: Any = None,
                timeout: Optional[float] = None) -> CompiledDAGRef:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._exec_lock:
            with self._meta_lock:
                if self._torn_down:
                    raise RuntimeError("compiled DAG was torn down")
                seq = self._seq
                self._seq += 1
            # Channel capacity provides backpressure; a parked get() holds
            # only _drain_lock, so it can never block this write.
            self._watched(lambda t: self._input_channel.write(
                input_value, timeout=t), deadline)
        return CompiledDAGRef(self, seq)

    def _drain_until(self, seq: int, timeout: Optional[float]) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._drain_lock:
            while self._read_seq <= seq:
                # _partial_outs survives a timeout mid-tuple so a retried
                # get() resumes at the unread channel instead of re-reading
                # channel 0 (which would misalign MultiOutputNode results
                # across sequence numbers).
                outs = self._partial_outs
                while len(outs) < len(self._output_channels):
                    i = len(outs)
                    ch = self._output_channels[i]
                    rid = self._output_reader_ids[i]
                    outs.append(self._watched(
                        lambda t: ch.read(rid, timeout=t), deadline))
                self._partial_outs = []
                with self._meta_lock:
                    self._results[self._read_seq] = (
                        list(outs) if self._multi_output else outs[0]
                    )
                    self._read_seq += 1

    def teardown(self) -> None:
        """Flush ``_TEARDOWN`` through the pipeline and wait for the loops
        (at most TEARDOWN_S), then close every channel, which unlinks its
        ring and wakes any loop still blocked; at once where a stage has
        died."""
        with self._meta_lock:
            if self._torn_down:
                return
            self._torn_down = True
        _LIVE.discard(self)
        deadline = time.monotonic() + TEARDOWN_S
        graceful = self._failed_stage() is None
        if graceful:
            try:
                self._input_channel.write(_TEARDOWN, timeout=TEARDOWN_S)
            except Exception:
                graceful = False
        if graceful and self._drain_lock.acquire(timeout=0):
            # Results nobody took would hold the last stages' writes.
            try:
                for ch, rid in zip(self._output_channels,
                                   self._output_reader_ids):
                    while not isinstance(ch.read(rid, timeout=max(
                            0.0, deadline - time.monotonic())), _Teardown):
                        pass
            except Exception:
                graceful = False
            finally:
                self._drain_lock.release()
        if graceful:
            api.wait(self._loop_refs, num_returns=len(self._loop_refs),
                     timeout=max(0.0, deadline - time.monotonic()))
        for ch in self._channels:
            ch.close()
        api.wait(self._loop_refs, num_returns=len(self._loop_refs),
                 timeout=TEARDOWN_S)

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


def _teardown_live() -> None:
    for dag in list(_LIVE):
        dag.teardown()


api.on_shutdown(_teardown_live)


def experimental_compile(dag: DAGNode, buffer_size: int = 16) -> CompiledDAG:
    return CompiledDAG(dag, buffer_size=buffer_size)
