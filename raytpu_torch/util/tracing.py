"""Tracing and profiling; the port of ``raytpu/util/tracing.py``.

Spans (Dapper model): a :class:`TraceContext` — trace id, span id,
parent span id, sampled flag — lives in a context variable; a span
entered under it records as its child, and each process keeps its
closed spans in a bounded ring buffer (:func:`get_spans`). The context
rides every call of the port's runtime (:mod:`raytpu_torch.runtime.api`)
as its wire form, as it rides the JAX package's RPC frames, and is
re-anchored in the worker, so a caller's ``rpc.client.*`` span is the
parent of the worker's ``rpc.server.*`` span. :func:`cluster_timeline`
gathers every process's buffer through the runtime's fan-out (the
driver asks every live process of the tree at once) and
:func:`assemble_timeline` merges them into one chrome trace, a track a
process, with flow arrows on the parent links that cross processes.

Cost model: with tracing disabled a span site is one module-flag check
plus returning a shared no-op context manager — nothing allocates, no
context variable is read. Arming is inherited by child processes via
``RAYTPU_TRACING`` / ``RAYTPU_TRACE_SAMPLE``.

A span times the host: on CUDA, code inside it that launches kernels
returns before the card runs them, so a span around a model forward
measures its dispatch (as the JAX package's span around an asynchronous
jit call does). Device time comes from :func:`profile`, which wraps a
region in ``torch.profiler`` (CPU and, with a card, CUDA activities) and
writes a chrome trace of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

ENV_VAR = "RAYTPU_TRACING"
SAMPLE_ENV_VAR = "RAYTPU_TRACE_SAMPLE"
BUFFER_ENV_VAR = "RAYTPU_TRACE_BUFFER"


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "False")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


_BUFFER = max(16, int(_env_float(BUFFER_ENV_VAR, 4096)))
_spans: "deque[dict]" = deque(maxlen=_BUFFER)
_spans_lock = threading.Lock()
_enabled = _env_truthy(ENV_VAR)
_sample_rate = _env_float(SAMPLE_ENV_VAR, 1.0)


# [kind, ident] — e.g. ["driver", ""], ["worker", "Replica-ab12cd34"].
# Mutated in place so dump() sees updates without rebinding.
_identity: List[str] = ["proc", ""]


class TraceContext:
    """Immutable Dapper-style context: which trace, which span, whose
    child, and whether anything records. On the wire only
    ``[trace_id, span_id, sampled]`` travels — the receiver's parent IS
    the sender's span id, so ``parent_span_id`` never needs to ride."""

    __slots__ = ("trace_id", "span_id", "parent_span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None,
                 sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.sampled = sampled

    @classmethod
    def root(cls, sampled: bool = True) -> "TraceContext":
        return cls(os.urandom(16).hex(), os.urandom(8).hex(), None, sampled)

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, os.urandom(8).hex(),
                            self.span_id, self.sampled)

    def to_wire(self) -> list:
        return [self.trace_id, self.span_id, 1 if self.sampled else 0]

    @classmethod
    def from_wire(cls, w: Any) -> Optional["TraceContext"]:
        """The context of a wire form; None where it is malformed."""
        try:
            trace_id, span_id, sampled = w[0], w[1], bool(w[2])
        except (TypeError, IndexError, KeyError):
            return None
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        return cls(trace_id, span_id, None, sampled)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext({self.trace_id[:8]}…/{self.span_id}"
                f" parent={self.parent_span_id} sampled={self.sampled})")


_current: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("raytpu_torch_trace", default=None)


def current_trace() -> Optional[TraceContext]:
    """The ambient trace context (None outside any span)."""
    return _current.get()


def set_current_trace(ctx: Optional[TraceContext]):
    """Anchor ``ctx`` as the ambient context; returns a reset token."""
    return _current.set(ctx)


def reset_current_trace(token) -> None:
    _current.reset(token)


def enabled() -> bool:
    return _enabled


def enable_tracing(sample_rate: Optional[float] = None,
                   env: bool = False) -> None:
    """Turn on span capture. ``sample_rate`` bounds ROOT creation: 0.0
    means new roots are created unsampled (contexts still propagate,
    nothing records). ``env=True`` exports the arming so child processes
    inherit it."""
    global _enabled, _sample_rate
    if sample_rate is not None:
        _sample_rate = float(sample_rate)
    _enabled = True
    if env:
        os.environ[ENV_VAR] = "1"
        os.environ[SAMPLE_ENV_VAR] = repr(_sample_rate)


def disable_tracing(env: bool = False) -> None:
    global _enabled
    _enabled = False
    if env:
        os.environ.pop(ENV_VAR, None)
        os.environ.pop(SAMPLE_ENV_VAR, None)


def set_process_identity(kind: str, ident: str = "") -> None:
    """Name this process for cluster timelines (driver, worker:<name>)."""
    _identity[0] = str(kind)
    _identity[1] = str(ident)


def get_spans() -> List[dict]:
    with _spans_lock:
        return list(_spans)


def clear_spans() -> None:
    with _spans_lock:
        _spans.clear()


def dump() -> dict:
    """This process's span buffer plus identity — what the runtime's
    trace fan-out gathers from every process."""
    return {"identity": list(_identity), "pid": os.getpid(),
            "spans": get_spans()}


_NOOP_ATTRS: Dict[str, Any] = {}


class _NoopSpan:
    """Shared disabled-path context manager: zero allocation per site."""

    __slots__ = ()

    def __enter__(self) -> Dict[str, Any]:
        # Sites may write attributes into the yielded dict; a shared one
        # is fine because nothing ever reads it.
        return _NOOP_ATTRS

    def __exit__(self, et, ev, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Recording context manager. Entering derives a child context from
    the ambient one (or starts a new root, subject to the sample rate)
    and anchors it; exiting restores the parent and — only when sampled —
    appends one record to the ring buffer."""

    __slots__ = ("name", "attrs", "_ctx", "_token", "_start", "_t0")

    def __init__(self, name: str, attributes: Optional[Dict] = None):
        self.name = name
        self.attrs: Dict[str, Any] = dict(attributes) if attributes else {}

    def __enter__(self) -> Dict[str, Any]:
        parent = _current.get()
        if parent is not None:
            self._ctx = parent.child()
        else:
            sampled = _sample_rate >= 1.0 or random.random() < _sample_rate
            self._ctx = TraceContext.root(sampled=sampled)
        self._token = _current.set(self._ctx)
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self.attrs

    def __exit__(self, et, ev, tb) -> bool:
        dur = time.perf_counter() - self._t0
        _current.reset(self._token)
        ctx = self._ctx
        if ctx.sampled:
            with _spans_lock:
                _spans.append({
                    "name": self.name,
                    "trace_id": ctx.trace_id,
                    "span_id": ctx.span_id,
                    "parent_span_id": ctx.parent_span_id,
                    "start": self._start,
                    "duration_s": dur,
                    "pid": os.getpid(),
                    "tid": threading.get_native_id(),
                    "attributes": self.attrs,
                    "error": repr(ev) if ev is not None else None,
                })
        return False


def span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """One traced region. Disabled cost is this flag check plus a shared
    no-op context manager; enabled, it parents into the ambient
    :class:`TraceContext` and records into the ring buffer. Yields the
    (mutable) attributes dict so sites can attach results post-hoc."""
    if not _enabled:
        return _NOOP_SPAN
    return _Span(name, attributes)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator version of :func:`span`."""

    def wrap(fn: Callable) -> Callable:
        label = name or getattr(fn, "__qualname__", "fn")

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(label):
                return fn(*args, **kwargs)

        return inner

    return wrap


def run_with_trace(tc: Optional[TraceContext], name: str,
                   fn: Callable, *args, **kwargs):
    """Re-anchor ``tc`` around ``fn`` on THIS thread and run it inside a
    span: the bridge for a hop that loses context variables (a thread
    started without the caller's context, a queue-decoupled call)."""
    token = _current.set(tc) if tc is not None else None
    try:
        with span(name):
            return fn(*args, **kwargs)
    finally:
        if token is not None:
            _current.reset(token)


def _span_event(s: dict, pid: Optional[int] = None) -> dict:
    args = dict(s.get("attributes") or {})
    for k in ("trace_id", "span_id", "parent_span_id"):
        if s.get(k):
            args[k] = s[k]
    if s.get("error"):
        args["error"] = s["error"]
    return {
        "name": s["name"],
        "cat": "span",
        "ph": "X",
        "ts": s["start"] * 1e6,
        "dur": s["duration_s"] * 1e6,
        "pid": s.get("pid", 0) if pid is None else pid,
        "tid": s.get("tid", 0),
        "args": args,
    }


@contextlib.contextmanager
def profile(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` (CPU
    activity, and CUDA when a card is present) and write its chrome
    trace to ``logdir/trace-<pid>-<ns>.json`` on the way out. Yields
    the profiler; the trace's path is its ``trace_path`` attribute once
    the region has closed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof = torch_profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(path)
    prof.trace_path = path


def timeline(filename: Optional[str] = None) -> List[dict]:
    """Chrome-trace events of this process's recorded spans (each on its
    real pid/tid track). The JAX package adds the runtime's task events,
    which the port's runtime does not record; for every process, see
    :func:`cluster_timeline`."""
    trace = [_span_event(s) for s in get_spans()]
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def assemble_timeline(dumps: List[dict],
                      filename: Optional[str] = None) -> List[dict]:
    """Merge per-process trace dumps (:func:`dump` payloads) into one
    chrome-trace JSON. Each dump becomes one ``pid`` track named by its
    identity via a ``process_name`` metadata event; spans whose parent
    lives in a DIFFERENT process get a flow-event pair (``ph:"s"`` at the
    parent, ``ph:"f", bp:"e"`` at the child) so Perfetto draws the
    cross-process arrow."""
    events: List[dict] = []
    # span_id -> (track pid, record)
    index: Dict[str, Tuple[int, dict]] = {}
    for i, d in enumerate(dumps or []):
        if not isinstance(d, dict):
            continue
        ident = list(d.get("identity") or ("proc", ""))
        label = str(ident[0]) if ident else "proc"
        if len(ident) > 1 and ident[1]:
            label += f":{ident[1]}"
        label += f" (pid {d.get('pid', '?')})"
        track = i + 1
        events.append({"name": "process_name", "ph": "M", "pid": track,
                       "tid": 0, "args": {"name": label}})
        for s in d.get("spans") or []:
            events.append(_span_event(s, pid=track))
            sid = s.get("span_id")
            if sid:
                index[sid] = (track, s)
    for sid, (track, s) in index.items():
        parent = s.get("parent_span_id")
        if not parent or parent not in index:
            continue
        ptrack, ps = index[parent]
        if ptrack == track:
            continue  # local nesting draws itself; arrows are for hops
        events.append({
            "name": "trace", "cat": "flow", "ph": "s", "id": sid,
            "pid": ptrack, "tid": ps.get("tid", 0),
            "ts": ps["start"] * 1e6,
        })
        events.append({
            "name": "trace", "cat": "flow", "ph": "f", "bp": "e",
            "id": sid, "pid": track, "tid": s.get("tid", 0),
            "ts": s["start"] * 1e6,
        })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events


def cluster_timeline(filename: Optional[str] = None) -> List[dict]:
    """Pull every process's span buffer through the runtime's fan-out
    (the driver asks every live process of the tree at once; a dead or
    silent one is skipped) and assemble one chrome trace."""
    from raytpu_torch.runtime import api as _api

    # Should the fan-out ever return this very process's buffer, the
    # local one, which is fresher, takes its place: one track a process.
    me = os.getpid()
    dumps = [d for d in _api.trace_dumps()
             if not (isinstance(d, dict) and d.get("pid") == me)]
    dumps.append(dump())
    return assemble_timeline(dumps, filename)
