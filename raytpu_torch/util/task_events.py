"""Request lifecycle recorder: the request half of
``raytpu/util/task_events.py``.

Every serving-plane transition of a request (admitted, prefill started
and done, first token, preempted, resumed, finished, aborted, a KV
handoff's start and end) is recorded as a compact structured event
(primitives only) in a bounded per-process ring. A full ring evicts the
OLDEST event and bumps a monotonic drop counter: the hot path never
blocks and the newest history survives.

Cost model: disabled, an emission site is ONE module-flag check (sites
guard with ``if task_events.request_events_enabled():``;
:func:`emit_request` double-checks). Arming is inherited by child
processes via ``RAYTPU_REQUEST_EVENTS``. An event carries the trace id
of the ambient sampled :class:`~raytpu_torch.util.tracing.TraceContext`.

Not ported: the task/actor/object/node vocabulary, shipping to a head
and the head's ``TaskEventStore`` — they need a runtime (ROADMAP.md).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from raytpu_torch.util import tracing

RING_ENV_VAR = "RAYTPU_TASK_EVENTS_RING"
REQUEST_ENV_VAR = "RAYTPU_REQUEST_EVENTS"


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "False")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class RequestTransition:
    """Serving-plane request lifecycle: the JAX package's vocabulary.
    RECEIVED, ROUTED and QUEUED are emitted by a serve handle, router
    and replica, which the port does not have yet; FAILED by a client's
    response generator."""

    RECEIVED = "RECEIVED"            # handle/router accepted the call
    ROUTED = "ROUTED"                # router picked a replica
    QUEUED = "QUEUED"                # replica enqueued (pre-semaphore)
    ADMITTED = "ADMITTED"            # scheduler admitted to a batch
    PREFILL_START = "PREFILL_START"  # prompt compute dispatched
    PREFILL_END = "PREFILL_END"      # prompt KV materialised
    HANDOFF_START = "HANDOFF_START"  # pulling prefilled KV from a peer
    HANDOFF_END = "HANDOFF_END"      # pull done (data: pages, fallback)
    FIRST_TOKEN = "FIRST_TOKEN"      # first output token sampled
    PREEMPTED = "PREEMPTED"          # evicted to recompute (KV freed)
    RESUMED = "RESUMED"              # re-admitted after preemption
    FINISHED = "FINISHED"            # terminal success (data: tokens_out)
    ABORTED = "ABORTED"              # consumer cancelled
    FAILED = "FAILED"                # stream died (error summary rides)

    ALL: Tuple[str, ...] = (
        RECEIVED, ROUTED, QUEUED, ADMITTED, PREFILL_START, PREFILL_END,
        HANDOFF_START, HANDOFF_END, FIRST_TOKEN, PREEMPTED, RESUMED,
        FINISHED, ABORTED, FAILED,
    )


_RING = max(64, _env_int(RING_ENV_VAR, 8192))
_ring: "deque[dict]" = deque(maxlen=_RING)
_lock = threading.Lock()
_request_enabled = _env_truthy(REQUEST_ENV_VAR)
_dropped_total = 0


def request_events_enabled() -> bool:
    """THE flag check every emission site guards with."""
    return _request_enabled


def enable_request_events(env: bool = False) -> None:
    """Arm request-lifecycle recording. ``env=True`` exports
    ``RAYTPU_REQUEST_EVENTS`` so child processes inherit."""
    global _request_enabled
    _request_enabled = True
    if env:
        os.environ[REQUEST_ENV_VAR] = "1"


def disable_request_events(env: bool = False) -> None:
    global _request_enabled
    _request_enabled = False
    if env:
        os.environ.pop(REQUEST_ENV_VAR, None)


def emit_request(request_id: str, transition: str, *,
                 deployment: str = "", tenant: str = "",
                 data: Optional[Dict[str, Any]] = None,
                 error: Optional[str] = None, attempt: int = 0) -> None:
    """Record one request lifecycle transition (primitives only). Never
    blocks; a full ring drops the oldest event and counts it. Call sites
    guard with ``if task_events.request_events_enabled():`` and this
    double-checks."""
    global _dropped_total
    if not _request_enabled:
        return
    ev: Dict[str, Any] = {
        "kind": "request",
        "id": str(request_id),
        "transition": transition,
        "ts": time.time(),
        "mono": time.monotonic(),
        "node_id": "",
        "worker_id": "",
        "attempt": int(attempt),
        "deployment": str(deployment or ""),
        "tenant": str(tenant or ""),
    }
    if data is not None:
        ev["data"] = data
    if error is not None:
        ev["error"] = str(error)[:256]
    tc = tracing.current_trace()
    if tc is not None and tc.sampled:
        ev["trace_id"] = tc.trace_id
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped_total += 1
        _ring.append(ev)


def dropped_count() -> int:
    """Monotonic count of events the full ring evicted."""
    return _dropped_total


def get_events() -> List[dict]:
    with _lock:
        return list(_ring)


def clear() -> None:
    """Drop buffered events and reset drop accounting."""
    global _dropped_total
    with _lock:
        _ring.clear()
        _dropped_total = 0
