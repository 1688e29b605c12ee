"""Structured events, the port's copy of :mod:`raytpu.util.events`
(which imports no JAX): the operational event framework.

Reference analogue: ``src/ray/util/event.h:41`` (``RAY_EVENT`` macros:
severity + label + structured fields, written to per-process event files)
and ``dashboard/modules/event/`` (cluster-wide surfacing). Ours:
:func:`record_event` appends JSONL to a per-process event file (when a
log dir is configured) and hands the event to an optional reporter. The
port has no head to forward to, so the ring of the process that records
an event (:func:`recent_events`) is where it is read: the tuner's
``TRIAL_RETRY`` in the process that runs the tuner.

Severities mirror the reference: DEBUG/INFO/WARNING/ERROR/FATAL.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")

_lock = threading.Lock()
_buffer: Deque[Dict[str, Any]] = deque(maxlen=1000)
_file_path: Optional[str] = None
_reporter: Optional[Callable[[Dict[str, Any]], None]] = None
_dropped = 0  # monotonic: events evicted from the ring by overflow


def configure(log_dir: Optional[str] = None,
              reporter: Optional[Callable[[Dict[str, Any]], None]] = None
              ) -> None:
    """Set the per-process event sink (file under ``log_dir``) and an
    optional forwarder (node daemon -> head)."""
    global _file_path, _reporter
    with _lock:
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            _file_path = os.path.join(log_dir,
                                      f"events-{os.getpid()}.jsonl")
        if reporter is not None:
            _reporter = reporter


def record_event(severity: str, label: str, message: str,
                 **fields: Any) -> Dict[str, Any]:
    """Record one structured event (reference: ``RAY_EVENT(severity,
    label) << message``). Never raises."""
    severity = severity.upper()
    if severity not in SEVERITIES:
        severity = "INFO"
    event = {
        "timestamp": time.time(),
        "severity": severity,
        "label": label,
        "message": message,
        "pid": os.getpid(),
        **{k: v for k, v in fields.items() if _plain(v)},
    }
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1  # oldest record falls off; newest survives
        _buffer.append(event)
        path = _file_path
        reporter = _reporter
    if path:
        try:
            with open(path, "a") as f:
                f.write(json.dumps(event) + "\n")
        except OSError:
            pass
    if reporter is not None:
        try:
            reporter(event)
        except Exception:
            pass
    return event


def _plain(v: Any) -> bool:
    return isinstance(v, (str, int, float, bool, type(None)))


def recent_events(severity: Optional[str] = None,
                  label: Optional[str] = None) -> List[Dict[str, Any]]:
    with _lock:
        events = list(_buffer)
    if severity:
        events = [e for e in events if e["severity"] == severity.upper()]
    if label:
        events = [e for e in events if e["label"] == label]
    return events


def dropped_count() -> int:
    """Monotonically increasing count of events lost to ring overflow
    (the overflow signal ``recent_events`` alone cannot give; included
    in post-mortem dumps so truncation is visible, not silent)."""
    return _dropped


def reset() -> None:
    global _file_path, _reporter, _dropped
    with _lock:
        _buffer.clear()
        _file_path = None
        _reporter = None
        _dropped = 0
