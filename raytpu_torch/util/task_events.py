"""Task-event flight recorder: lifecycle transitions as structured
events; the port of ``raytpu/util/task_events.py``.

Every task, actor, object and request transition of the port's runtime
is recorded as a compact structured event (primitives only) in a bounded
per-process ring. A full ring evicts the OLDEST event and bumps a
monotonic ``dropped`` counter: the hot path never blocks and the newest
history survives.

- :func:`emit` and :func:`emit_request` append one event;
- shippers (an actor's ship timer, a task worker's done message) call
  :func:`drain` and forward the batch to the driver; delivery failure
  calls :func:`requeue`;
- the driver folds batches into a :class:`TaskEventStore` (bounded per
  kind, FIFO-evicting, indexed by id and by state), which
  :mod:`raytpu_torch.state` reads (:mod:`raytpu_torch.runtime.records`);
- :func:`write_postmortem` snapshots the local ring and recent
  operational events to a log directory.

Cost model: disabled, an emission site is ONE module-flag check (sites
guard with ``if task_events.enabled():`` or ``if
task_events.request_events_enabled():``; :func:`emit` and
:func:`emit_request` double-check). Arming is inherited by child
processes via ``RAYTPU_TASK_EVENTS`` and ``RAYTPU_REQUEST_EVENTS``. An
event carries the trace id of the ambient sampled
:class:`~raytpu_torch.util.tracing.TraceContext`. Stamps are wall-clock
(``time.time()``): the processes of a tree share the host's clock, not
a monotonic origin, and the store folds by event time.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from raytpu_torch.util import tracing

ENV_VAR = "RAYTPU_TASK_EVENTS"
RING_ENV_VAR = "RAYTPU_TASK_EVENTS_RING"
REQUEST_ENV_VAR = "RAYTPU_REQUEST_EVENTS"


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "False")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class TaskTransition:
    """Every lifecycle state the recorder knows: the JAX package's closed
    vocabulary. tests/test_torch_port_rules.py asserts that each member
    is emitted somewhere under ``raytpu_torch/``, or stands in its list
    of members the port never emits, with the reason."""

    # task lifecycle
    SUBMITTED = "SUBMITTED"          # driver/backend accepted the spec
    PENDING_SCHED = "PENDING_SCHED"  # waiting for a feasible node
    SCHEDULED = "SCHEDULED"          # head picked a node
    LEASED = "LEASED"                # node leased a worker process
    RUNNING = "RUNNING"              # worker entered user code
    FINISHED = "FINISHED"            # terminal success
    FAILED = "FAILED"                # attempt failed (may retry)
    RETRIED = "RETRIED"              # a new attempt was queued
    # actor lifecycle
    CREATED = "CREATED"
    RESTARTING = "RESTARTING"
    RESTARTED = "RESTARTED"
    DEAD = "DEAD"
    # object lifecycle
    PUT = "PUT"                      # became local in some store
    TRANSFERRED = "TRANSFERRED"      # crossed nodes (push or pull)
    # node lifecycle
    NODE_ADDED = "NODE_ADDED"
    NODE_DIED = "NODE_DIED"

    ALL: Tuple[str, ...] = (
        SUBMITTED, PENDING_SCHED, SCHEDULED, LEASED, RUNNING, FINISHED,
        FAILED, RETRIED, CREATED, RESTARTING, RESTARTED, DEAD, PUT,
        TRANSFERRED, NODE_ADDED, NODE_DIED,
    )


class RequestTransition:
    """Serving-plane request lifecycle: the JAX package's vocabulary.
    RECEIVED and ROUTED are emitted by the serve router, QUEUED by a
    replica (in its own process), FAILED by a client's response
    generator."""

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


KINDS = ("task", "actor", "object", "node", "request")

_RING = max(64, _env_int(RING_ENV_VAR, 8192))
_ring: "deque[dict]" = deque(maxlen=_RING)
_lock = threading.Lock()
_enabled = _env_truthy(ENV_VAR)
_request_enabled = _env_truthy(REQUEST_ENV_VAR)
_dropped_total = 0    # monotonic: events lost locally OR reported by
_dropped_shipped = 0  # an upstream emitter; shipped-watermark for drain
# [node_id, worker_id] — mutated in place (tracing._identity pattern) so
# events stamped after process setup carry their emitter.
_identity: List[str] = ["", ""]


def enabled() -> bool:
    return _enabled


def enable_task_events(env: bool = False,
                       ring_size: Optional[int] = None) -> None:
    """Arm the recorder. ``env=True`` exports ``RAYTPU_TASK_EVENTS`` so
    child processes (actors, task workers) inherit the arming: arm
    before the first child starts, since a child is forked from a
    server of its starter's environment
    (:mod:`raytpu_torch.runtime.starter`). ``ring_size`` rebuilds the
    local ring (tests shrink it to force drops)."""
    global _enabled, _ring
    if ring_size is not None:
        with _lock:
            _ring = deque(_ring, maxlen=max(1, int(ring_size)))
    _enabled = True
    if env:
        os.environ[ENV_VAR] = "1"
        if ring_size is not None:
            os.environ[RING_ENV_VAR] = str(int(ring_size))


def disable_task_events(env: bool = False) -> None:
    global _enabled
    _enabled = False
    if env:
        os.environ.pop(ENV_VAR, None)
        os.environ.pop(RING_ENV_VAR, None)


def request_events_enabled() -> bool:
    """The request-timeline flag — independent of :func:`enabled` so a
    serving cluster records request waterfalls without paying for the
    task/actor/object firehose (and vice versa)."""
    return _request_enabled


def enable_request_events(env: bool = False) -> None:
    """Arm request-lifecycle recording. ``env=True`` exports
    ``RAYTPU_REQUEST_EVENTS`` so child processes (replicas) inherit."""
    global _request_enabled
    _request_enabled = True
    if env:
        os.environ[REQUEST_ENV_VAR] = "1"


def disable_request_events(env: bool = False) -> None:
    global _request_enabled
    _request_enabled = False
    if env:
        os.environ.pop(REQUEST_ENV_VAR, None)


def ship_enabled() -> bool:
    """True when ANY event class is armed: the shipping seams (an actor's
    ship timer, a task worker's done message, the driver's lazy fold)
    gate on this, not on :func:`enabled`, so request events reach the
    driver even when the task firehose is off."""
    return _enabled or _request_enabled


def set_emitter_identity(node_id: str = "", worker_id: str = "") -> None:
    """Stamp this process's emitter ids onto every future event (set
    once at a worker's start, after the fork, like
    tracing.set_process_identity)."""
    if node_id:
        _identity[0] = str(node_id)
    if worker_id:
        _identity[1] = str(worker_id)


def emit(kind: str, entity_id: str, transition: str, *,
         name: Optional[str] = None, attempt: int = 0,
         error: Optional[str] = None,
         parent_task_id: Optional[str] = None,
         node_id: Optional[str] = None,
         worker_id: Optional[str] = None) -> None:
    """Record one lifecycle transition. Never blocks, never raises on
    the hot path; a full ring drops the oldest event and counts it."""
    global _dropped_total
    if not _enabled:
        return
    ev: Dict[str, Any] = {
        "kind": kind,
        "id": str(entity_id),
        "transition": transition,
        "ts": time.time(),
        "mono": time.monotonic(),
        "node_id": node_id if node_id is not None else _identity[0],
        "worker_id": worker_id if worker_id is not None else _identity[1],
        "attempt": int(attempt),
    }
    if name is not None:
        ev["name"] = str(name)
    if error is not None:
        # Summary only — full tracebacks live in logs, not the wire.
        ev["error"] = str(error)[:256]
    if parent_task_id is not None:
        ev["parent_task_id"] = str(parent_task_id)
    tc = tracing.current_trace()
    if tc is not None and tc.sampled:
        ev["trace_id"] = tc.trace_id
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped_total += 1
        _ring.append(ev)


def emit_request(request_id: str, transition: str, *,
                 deployment: str = "", tenant: str = "",
                 data: Optional[Dict[str, Any]] = None,
                 error: Optional[str] = None, attempt: int = 0) -> None:
    """Record one request lifecycle transition (primitives only — the
    batch crosses strict ``allow_pickle=False`` wire surfaces). Same
    never-block contract as :func:`emit`; call sites guard with
    ``if task_events.request_events_enabled():`` (RTP021 enforces the
    one-flag-check budget) and :func:`emit_request` double-checks."""
    global _dropped_total
    if not _request_enabled:
        return
    ev: Dict[str, Any] = {
        "kind": "request",
        "id": str(request_id),
        "transition": transition,
        "ts": time.time(),
        "mono": time.monotonic(),
        "node_id": _identity[0],
        "worker_id": _identity[1],
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
    """Monotonic count of events lost before reaching a store: local
    ring evictions plus drops reported by upstream emitters via
    :func:`ingest`."""
    return _dropped_total


def get_events() -> List[dict]:
    with _lock:
        return list(_ring)


def clear() -> None:
    """Drop buffered events and reset drop accounting (test isolation)."""
    global _dropped_total, _dropped_shipped
    with _lock:
        _ring.clear()
        _dropped_total = 0
        _dropped_shipped = 0


def drain() -> Tuple[List[dict], int]:
    """Pop everything buffered for shipping. Returns ``(batch,
    dropped_delta)`` — the delta is the number of events lost since the
    last successful drain, so the driver's drop accounting stays exact
    across repeated ships."""
    global _dropped_shipped
    with _lock:
        batch = list(_ring)
        _ring.clear()
        delta = _dropped_total - _dropped_shipped
        _dropped_shipped = _dropped_total
    return batch, delta


def requeue(batch: List[dict], dropped: int = 0) -> None:
    """Put a failed ship back at the FRONT of the ring (oldest-first
    order preserved). Overflow drops the oldest of the requeued batch —
    never newer events recorded meanwhile."""
    global _dropped_total, _dropped_shipped
    if not batch and not dropped:
        return
    with _lock:
        _dropped_shipped -= int(dropped)
        space = (_ring.maxlen or 0) - len(_ring)
        if len(batch) > space:
            _dropped_total += len(batch) - space
            batch = batch[len(batch) - space:]
        _ring.extendleft(reversed(batch))


def ingest(batch: List[dict], dropped: int = 0) -> None:
    """Fold a downstream emitter's shipped batch into the LOCAL ring
    (a process relaying another's events toward the driver). Forwarded
    drop counts accumulate into this process's total so the driver
    eventually sees every loss."""
    global _dropped_total
    if not batch and not dropped:
        return
    with _lock:
        _dropped_total += int(dropped)
        for ev in batch:
            if isinstance(ev, dict):
                if len(_ring) == _ring.maxlen:
                    _dropped_total += 1
                _ring.append(ev)


# -- the driver's store ----------------------------------------------------------


class TaskEventStore:
    """Bounded per-kind event store: FIFO-evicting OrderedDicts keyed by
    entity id, with a by-state index kept in lockstep (reference:
    ``GcsTaskManager::GcsTaskManagerStorage``: bounded task storage
    with job/state indexes, oldest-first eviction). The port's driver
    holds one (:mod:`raytpu_torch.runtime.records`).

    One entity record folds its event stream: current ``state`` is the
    latest transition, ``events`` keeps the (bounded) timeline, and
    summary fields (name, node, attempt, error, trace id) are overlaid
    as events arrive, so a list query never walks event lists."""

    def __init__(self, per_kind: int = 4096, events_per_entity: int = 256):
        self._per_kind = max(16, int(per_kind))
        self._events_per_entity = max(8, int(events_per_entity))
        self._lock = threading.Lock()
        self._entities: Dict[str, "OrderedDict[str, dict]"] = {
            k: OrderedDict() for k in KINDS}
        self._by_state: Dict[str, Dict[str, set]] = {k: {} for k in KINDS}
        self._evicted = 0
        self._dropped_reported = 0

    # -- writes --------------------------------------------------------------

    def add_batch(self, events: List[dict], dropped: int = 0) -> None:
        with self._lock:
            self._dropped_reported += int(dropped)
            for ev in events or ():
                if not isinstance(ev, dict):
                    continue
                kind = ev.get("kind")
                eid = ev.get("id")
                transition = ev.get("transition")
                if kind not in self._entities or not eid or not transition:
                    continue
                self._add_locked(kind, str(eid), transition, ev)

    def _add_locked(self, kind: str, eid: str, transition: str,
                    ev: dict) -> None:
        table = self._entities[kind]
        index = self._by_state[kind]
        rec = table.get(eid)
        if rec is None:
            while len(table) >= self._per_kind:
                old_id, old = table.popitem(last=False)
                ids = index.get(old["state"])
                if ids is not None:
                    ids.discard(old_id)
                    if not ids:
                        index.pop(old["state"], None)
                self._evicted += 1
            rec = {"kind": kind, "id": eid, "state": transition,
                   "name": None, "node_id": None, "worker_id": None,
                   "attempt": 0, "error": None, "trace_id": None,
                   "parent_task_id": None, "first_ts": ev.get("ts"),
                   "last_ts": ev.get("ts"), "_state_ts": ev.get("ts"),
                   "events": []}
            if kind == "request":
                # Serving-plane attribution rides the record so list
                # queries filter by deployment/tenant without walking
                # event lists. Other kinds keep their existing shape.
                rec["deployment"] = None
                rec["tenant"] = None
            table[eid] = rec
            index.setdefault(transition, set()).add(eid)
        else:
            # Batches from different processes arrive out of order (the
            # driver's own ring may be folded after a worker's ship): the
            # state overlay follows event wall time, never arrival order,
            # else a fast task sits at SUBMITTED because the driver's fold
            # clobbered the worker's FINISHED.
            ev_ts = ev.get("ts") or 0.0
            if ev_ts >= (rec["_state_ts"] or 0.0):
                if rec["state"] != transition:
                    ids = index.get(rec["state"])
                    if ids is not None:
                        ids.discard(eid)
                        if not ids:
                            index.pop(rec["state"], None)
                    index.setdefault(transition, set()).add(eid)
                rec["state"] = transition
                rec["_state_ts"] = ev_ts
        ts = ev.get("ts")
        if ts is not None:
            rec["last_ts"] = max(rec["last_ts"] or ts, ts)
            rec["first_ts"] = min(rec["first_ts"] or ts, ts)
        if ev.get("name"):
            rec["name"] = ev["name"]
        if kind == "request":
            if ev.get("deployment"):
                rec["deployment"] = ev["deployment"]
            if ev.get("tenant"):
                rec["tenant"] = ev["tenant"]
        if ev.get("node_id"):
            rec["node_id"] = ev["node_id"]
        if ev.get("worker_id"):
            rec["worker_id"] = ev["worker_id"]
        if ev.get("trace_id"):
            rec["trace_id"] = ev["trace_id"]
        if ev.get("parent_task_id"):
            rec["parent_task_id"] = ev["parent_task_id"]
        if ev.get("error") is not None:
            rec["error"] = ev["error"]
        rec["attempt"] = max(rec["attempt"], int(ev.get("attempt") or 0))
        evs = rec["events"]
        if len(evs) >= self._events_per_entity:
            evs.pop(0)
        evs.append(ev)

    # -- reads ---------------------------------------------------------------

    @staticmethod
    def _strip(rec: dict, detail: bool) -> dict:
        out = {k: v for k, v in rec.items()
               if k != "events" and not k.startswith("_")}
        out["num_events"] = len(rec["events"])
        if detail:
            out["events"] = sorted(rec["events"],
                                   key=lambda e: e.get("ts") or 0.0)
        return out

    def get(self, kind: str, entity_id: str) -> Optional[dict]:
        """Exact-id lookup, falling back to a unique hex prefix (CLI
        users paste truncated ids)."""
        with self._lock:
            table = self._entities.get(kind)
            if table is None:
                return None
            rec = table.get(entity_id)
            if rec is None and entity_id:
                matches = [r for i, r in table.items()
                           if i.startswith(entity_id)]
                if len(matches) == 1:
                    rec = matches[0]
            return self._strip(rec, detail=True) if rec else None

    def list(self, kind: str, state: Optional[str] = None,
             node: Optional[str] = None, name: Optional[str] = None,
             limit: int = 100, detail: bool = False) -> List[dict]:
        with self._lock:
            table = self._entities.get(kind)
            if table is None:
                return []
            if state:
                ids = self._by_state[kind].get(state.upper(), set())
                recs = [table[i] for i in ids if i in table]
            else:
                recs = list(table.values())
            out = []
            for rec in recs:
                if node and not str(rec.get("node_id") or
                                    "").startswith(node):
                    continue
                if name and name not in str(rec.get("name") or ""):
                    continue
                out.append(self._strip(rec, detail))
            out.sort(key=lambda r: r.get("last_ts") or 0.0, reverse=True)
            return out[:max(0, int(limit))] if limit else out

    def summary(self, kind: str) -> Dict[str, Any]:
        """Counts by state × name plus queue→run latency percentiles
        (wall-ts delta SUBMITTED → RUNNING per entity) — the ``ray
        summary tasks`` shape."""
        with self._lock:
            table = self._entities.get(kind, {})
            by_state: Dict[str, Dict[str, int]] = {}
            latencies: List[float] = []
            for rec in table.values():
                nm = rec.get("name") or "<unknown>"
                row = by_state.setdefault(rec["state"], {})
                row[nm] = row.get(nm, 0) + 1
                sub = run = None
                for ev in rec["events"]:
                    t = ev.get("transition")
                    if t == TaskTransition.SUBMITTED and sub is None:
                        sub = ev.get("ts")
                    elif t == TaskTransition.RUNNING and run is None:
                        run = ev.get("ts")
                if sub is not None and run is not None and run >= sub:
                    latencies.append(run - sub)
        out: Dict[str, Any] = {
            "kind": kind,
            "total": sum(sum(r.values()) for r in by_state.values()),
            "by_state": {s: dict(sorted(r.items())) for s, r in
                         sorted(by_state.items())},
        }
        if latencies:
            latencies.sort()

            def pct(p: float) -> float:
                i = min(len(latencies) - 1,
                        int(p * (len(latencies) - 1) + 0.5))
                return round(latencies[i], 6)

            out["queue_to_run_latency_s"] = {
                "count": len(latencies), "p50": pct(0.50),
                "p95": pct(0.95), "max": round(latencies[-1], 6)}
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "entities": {k: len(t) for k, t in self._entities.items()},
                "evicted": self._evicted,
                "dropped_reported": self._dropped_reported,
            }


# -- post-mortem --------------------------------------------------------------

_POSTMORTEM_MIN_INTERVAL_S = 30.0
_postmortem_lock = threading.Lock()
_last_postmortem = [0.0]


def write_postmortem(log_dir: str, reason: str,
                     last_n: int = 2000) -> Optional[str]:
    """Dump the flight record to ``log_dir`` as one JSON file: last N
    local events + drop counters + open circuit breakers + recent
    operational events (:mod:`raytpu_torch.util.events` incl. its own
    ``dropped_count``). Rate-limited per process; never raises: a
    post-mortem writer that crashes the crashing process helps no one.
    Returns the written path, or None when skipped/failed.

    The port has no circuit breakers (no ``resilience`` module), so
    ``breakers`` is ``{}``: the JAX function's own fallback."""
    try:
        now = time.monotonic()
        with _postmortem_lock:
            if now - _last_postmortem[0] < _POSTMORTEM_MIN_INTERVAL_S:
                return None
            _last_postmortem[0] = now
        payload: Dict[str, Any] = {
            "reason": str(reason),
            "wall_time": time.time(),
            "pid": os.getpid(),
            "identity": list(_identity),
            "task_events": get_events()[-int(last_n):],
            "task_events_dropped": dropped_count(),
            "breakers": {},
        }
        from raytpu_torch.util import events as _events

        payload["recent_events"] = _events.recent_events()[-200:]
        payload["events_dropped"] = _events.dropped_count()
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(
            log_dir, f"postmortem_{os.getpid()}_{int(time.time())}.json")
        with open(path, "w") as f:
            json.dump(payload, f, default=str)
        return path
    except Exception:
        return None
