"""The driver's records: every process's task events and metrics, in one
store at the driver; the counterpart of the JAX head's flight-recorder
and metrics sections (``raytpu/cluster/head.py:487-493``,
``:1700-1760``).

The JAX package ships a worker's records to its node daemon and from
there to the head. The port has neither: its driver (the process the
runtime did not start) holds the store, and every process of the tree
reaches it as it reaches the driver's registry socket.

- **Identity.** Each process stamps its records with an id of its own,
  drawn by whoever starts it and set after the fork
  (:func:`set_identity`): a forked child never keeps its server's. Task
  events carry it as ``worker_id`` (``node_id`` is the port's one host,
  :func:`node_id`); metric frames as ``worker:<id>.<pid hex>`` (the
  driver's as ``driver:<id>``), which is what the store's per-origin
  sequence numbers and :meth:`~raytpu_torch.util.tsdb.MetricStore.mark_proc_dead`
  key by. A pid that the host reuses gets a new id, so a reaped
  worker's tombstone never drops a live series.
- **Carriers.** A ship is one blob (:func:`collect_ship`): this
  process's drained event ring, delta frames and (with profiling armed)
  continuous-profile frames, with their drop counts. A task worker's
  ship rides the done message it already sends
  (:mod:`raytpu_torch.runtime.task_pool`); an actor process (or one
  that joined the tree) ships on a timer of ``METRICS_SHIP_PERIOD_S``
  and once at a clean exit (:func:`start_shipping`,
  :func:`stop_shipping`), through the registry socket. A failed ship is requeued. A process that is
  killed loses only what it had not shipped.
- **The driver.** :func:`ingest` folds a ship into the driver's
  :class:`~raytpu_torch.util.task_events.TaskEventStore`,
  :class:`~raytpu_torch.util.tsdb.MetricStore` and
  :class:`~raytpu_torch.util.profstore.ProfileStore`, and measures it
  (bytes, the lag from each event's stamp to its arrival:
  :func:`ship_stats`). The driver's own ring, metrics and profile frames
  are folded lazily, before each query and at each ship
  (:func:`fold_local`). :func:`proc_dead` tombstones a reaped worker's
  series and profile frames, as the JAX head does a dead node's
  (``raytpu/cluster/head.py:1623``).

:mod:`raytpu_torch.state` reads the store; a process other than the
driver runs its queries in the driver (:func:`at_driver`).
"""

from __future__ import annotations

import hashlib
import importlib
import os
import socket
import threading
import time
import uuid
from collections import deque
from typing import Optional, Tuple

from raytpu_torch.cluster import constants
from raytpu_torch.runtime import serialization
from raytpu_torch.util import metrics, profiler, profstore, task_events, tsdb
from raytpu_torch.util.profiler import profiling_enabled

# The JAX package's store sizes (raytpu/core/config.py:330-362).
TASK_EVENT_STORE_PER_KIND = 4096
TASK_EVENT_STORE_EVENTS_PER_ENTITY = 256
METRICS_STORE_MAX_BYTES = 8 * 1024 * 1024
METRICS_FINE_STEP_S = 5.0
METRICS_FINE_SLOTS = 120
METRICS_COARSE_STEP_S = 30.0
METRICS_COARSE_SLOTS = 120
PROFILE_STORE_MAX_BYTES = 4 * 1024 * 1024
PROFILE_RING_SLOTS = 120
# Lags kept for ship_stats (the newest).
LAGS_KEPT = 65536

_LOCK = threading.Lock()
_STORES: Optional[Tuple[task_events.TaskEventStore, tsdb.MetricStore,
                        profstore.ProfileStore]] = None
_UID = [""]
_STATS = {"ships": 0, "bytes": 0, "events": 0, "frames": 0,
          "profile_frames": 0}
_LAGS: deque = deque(maxlen=LAGS_KEPT)
_STOP = threading.Event()


def _driver() -> bool:
    from raytpu_torch.runtime import api

    return api._REGISTRY is None


def node_id() -> str:
    """The port's one host, as the state API names it: a hex id of the
    host name and the tree (the driver's pid, which every process of
    the tree inherits)."""
    from raytpu_torch.runtime import object_store

    key = f"{socket.gethostname()}/{object_store.tree()}"
    return hashlib.sha1(key.encode()).hexdigest()[:28]


def new_uid() -> str:
    """An id for a process about to start (12 hex digits)."""
    return uuid.uuid4().hex[:12]


def set_identity(driver: bool, uid: Optional[str] = None) -> str:
    """Stamp this process's records with ``uid`` (a new one where None):
    its task events' ``worker_id`` and its metric frames' origin."""
    uid = uid or new_uid()
    _UID[0] = uid
    task_events.set_emitter_identity(node_id=node_id(), worker_id=uid)
    metrics.set_shipper_identity(f"driver:{uid}" if driver
                                 else f"worker:{uid}.{os.getpid():012x}")
    return uid


def identity() -> str:
    """This process's id ("" until :func:`set_identity`)."""
    return _UID[0]


# ---- every process: what it ships -------------------------------------


def collect_ship(force: bool = False) -> Optional[bytes]:
    """This process's pending records as one ship: its drained event
    ring, its metric deltas (collected at most once a
    ``METRICS_SHIP_PERIOD_S`` unless ``force``) and its profile frames,
    with their drop counts; None when there is nothing."""
    events, dropped, frames, frames_dropped = [], 0, [], 0
    prof, prof_dropped = [], 0
    if task_events.ship_enabled():
        events, dropped = task_events.drain()
    if metrics.enabled():
        metrics.collect(min_interval_s=constants.METRICS_SHIP_PERIOD_S,
                        force=force)
        frames, frames_dropped = metrics.drain()
    if profiling_enabled():
        prof, prof_dropped = profiler.prof_drain()
    if not (events or dropped or frames or frames_dropped or prof
            or prof_dropped):
        return None
    return serialization.dumps((events, dropped, frames, frames_dropped,
                                prof, prof_dropped))


def requeue_ship(blob: bytes) -> None:
    """Put a ship that did not reach the driver back in this process's
    buffers (oldest first, drop counts exact)."""
    events, dropped, frames, frames_dropped, prof, prof_dropped = \
        serialization.loads(blob)
    task_events.requeue(events, dropped)
    metrics.requeue(frames, frames_dropped)
    profiler.prof_requeue(prof, prof_dropped)


def ship() -> None:
    """Send this process's pending records (its metric deltas collected
    now) to the driver (in the driver: fold them); requeue them when
    the driver cannot be reached."""
    blob = collect_ship(force=True)
    if blob is None:
        return
    if _driver():
        ingest(blob)
        return
    from raytpu_torch.runtime import api

    try:
        api._ask_registry("ship", blob)
    except (OSError, EOFError):
        requeue_ship(blob)


def _ship_loop() -> None:
    while not _STOP.wait(constants.METRICS_SHIP_PERIOD_S):
        ship()


def start_shipping() -> None:
    """In an actor process (or one that joined the tree), at its start:
    ship every ``METRICS_SHIP_PERIOD_S`` from a thread of its own, when
    any record is armed (its environment's flags)."""
    if task_events.ship_enabled() or metrics.enabled() or \
            profiling_enabled():
        threading.Thread(target=_ship_loop, name="raytpu-torch-ship",
                         daemon=True).start()


def stop_shipping() -> None:
    """In an actor process, at its clean exit: the last ship."""
    _STOP.set()
    ship()


def proc_dead(uid: str) -> None:
    """A worker of id ``uid`` was reaped: the driver drops its series
    and profile frames and rejects its late frames. Sites guard with
    ``metrics.enabled()`` (or ``profiling_enabled()``)."""
    if _driver():
        tombstone(uid)
        return
    from raytpu_torch.runtime import api

    try:
        api._ask_registry("proc_dead", uid)
    except (OSError, EOFError):
        pass  # the driver is gone, and its store with it


# ---- the driver ---------------------------------------------------------


def _stores() -> Tuple[task_events.TaskEventStore, tsdb.MetricStore,
                       profstore.ProfileStore]:
    global _STORES
    with _LOCK:
        if _STORES is None:
            _STORES = (
                task_events.TaskEventStore(
                    per_kind=TASK_EVENT_STORE_PER_KIND,
                    events_per_entity=TASK_EVENT_STORE_EVENTS_PER_ENTITY),
                tsdb.MetricStore(
                    max_bytes=METRICS_STORE_MAX_BYTES,
                    fine_step_s=METRICS_FINE_STEP_S,
                    fine_slots=METRICS_FINE_SLOTS,
                    coarse_step_s=METRICS_COARSE_STEP_S,
                    coarse_slots=METRICS_COARSE_SLOTS),
                profstore.ProfileStore(max_bytes=PROFILE_STORE_MAX_BYTES,
                                       ring_slots=PROFILE_RING_SLOTS))
        return _STORES


def tombstone(uid: str) -> None:
    """In the driver: drop the series and profile frames of the process
    of id ``uid`` and reject its late frames."""
    _, metric_store, profile_store = _stores()
    metric_store.mark_proc_dead(uid)
    profile_store.mark_proc_dead(uid)


def ingest(blob: bytes) -> None:
    """Fold one ship into the driver's stores, with the driver's own
    ring (so that its events are never staler than the last ship)."""
    events, dropped, frames, frames_dropped, prof, prof_dropped = \
        serialization.loads(blob)
    now = time.time()
    event_store, metric_store, profile_store = _stores()
    if events or dropped:
        event_store.add_batch(events, dropped)
    if frames_dropped:
        metric_store.note_upstream_drops(frames_dropped)
    if frames:
        metric_store.push(frames)
    if prof_dropped:
        # Attributed to the shipping process, as the JAX head attributes
        # them to their carrier.
        profile_store.note_upstream_drops(prof_dropped,
                                          proc=prof[0][0] if prof else "")
    if prof:
        profile_store.push(prof)
    with _LOCK:
        _STATS["ships"] += 1
        _STATS["bytes"] += len(blob)
        _STATS["events"] += len(events)
        _STATS["frames"] += len(frames)
        _STATS["profile_frames"] += len(prof)
        _LAGS.extend(now - ev["ts"] for ev in events)
    _fold_events()


def _fold_events() -> None:
    if task_events.ship_enabled():
        batch, dropped = task_events.drain()
        if batch or dropped:
            _stores()[0].add_batch(batch, dropped)


def fold_local() -> None:
    """Fold the driver's own ring, metric deltas and profile frames into
    its stores: lazily, before every query (``head.py:1705-1712``,
    ``:1745-1769``)."""
    _fold_events()
    if metrics.enabled():
        metrics.collect(force=True)
        frames, dropped = metrics.drain()
        metric_store = _stores()[1]
        if dropped:
            metric_store.note_upstream_drops(dropped)
        if frames:
            metric_store.push(frames)
    if profiling_enabled():
        frames, dropped = profiler.prof_drain()
        profile_store = _stores()[2]
        if dropped:
            profile_store.note_upstream_drops(
                dropped, proc=metrics.shipper_identity())
        if frames:
            profile_store.push(frames)


def event_store() -> task_events.TaskEventStore:
    """The driver's event store, with its own ring folded in."""
    fold_local()
    return _stores()[0]


def metric_store() -> tsdb.MetricStore:
    """The driver's metric store, with its own deltas folded in."""
    fold_local()
    return _stores()[1]


def profile_store() -> profstore.ProfileStore:
    """The driver's profile store, with its own frames folded in."""
    fold_local()
    return _stores()[2]


def reset() -> None:
    """Drop the driver's stores and ship counts (tests)."""
    global _STORES
    with _LOCK:
        _STORES = None
        _STATS.update(ships=0, bytes=0, events=0, frames=0,
                      profile_frames=0)
        _LAGS.clear()


def at_driver(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run in the driver: here in the driver,
    else over the registry socket (``fn`` a module-level function of
    ``raytpu_torch``, found there by name)."""
    if _driver():
        return fn(*args, **kwargs)
    from raytpu_torch.runtime import api

    return api._ask_registry("at_driver", fn.__module__, fn.__qualname__,
                             args, kwargs)


def run_at_driver(module: str, name: str, args, kwargs):
    """The registry's side of :func:`at_driver`."""
    if not module.startswith("raytpu_torch."):
        raise ValueError(f"{module}.{name}: not a function of raytpu_torch")
    return getattr(importlib.import_module(module), name)(*args, **kwargs)


def _prometheus_text() -> str:
    return metric_store().prometheus_text()


def prometheus_text() -> str:
    """The driver's TSDB exposition: every process's shipped series."""
    return at_driver(_prometheus_text)


def _profile_query(mode: str, since_s: float, until_s: float,
                   recent_s: float) -> dict:
    store = profile_store()
    if mode == "diff":
        return store.diff(float(recent_s))
    return store.merged(float(since_s), float(until_s))


def profile_query(mode: str = "merged", since_s: float = 600.0,
                  until_s: float = 0.0, recent_s: float = 120.0) -> dict:
    """The driver's profile store: one merged flamegraph of the frames
    in ``[now - since_s, now - until_s]`` (``mode="merged"``), or the
    last ``recent_s`` seconds minus the ``recent_s`` before them
    (``"diff"``); the JAX head's ``profile_query``
    (``raytpu/cluster/head.py:1772``)."""
    return at_driver(_profile_query, mode, since_s, until_s, recent_s)


def _profile_stats() -> dict:
    store = profile_store()
    return {"store": store.stats(), "procs": store.proc_rows()}


def profile_stats() -> dict:
    """The driver's profile store's counters and its per-process rows
    (the JAX head's ``profile_stats``)."""
    return at_driver(_profile_stats)


def _ship_stats() -> dict:
    with _LOCK:
        stats, lags = dict(_STATS), sorted(_LAGS)
    if lags:
        stats["lag_s"] = {
            "count": len(lags), "p50": lags[len(lags) // 2],
            "p95": lags[min(len(lags) - 1, int(0.95 * len(lags)))],
            "max": lags[-1]}
    return stats


def ship_stats() -> dict:
    """What reached the driver: ships, their bytes, events, metric
    frames and profile frames, and the lag from each event's stamp to
    its arrival (seconds, ``lag_s``: count, p50, p95, max, of the newest
    ``LAGS_KEPT``)."""
    return at_driver(_ship_stats)
