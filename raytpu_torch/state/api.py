"""Introspection of the port's process tree: the state API; the
counterpart of ``raytpu/state/api.py``, with its names.

Reference analogue: ``python/ray/util/state/api.py`` (``ray list actors /
tasks / objects / nodes / placement-groups`` and summaries) backed by the
GCS task-event store. The port reads two planes and merges them, as the
JAX package's cluster mode does:

- **The flight recorder**: the driver's
  :class:`~raytpu_torch.util.task_events.TaskEventStore` and
  :class:`~raytpu_torch.util.tsdb.MetricStore`, fed by every process of
  the tree (:mod:`raytpu_torch.runtime.records`): lifecycle timelines of
  tasks, actors, objects and serve requests, and every process's
  metric series;
- **the driver's live tables**: its task pool's queued and running
  tasks, the actors it owns, the objects it owns.

Every function runs in the driver: called in another process of the
tree, it runs there over the registry socket
(:func:`~raytpu_torch.runtime.records.at_driver`). ``detail=True``
attaches the per-entity event timeline (ts-sorted), and
``state``/``node``/``name`` filter in the store.

What the port has none of reads empty: ``list_placement_groups`` is
``[]`` (no placement groups), ``list_nodes`` gives the one host.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

from raytpu_torch.runtime import records


def _in_driver(fn):
    """Run ``fn`` in the driver, wherever it is called."""
    @functools.wraps(fn)
    def in_driver(*args, **kwargs):
        return records.at_driver(fn, *args, **kwargs)

    return in_driver


def _recorder_list(kind: str, state: Optional[str] = None,
                   node: Optional[str] = None, name: Optional[str] = None,
                   limit: int = 1000, detail: bool = False) -> List[dict]:
    return records.event_store().list(kind, state=state, node=node,
                                      name=name, limit=limit, detail=detail)


def _events_by_id(kind: str) -> Dict[str, list]:
    return {r["id"]: r.get("events", [])
            for r in _recorder_list(kind, limit=0, detail=True)}


def _norm_task(rec: dict) -> Dict[str, Any]:
    """Recorder record -> the state-API task row shape."""
    out: Dict[str, Any] = {
        "task_id": rec.get("id"),
        "name": rec.get("name"),
        "state": rec.get("state"),
        "node_id": rec.get("node_id"),
        "attempt": rec.get("attempt", 0),
        "num_events": rec.get("num_events", 0),
        "first_ts": rec.get("first_ts"),
        "last_ts": rec.get("last_ts"),
    }
    for k in ("error", "trace_id", "parent_task_id", "worker_id"):
        if rec.get(k):
            out[k] = rec[k]
    if "events" in rec:
        out["events"] = rec["events"]
    return out


def _match(row: dict, state: Optional[str], node: Optional[str],
           name: Optional[str]) -> bool:
    if state is not None and row.get("state") != state:
        return False
    if node and not str(row.get("node_id") or "").startswith(node):
        return False
    if name and name not in str(row.get("name") or ""):
        return False
    return True


# -- listings -----------------------------------------------------------------


@_in_driver
def list_nodes(detail: bool = False) -> List[Dict[str, Any]]:
    """The port's one host: its id, and the driver's ledger's resources
    (CPUs, cards, custom ones) in all and not held."""
    from raytpu_torch.runtime import api

    res = api._ledger().resources()
    node = {"node_id": records.node_id(), "alive": True,
            "resources": res["total"], "available": res["available"]}
    if detail:
        node["events"] = _events_by_id("node").get(node["node_id"], [])
    return [node]


@_in_driver
def list_actors(state: Optional[str] = None, node: Optional[str] = None,
                name: Optional[str] = None,
                detail: bool = False) -> Dict[str, Any]:
    """Actors of every process of the tree (their owners record their
    CREATED and DEAD), with the driver's own live actors. Returns
    ``{"actors": [...], "partial": bool, "errors": [...]}``: the port
    reads one store, so a listing is never partial."""
    from raytpu_torch.runtime import api

    actors: Dict[str, Dict[str, Any]] = {}
    for rec in _recorder_list("actor", limit=0):
        actors[rec["id"]] = {
            "actor_id": rec["id"], "name": rec.get("name"),
            "state": "ALIVE" if rec["state"] == "CREATED" else rec["state"],
            "node_id": rec.get("node_id"), "worker_id": rec.get("worker_id"),
            "error": rec.get("error")}
    with api._HANDLES_LOCK:
        owned = [h._worker for h in list(api._OWNED.values())]
    for w in owned:
        actors.setdefault(w.actor_id, {
            "actor_id": w.actor_id, "name": w.label,
            "state": "DEAD" if w.dead is not None else "ALIVE",
            "node_id": records.node_id(), "worker_id": w.uid,
            "error": w.dead})["pid"] = w.pid
    rows = [a for a in actors.values() if _match(a, state, node, name)]
    if detail:
        events = _events_by_id("actor")
        for a in rows:
            a["events"] = events.get(a["actor_id"], [])
    return {"actors": rows, "partial": False, "errors": []}


@_in_driver
def list_tasks(state: Optional[str] = None, node: Optional[str] = None,
               name: Optional[str] = None, detail: bool = False,
               limit: int = 1000) -> List[Dict[str, Any]]:
    """Tasks: flight-recorder records (full lifecycle, survives task
    completion; the pool's tasks and every process's actor calls)
    merged with the pool's live table (queued and running tasks, which
    covers the recorder-disabled case)."""
    from raytpu_torch.runtime import api

    live = [] if api._POOL is None else api._POOL.live()
    live = [t for t in live if _match(t, state, node, name)]
    out = [_norm_task(r) for r in _recorder_list(
        "task", state=state, node=node, name=name, limit=limit,
        detail=detail)]
    have = {t["task_id"] for t in out}
    out.extend(t for t in live if t["task_id"] not in have)
    return out[:limit] if limit else out


@_in_driver
def list_objects(detail: bool = False) -> List[Dict[str, Any]]:
    """The objects the driver owns (with their sealed bytes), then those
    every other process recorded (PUT in its owner's table; their bytes
    stay with their owners: ``size_bytes`` None)."""
    from raytpu_torch.runtime import refcount

    with refcount.READY:
        entries = {oid: e.sealed.size() if e.sealed is not None else 0
                   for oid, e in refcount.OWNED.items()
                   if e.state == refcount.DONE}
    rows = [{"object_id": oid, "size_bytes": n} for oid, n in entries.items()]
    recorded = _recorder_list("object", limit=0, detail=detail)
    by_id = {r["id"]: r for r in recorded}
    rows += [{"object_id": r["id"], "size_bytes": None,
              "worker_id": r.get("worker_id")}
             for r in recorded if r["id"] not in entries]
    if detail:
        for row in rows:
            rec = by_id.get(row["object_id"])
            if rec:
                row["events"] = rec.get("events", [])
    return rows


def list_placement_groups() -> List[Dict[str, Any]]:
    """The driver's ledger's placement groups, as the JAX local
    backend's rows."""
    from raytpu_torch.runtime import api

    return [{"placement_group_id": g["id"], "state": g["state"],
             "strategy": g["strategy"], "bundles": g["bundles"]}
            for g in api._ledger().groups()]


@_in_driver
def list_events(severity: Optional[str] = None,
                label: Optional[str] = None,
                limit: int = 200) -> List[Dict[str, Any]]:
    """Structured operational events of the driver
    (:mod:`raytpu_torch.util.events`)."""
    from raytpu_torch.util import events

    if int(limit) <= 0:
        return []
    return events.recent_events(severity, label)[-int(limit):]


# -- metrics ------------------------------------------------------------------


@_in_driver
def query_metrics(name: str, tags: Optional[Dict[str, str]] = None,
                  agg: str = "sum", since_s: float = 600.0,
                  step: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """Aggregate one metric across every process of the tree from the
    driver's TSDB (``{"name", "kind", "agg", "step", "series_matched",
    "points"}``)."""
    return records.metric_store().query(name, tags=tags, agg=agg,
                                        since_s=since_s, step=step)


@_in_driver
def list_metric_series(prefix: Optional[str] = None) -> \
        Optional[List[Dict[str, Any]]]:
    """Every live series (name, tags, kind) the driver's TSDB holds,
    optionally filtered by name prefix."""
    return records.metric_store().series(prefix)


def rpc_stage_summary(since_s: float = 600.0) -> Dict[str, Any]:
    """Per-stage RPC dispatch timing from ``raytpu_rpc_stage_seconds``,
    grouped ``{method: {stage: {"p50", "p95"}}}``. Empty on the port,
    which mints no such series; kept for the JAX package's shape."""
    series = list_metric_series("raytpu_rpc_stage_seconds") or []
    combos = sorted({(s["tags"].get("stage", ""),
                      s["tags"].get("method", "")) for s in series})
    out: Dict[str, Any] = {}
    for stage, method in combos:
        if not stage:
            continue
        tags = {"stage": stage, "method": method}
        row: Dict[str, Any] = {}
        for q in ("p50", "p95"):
            res = query_metrics("raytpu_rpc_stage_seconds", tags=tags,
                                agg=q, since_s=since_s)
            pts = [p for p in (res or {}).get("points") or []
                   if p[1] is not None]
            row[q] = pts[-1][1] if pts else None
        out.setdefault(method, {})[stage] = row
    return out


# -- summaries & timelines ----------------------------------------------------


@_in_driver
def summary_tasks() -> Dict[str, Any]:
    """Counts by state x task name plus queue->run latency percentiles
    from SUBMITTED->RUNNING event deltas (the ``ray summary tasks``
    shape)."""
    return records.event_store().summary("task")


@_in_driver
def summary_actors() -> Dict[str, Any]:
    return records.event_store().summary("actor")


@_in_driver
def get_timeline(entity_id: str, kind: str = "task") -> Optional[dict]:
    """One entity's full lifecycle record (ts-sorted events, attempt
    numbers, trace-id cross-link). Accepts a unique id prefix."""
    return records.event_store().get(kind, entity_id)


def get_request_timeline(request_id: str) -> Optional[dict]:
    """One serve request's stitched lifecycle waterfall: every
    RECEIVED->...->FINISHED/ABORTED/FAILED transition any process
    emitted under this id, ts-sorted, with deployment/tenant
    attribution. Accepts a unique id prefix."""
    return get_timeline(request_id, kind="request")


@_in_driver
def list_serve_requests(deployment: Optional[str] = None,
                        tenant: Optional[str] = None,
                        state: Optional[str] = None,
                        limit: int = 100,
                        detail: bool = False) -> List[Dict[str, Any]]:
    """Serve request records from the flight recorder, newest first,
    filtered by deployment/tenant/lifecycle state."""
    out = []
    for r in _recorder_list("request", state=state, limit=0, detail=detail):
        if deployment and r.get("deployment") != deployment:
            continue
        if tenant and r.get("tenant") != tenant:
            continue
        out.append(r)
    return out[:max(0, int(limit))] if limit else out


def summarize_tasks() -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for t in list_tasks():
        counts[t["state"]] = counts.get(t["state"], 0) + 1
    return counts


def object_summary() -> Dict[str, Any]:
    """The objects of :func:`list_objects`: their count and the bytes of
    those the driver owns."""
    objs = list_objects()
    return {
        "count": len(objs),
        "total_bytes": sum(o["size_bytes"] or 0 for o in objs),
    }
