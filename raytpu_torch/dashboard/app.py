"""The dashboard: one HTTP server over the state API, the metrics, the
timeline, stack dumps and profiles; the port of
``raytpu/dashboard/app.py``.

Reference analogue: ``dashboard/head.py:81`` / ``dashboard/agent.py:28``
— the JAX package's server-rendered essentials (cluster summary, node /
actor / task / placement-group tables, object-store summary, a
chrome-trace timeline download, Prometheus metrics, live stacks, CPU and
memory flamegraphs, the continuous-profile store), every page generated
from the state API the CLI uses.

What differs from the JAX package:

- the server is :class:`~raytpu_torch.util.http_server.HttpServer` (the
  standard library's asyncio streams: the chip machine has no aiohttp),
  with the JAX package's routes, statuses, JSON keys, Content-Types and
  per-section ``{"error": ...}`` shape;
- it runs in any process of a driver's tree (the driver, or one that
  joined with ``init(address=...)``): every read runs in the driver,
  whose store holds every process's records
  (:mod:`raytpu_torch.runtime.records`); ``/metrics`` is the driver's
  TSDB and ``/api/profile`` its profile store, where the JAX package
  asks its head;
- ``/stacks``, ``/profile`` and ``/memprofile`` ask every live process
  of the tree at once (:mod:`raytpu_torch.util.stack_dump`), with the
  port's one host as the node; ``?worker=`` takes a process id prefix
  (``daemon``: the driver);
- the summary's node table reads the state API's rows (``node_id``,
  ``alive``), where the JAX page reads ``raytpu.nodes()``'s cluster
  keys;
- ``/logs`` and ``/logs/{node}/{name}`` are not served: they read a
  node daemon's per-process log files, which the port does not write
  (ROADMAP.md, with the cluster).

Start it with ``python -m raytpu_torch dashboard --address ADDRESS`` or
embed :class:`DashboardServer` in a driver.
"""

from __future__ import annotations

import html
import json
from typing import Any, Dict, List, Optional

from raytpu_torch.util.http_server import (HTML, HttpRequest, HttpServer,
                                           Reply, Routes)

_PAGE = """<!doctype html>
<html><head><title>raytpu dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2em; color: #222; }}
 h1 {{ font-size: 1.4em; }} h2 {{ font-size: 1.1em; margin-top: 1.5em; }}
 table {{ border-collapse: collapse; min-width: 40em; }}
 th, td {{ border: 1px solid #ccc; padding: 4px 10px; text-align: left;
           font-size: 0.9em; }}
 th {{ background: #f0f0f0; }}
 .pill {{ padding: 1px 8px; border-radius: 8px; font-size: 0.85em; }}
 .ok {{ background: #d8f5d8; }} .bad {{ background: #f5d8d8; }}
 nav a {{ margin-right: 1em; }}
</style></head>
<body>
<h1>raytpu dashboard</h1>
<nav><a href="/">summary</a><a href="/timeline">timeline.json</a>
<a href="/metrics">metrics</a><a href="/api/summary">api</a></nav>
{body}
</body></html>"""


def _table(headers: List[str], rows: List[List[Any]]) -> str:
    head = "".join(f"<th>{html.escape(str(h))}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{cell}</td>" for cell in row) + "</tr>"
        for row in rows)
    return f"<table><tr>{head}</tr>{body}</table>"


def _pill(ok: bool, text: str) -> str:
    return f'<span class="pill {"ok" if ok else "bad"}">{text}</span>'




class DashboardServer:
    """Serves the dashboard of the tree this process belongs to (its
    driver, or a process that joined it)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._host = host
        self._port = port
        self._server: Optional[HttpServer] = None
        self.url: Optional[str] = None

    # -- data --------------------------------------------------------------

    def _snapshot(self) -> Dict[str, Any]:
        from raytpu_torch.state import api as state

        out: Dict[str, Any] = {}
        for key, fn in (
            ("nodes", state.list_nodes),
            # list_actors wraps its rows with partial/errors markers;
            # the dashboard sections keep the flat-list shape.
            ("actors", lambda: state.list_actors().get("actors", [])),
            ("tasks", lambda: state.list_tasks()),
            ("placement_groups", state.list_placement_groups),
            ("task_summary", state.summarize_tasks),
            ("objects", state.object_summary),
            ("events", lambda: state.list_events(limit=50)),
        ):
            try:
                out[key] = fn()
            except Exception as e:  # degrade per-section, never 500
                out[key] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- pages -------------------------------------------------------------

    def _render_summary(self) -> str:
        snap = self._snapshot()
        parts = []

        nodes = snap["nodes"]
        if isinstance(nodes, list):
            alive = sum(1 for n in nodes if n.get("alive"))
            parts.append(f"<h2>Nodes ({alive}/{len(nodes)} alive)</h2>")
            parts.append(_table(
                ["node", "alive", "address", "resources", "available"],
                [[n.get("node_id", "")[:12],
                  _pill(bool(n.get("alive")),
                        "alive" if n.get("alive") else "dead"),
                  html.escape(str(n.get("address", ""))),
                  html.escape(json.dumps(n.get("resources", {}))),
                  html.escape(json.dumps(n.get("available", {})))]
                 for n in nodes]))

        ts = snap["task_summary"]
        if isinstance(ts, dict) and "error" not in ts:
            parts.append("<h2>Tasks</h2>")
            parts.append(_table(["state", "count"],
                                [[html.escape(k), v]
                                 for k, v in sorted(ts.items())]))

        actors = snap["actors"]
        if isinstance(actors, list):
            parts.append(f"<h2>Actors ({len(actors)})</h2>")
            parts.append(_table(
                ["actor", "name", "state", "node"],
                [[a.get("actor_id", "")[:12],
                  html.escape(str(a.get("name") or "")),
                  _pill(a.get("state") == "ALIVE",
                        str(a.get("state", "?"))),
                  str(a.get("node_id", ""))[:12]]
                 for a in actors[:200]]))

        pgs = snap["placement_groups"]
        if isinstance(pgs, list) and pgs:
            parts.append(f"<h2>Placement groups ({len(pgs)})</h2>")
            parts.append(_table(
                ["id", "strategy", "bundles"],
                [[p.get("id", "")[:12], html.escape(str(p.get("strategy"))),
                  html.escape(json.dumps(p.get("bundles")))]
                 for p in pgs]))

        events = snap.get("events")
        if isinstance(events, list) and events:
            parts.append(f"<h2>Events ({len(events)} recent)</h2>")
            parts.append(_table(
                ["severity", "label", "message"],
                [[_pill(e.get("severity") not in ("ERROR", "FATAL"),
                        html.escape(str(e.get("severity", "?")))),
                  html.escape(str(e.get("label", ""))),
                  html.escape(str(e.get("message", "")))]
                 for e in events[-50:]]))

        objs = snap["objects"]
        if isinstance(objs, dict) and "error" not in objs:
            parts.append("<h2>Object store</h2>")
            parts.append(_table(["key", "value"],
                                [[html.escape(k), html.escape(str(v))]
                                 for k, v in objs.items()]))
        return _PAGE.format(body="".join(parts))

    def _collect_stacks(self, worker: Optional[str],
                        node_filter: Optional[str]) -> Dict[str, Any]:
        """Every live process's stack, asked at once."""
        from raytpu_torch.util.stack_dump import collect_cluster_stacks

        return collect_cluster_stacks(worker=worker, node_filter=node_filter)

    def _collect_profile(self, worker: Optional[str],
                         node_filter: Optional[str],
                         duration_s: float, hz: float,
                         include_idle: bool) -> Dict[str, Any]:
        """A sampling profile of every live process (one duration_s
        total: every process samples in parallel)."""
        from raytpu_torch.util.stack_dump import fanout_process_call

        return fanout_process_call(
            "profile", duration_s, hz, include_idle, worker=worker,
            node_filter=node_filter, timeout=duration_s + 60.0)

    def _collect_memprofile(self, worker: Optional[str],
                            node_filter: Optional[str],
                            duration_s: float, trace_frames: int,
                            stop_after: bool) -> Dict[str, Any]:
        """An allocation profile of every live process (one shared
        window, the same fan-out as _collect_profile)."""
        from raytpu_torch.util.stack_dump import fanout_process_call

        return fanout_process_call(
            "memory_profile", duration_s, trace_frames, 40, stop_after,
            worker=worker, node_filter=node_filter,
            timeout=duration_s + 60.0)

    # -- routes ------------------------------------------------------------

    def _index(self, request: HttpRequest) -> Reply:
        return Reply.text(200, self._render_summary(), HTML)

    def _api_summary(self, request: HttpRequest) -> Reply:
        return Reply.json(self._snapshot())

    def _api_section(self, request: HttpRequest, section: str) -> Reply:
        snap = self._snapshot()
        if section not in snap:
            return Reply.text(404, f"no section {section}")
        return Reply.json({section: snap[section]})

    def _timeline(self, request: HttpRequest) -> Reply:
        from raytpu_torch.runtime import api

        return Reply.text(200, json.dumps(api.timeline()),
                          "application/json; charset=utf-8",
                          [("Content-Disposition",
                            "attachment; filename=timeline.json")])

    def _api_trace(self, request: HttpRequest) -> Reply:
        """Every process's span buffer, fanned out down the tree from the
        driver, merged into one chrome trace."""
        from raytpu_torch.runtime import records
        from raytpu_torch.util.tracing import cluster_timeline

        return Reply.text(200, json.dumps(records.at_driver(
            cluster_timeline)), "application/json; charset=utf-8",
            [("Content-Disposition", "attachment; filename=trace.json")])

    def _metrics(self, request: HttpRequest) -> Reply:
        """Prometheus exposition of the driver's TSDB: every process's
        shipped series behind one scrape target. ``?local=1`` is the
        JAX package's per-process ``prometheus_client`` registry, which
        the port has none of."""
        from raytpu_torch.runtime import records

        if request.query.get("local") != "1":
            return Reply.text(200, records.prometheus_text())
        return Reply.text(200, "# prometheus_client unavailable\n")

    def _api_metrics_query(self, request: HttpRequest) -> Reply:
        """Time series from the driver's TSDB, aggregated over every
        process. ?name= (required), ?agg=sum|max|min|avg|rate|p50..p99,
        ?since=<seconds>, ?step=<seconds>, ?tag.<key>=<val>."""
        from raytpu_torch.state import api as state

        q = request.query
        name = q.get("name")
        if not name:
            return Reply.text(400, "name is required")
        try:
            since_s = float(q.get("since", 600.0))
            step = float(q["step"]) if q.get("step") else None
        except ValueError:
            return Reply.text(400, "since/step must be numbers")
        tags = {k[4:]: v for k, v in q.items()
                if k.startswith("tag.")} or None
        try:
            data = state.query_metrics(name, tags=tags,
                                       agg=q.get("agg", "sum"),
                                       since_s=since_s, step=step)
        except Exception as e:
            return Reply.json({"error": f"{type(e).__name__}: {e}"}, 503)
        if data is None:
            return Reply.text(503, "head unreachable")
        return Reply.json(data)

    def _api_metrics_series(self, request: HttpRequest) -> Reply:
        """Every live (name, tags, kind) series of the driver's TSDB;
        ?prefix= filters by metric-name prefix."""
        from raytpu_torch.state import api as state

        try:
            data = state.list_metric_series(
                request.query.get("prefix") or None)
        except Exception as e:
            return Reply.json({"error": f"{type(e).__name__}: {e}"}, 503)
        if data is None:
            return Reply.text(503, "head unreachable")
        return Reply.json(data)

    def _stacks(self, request: HttpRequest) -> Reply:
        """Live stack dumps of every process of the tree. ?worker=<id
        prefix|daemon>, ?node=<node id prefix> narrow the dump."""
        q = request.query
        return Reply.json(self._collect_stacks(q.get("worker") or None,
                                               q.get("node") or None))

    def _profile(self, request: HttpRequest) -> Reply:
        """On-demand CPU flamegraph of the live processes. Query params:
        ?worker=<id prefix|daemon>, ?node=<id prefix>, ?duration=<s,
        default 2>, ?hz=<default 50>, ?idle=1 (keep parked threads),
        ?format=svg|json|collapsed."""
        from raytpu_torch.util.profiler import (flamegraph_svg,
                                                merge_collapsed,
                                                to_collapsed_text)

        q = request.query
        try:
            duration = float(q.get("duration", 2.0))
            hz = float(q.get("hz", 50.0))
        except ValueError:
            return Reply.text(400, "duration/hz must be numbers")
        include_idle = q.get("idle", "0") == "1"
        fmt = q.get("format", "svg")
        result = self._collect_profile(q.get("worker") or None,
                                       q.get("node") or None, duration, hz,
                                       include_idle)
        if fmt == "json":
            return Reply.json(result)
        merged = merge_collapsed(
            w.get("profile", {}).get("collapsed", {})
            for node in result.values() if isinstance(node, dict)
            for w in node.values() if isinstance(w, dict))
        if fmt == "collapsed":
            return Reply.text(200, to_collapsed_text(merged), headers=[
                ("Content-Disposition",
                 "attachment; filename=profile.collapsed")])
        n_workers = sum(
            1 for node in result.values() if isinstance(node, dict)
            for w in node.values()
            if isinstance(w, dict) and "profile" in w)
        svg = flamegraph_svg(
            merged, title=f"{n_workers} process(es), {duration:g}s "
                          f"@ {hz:g} Hz"
                          + (" (idle included)" if include_idle else ""))
        return Reply.text(200, svg, "image/svg+xml; charset=utf-8")

    def _memprofile(self, request: HttpRequest) -> Reply:
        """On-demand allocation memory flamegraph of the live processes.
        Query: ?worker=<id prefix|daemon>, ?node=<id prefix>,
        ?duration=<s, default 2>, ?frames=<traceback depth, 16>,
        ?stop=1 (turn tracing off after), ?format=svg|json|table."""
        from raytpu_torch.util.memprofile import top_table
        from raytpu_torch.util.profiler import flamegraph_svg, merge_collapsed

        q = request.query
        try:
            duration = float(q.get("duration", 2.0))
            frames = int(q.get("frames", 16))
        except ValueError:
            return Reply.text(400, "duration/frames must be numbers")
        stop_after = q.get("stop", "0") == "1"
        fmt = q.get("format", "svg")
        result = self._collect_memprofile(q.get("worker") or None,
                                          q.get("node") or None, duration,
                                          frames, stop_after)
        worker_mems = [
            w for node in result.values() if isinstance(node, dict)
            for w in node.values()
            if isinstance(w, dict) and "memory" in w]
        if fmt == "json":
            return Reply.json(result)
        if fmt == "table":
            text = "\n\n".join(top_table(w["memory"]) for w in worker_mems)
            return Reply.text(200, text or "no profiles")
        merged = merge_collapsed(
            w["memory"].get("collapsed", {}) for w in worker_mems)
        total = sum(w["memory"].get("total_kb", 0) for w in worker_mems)
        svg = flamegraph_svg(
            merged, title=f"live python allocations — "
                          f"{len(worker_mems)} process(es), "
                          f"{total:,} KiB traced (weights = KiB)")
        return Reply.text(200, svg, "image/svg+xml; charset=utf-8")

    def _api_profile(self, request: HttpRequest) -> Reply:
        """The continuous-profile store (the driver's ProfileStore, fed
        by every process while RAYTPU_PROFILE_CONTINUOUS=1; no
        on-demand sampling). Query params: ?mode=merged|diff,
        ?since=<s, merged window>, ?recent=<s, diff window>,
        ?format=json|svg|collapsed."""
        from raytpu_torch.runtime import records
        from raytpu_torch.util.profiler import (flamegraph_svg,
                                                to_collapsed_text)

        q = request.query
        mode = q.get("mode", "merged")
        if mode not in ("merged", "diff"):
            return Reply.text(400, "mode must be merged|diff")
        try:
            since_s = float(q.get("since", 600.0))
            recent_s = float(q.get("recent", 120.0))
        except ValueError:
            return Reply.text(400, "since/recent must be numbers")
        data = records.profile_query(mode, since_s, 0.0, recent_s)
        fmt = q.get("format", "json")
        if fmt == "json":
            return Reply.json(data)
        collapsed = (data.get("delta") if mode == "diff"
                     else data.get("collapsed")) or {}
        if fmt == "collapsed":
            return Reply.text(200, to_collapsed_text(collapsed), headers=[
                ("Content-Disposition",
                 "attachment; filename=profile.collapsed")])
        if mode == "diff":
            title = (f"cluster profile diff — last {recent_s:g}s "
                     f"minus prior {recent_s:g}s")
        else:
            title = (f"cluster profile — last {since_s:g}s, "
                     f"{data.get('samples', 0)} samples, "
                     f"{len(data.get('procs') or [])} proc(s)")
        # SVG weights must be positive; a diff keeps what got hotter.
        pos = {k: v for k, v in collapsed.items() if v > 0}
        return Reply.text(200, flamegraph_svg(pos, title=title),
                          "image/svg+xml; charset=utf-8")

    def _api_state_list(self, request: HttpRequest, kind: str) -> Reply:
        """Flight-recorder state listings. ?state= ?node= ?name= filter;
        ?detail=1 attaches event timelines."""
        from raytpu_torch.state import api as state

        q = request.query
        detail = q.get("detail", "0") == "1"
        try:
            limit = int(q.get("limit", 100))
        except ValueError:
            return Reply.text(400, "limit must be an integer")
        try:
            if kind == "tasks":
                data = state.list_tasks(state=q.get("state"),
                                        node=q.get("node"),
                                        name=q.get("name"), detail=detail,
                                        limit=limit)
            elif kind == "actors":
                data = state.list_actors(state=q.get("state"),
                                         node=q.get("node"),
                                         name=q.get("name"), detail=detail)
            elif kind == "objects":
                data = state.list_objects(detail=detail)
            elif kind == "nodes":
                data = state.list_nodes(detail=detail)
            else:
                return Reply.text(404, f"unknown kind {kind!r}")
        except Exception as e:
            return Reply.json({"error": f"{type(e).__name__}: {e}"}, 503)
        return Reply.json(data)

    def _api_state_summary(self, request: HttpRequest, kind: str) -> Reply:
        from raytpu_torch.state import api as state

        if kind not in ("tasks", "actors"):
            return Reply.text(404, f"no summary for {kind!r}")
        fn = state.summary_tasks if kind == "tasks" else state.summary_actors
        try:
            data = fn()
        except Exception as e:
            return Reply.json({"error": f"{type(e).__name__}: {e}"}, 503)
        return Reply.json(data)

    def _api_state_timeline(self, request: HttpRequest,
                            entity_id: str) -> Reply:
        from raytpu_torch.state import api as state

        kind = request.query.get("kind", "task")
        try:
            data = state.get_timeline(entity_id, kind)
        except Exception as e:
            return Reply.json({"error": f"{type(e).__name__}: {e}"}, 503)
        if data is None:
            return Reply.text(404,
                              f"no recorded {kind} matching {entity_id!r}")
        return Reply.json(data)

    def routes(self) -> Routes:
        """The JAX dashboard's routes, in its order: /api/trace, the
        metrics and profile APIs and /api/state/* before the
        /api/{section} wildcard, which would 404 them as unknown
        snapshot keys."""
        r = Routes()
        r.get("/", self._index)
        r.get("/api/summary", self._api_summary)
        r.get("/api/trace", self._api_trace)
        r.get("/api/metrics/query", self._api_metrics_query)
        r.get("/api/metrics/series", self._api_metrics_series)
        r.get("/api/profile", self._api_profile)
        r.get("/api/state/summary/{kind}", self._api_state_summary)
        r.get("/api/state/timeline/{entity_id}", self._api_state_timeline)
        r.get("/api/state/{kind}", self._api_state_list)
        r.get("/api/{section}", self._api_section)
        r.get("/timeline", self._timeline)
        r.get("/metrics", self._metrics)
        r.get("/stacks", self._stacks)
        r.get("/profile", self._profile)
        r.get("/memprofile", self._memprofile)
        return r

    # -- server ------------------------------------------------------------

    def start(self) -> str:
        self._server = HttpServer(self.routes(), self._host, self._port,
                                  name="raytpu-dashboard")
        self.url = self._server.start()
        return self.url

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
