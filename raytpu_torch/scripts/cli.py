"""The ``python -m raytpu_torch`` command line; the port of
``raytpu/scripts/cli.py``.

Reference analogue: ``python/ray/scripts/scripts.py`` — ``ray
timeline/memory/job ...``. The commands that read a driver's tree
(``timeline``, ``trace``, ``memory``, ``events``, ``state``, ``serve``,
``stack``, ``profile``, ``memprofile``, ``dashboard``) join it as a
process of their own (``raytpu_torch.runtime.init(address=...)``) and
run their reads in the driver; ``--address`` takes the driver's address
(:func:`raytpu_torch.runtime.api.driver_address`, by default
``$RAYTPU_TORCH_ADDRESS``). An address that no driver answers exits 1
and names it: no command starts a runtime of its own in its place.
``metrics export-config`` and ``job`` are the JAX package's. Arguments
and output are the JAX CLI's.

Not registered: the commands that need a head or nodes (``start``,
``status``, ``top``, ``tenant``, ``logs``, ``up``, ``down``, ``proxy``)
and ``lint`` (ROADMAP.md, with the cluster).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

_ADDRESS_HELP = ("the driver's address (raytpu_torch.runtime.api."
                 "driver_address(); default $RAYTPU_TORCH_ADDRESS)")


def _join(args) -> bool:
    """Join the tree of the driver at ``args.address`` (or the address
    variable's); False, with the reason on stderr, when there is no
    address or no driver answers it."""
    from raytpu_torch.runtime import api

    address = args.address or os.environ.get(api.ADDRESS_ENV)
    if not address:
        print(f"no driver address: pass --address or set "
              f"{api.ADDRESS_ENV}", file=sys.stderr)
        return False
    try:
        api.init(address=address)
    except (ConnectionError, ValueError, RuntimeError) as e:
        print(f"cannot reach a driver at {address}: {e}", file=sys.stderr)
        return False
    return True


def _cmd_timeline(args) -> int:
    from raytpu_torch.runtime import api

    if not _join(args):
        return 1
    events = api.timeline(args.output)
    print(f"wrote {len(events)} events to {args.output}")
    return 0


def _cmd_trace(args) -> int:
    from raytpu_torch.runtime import records
    from raytpu_torch.util.tracing import cluster_timeline

    if not _join(args):
        return 1
    events = records.at_driver(cluster_timeline)
    with open(args.output, "w") as f:
        json.dump(events, f)
    print(f"wrote {len(events)} events to {args.output}")
    return 0


def _cmd_memory(args) -> int:
    from raytpu_torch.state import object_summary

    if not _join(args):
        return 1
    s = object_summary()
    print(f"objects: {s['count']}  bytes: {s['total_bytes']}")
    return 0


def _cmd_events(args) -> int:
    """Tail the driver's structured-event ring (reference: the dashboard
    event module / `ray list cluster-events`)."""
    import datetime

    from raytpu_torch.state import api as state

    if not _join(args):
        return 1
    for e in state.list_events(args.severity, args.label, args.limit):
        ts = datetime.datetime.fromtimestamp(
            e.get("timestamp", 0)).strftime("%H:%M:%S")
        print(f"{ts} {e.get('severity', '?'):7s} "
              f"{e.get('label', ''):18s} {e.get('message', '')}")
    return 0


def _cmd_state(args) -> int:
    """Query the flight-recorder-backed state API (reference: ``ray
    list tasks`` / ``ray summary tasks`` over the GCS task-event
    store)."""
    from raytpu_torch.state import api as state

    if not _join(args):
        return 1
    if args.state_cmd == "list":
        kind = args.kind
        if kind == "tasks":
            rows = state.list_tasks(state=args.state, node=args.node,
                                    name=args.name, detail=args.detail,
                                    limit=args.limit)
        elif kind == "actors":
            res = state.list_actors(state=args.state, node=args.node,
                                    name=args.name, detail=args.detail)
            rows = res["actors"]
            if res["partial"]:
                print(f"WARNING: partial listing — "
                      f"{len(res['errors'])} node(s) unreachable:",
                      file=sys.stderr)
                for err in res["errors"]:
                    print(f"  {str(err['node_id'])[:12]}: {err['error']}",
                          file=sys.stderr)
        elif kind == "objects":
            rows = state.list_objects(detail=args.detail)
        else:  # nodes
            rows = state.list_nodes(detail=args.detail)
        if args.detail:
            print(json.dumps(rows, indent=2, default=str))
            return 0
        for r in rows:
            rid = (r.get("task_id") or r.get("actor_id")
                   or r.get("object_id") or r.get("node_id") or "?")
            print(f"{str(rid)[:16]:16s} "
                  f"{str(r.get('state', '-')):22s} "
                  f"{str(r.get('name') or '')}")
        return 0
    if args.state_cmd == "summary":
        fn = (state.summary_tasks if args.kind == "tasks"
              else state.summary_actors)
        print(json.dumps(fn(), indent=2, default=str))
        return 0
    # timeline
    rec = state.get_timeline(args.entity_id, kind=args.kind)
    if rec is None:
        print(f"no recorded {args.kind} matching {args.entity_id!r} "
              f"(is RAYTPU_TASK_EVENTS=1 set?)", file=sys.stderr)
        return 1
    if getattr(args, "detail", False):
        rec = dict(rec)
        rec["rpc_stages"] = state.rpc_stage_summary()
    print(json.dumps(rec, indent=2, default=str))
    return 0


def _cmd_serve(args) -> int:
    """Request-centric serving observability: list in-flight/finished
    serve requests, or render one request's stitched lifecycle
    waterfall (router -> replica -> engine -> client), keyed by the
    id the router stamped on the stream."""
    from raytpu_torch.state import api as state

    if not _join(args):
        return 1
    if args.detail:
        rec = state.get_request_timeline(args.detail)
        if rec is None:
            print(f"no recorded request matching {args.detail!r} "
                  f"(is RAYTPU_REQUEST_EVENTS=1 set?)", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(rec, indent=2, default=str))
            return 0
        print(f"request {rec['id']}  deployment={rec.get('deployment') or '-'}"
              f"  tenant={rec.get('tenant') or '-'}  "
              f"state={rec.get('state', '-')}")
        events = rec.get("events") or []
        t0 = events[0]["ts"] if events else 0.0
        for ev in events:
            extra = ""
            if ev.get("data"):
                extra = "  " + json.dumps(ev["data"], default=str)
            if ev.get("error"):
                extra += f"  error={ev['error']}"
            print(f"  +{ev['ts'] - t0:9.4f}s  "
                  f"{str(ev.get('transition', '?')):14s}"
                  f"{extra}")
        return 0
    rows = state.list_serve_requests(deployment=args.deployment,
                                     tenant=args.tenant,
                                     state=args.state, limit=args.limit)
    if args.json:
        print(json.dumps(rows, indent=2, default=str))
        return 0
    for r in rows:
        print(f"{str(r.get('id', '?'))[:16]:16s} "
              f"{str(r.get('state', '-')):14s} "
              f"{str(r.get('deployment') or '-'):28s} "
              f"{str(r.get('tenant') or '-')}")
    return 0


def _cmd_stack(args) -> int:
    """Dump live thread stacks of every process of the tree (reference:
    ``ray stack`` + the dashboard's py-spy profiling)."""
    from raytpu_torch.util.stack_dump import collect_cluster_stacks

    if not _join(args):
        return 1
    results = collect_cluster_stacks(worker=args.worker,
                                     node_filter=args.node)
    shown = 0
    for node_id, stacks in results.items():
        if set(stacks) == {"error"}:
            print(f"== node {node_id[:12]}: unreachable: "
                  f"{stacks['error']}")
            continue
        for wid, info in stacks.items():
            print(f"== node {node_id[:12]} worker {wid[:12]} "
                  f"pid={info.get('pid')}")
            print(info.get("stack") or f"error: {info.get('error')}")
            shown += 1
    if not shown:
        print("no matching live workers")
        return 1
    return 0


def _profile_from_store(args) -> int:
    """Read the driver's continuous-profile store — no on-demand
    sampling; the frames were shipped by every process while
    ``RAYTPU_PROFILE_CONTINUOUS=1`` was set."""
    from raytpu_torch.runtime import records
    from raytpu_torch.util.profiler import flamegraph_svg, to_collapsed_text

    if args.diff is not None:
        res = records.profile_query("diff", 0.0, 0.0, args.diff)
        collapsed = res.get("delta") or {}
        recent = res.get("recent") or {}
        title = (f"cluster profile diff — last {args.diff:g}s minus "
                 f"prior {args.diff:g}s")
        print(f"{len(collapsed)} changed stack(s); recent window: "
              f"{recent.get('samples', 0)} samples from "
              f"{len(recent.get('procs') or [])} proc(s)",
              file=sys.stderr)
    else:
        res = records.profile_query("merged", args.since)
        collapsed = res.get("collapsed") or {}
        procs = res.get("procs") or []
        title = (f"cluster profile — last {args.since:g}s, "
                 f"{res.get('samples', 0)} samples, "
                 f"{len(procs)} proc(s)")
        print(f"{res.get('frames', 0)} frame(s) / "
              f"{res.get('samples', 0)} samples from "
              f"{len(procs)} proc(s)", file=sys.stderr)
    if not collapsed:
        print("profile store is empty (is RAYTPU_PROFILE_CONTINUOUS=1 "
              "set on the cluster?)", file=sys.stderr)
        return 1
    if args.out.endswith(".collapsed") or args.out == "-":
        text = to_collapsed_text(collapsed)
        if args.out == "-":
            sys.stdout.write(text)
        else:
            with open(args.out, "w") as f:
                f.write(text)
    else:
        # SVG weights must be positive; a diff keeps only what got
        # hotter (the full signed delta is in the .collapsed output).
        pos = {k: v for k, v in collapsed.items() if v > 0}
        with open(args.out, "w") as f:
            f.write(flamegraph_svg(pos, title=title))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _cmd_profile(args) -> int:
    """Sample CPU profiles of the live processes of the tree and write a
    flamegraph SVG (reference: ``ray``'s dashboard py-spy flamegraphs;
    profile_manager.py:79). With ``--continuous``/``--diff``, read the
    driver's always-on profile store instead of sampling now."""
    from raytpu_torch.util.profiler import (flamegraph_svg, merge_collapsed,
                                            to_collapsed_text)
    from raytpu_torch.util.stack_dump import fanout_process_call

    if not _join(args):
        return 1
    if args.continuous or args.diff is not None:
        return _profile_from_store(args)
    results = fanout_process_call(
        "profile", args.duration, args.hz, args.idle, worker=args.worker,
        node_filter=args.node, timeout=args.duration + 60.0)
    profiles = []
    for node_id, workers in results.items():
        if set(workers) == {"error"}:
            print(f"== node {node_id[:12]}: unreachable: "
                  f"{workers['error']}", file=sys.stderr)
            continue
        for wid, info in workers.items():
            if "profile" in info:
                p = info["profile"]
                profiles.append(p["collapsed"])
                print(f"node {node_id[:12]} {wid[:12]} pid="
                      f"{info.get('pid')}: {p['samples']} samples",
                      file=sys.stderr)
            else:
                print(f"node {node_id[:12]} {wid[:12]}: "
                      f"error: {info.get('error')}", file=sys.stderr)
    if not profiles:
        print("no profiles collected", file=sys.stderr)
        return 1
    merged = merge_collapsed(profiles)
    if args.out.endswith(".collapsed") or args.out == "-":
        text = to_collapsed_text(merged)
        if args.out == "-":
            sys.stdout.write(text)
        else:
            with open(args.out, "w") as f:
                f.write(text)
    else:
        with open(args.out, "w") as f:
            f.write(flamegraph_svg(
                merged, title=f"{len(profiles)} process(es), "
                              f"{args.duration:g}s @ {args.hz:g} Hz"))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _cmd_memprofile(args) -> int:
    """Trace the live processes' Python allocations and write a memory
    flamegraph SVG (reference: the dashboard's memray profiles;
    profile_manager.py:79 — tracemalloc analogue, weights are KiB)."""
    from raytpu_torch.util.memprofile import top_table
    from raytpu_torch.util.profiler import flamegraph_svg, merge_collapsed
    from raytpu_torch.util.stack_dump import fanout_process_call

    if not _join(args):
        return 1
    results = fanout_process_call(
        "memory_profile", args.duration, args.frames, 40, args.stop,
        worker=args.worker, node_filter=args.node,
        timeout=args.duration + 60.0)
    mems = []
    for node_id, workers in results.items():
        if set(workers) == {"error"}:
            print(f"== node {node_id[:12]}: unreachable: "
                  f"{workers['error']}", file=sys.stderr)
            continue
        for wid, info in workers.items():
            if "memory" in info:
                m = info["memory"]
                mems.append(m)
                print(f"node {node_id[:12]} {wid[:12]} pid="
                      f"{info.get('pid')}: {m['total_kb']:,} KiB live, "
                      f"rss {m.get('rss_kb') or 0:,} KiB"
                      + (" [window-only]" if m.get("window_only")
                         else ""), file=sys.stderr)
            else:
                print(f"node {node_id[:12]} {wid[:12]}: "
                      f"error: {info.get('error')}", file=sys.stderr)
    if not mems:
        print("no memory profiles collected", file=sys.stderr)
        return 1
    if args.out == "-":
        for m in mems:
            print(top_table(m))
        return 0
    merged = merge_collapsed(m.get("collapsed", {}) for m in mems)
    total = sum(m.get("total_kb", 0) for m in mems)
    with open(args.out, "w") as f:
        f.write(flamegraph_svg(
            merged, title=f"live python allocations — {len(mems)} "
                          f"process(es), {total:,} KiB (weights = KiB)"))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _cmd_dashboard(args) -> int:
    """Serve the dashboard of a running driver's tree (reference:
    ``ray dashboard``; ours is the server-rendered v1)."""
    from raytpu_torch.dashboard import DashboardServer

    if not _join(args):
        return 1
    server = DashboardServer(host=args.host, port=args.port)
    url = server.start()
    print(f"raytpu dashboard at {url}", flush=True)
    if args.block:
        signal.sigwait({signal.SIGINT, signal.SIGTERM})
        server.stop()
    return 0


def _cmd_metrics(args) -> int:
    """Export Prometheus scrape config + Grafana dashboard (reference:
    ``dashboard/modules/metrics`` config generation)."""
    from raytpu_torch.util.metrics_export import export_config

    targets = [t.strip() for t in args.targets.split(",") if t.strip()]
    for path in export_config(args.out, targets):
        print(path)
    return 0


def _cmd_job(args) -> int:
    from raytpu_torch.job.sdk import JobSubmissionClient

    import shlex

    client = JobSubmissionClient(args.api)
    if args.job_cmd == "submit":
        job_id = client.submit_job(
            entrypoint=shlex.join(args.entrypoint))
        print(job_id)
        if args.wait:
            status = client.wait_until_finished(job_id)
            print(status)
            return 0 if status == "SUCCEEDED" else 1
    elif args.job_cmd == "status":
        print(client.get_job_status(args.job_id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.job_id), end="")
    elif args.job_cmd == "stop":
        print(client.stop_job(args.job_id))
    elif args.job_cmd == "list":
        for j in client.list_jobs():
            print(f"{j['job_id']}\t{j['status']}\t{j['entrypoint']}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m raytpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("timeline", help="dump chrome-trace timeline")
    s.add_argument("--address", default=None, help=_ADDRESS_HELP)
    s.add_argument("--output", default="timeline.json")
    s.set_defaults(fn=_cmd_timeline)

    s = sub.add_parser("trace",
                       help="pull every process's spans as a chrome trace")
    s.add_argument("--address", default=None, help=_ADDRESS_HELP)
    s.add_argument("--output", default="trace.json")
    s.set_defaults(fn=_cmd_trace)

    s = sub.add_parser("memory", help="object store summary")
    s.add_argument("--address", default=None, help=_ADDRESS_HELP)
    s.set_defaults(fn=_cmd_memory)

    s = sub.add_parser("dashboard", help="serve the dashboard")
    s.add_argument("--address", default=None, help=_ADDRESS_HELP)
    s.add_argument("--host", default="127.0.0.1")
    # 8266: the job REST API owns 8265 as a separate server here (the
    # reference co-hosts both on one port; ours are distinct servers).
    s.add_argument("--port", type=int, default=8266)
    s.add_argument("--block", dest="block", action="store_true",
                   default=True)
    s.add_argument("--no-block", dest="block", action="store_false")
    s.set_defaults(fn=_cmd_dashboard)

    s = sub.add_parser("events", help="recent structured events")
    s.add_argument("--address", default=None, help=_ADDRESS_HELP)
    s.add_argument("--severity", default=None,
                   help="filter: DEBUG/INFO/WARNING/ERROR/FATAL")
    s.add_argument("--label", default=None)
    s.add_argument("--limit", type=int, default=50)
    s.set_defaults(fn=_cmd_events)

    s = sub.add_parser(
        "state", help="task/actor/object/node lifecycle state "
                      "(reference: ray list / ray summary over the GCS "
                      "task-event store)")
    ssub = s.add_subparsers(dest="state_cmd", required=True)
    st = ssub.add_parser("list", help="list entities of one kind")
    st.add_argument("kind",
                    choices=("tasks", "actors", "objects", "nodes"))
    st.add_argument("--address", default=None, help=_ADDRESS_HELP)
    st.add_argument("--state", default=None,
                    help="filter: lifecycle state (e.g. FAILED, RUNNING)")
    st.add_argument("--node", default=None, help="node id prefix filter")
    st.add_argument("--name", default=None, help="name substring filter")
    st.add_argument("--detail", action="store_true",
                    help="full records incl. event timelines, as JSON")
    st.add_argument("--limit", type=int, default=100)
    st.set_defaults(fn=_cmd_state)
    st = ssub.add_parser("summary",
                         help="counts by state x name + latency pcts")
    st.add_argument("kind", choices=("tasks", "actors"))
    st.add_argument("--address", default=None, help=_ADDRESS_HELP)
    st.set_defaults(fn=_cmd_state)
    st = ssub.add_parser("timeline",
                         help="one entity's full lifecycle record")
    st.add_argument("entity_id", help="id (unique prefix accepted)")
    st.add_argument("--kind", default="task",
                    choices=("task", "actor", "object", "node"))
    st.add_argument("--address", default=None, help=_ADDRESS_HELP)
    st.add_argument("--detail", action="store_true",
                    help="attach RPC per-stage timing columns "
                         "(recv/decode/queue/handler/encode/send "
                         "p50/p95; empty on the port)")
    st.set_defaults(fn=_cmd_state)

    s = sub.add_parser(
        "serve", help="serve request timelines and listings "
                      "(request-centric observability; needs "
                      "RAYTPU_REQUEST_EVENTS=1)")
    s.add_argument("--address", default=None, help=_ADDRESS_HELP)
    s.add_argument("--detail", default=None, metavar="REQUEST_ID",
                   help="render one request's lifecycle waterfall "
                        "(unique id prefix accepted)")
    s.add_argument("--deployment", default=None,
                   help="filter: full deployment name (app#Deployment)")
    s.add_argument("--tenant", default=None, help="filter: tenant")
    s.add_argument("--state", default=None,
                   help="filter: lifecycle state (e.g. FINISHED, FAILED)")
    s.add_argument("--limit", type=int, default=100)
    s.add_argument("--json", action="store_true",
                   help="emit records as JSON")
    s.set_defaults(fn=_cmd_serve)

    s = sub.add_parser(
        "stack", help="live stack dump of the tree's processes "
                      "(reference: ray stack / dashboard py-spy)")
    s.add_argument("--address", required=True, help=_ADDRESS_HELP)
    s.add_argument("--node", default=None, help="node id prefix filter")
    s.add_argument("worker", nargs="?", default=None,
                   help="process id prefix, 'daemon' (the driver), or "
                        "empty for all")
    s.set_defaults(fn=_cmd_stack)

    s = sub.add_parser(
        "profile", help="sampling CPU profile of the tree's processes -> "
                        "flamegraph SVG (reference: dashboard py-spy)")
    s.add_argument("--address", required=True, help=_ADDRESS_HELP)
    s.add_argument("--node", default=None, help="node id prefix filter")
    s.add_argument("--duration", type=float, default=2.0)
    s.add_argument("--hz", type=float, default=50.0)
    s.add_argument("--idle", action="store_true",
                   help="keep parked threads in the profile")
    s.add_argument("--continuous", action="store_true",
                   help="read the driver's always-on profile store "
                        "(RAYTPU_PROFILE_CONTINUOUS=1) instead of "
                        "sampling now")
    s.add_argument("--since", type=float, default=600.0,
                   help="store window seconds (with --continuous)")
    s.add_argument("--diff", type=float, default=None, metavar="S",
                   help="store diff flamegraph: last S seconds minus "
                        "the prior S (implies --continuous)")
    s.add_argument("--out", default="profile.svg",
                   help="output path (.svg, .collapsed, or '-')")
    s.add_argument("worker", nargs="?", default=None,
                   help="process id prefix, 'daemon' (the driver), or "
                        "empty for all")
    s.set_defaults(fn=_cmd_profile)

    s = sub.add_parser(
        "memprofile", help="allocation memory profile of the tree's "
                           "processes -> flamegraph SVG (reference: "
                           "dashboard memray)")
    s.add_argument("--address", required=True, help=_ADDRESS_HELP)
    s.add_argument("--node", default=None, help="node id prefix filter")
    s.add_argument("--duration", type=float, default=2.0,
                   help="trace window seconds")
    s.add_argument("--frames", type=int, default=16,
                   help="allocation traceback depth")
    s.add_argument("--stop", action="store_true",
                   help="stop tracing after (removes overhead, loses "
                        "the baseline for the next call)")
    s.add_argument("--out", default="memprofile.svg",
                   help="output path (.svg or '-' for a text table)")
    s.add_argument("worker", nargs="?", default=None,
                   help="process id prefix, 'daemon' (the driver), or "
                        "empty for all")
    s.set_defaults(fn=_cmd_memprofile)

    s = sub.add_parser(
        "metrics", help="export Prometheus/Grafana monitoring config")
    msub = s.add_subparsers(dest="metrics_cmd", required=True)
    m = msub.add_parser("export-config")
    m.add_argument("--out", default="./raytpu-monitoring",
                   help="output directory")
    m.add_argument("--targets", default="127.0.0.1:8090",
                   help="comma-separated metrics host:port targets — "
                        "the driver's start_metrics_server endpoint, "
                        "where the raytpu_* series of every process "
                        "live, not the dashboard")
    m.set_defaults(fn=_cmd_metrics)

    s = sub.add_parser("job", help="job submission")
    s.add_argument("--api", default="http://127.0.0.1:8265",
                   help="job REST endpoint")
    jsub = s.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--wait", action="store_true")
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("job_id")
    jsub.add_parser("list")
    s.set_defaults(fn=_cmd_job)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
