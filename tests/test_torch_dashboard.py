"""The port's dashboard (raytpu_torch/dashboard/app.py) held to the JAX
package's (raytpu/dashboard/app.py) on the CPU.

One scenario (a named actor and a call on it, two tasks, a ``put``, with
task events armed) runs in the port's runtime and in the JAX package's
local mode, each with its dashboard; every route gives the same status,
Content-Type and JSON keys (or the same text, for the errors), and an
unknown ``/api`` section is a 404. Where the JAX package's local mode
has nothing to ask (``/stacks`` and ``/profile`` fan out to node
daemons, and ``/api/profile`` reads a head), the port's answers are
held to the JAX shapes: each process's entry ``{"pid", "stack"}`` or
``{"pid", "profile"}``, and the JAX ``ProfileStore``'s keys. A busy
actor's process and function are named by ``/stacks`` and ``/profile``.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

import raytpu
from raytpu.dashboard import DashboardServer as JaxDashboard
from raytpu.util import task_events as jax_events
from raytpu.util.profstore import ProfileStore as JaxProfileStore

from raytpu_torch import runtime
from raytpu_torch.dashboard import DashboardServer
from raytpu_torch.runtime import records
from raytpu_torch.util import task_events

T = 60.0


def dash_square(x):
    return x * x


class DashCounter:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


class DashBusy:
    def spin(self, seconds):
        return _dash_spin_target(seconds)


def _dash_spin_target(seconds):
    end = time.time() + seconds
    while time.time() < end:
        sum(i * i for i in range(500))
    return seconds


def get(url: str):
    """(status, Content-Type, body) of a GET, an error status included."""
    try:
        with urllib.request.urlopen(url, timeout=T) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers.get("Content-Type"), e.read()


def scenario(rt, remote):
    """The shared scenario through one package: its task id."""
    counter = remote(DashCounter).options(name="dash-counter").remote()
    assert rt.get(counter.bump.remote(), timeout=T) == 1
    refs = [remote(dash_square).remote(i) for i in range(2)]
    assert rt.get(refs, timeout=T) == [0, 1]
    assert rt.get(rt.put(b"x" * 100)) == b"x" * 100
    return counter


@pytest.fixture(scope="module")
def dashboards():
    """The scenario in both packages, each with its dashboard: the two
    URLs, the port's busy actor."""
    saved = os.environ.get(task_events.ENV_VAR)
    task_events.enable_task_events(env=True)
    jax_was = jax_events.enabled()
    jax_events.enable_task_events()
    records.reset()
    runtime.shutdown()
    runtime.init(num_cpus=1)
    raytpu.init(num_cpus=2, ignore_reinit_error=True)
    keep = [scenario(runtime, runtime.remote),
            scenario(raytpu, raytpu.remote)]
    busy = runtime.remote(DashBusy).remote()
    port, jax = DashboardServer(port=0), JaxDashboard(port=0)
    try:
        yield port.start(), jax.start(), busy
    finally:
        port.stop()
        jax.stop()
        del keep
        runtime.shutdown()
        raytpu.shutdown()
        if saved is None:
            os.environ.pop(task_events.ENV_VAR, None)
            task_events.disable_task_events()
        if not jax_was:
            jax_events.disable_task_events()
        records.reset()


# Keys a JAX state row carries only where its record has them
# (``raytpu/state/api.py``'s ``_norm_task``).
OPTIONAL_KEYS = {"error", "trace_id", "parent_task_id", "worker_id"}


def _shape(value):
    """What the parity compares of a JSON body: a dict's keys, a list's
    type and its first row's keys but the optional ones."""
    if isinstance(value, dict):
        return sorted(value)
    if isinstance(value, list):
        return ["list", sorted(set(value[0]) - OPTIONAL_KEYS) if value
                and isinstance(value[0], dict) else None]
    return type(value).__name__


ROUTES = [
    "/api/summary", "/api/nodes", "/api/actors", "/api/tasks",
    "/api/placement_groups", "/api/task_summary", "/api/objects",
    "/api/events", "/api/bogus", "/api/trace", "/api/metrics/query",
    "/api/metrics/query?name=raytpu_infer_decode_tokens_total&since=x",
    "/api/metrics/query?name=dash_nothing_total", "/api/metrics/series",
    "/api/state/tasks", "/api/state/tasks?limit=x", "/api/state/actors",
    "/api/state/actors?name=dash-counter&detail=1", "/api/state/objects",
    "/api/state/nodes", "/api/state/bogus", "/api/state/summary/tasks",
    "/api/state/summary/actors", "/api/state/summary/objects",
    "/api/state/timeline/nope", "/timeline", "/profile?duration=x",
    "/memprofile?frames=x", "/api/profile?mode=bogus",
    "/api/profile?since=x", "/no/such/page"]


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_answers_as_the_jax_dashboard(dashboards, route):
    port_url, jax_url, _ = dashboards
    got, want = get(port_url + route), get(jax_url + route)
    assert got[:2] == want[:2], route
    if want[1].startswith("application/json"):
        got, want = json.loads(got[2]), json.loads(want[2])
        if isinstance(want, list) and not (got and want):
            assert isinstance(got, list)  # no rows to compare
        else:
            assert _shape(got) == _shape(want)
    elif want[0] != 200:
        assert got[2] == want[2]


def test_the_summary_page_and_the_api_sections(dashboards):
    port_url, jax_url, _ = dashboards
    for url in (port_url, jax_url):
        status, ctype, page = get(url + "/")
        assert (status, ctype) == (200, "text/html; charset=utf-8")
        assert b"<h1>raytpu dashboard</h1>" in page
        assert b"dash-counter" in page and b">ALIVE</span>" in page
    summary = json.loads(get(port_url + "/api/summary")[2])
    jax_summary = json.loads(get(jax_url + "/api/summary")[2])
    assert {k: type(v) for k, v in summary.items()} == \
        {k: type(v) for k, v in jax_summary.items()}
    assert not [v for v in summary.values()
                if isinstance(v, dict) and "error" in v]
    assert summary["task_summary"]["FINISHED"] >= 2
    assert {a["name"] for a in summary["actors"]} >= {"dash-counter"}
    [node] = summary["nodes"]
    assert node["alive"] and node["node_id"] == records.node_id()
    assert b"1/1 alive" in get(port_url + "/")[2]


def test_a_task_s_timeline_has_the_jax_keys(dashboards):
    port_url, jax_url, _ = dashboards
    shapes = []
    for url in (port_url, jax_url):
        tasks = json.loads(get(url + "/api/state/tasks?name=dash_square")[2])
        assert tasks and all(t["state"] == "FINISHED" for t in tasks)
        status, _, body = get(
            f"{url}/api/state/timeline/{tasks[0]['task_id']}")
        assert status == 200
        shapes.append(_shape(json.loads(body)))
    assert shapes[0] == shapes[1]


def test_metrics_and_the_profile_store(dashboards):
    port_url, jax_url, _ = dashboards
    for url in (port_url, jax_url):
        status, ctype, _ = get(url + "/metrics")
        assert (status, ctype) == (200, "text/plain; charset=utf-8")
    assert get(port_url + "/metrics?local=1")[:2] == \
        get(jax_url + "/metrics?local=1")[:2]
    # The JAX package's local mode has no head, so no store (503); the
    # port's driver always has one, with the JAX store's keys.
    assert get(jax_url + "/api/profile")[0] == 503
    store = JaxProfileStore()
    merged = json.loads(get(port_url + "/api/profile")[2])
    assert set(merged) == set(store.merged())
    diff = json.loads(get(port_url + "/api/profile?mode=diff")[2])
    assert set(diff) == set(store.diff())
    status, ctype, svg = get(port_url + "/api/profile?format=svg")
    assert (status, ctype) == (200, "image/svg+xml; charset=utf-8")
    assert svg.startswith(b"<svg")


def test_stacks_and_profiles_name_the_busy_actor(dashboards):
    port_url, jax_url, busy = dashboards
    spin = busy.spin.remote(6.0)
    try:
        time.sleep(0.5)
        status, _, body = get(port_url + "/stacks")
        assert status == 200
        [(node, procs)] = json.loads(body).items()
        assert node == records.node_id()
        assert {p["uid"] for p in runtime.api.tree_processes()} == set(procs)
        assert all(set(e) == {"pid", "stack"} for e in procs.values())
        [mine] = [e for e in procs.values() if e["pid"] == busy.pid]
        assert "_dash_spin_target" in mine["stack"]
        [(_, procs)] = json.loads(get(
            port_url + "/profile?duration=0.5&format=json")[2]).items()
        assert all(set(e) == {"pid", "profile"} for e in procs.values())
        [mine] = [e for e in procs.values() if e["pid"] == busy.pid]
        assert any("_dash_spin_target" in k
                   for k in mine["profile"]["collapsed"])
        status, ctype, svg = get(port_url + "/profile?duration=0.5")
        assert (status, ctype) == (200, "image/svg+xml; charset=utf-8")
        assert b"_dash_spin_target" in svg
        status, ctype, text = get(port_url + "/profile?duration=0.3"
                                  "&format=collapsed&worker=daemon")
        assert status == 200 and b"_dash_spin_target" not in text
        status, _, table = get(port_url + "/memprofile?duration=0.2&stop=1"
                               "&format=table")
        assert status == 200 and table.count(b"pid ") == len(procs)
    finally:
        assert runtime.get(spin, timeout=T) == 6.0
    # The JAX package's local mode has no node daemon to ask.
    assert json.loads(get(jax_url + "/stacks")[2]) == {}
