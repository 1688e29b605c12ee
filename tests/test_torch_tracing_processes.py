"""Traces that cross the port's processes (raytpu_torch/util/tracing.py
and raytpu_torch/runtime/api.py), held to the JAX package's rules:
``TraceContext.to_wire``/``from_wire`` and ``assemble_timeline`` give
the JAX package's values on the same inputs (tests/test_tracing.py's
fake dumps); a call through the port's runtime carries its caller's
context (the worker's ``rpc.server.*`` span parents under the caller's
``rpc.client.*``, and ``worker.actor_task.run`` under it, on the pool
and on the event loop); an unsampled context records nothing anywhere
but still arrives; a hop with tracing off forwards the context
unchanged; and a handle call from one replica to another gives one trace
over three processes in ``cluster_timeline``, with flow arrows and no
dangling parent (tests/test_tracing.py:506).

Workers rebuild these classes by importing this module by name, so it
imports nothing of JAX or of the JAX package at its top level. Tracing
is armed through the environment before a worker spawns (a worker reads
it when it imports the tracing module), and every flag is restored at
each test's end.
"""

import os
import time

import pytest

from raytpu_torch import runtime
from raytpu_torch import serve as port_serve
from raytpu_torch.runtime import api
from raytpu_torch.util import tracing

DEADLINE_S = 60.0


class Probe:
    """Reports the trace context its calls run under."""

    def where(self):
        tc = tracing.current_trace()
        return os.getpid(), None if tc is None else tc.to_wire()

    async def where_async(self):
        tc = tracing.current_trace()
        return os.getpid(), None if tc is None else tc.to_wire()

    def hop(self, other):
        """Call ``other`` from this worker."""
        return runtime.get(other.where.remote(), timeout=DEADLINE_S)


class Leaf:
    def __call__(self, x):
        return x + 1


class Composer:
    """Calls its child deployment through its handle (a coroutine, so
    the call is sent under the request's context)."""

    def __init__(self, child):
        self.child = child

    async def __call__(self, x):
        return await self.child.remote(x)


@pytest.fixture
def armed():
    """Restores the tracing flags, the environment's arming and the
    driver's buffer after the test."""
    saved = (tracing._enabled, tracing._sample_rate,
             {k: os.environ.get(k) for k in (tracing.ENV_VAR,
                                             tracing.SAMPLE_ENV_VAR)})
    tracing.clear_spans()
    yield
    tracing._enabled, tracing._sample_rate, env = saved
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    tracing.clear_spans()


def spans_of(trace_id: str) -> dict:
    """span id -> (pid, record) of one trace, over this process and
    every worker below it."""
    dumps = api.trace_dumps() + [tracing.dump()]
    return {s["span_id"]: (d["pid"], s) for d in dumps
            for s in d["spans"] if s["trace_id"] == trace_id}


def named(spans: dict, name: str) -> list:
    return [(pid, s) for pid, s in spans.values() if s["name"] == name]


# ---- the same values as the JAX package --------------------------------


def test_wire_forms_agree_with_the_jax_package():
    from raytpu.util import tracing as jt

    for args in (("t" * 32, "s" * 16, "p", True), ("a", "b", None, False)):
        port, jax = tracing.TraceContext(*args), jt.TraceContext(*args)
        assert port.to_wire() == jax.to_wire()
        back = tracing.TraceContext.from_wire(port.to_wire())
        ref = jt.TraceContext.from_wire(jax.to_wire())
        assert [getattr(back, k) for k in tracing.TraceContext.__slots__] \
            == [getattr(ref, k) for k in jt.TraceContext.__slots__]
    for bad in (None, [], ["t"], [1, "s", 1], ["t", 2, 1], {"a": 1}, 7):
        assert tracing.TraceContext.from_wire(bad) is None
        assert jt.TraceContext.from_wire(bad) is None


def _fake_dump(kind, ident, pid, spans):
    return {"identity": [kind, ident], "pid": pid, "spans": spans}


def _fake_span(name, trace_id, span_id, parent, pid, tid=7, start=1.0):
    return {"name": name, "trace_id": trace_id, "span_id": span_id,
            "parent_span_id": parent, "start": start, "duration_s": 0.5,
            "pid": pid, "tid": tid, "attributes": {}, "error": None}


def test_assembled_timelines_agree_with_the_jax_package(tmp_path):
    from raytpu.util import tracing as jt

    t = "t" * 32
    dumps = [
        _fake_dump("driver", "", 111, [
            _fake_span("rpc.client.f", t, "s1", None, 111)]),
        _fake_dump("worker", "Replica-ab12", 222, [
            _fake_span("rpc.server.f", t, "s2", "s1", 222, start=1.5),
            _fake_span("worker.actor_task.run", t, "s3", "s2", 222)]),
        None, "junk", {"identity": None, "spans": None}]
    port = tracing.assemble_timeline(dumps, str(tmp_path / "port.json"))
    assert port == jt.assemble_timeline(dumps, str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    flows = [e for e in port if e.get("cat") == "flow"]
    assert {(e["ph"], e["pid"], e["id"]) for e in flows} == {
        ("s", 1, "s2"), ("f", 2, "s2")}
    assert {e["pid"]: e["args"]["name"] for e in port if e["ph"] == "M"} \
        == {1: "driver (pid 111)", 2: "worker:Replica-ab12 (pid 222)",
            5: "proc (pid ?)"}


# ---- contexts through the port's runtime -------------------------------


def test_a_call_carries_its_context_on_the_pool_and_the_loop(armed):
    tracing.enable_tracing(sample_rate=1.0, env=True)
    probe = runtime.remote(Probe).remote()
    try:
        with tracing.span("test.root"):
            (pid, wire), (pid2, wire2) = runtime.get(
                [probe.where.remote(), probe.where_async.remote()],
                timeout=DEADLINE_S)
        (root,) = [s for s in tracing.get_spans() if s["name"] == "test.root"]
        spans = spans_of(root["trace_id"])
        assert pid == pid2 == probe.pid != os.getpid()
        for method, got in (("where", wire), ("where_async", wire2)):
            [(cpid, client)] = named(spans, f"rpc.client.{method}")
            [(spid, server)] = named(spans, f"rpc.server.{method}")
            [(rpid, run)] = [(p, s) for p, s in named(
                spans, "worker.actor_task.run")
                if s["parent_span_id"] == server["span_id"]]
            assert (cpid, spid, rpid) == (os.getpid(), pid, pid)
            assert client["parent_span_id"] == root["span_id"]
            assert server["parent_span_id"] == client["span_id"]
            # The method ran under worker.actor_task.run's context.
            assert got == [root["trace_id"], run["span_id"], 1]
        events = tracing.cluster_timeline()
        names = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert f"driver (pid {os.getpid()})" in names
        assert any(n.startswith("worker:Probe-") for n in names)
    finally:
        runtime.kill(probe)


def test_an_unsampled_context_records_nothing_but_propagates(armed):
    tracing.enable_tracing(sample_rate=0.0, env=True)
    probe = runtime.remote(Probe).remote()
    try:
        with tracing.span("test.unsampled"):
            root = tracing.current_trace()
            _, wire = runtime.get(probe.where.remote(), timeout=DEADLINE_S)
        assert not root.sampled
        assert wire[0] == root.trace_id and wire[2] == 0
        assert spans_of(root.trace_id) == {}
    finally:
        runtime.kill(probe)


def test_a_hop_with_tracing_off_forwards_the_context(armed):
    # ``off`` starts untraced; ``on`` traced.
    tracing.disable_tracing(env=True)
    off = runtime.remote(Probe).remote()
    tracing.enable_tracing(sample_rate=1.0, env=True)
    on = runtime.remote(Probe).remote()
    try:
        with tracing.span("test.root"):
            root = tracing.current_trace()
            _, wire = runtime.get(off.hop.remote(on), timeout=DEADLINE_S)
        spans = spans_of(root.trace_id)
        [(_, client)] = named(spans, "rpc.client.hop")
        [(spid, server)] = named(spans, "rpc.server.where")
        # Nothing recorded in ``off``; ``on`` parents under the driver's
        # span that ``off`` forwarded unchanged.
        assert off.pid not in {pid for pid, _ in spans.values()}
        assert spid == on.pid
        assert server["parent_span_id"] == client["span_id"]
        assert wire[0] == root.trace_id
    finally:
        runtime.kill(off)
        runtime.kill(on)


def test_a_handle_call_between_replicas_is_one_trace_over_three_processes(
        armed):
    tracing.enable_tracing(sample_rate=1.0, env=True)
    try:
        handle = port_serve.run(port_serve.deployment(Composer).bind(
            port_serve.deployment(Leaf).bind()), name="traced",
            route_prefix=None)
        with tracing.span("test.root"):
            assert handle.remote(41).result(timeout_s=DEADLINE_S) == 42
        (root,) = [s for s in tracing.get_spans() if s["name"] == "test.root"]
        end = time.monotonic() + DEADLINE_S
        while True:
            spans = spans_of(root["trace_id"])
            pids = {pid for pid, _ in spans.values()}
            servers = [pid for pid, s in named(
                spans, "rpc.server.handle_request")]
            if len(pids) >= 3 and len(servers) == 2:
                break
            assert time.monotonic() < end, (pids, servers)
            time.sleep(0.1)
        dangling = [s["name"] for _, s in spans.values()
                    if s["parent_span_id"] and s["parent_span_id"]
                    not in spans]
        assert dangling == []
        events = tracing.cluster_timeline()
        flows = {(e["ph"], e["id"]) for e in events
                 if e.get("cat") == "flow"}
        for pid, s in named(spans, "rpc.server.handle_request"):
            assert {("s", s["span_id"]), ("f", s["span_id"])} <= flows
        ours = [e for e in events if e.get("ph") == "X"
                and e["args"].get("trace_id") == root["trace_id"]]
        assert len({e["pid"] for e in ours}) >= 3
    finally:
        port_serve.shutdown()
