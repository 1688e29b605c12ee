"""The port's task-event flight recorder (raytpu_torch/util/task_events.py)
held to the JAX package's (raytpu/util/task_events.py) on the CPU.

- The ring: the assertions of tests/test_task_events.py's ring buffer
  (emit, overflow, drain, requeue, ingest, never blocking), each one test
  parametrised over both packages;
- the store: identical event batches, made with numpy from a seed
  (arrival shuffled across "processes", entities evicted FIFO, events
  per entity bounded, ids found by unique prefix), folded by both
  packages' ``TaskEventStore``, give equal ``list``, ``get``, ``summary``
  and ``stats``;
- the post-mortem dump (no circuit breakers in the port: ``{}``).

This module imports nothing of JAX at its top: the packages are loaded
inside the tests.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest

PACKAGES = ("raytpu", "raytpu_torch")


def _module(package: str):
    return importlib.import_module(f"{package}.util.task_events")


@pytest.fixture(params=PACKAGES)
def recorder(request):
    """One package's armed recorder with a fresh ring; its defaults are
    restored on exit."""
    te = _module(request.param)
    te.clear()
    te.enable_task_events()
    yield te
    te.disable_task_events(env=True)
    te.enable_task_events(ring_size=8192)
    te.disable_task_events()
    te.clear()


def _ev(kind="task", eid="aa11", transition="SUBMITTED", **over):
    ev = {"kind": kind, "id": eid, "transition": transition,
          "ts": time.time(), "mono": time.monotonic(), "node_id": "n1",
          "worker_id": "", "attempt": 0}
    ev.update(over)
    return ev


# ---- the ring ------------------------------------------------------------


@pytest.mark.parametrize("package", PACKAGES)
def test_disabled_emit_is_noop(package):
    te = _module(package)
    te.clear()
    assert not te.enabled()
    te.emit("task", "t1", te.TaskTransition.SUBMITTED)
    assert te.get_events() == []
    assert te.dropped_count() == 0


def test_emit_records_primitives_only(recorder):
    te = recorder
    te.emit("task", "t1", te.TaskTransition.SUBMITTED, name="f", attempt=2,
            error="boom", parent_task_id="p1")
    (ev,) = te.get_events()
    assert ev["kind"] == "task" and ev["id"] == "t1"
    assert ev["transition"] == "SUBMITTED"
    assert ev["attempt"] == 2 and ev["error"] == "boom"
    assert ev["parent_task_id"] == "p1"
    for v in ev.values():
        assert isinstance(v, (str, int, float, bool, type(None)))
    json.dumps(ev)


def test_overflow_drops_oldest_and_counts(recorder):
    te = recorder
    te.enable_task_events(ring_size=4)
    for i in range(10):
        te.emit("task", f"t{i}", te.TaskTransition.SUBMITTED)
    assert [e["id"] for e in te.get_events()] == ["t6", "t7", "t8", "t9"]
    assert te.dropped_count() == 6


def test_drain_reports_drop_delta_once(recorder):
    te = recorder
    te.enable_task_events(ring_size=2)
    for i in range(5):
        te.emit("task", f"t{i}", te.TaskTransition.SUBMITTED)
    batch, dropped = te.drain()
    assert len(batch) == 2 and dropped == 3
    assert te.drain() == ([], 0)


def test_requeue_preserves_order_and_drop_accounting(recorder):
    te = recorder
    for i in range(3):
        te.emit("task", f"t{i}", te.TaskTransition.SUBMITTED)
    batch, dropped = te.drain()
    te.emit("task", "t-new", te.TaskTransition.SUBMITTED)
    te.requeue(batch, dropped)
    assert [e["id"] for e in te.get_events()] == ["t0", "t1", "t2", "t-new"]
    _, redrained = te.drain()
    assert redrained == dropped


def test_requeue_overflow_drops_oldest_of_batch(recorder):
    te = recorder
    te.enable_task_events(ring_size=3)
    batch = [_ev(eid=f"old{i}") for i in range(4)]
    te.emit("task", "fresh", te.TaskTransition.SUBMITTED)
    before = te.dropped_count()
    te.requeue(batch)
    assert [e["id"] for e in te.get_events()] == ["old2", "old3", "fresh"]
    assert te.dropped_count() == before + 2


def test_ingest_folds_batch_and_forwarded_drops(recorder):
    te = recorder
    te.ingest([_ev(eid="w1"), _ev(eid="w2")], dropped=7)
    assert [e["id"] for e in te.get_events()] == ["w1", "w2"]
    _, dropped = te.drain()
    assert dropped == 7


def test_emit_never_blocks_under_pressure(recorder):
    te = recorder
    te.enable_task_events(ring_size=8)
    t0 = time.perf_counter()
    for i in range(5000):
        te.emit("task", f"t{i}", te.TaskTransition.RUNNING)
    assert time.perf_counter() - t0 < 2.0
    assert te.dropped_count() == 5000 - 8


def test_both_packages_share_the_vocabulary_and_the_arming_variables():
    jax_te, port_te = _module("raytpu"), _module("raytpu_torch")
    assert port_te.TaskTransition.ALL == jax_te.TaskTransition.ALL
    assert port_te.RequestTransition.ALL == jax_te.RequestTransition.ALL
    assert port_te.KINDS == jax_te.KINDS
    assert (port_te.ENV_VAR, port_te.RING_ENV_VAR, port_te.REQUEST_ENV_VAR) \
        == (jax_te.ENV_VAR, jax_te.RING_ENV_VAR, jax_te.REQUEST_ENV_VAR)


@pytest.mark.parametrize("package", PACKAGES)
def test_arming_with_env_is_inherited_and_disarming_clears_it(package,
                                                              monkeypatch):
    te = _module(package)
    monkeypatch.delenv(te.ENV_VAR, raising=False)
    monkeypatch.delenv(te.REQUEST_ENV_VAR, raising=False)
    try:
        te.enable_task_events(env=True)
        te.enable_request_events(env=True)
        assert os.environ[te.ENV_VAR] == "1"
        assert os.environ[te.REQUEST_ENV_VAR] == "1"
        assert te.ship_enabled()
    finally:
        te.disable_task_events(env=True)
        te.disable_request_events(env=True)
    assert te.ENV_VAR not in os.environ
    assert te.REQUEST_ENV_VAR not in os.environ
    assert not te.ship_enabled()


# ---- the store, fed the same batches through both packages ---------------


KINDS = ("task", "actor", "object", "request")
TRANSITIONS = {
    "task": ("SUBMITTED", "RUNNING", "FAILED", "RETRIED", "FINISHED"),
    "actor": ("CREATED", "DEAD"),
    "object": ("PUT",),
    "request": ("RECEIVED", "ROUTED", "QUEUED", "ADMITTED", "FIRST_TOKEN",
                "FINISHED", "ABORTED"),
}


def seeded_batches(seed: int, n_entities: int = 60, n_batches: int = 7):
    """Entities of every kind, each with a lifecycle stamped on a wall
    clock, cut into batches as processes would ship them and shuffled in
    arrival; names, nodes, workers, attempts, errors and trace ids drawn
    from the seed; some ids share prefixes."""
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    events = []
    for i in range(n_entities):
        kind = KINDS[int(rng.integers(len(KINDS)))]
        eid = f"{int(rng.integers(16)):x}{i:04x}{int(rng.integers(1 << 20)):05x}"
        steps = TRANSITIONS[kind]
        n = int(rng.integers(1, len(steps) + 1))
        ts = t0 + float(rng.uniform(0, 100))
        for j, transition in enumerate(steps[:n]):
            ts += float(rng.uniform(0.001, 2.0))
            ev = {"kind": kind, "id": eid, "transition": transition,
                  "ts": round(ts, 6), "mono": round(ts - t0, 6),
                  "node_id": f"node{int(rng.integers(3))}",
                  "worker_id": f"w{int(rng.integers(5))}",
                  "attempt": int(rng.integers(3))}
            if rng.random() < 0.8:
                ev["name"] = f"fn{int(rng.integers(4))}"
            if rng.random() < 0.2:
                ev["error"] = f"E{int(rng.integers(9))}"
            if rng.random() < 0.3:
                ev["trace_id"] = f"{int(rng.integers(1 << 30)):08x}"
            if kind == "request":
                ev["deployment"] = f"app#d{int(rng.integers(2))}"
                ev["tenant"] = f"t{int(rng.integers(2))}"
                ev["data"] = {"n": int(rng.integers(100))}
            events.append(ev)
    order = rng.permutation(len(events))
    cuts = np.sort(rng.choice(np.arange(1, len(events)), n_batches - 1,
                              replace=False))
    batches = [[events[k] for k in part] for part in np.split(order, cuts)]
    dropped = [int(rng.integers(4)) for _ in batches]
    return batches, dropped, sorted({e["id"] for e in events})


def fold(package: str, batches, dropped, per_kind: int,
         events_per_entity: int):
    te = _module(package)
    store = te.TaskEventStore(per_kind=per_kind,
                              events_per_entity=events_per_entity)
    for batch, d in zip(batches, dropped):
        store.add_batch([dict(e) for e in batch], d)
    return store


def readings(store, ids) -> dict:
    out = {"stats": store.stats()}
    for kind in KINDS:
        out[f"summary/{kind}"] = store.summary(kind)
        out[f"list/{kind}"] = store.list(kind, limit=0, detail=True)
        out[f"list10/{kind}"] = store.list(kind, limit=10)
        for st in TRANSITIONS[kind]:
            out[f"state/{kind}/{st}"] = store.list(kind, state=st.lower(),
                                                   limit=0)
        out[f"node/{kind}"] = store.list(kind, node="node1", limit=0)
        out[f"name/{kind}"] = store.list(kind, name="fn2", limit=0)
        for eid in ids:
            out[f"get/{kind}/{eid}"] = store.get(kind, eid)
            out[f"prefix/{kind}/{eid[:1]}"] = store.get(kind, eid[:1])
            out[f"prefix/{kind}/{eid[:6]}"] = store.get(kind, eid[:6])
    return out


@pytest.mark.parametrize("per_kind,events_per_entity", [
    (4096, 256), (16, 8), (16, 256)],
    ids=["unbounded", "evicting", "evicting-entities"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stores_fed_the_same_batches_agree(seed, per_kind,
                                           events_per_entity):
    batches, dropped, ids = seeded_batches(seed)
    want = readings(fold("raytpu", batches, dropped, per_kind,
                         events_per_entity), ids)
    got = readings(fold("raytpu_torch", batches, dropped, per_kind,
                        events_per_entity), ids)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    if per_kind == 16:
        assert want["stats"]["evicted"] > 0


def test_a_late_older_event_never_clobbers_the_state():
    """The driver's SUBMITTED folded after a worker's FINISHED: the state
    follows event time in both packages."""
    t0 = time.time()
    late = [_ev(eid="t1", transition="RUNNING", ts=t0 + 1),
            _ev(eid="t1", transition="FINISHED", ts=t0 + 2)]
    early = [_ev(eid="t1", name="f", transition="SUBMITTED", ts=t0)]
    out = []
    for package in PACKAGES:
        store = _module(package).TaskEventStore()
        store.add_batch([dict(e) for e in late])
        store.add_batch([dict(e) for e in early])
        rec = store.get("task", "t1")
        assert rec["state"] == "FINISHED" and rec["name"] == "f"
        assert store.list("task", state="SUBMITTED") == []
        out.append(rec)
    assert out[0] == out[1]


# ---- post-mortem -----------------------------------------------------------


def test_postmortem_writes_the_ring_and_recent_events(tmp_path):
    from raytpu_torch.util import events
    from raytpu_torch.util import task_events as te

    te.clear()
    te.enable_task_events()
    try:
        te._last_postmortem[0] = -10_000.0
        events.reset()
        events.record_event("ERROR", "PM_TEST", "it broke")
        te.emit("task", "t1", te.TaskTransition.FAILED, name="f",
                error="boom")
        path = te.write_postmortem(str(tmp_path), "unit test")
        assert path is not None and os.path.exists(path)
        with open(path) as f:
            dump = json.load(f)
        assert dump["reason"] == "unit test"
        assert dump["task_events_dropped"] == 0
        assert any(e["id"] == "t1" for e in dump["task_events"])
        assert any(e.get("label") == "PM_TEST"
                   for e in dump["recent_events"])
        assert dump["breakers"] == {} and "events_dropped" in dump
        assert te.write_postmortem(str(tmp_path), "again") is None
        te._last_postmortem[0] = -10_000.0
        assert te.write_postmortem("/proc/not/writable", "nope") is None
    finally:
        events.reset()
        te.disable_task_events()
        te.clear()
