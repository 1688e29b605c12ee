"""The card as a resource in the port's runtime, against the JAX package.

- The port's copies (``core/ids``, ``core/resources``, ``util/usage_stats``)
  give what the JAX package's give, case by case; the ledger
  (``runtime/ledger.py``) packs shares of a card, takes whole cards,
  waits and admits first in first out, and raises where a request can
  never fit; the cards are detected without CUDA.
- Through the runtime (one for the module, two pretend cards): actors at
  ``num_gpus=0.5`` are bound to the cards as the ledger packed them and
  read it in ``CUDA_VISIBLE_DEVICES``; a fifth waits, then runs on the
  freed card. ``max_restarts=1`` with ``kill(no_restart=False)`` restarts
  as the JAX local backend does (the restart count, the record's
  CREATED, DEAD, RESTARTED, CREATED, DEAD), and the port's restarted
  actor reads ``was_current_actor_reconstructed``; a SIGKILL restarts it
  too, and ``kill`` from another process ends it for good.
- Metrics ship by default, as in the JAX package: with no
  ``RAYTPU_METRICS_SHIP`` set, a worker actor's counter reaches the
  driver's store and ``/metrics``.

This module imports nothing of JAX at its top: the port's workers import
it by name.
"""

import importlib
import json
import os
import signal
import socket
import threading
import time
import urllib.request

import pytest

from raytpu_torch import runtime
from raytpu_torch.core.errors import ActorDiedError, PlacementGroupError
from raytpu_torch.runtime import ledger as ledger_mod

T = 60.0
PACKAGES = ("raytpu", "raytpu_torch")


# ---- the copies, case by case ----------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_ids_derive_alike(pkg):
    ids = importlib.import_module(f"{pkg}.core.ids")
    tid = ids.TaskID(bytes(range(16)))
    got = [ids.ObjectID.for_task_return(tid, 3).hex(),
           ids.TaskID.for_actor_creation(ids.ActorID(b"\x01" * 16)).hex(),
           ids.ObjectID.for_put(ids.WorkerID(b"\x02" * 16), 7).hex(),
           ids.JobID.nil().is_nil(), repr(ids.NodeID(b"\x03" * 16))]
    jax_ids = importlib.import_module("raytpu.core.ids")
    jtid = jax_ids.TaskID(bytes(range(16)))
    assert got == [jax_ids.ObjectID.for_task_return(jtid, 3).hex(),
                   jax_ids.TaskID.for_actor_creation(
                       jax_ids.ActorID(b"\x01" * 16)).hex(),
                   jax_ids.ObjectID.for_put(
                       jax_ids.WorkerID(b"\x02" * 16), 7).hex(),
                   True, "NodeID(" + "03" * 16 + ")"]
    with pytest.raises(ValueError):
        ids.PlacementGroupID(b"short")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_resource_sets_count_alike(pkg):
    res = importlib.import_module(f"{pkg}.core.resources")
    a = res.ResourceSet({"CPU": 1.5, "ACC": 0.25})
    b = res.ResourceSet({"CPU": 0.5, "ACC": 0.25, "x": 0})
    node = res.NodeResources(res.ResourceSet({"CPU": 4, "ACC": 1}))
    node.allocate(a)
    got = [(a + b).to_dict(), (a - b).to_dict(), b.is_subset_of(a),
           node.available.to_dict(), node.can_fit(a), node.utilization()]
    node.release(a)
    got.append(node.available.to_dict())
    with pytest.raises(ValueError):
        b - a - a
    assert got == [{"CPU": 2.0, "ACC": 0.5}, {"CPU": 1.0}, True,
                   {"CPU": 2.5, "ACC": 0.75}, True, 0.375,
                   {"CPU": 4.0, "ACC": 1.0}]


def test_the_libraries_record_their_use():
    """Each library records its use on import, where the JAX package's
    do (before any reset of this process's record)."""
    from raytpu_torch import data, rllib, serve, train, tune  # noqa: F401
    from raytpu_torch.util import usage_stats

    with usage_stats._lock:
        assert {"data", "rllib", "serve", "train", "tune"} <= set(
            usage_stats._features)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_usage_stats_record_report_and_opt_out(pkg, tmp_path, monkeypatch):
    """tests/test_usage_stats.py's cases, through both packages; the port
    reports torch's version where the JAX package reports JAX's."""
    usage_stats = importlib.import_module(f"{pkg}.util.usage_stats")
    usage_stats.reset()
    monkeypatch.delenv("RAYTPU_USAGE_STATS_ENABLED", raising=False)
    usage_stats.record_library_usage("rllib")
    usage_stats.record_library_usage("rllib")
    usage_stats.record_library_usage("data")
    usage_stats.record_extra("num_nodes", 3)
    path = usage_stats.report(str(tmp_path / "usage.json"))
    payload = json.load(open(path))
    assert payload["library_usages"] == {"rllib": 2, "data": 1}
    assert payload["extra"]["num_nodes"] == 3
    assert payload["raytpu_version"] and payload["python_version"]
    assert ("torch_version" in payload) == (pkg == "raytpu_torch")
    assert usage_stats.report("/no/such/dir/usage.json") is None
    usage_stats.reset()
    monkeypatch.setenv("RAYTPU_USAGE_STATS_ENABLED", "0")
    usage_stats.record_library_usage("serve")
    assert usage_stats.report(str(tmp_path / "off.json")) is None
    assert not os.path.exists(tmp_path / "off.json")


# ---- the ledger ----------------------------------------------------------


def spec(**res):
    return ledger_mod.Spec(res)


def test_shares_pack_onto_a_card_and_whole_cards_are_taken():
    led = ledger_mod.Ledger(4, ["3", "5"], {"ACC": 2})
    grants = [led.try_acquire(spec(CPU=0.5, GPU=0.5)) for _ in range(3)]
    assert [g.view(led.card_ids)["visible"] for g in grants] == \
        ["3", "3", "5"]
    assert led.try_acquire(spec(GPU=1)) is None  # no whole card free
    assert led.available() == {"CPU": 2.5, "GPU": 0.5, "ACC": 2.0}
    for g in grants:
        led.release(g.gid)
    both = led.try_acquire(spec(GPU=2, ACC=1))
    assert both.view(led.card_ids)["visible"] == "3,5"
    assert led.available() == {"CPU": 4.0, "ACC": 1.0}
    led.release(both.gid)
    assert led.available() == led.total() == {"CPU": 4.0, "GPU": 2.0,
                                              "ACC": 2.0}


def test_what_can_never_fit_raises_and_what_fits_later_waits():
    led = ledger_mod.Ledger(2, ["0"])
    for too_big in (spec(GPU=2), spec(CPU=3), spec(TPU=1)):
        with pytest.raises(ValueError, match="can never fit"):
            led.request(too_big, lambda g: None)
    with pytest.raises(ValueError, match="whole number"):
        ledger_mod.build_resources({"num_gpus": 1.5}, default_cpus=0)
    none = ledger_mod.Ledger(2, [])  # a host without a card
    with pytest.raises(ValueError, match="can never fit"):
        none.check(ledger_mod.Spec(ledger_mod.build_resources(
            {"num_gpus": 0.5}, default_cpus=0)))
    held, _ = led.request(spec(GPU=1), lambda g: None)
    got = []
    first, rid1 = led.request(spec(GPU=0.5), got.append, owner="a")
    second, rid2 = led.request(spec(GPU=0.5), got.append, owner="b")
    third, rid3 = led.request(spec(GPU=0.5), got.append, owner="c")
    assert first is second is third is None and led.waiting() == 3
    led.drop_owner("c")  # its process is gone
    assert led.cancel(rid2) and not led.cancel(rid3)
    led.release(held.gid)
    end = time.monotonic() + T
    while not got and time.monotonic() < end:
        time.sleep(0.01)
    assert len(got) == 1 and led.waiting() == 0
    assert got[0].cards == [0]
    [admitted] = led.admissions()
    assert admitted["waited_s"] >= admitted["after_release_s"] >= 0


def test_a_link_closing_while_its_request_is_granted_frees_the_grant(
        monkeypatch):
    """Another process's request waits for the card; the release that
    admits it crosses its link's close (the grant is made, its answer is
    not yet sent): the grant goes back all the same."""
    from raytpu_torch.runtime import api

    led = ledger_mod.Ledger(1, ["0"])
    monkeypatch.setattr(api, "_LEDGER", led)
    monkeypatch.setattr(api, "_POOL", None)
    held, _ = led.request(spec(GPU=1), lambda g: None)
    answers, admitted, gate = [], [], threading.Event()

    def route(message):  # the other process's link
        if message[0] == "admitted":
            gate.wait(T)
            admitted.append(message)
        else:
            answers.append(message)

    api._serve_link(("admit", 7, spec(GPU=0.5)), route)
    assert answers[0][:3] == ("answer", 7, True) and answers[0][3][0] is None
    api.release(held.gid)
    end = time.monotonic() + T
    while led.waiting():  # granted; its answer waits at the gate
        assert time.monotonic() < end
        time.sleep(0.01)
    assert led.available()["GPU"] == 0.5 and not admitted
    api._drop_route(route)
    assert led.available() == led.total() and not led.holds_grants()
    gate.set()
    while not admitted:
        assert time.monotonic() < end
        time.sleep(0.01)
    assert led.available() == led.total()


def test_groups_reserve_cards_as_their_strategy_says():
    led = ledger_mod.Ledger(4, ["0", "1"])
    pack = led.create_group([{"GPU": 0.5}, {"GPU": 0.5}], "PACK")
    assert led.group_info(pack)["cards"] == [[0], [0]]
    spread = led.create_group([{"GPU": 0.25}, {"GPU": 0.25}], "SPREAD")
    assert led.group_info(spread)["cards"] == [[1], [1]] or \
        led.group_info(spread)["cards"] == [[1], [0]]
    with pytest.raises(PlacementGroupError, match="STRICT_SPREAD"):
        led.create_group([{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD")
    with pytest.raises(PlacementGroupError, match="infeasible"):
        led.create_group([{"CPU": 5}], "PACK")
    with pytest.raises(ValueError, match="strategy"):
        led.create_group([{"CPU": 1}], "NEAREST")
    # A bundle grants what it holds, on its card, and nothing past it.
    g = led.try_acquire(ledger_mod.Spec({"GPU": 0.5}, pack, 1))
    assert g.cards == [0] and g.bundle == 1
    with pytest.raises(PlacementGroupError, match="never fit"):
        led.try_acquire(ledger_mod.Spec({"GPU": 1}, pack, 0))
    led.remove_group(pack)
    led.release(g.gid)  # into a removed group: goes nowhere
    with pytest.raises(PlacementGroupError, match="gone"):
        led.try_acquire(ledger_mod.Spec({"CPU": 1}, pack, 0))
    led.remove_group(spread)
    assert led.available() == led.total() and led.groups() == []


def test_cards_are_counted_without_cuda(monkeypatch):
    import torch

    from raytpu_torch.core import topology

    def touched(*a, **k):
        raise AssertionError("a CUDA query")

    for name in ("is_available", "device_count", "current_device", "init",
                 "_lazy_init"):
        monkeypatch.setattr(torch.cuda, name, touched)
    monkeypatch.setattr(topology, "_host_cards", lambda: 4)
    for env, want in ((None, ["0", "1", "2", "3"]), ("2,0", ["2", "0"]),
                      ("", []), ("-1", []), ("1,7,2", ["1"]),
                      ("GPU-aa,GPU-bb", ["GPU-aa", "GPU-bb"])):
        if env is None:
            monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        else:
            monkeypatch.setenv("CUDA_VISIBLE_DEVICES", env)
        assert topology.detect_local_gpus() == {"gpus": len(want),
                                                "ids": want}


# ---- through the runtime ---------------------------------------------------


class Bound:
    def where(self):
        from raytpu_torch import get_runtime_context

        ctx = get_runtime_context()
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "pid": os.getpid(),
                "reconstructed": ctx.was_current_actor_reconstructed,
                "actor": ctx.get_actor_id().hex()}

    def sleep(self, s: float) -> None:
        time.sleep(s)


class JaxBound:
    def where(self):
        return {"pid": os.getpid()}


class Killer:
    def kill(self, handle) -> None:
        runtime.kill(handle)


class Hits:
    def hit(self, n: int) -> float:
        for _ in range(n):
            HITS.inc(tags={"deployment": "default-ship", "tenant": "t"})
        return HITS.value


class JaxHits:
    """``Hits`` on the JAX package: its counter of the same name."""

    def __init__(self):
        from raytpu.util import metrics

        self.hits = metrics.Counter("raytpu_serve_requests_total",
                                    tag_keys=("deployment", "tenant"))

    def hit(self, n: int) -> float:
        for _ in range(n):
            self.hits.inc(tags={"deployment": "default-ship", "tenant": "t"})
        return self.hits.value


def _hits_counter():
    from raytpu_torch.util import metrics

    return metrics.Counter("raytpu_serve_requests_total",
                           tag_keys=("deployment", "tenant"))


HITS = _hits_counter()


@pytest.fixture(scope="module")
def tree():
    """The module's runtime: two CPUs and two pretend cards, task events
    on in this process (the owner records its actors), no metrics
    variable set (shipping's default)."""
    from raytpu_torch.runtime import records
    from raytpu_torch.util import metrics, task_events

    saved = os.environ.pop(metrics.ENV_SHIP, None)
    records.reset()
    was = task_events.enabled()
    task_events.enable_task_events()
    runtime.init(num_cpus=2, num_gpus=2)
    yield runtime
    runtime.shutdown()
    if not was:
        task_events.disable_task_events()
    if saved is not None:
        os.environ[metrics.ENV_SHIP] = saved


def test_shares_bind_children_as_the_ledger_packed_them(tree):
    from raytpu_torch.util import usage_stats

    with usage_stats._lock:  # init records the core's use, as JAX's does
        assert "core_local" in usage_stats._features
    cls = runtime.remote(Bound).options(num_gpus=0.5)
    actors = [cls.remote() for _ in range(4)]
    where = runtime.get([a.where.remote() for a in actors], timeout=T)
    assert [w["visible"] for w in where] == ["0", "0", "1", "1"]
    assert runtime.available_resources() == {"CPU": 2.0}
    fifth = cls.remote()
    ref = fifth.where.remote()
    assert runtime.wait([ref], timeout=1.0)[0] == []
    runtime.kill(actors[2])
    assert runtime.get(ref, timeout=T)["visible"] == "1"
    with pytest.raises(ValueError, match="can never fit"):
        runtime.remote(Bound).options(num_gpus=3).remote()
    for a in (*actors, fifth):
        runtime.kill(a)
    end = time.monotonic() + T
    while runtime.available_resources() != runtime.cluster_resources():
        assert time.monotonic() < end
        time.sleep(0.05)


def transitions(pkg, actor_id: str) -> list:
    state = importlib.import_module(f"{pkg}.state")
    rec = state.get_timeline(actor_id, kind="actor")
    return [e["transition"] for e in (rec or {}).get("events", [])]


def test_restarts_as_the_jax_local_backend(tree):
    import raytpu
    from raytpu.util import task_events as jax_events

    jax_events.enable_task_events()
    raytpu.shutdown()
    raytpu.init(num_cpus=2, num_tpus=2)
    try:
        ja = raytpu.remote(JaxBound).options(max_restarts=1,
                                          num_tpus=0.5).remote()
        raytpu.get(ja.where.remote(), timeout=T)
        # The local backend's creation task ends on a thread of its own
        # after the actor answers; a restart submitted before that end
        # reuses the task's id, and the end then drops the restart's
        # record (the restart never runs). Kill once the creation ended.
        backend = raytpu.runtime.api._backend
        end = time.monotonic() + T
        while any(r.spec.actor_creation is not None
                  and r.spec.actor_creation.actor_id == ja._id
                  for r in list(backend._tasks.values())):
            assert time.monotonic() < end
            time.sleep(0.02)
        raytpu.kill(ja, no_restart=False)
        end = time.monotonic() + T
        while transitions("raytpu", ja._id.hex())[-1:] != ["CREATED"] \
                or len(transitions("raytpu", ja._id.hex())) < 4:
            assert time.monotonic() < end, transitions("raytpu",
                                                       ja._id.hex())
            time.sleep(0.02)
        raytpu.get(ja.where.remote(), timeout=T)
        raytpu.kill(ja, no_restart=False)
        with pytest.raises(raytpu.ActorDiedError):
            raytpu.get(ja.where.remote(), timeout=T)
        jax_restarts = backend._actor_restarts[ja._id]
        jax_seq = transitions("raytpu", ja._id.hex())
    finally:
        raytpu.shutdown()
        jax_events.disable_task_events()

    pa = runtime.remote(Bound).options(max_restarts=1, num_gpus=0.5).remote()
    first = runtime.get(pa.where.remote(), timeout=T)
    runtime.kill(pa, no_restart=False)
    end = time.monotonic() + T  # the restart is the owner's, as the JAX one
    while transitions("raytpu_torch", first["actor"])[-1:] != ["CREATED"] \
            or len(transitions("raytpu_torch", first["actor"])) < 4:
        assert time.monotonic() < end
        time.sleep(0.02)
    again = runtime.get(pa.where.remote(), timeout=T)
    runtime.kill(pa, no_restart=False)
    with pytest.raises(ActorDiedError):
        runtime.get(pa.where.remote(), timeout=T)
    assert pa._worker.restarts == jax_restarts == 1
    assert not first["reconstructed"] and again["reconstructed"]
    assert again["pid"] != first["pid"] and again["visible"] == "0"
    end = time.monotonic() + T
    while transitions("raytpu_torch", first["actor"])[-1:] != ["DEAD"]:
        assert time.monotonic() < end
        time.sleep(0.05)
    assert transitions("raytpu_torch", first["actor"]) == jax_seq == [
        "CREATED", "DEAD", "RESTARTED", "CREATED", "DEAD"]
    assert runtime.available_resources() == runtime.cluster_resources()


def test_a_sigkill_restarts_and_a_kill_from_elsewhere_ends_it(tree):
    a = runtime.remote(Bound).options(max_restarts=-1,
                                      num_gpus=0.5).remote()
    first = runtime.get(a.where.remote(), timeout=T)
    busy = a.sleep.remote(30)
    os.kill(first["pid"], signal.SIGKILL)
    with pytest.raises(ActorDiedError):
        runtime.get(busy, timeout=T)  # in flight at the death
    again = runtime.get(a.where.remote(), timeout=T)
    assert again["pid"] != first["pid"] and again["reconstructed"]
    killer = runtime.remote(Killer).remote()
    runtime.get(killer.kill.remote(a), timeout=T)
    with pytest.raises(ActorDiedError, match="kill"):
        runtime.get(a.where.remote(), timeout=T)
    runtime.kill(killer)
    assert a._worker.restarts == 1


def test_metrics_ship_by_default_to_the_driver(tree):
    """No RAYTPU_METRICS_SHIP in the environment: a worker actor's counter
    reaches the driver's store and ``/metrics``; the same actor under the
    JAX package's ``init`` reaches its driver's store with the same
    value."""
    import raytpu
    from raytpu import state as jax_state

    from raytpu_torch import state
    from raytpu_torch.runtime import records
    from raytpu_torch.util import metrics

    assert metrics.ENV_SHIP not in os.environ and metrics.enabled()
    a = runtime.remote(Hits).remote()
    assert runtime.get(a.hit.remote(3), timeout=T) == 3.0

    def total(st=state):
        res = st.query_metrics("raytpu_serve_requests_total",
                               tags={"deployment": "default-ship"},
                               since_s=3600.0)
        return sum(v for _, v in res["points"])

    end = time.monotonic() + T
    while total() != 3.0:
        assert time.monotonic() < end, "the actor's counter never shipped"
        time.sleep(0.05)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert metrics.start_metrics_server(port)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=T) as r:
            text = r.read().decode()
    finally:
        metrics.stop_metrics_server(port)
    [line] = [ln for ln in text.splitlines()
              if ln.startswith("raytpu_serve_requests_total{")
              and 'deployment="default-ship"' in ln]
    assert line.endswith(" 3") and text == records.prometheus_text()
    shipped = total()
    runtime.kill(a)  # its series go with it
    raytpu.shutdown()
    raytpu.init(num_cpus=1)
    try:
        ja = raytpu.remote(JaxHits).remote()
        assert raytpu.get(ja.hit.remote(3), timeout=T) == 3.0
        assert total(jax_state) == shipped == 3.0
    finally:
        raytpu.shutdown()
