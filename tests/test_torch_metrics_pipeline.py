"""The port's metrics pipeline (raytpu_torch/util/metrics.py's shipping
half, raytpu_torch/util/tsdb.py, raytpu_torch/util/metrics_export.py)
held to the JAX package's on the CPU, then across the port's processes.

- Shipping: the assertions of tests/test_metrics_pipeline.py's shipping
  tests (delta frames with a monotonic sequence number, the rate limit,
  requeue, overflow, ingest, disarmed), each one test parametrised over
  both packages; the same metric operations give the same delta rows;
- the store: identical frames made with numpy from a seed (several
  origins, duplicates, out-of-order stamps, ring wraps under a fake
  clock, processes marked dead) through both packages' ``MetricStore``
  give equal ``query`` (every aggregation), ``series``, ``latest``,
  ``prometheus_text`` and ``stats``; the same rules over the same
  stores fire and resolve alike; the export config is the JAX
  package's;
- across processes (one set of actors for the module, armed through the
  environment before they start): an actor's counter reaches the
  driver's store exactly once however often its frames are reshipped,
  a reaped worker's series are marked dead while a live one's stay, and
  ``start_metrics_server``'s ``/metrics`` carries the driver's store.

This module imports nothing of JAX at its top: actors rebuild its
classes by importing it by name.
"""

import importlib
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from raytpu_torch import runtime
from raytpu_torch.util import metrics as port_metrics

PACKAGES = ("raytpu", "raytpu_torch")
T = 60.0


def _metrics(package: str):
    return importlib.import_module(f"{package}.util.metrics")


def _tsdb(package: str):
    return importlib.import_module(f"{package}.util.tsdb")


@pytest.fixture(params=PACKAGES)
def shipper(request):
    """One package's armed shipper with a clean buffer and identity;
    restored on exit."""
    m = _metrics(request.param)
    was = m.enabled()
    m.reset_shipping()
    m.enable_metrics_ship()
    old_id = m._proc_id[0]
    m.set_shipper_identity("node:aaaaaaaaaaaa")
    yield m
    m.reset_shipping()
    if not was:
        m.disable_metrics_ship()
    m._proc_id[0] = old_id


def _cframe(proc, seq, ts, name, inc, keys=(), vals=()):
    return [proc, seq, ts, [["c", name, list(keys), list(vals), inc]]]


# ---- shipping ----------------------------------------------------------------


def test_collect_builds_frames_with_monotonic_seq(shipper):
    m = shipper
    c = m.Counter("tp_ship_seq_total", "t")
    c.inc(3)
    assert m.collect(force=True)
    c.inc(2)
    assert m.collect(force=True)
    frames, dropped = m.drain()
    assert dropped == 0
    ours = [f for f in frames
            if any(r[1] == "tp_ship_seq_total" for r in f[3])]
    assert len(ours) == 2
    assert ours[0][0] == "node:aaaaaaaaaaaa"
    assert ours[1][1] > ours[0][1]
    assert [r[4] for f in ours for r in f[3]
            if r[1] == "tp_ship_seq_total"] == [3.0, 2.0]


def test_rate_limit_skips_inside_interval(shipper):
    m = shipper
    c = m.Counter("tp_ship_rl_total", "t")
    c.inc()
    assert m.collect(min_interval_s=10.0, now=1000.0)
    c.inc()
    assert not m.collect(min_interval_s=10.0, now=1005.0)
    assert m.collect(min_interval_s=10.0, now=1011.0)
    frames, _ = m.drain()
    assert sum(r[4] for f in frames for r in f[3]
               if r[1] == "tp_ship_rl_total") == 2.0


def test_requeue_preserves_order_and_drop_accounting(shipper):
    m = shipper
    c = m.Counter("tp_ship_rq_total", "t")
    for _ in range(3):
        c.inc()
        m.collect(force=True)
    frames, dropped = m.drain()
    assert len(frames) >= 3 and dropped == 0
    m.requeue(frames, dropped)
    assert m.drain() == (frames, 0)


def test_buffer_overflow_drops_oldest_and_counts(shipper, monkeypatch):
    m = shipper
    monkeypatch.setattr(m, "_BUFFER_MAX", 2)
    c = m.Counter("tp_ship_ovf_total", "t")
    for _ in range(4):
        c.inc()
        m.collect(force=True)
    frames, dropped = m.drain()
    assert len(frames) == 2 and dropped == 2
    m.requeue(frames, dropped)
    _, dropped2 = m.drain()
    assert dropped2 == 2


def test_ingest_relays_foreign_frames(shipper):
    m = shipper
    m.ingest([_cframe("worker:aaaaaaaaaaaa.bbbbbbbbbbbb", 1, 1000.0,
                      "tp_ship_ing_total", 1.0)], dropped=3)
    frames, dropped = m.drain()
    assert any(f[0].startswith("worker:") for f in frames)
    assert dropped == 3


def test_disarmed_shipping_is_inert(shipper):
    m = shipper
    m.disable_metrics_ship()
    try:
        assert not m.enabled()
        m.Counter("tp_ship_off_total", "t").inc()
        assert not m.collect(force=True)
        assert m.pending_frames() == 0
    finally:
        m.enable_metrics_ship()


@pytest.mark.parametrize("package", PACKAGES)
def test_disarming_for_children_sets_the_variable_to_zero(package,
                                                          monkeypatch):
    m = _metrics(package)
    was = m.enabled()
    monkeypatch.delenv(m.ENV_SHIP, raising=False)
    try:
        m.disable_metrics_ship(env=True)
        assert os.environ[m.ENV_SHIP] == "0" and not m.enabled()
        m.enable_metrics_ship(env=True)
        assert os.environ[m.ENV_SHIP] == "1" and m.enabled()
    finally:
        (m.enable_metrics_ship if was else m.disable_metrics_ship)()


def _delta_rows_after(package: str, seed: int) -> list:
    """Each metric kind driven by the same seeded operations, and the
    delta rows it ships after each of three rounds."""
    m = _metrics(package)
    rng = np.random.default_rng(seed)
    c = m.Counter(f"tp_rows{seed}_total", "t", tag_keys=("k",))
    g = m.Gauge(f"tp_rows{seed}_gauge", "t", tag_keys=("k",))
    h = m.Histogram(f"tp_rows{seed}_seconds", "t",
                    boundaries=(0.1, 0.5, 1.0, 5.0), tag_keys=("k",))
    rows = []
    for _ in range(3):
        for _ in range(int(rng.integers(1, 20))):
            tags = {"k": f"v{int(rng.integers(3))}"}
            op = int(rng.integers(3))
            x = float(rng.exponential(1.0))
            if op == 0:
                c.inc(round(x, 3), tags=tags)
            elif op == 1:
                g.set(round(x, 3), tags=tags)
            else:
                h.observe(round(x, 3), tags=tags)
        rows.append([c._delta_rows(), g._delta_rows(), h._delta_rows()])
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_same_operations_ship_the_same_rows(seed):
    assert _delta_rows_after("raytpu_torch", seed) == \
        _delta_rows_after("raytpu", seed)


# ---- the store, fed the same frames through both packages ----------------


PROCS = ("driver:aaaaaaaaaaaa", "worker:bbbbbbbbbbbb.000000001234",
         "worker:cccccccccccc.000000005678", "node:dddddddddddd")
BOUNDS = [0.05, 0.25, 1.0, 5.0]


def seeded_frames(seed: int, n: int = 120):
    """Frames from several origins over ten minutes: counters, gauges and
    histograms with tags, each origin's sequence numbers monotonic, with
    duplicates (a requeued frame shipped twice) and out-of-order
    arrival."""
    rng = np.random.default_rng(seed)
    seq = {p: 0 for p in PROCS}
    frames = []
    for i in range(n):
        proc = PROCS[int(rng.integers(len(PROCS)))]
        seq[proc] += 1
        ts = 10_000.0 + i * 5.0 + float(rng.uniform(0, 4))
        rows = []
        for _ in range(int(rng.integers(1, 4))):
            tag = f"t{int(rng.integers(2))}"
            kind = int(rng.integers(3))
            if kind == 0:
                rows.append(["c", "tp_c_total", ["tenant"], [tag],
                             float(rng.integers(1, 9))])
            elif kind == 1:
                rows.append(["g", "tp_g", ["tenant"], [tag],
                             round(float(rng.uniform(0, 10)), 3)])
            else:
                counts = [int(x) for x in rng.integers(0, 5, len(BOUNDS) + 1)]
                rows.append(["h", "tp_h_seconds", ["tenant"], [tag],
                             list(BOUNDS), counts,
                             round(float(rng.uniform(0, 10)), 3),
                             sum(counts)])
        frames.append([proc, seq[proc], ts, rows])
    pushes = [[f] for f in frames]
    for k in rng.choice(len(pushes), 10, replace=False):
        pushes.append([frames[int(k)]])  # reshipped
    order = rng.permutation(len(pushes))
    # Mostly in order, a few late: swap neighbours.
    order = np.sort(order)
    for k in rng.choice(len(order) - 1, 15, replace=False):
        order[k], order[k + 1] = order[k + 1], order[k]
    return [pushes[int(k)] for k in order]


def store_readings(package: str, pushes, small: bool, dead: bool) -> dict:
    t = [10_000.0]
    kw = dict(max_bytes=1_000_000, fine_step_s=5.0, fine_slots=120,
              coarse_step_s=30.0, coarse_slots=120)
    if small:
        kw.update(max_bytes=40_000, fine_step_s=1.0, fine_slots=8,
                  coarse_step_s=10.0, coarse_slots=30)
    store = _tsdb(package).MetricStore(clock=lambda: t[0], **kw)
    applied = []
    for k, push in enumerate(pushes):
        t[0] = push[0][2] + 0.5
        applied.append(store.push([list(f) for f in push]))
        if dead and k == len(pushes) // 2:
            applied.append(store.mark_proc_dead("bbbbbbbbbbbb"))
    t[0] = 10_000.0 + 600.0
    out = {"applied": applied, "stats": store.stats(),
           "series": store.series(), "series_tp_c": store.series("tp_c"),
           "prom": store.prometheus_text()}
    for name in ("tp_c_total", "tp_g", "tp_h_seconds", "missing"):
        for agg in _tsdb(package).AGGS:
            for tags in (None, {"tenant": "t0"},
                         {"proc": "driver:aaaaaaaaaaaa"}):
                for step in (None, 30.0):
                    out[f"q/{name}/{agg}/{tags}/{step}"] = store.query(
                        name, tags=tags, agg=agg, since_s=600.0, step=step)
        out[f"latest/{name}"] = store.latest(name)
        out[f"latest/{name}/t1"] = store.latest(name, {"tenant": "t1"})
    return out


@pytest.mark.parametrize("small,dead", [(False, False), (True, False),
                                        (False, True)],
                         ids=["plain", "small-rings", "proc-dead"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stores_fed_the_same_frames_agree(seed, small, dead):
    pushes = seeded_frames(seed)
    want = store_readings("raytpu", pushes, small, dead)
    got = store_readings("raytpu_torch", pushes, small, dead)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert want["stats"]["frames_deduped"] > 0
    if dead:
        assert want["stats"]["frames_rejected"] > 0


def _firings(package: str, seed: int) -> list:
    tsdb = _tsdb(package)
    t = [1000.0]
    store = tsdb.MetricStore(fine_step_s=1.0, fine_slots=120,
                             coarse_step_s=10.0, coarse_slots=60,
                             clock=lambda: t[0])
    log = []
    rules = tsdb.parse_alert_rules(
        "tp_g:max > 5 for 2s; tp_c_total:rate > 0.5; "
        "tp_h_seconds:p95 >= 1 for 3s")
    rules += tsdb.serve_slo_preset_rules("acme=0.5; free-tier=2", for_s=2.0)
    ev = tsdb.AlertEvaluator(
        store, rules,
        on_fire=lambda r, v: log.append(("fire", r.name, v, t[0])),
        on_resolve=lambda r, v: log.append(("resolve", r.name, v, t[0])))
    rng = np.random.default_rng(seed)
    for i in range(80):
        t[0] = 1000.0 + i
        g = float(rng.choice([1.0, 9.0], p=[0.3, 0.7])) if i < 50 else 1.0
        counts = [int(x) for x in rng.integers(0, 3, 5)]
        store.push([["node:aaaaaaaaaaaa", i + 1, t[0], [
            ["g", "tp_g", [], [], g],
            ["c", "tp_c_total", [], [], float(rng.integers(0, 2))],
            ["h", "tp_h_seconds", [], [], [0.1, 0.5, 1.0, 2.0], counts,
             1.0, sum(counts)],
            ["h", "raytpu_serve_ttft_seconds", ["tenant"], ["acme"],
             [0.1, 0.5, 1.0, 2.0], counts, 1.0, sum(counts)]]]])
        ev.tick()
        log.append(("firing", tuple(ev.firing())))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_the_same_rules_fire_and_resolve_alike(seed):
    got = _firings("raytpu_torch", seed)
    assert got == _firings("raytpu", seed)
    assert any(e[0] == "fire" for e in got)
    assert any(e[0] == "resolve" for e in got)


def test_malformed_rules_raise_in_both():
    for package in PACKAGES:
        tsdb = _tsdb(package)
        with pytest.raises(ValueError):
            tsdb.parse_alert_rules("what even is this")
        with pytest.raises(ValueError):
            tsdb.parse_alert_rules("m:notanagg > 1")


def test_the_export_config_is_the_jax_package_s(tmp_path):
    from raytpu.util import metrics_export as jax_export

    from raytpu_torch.util import metrics_export as port_export

    targets = ["127.0.0.1:8090", "host:9000"]
    assert port_export.prometheus_config(targets) == \
        jax_export.prometheus_config(targets)
    assert port_export.grafana_dashboard() == jax_export.grafana_dashboard()
    paths = port_export.export_config(str(tmp_path), targets)
    assert sorted(os.path.basename(p) for p in paths) == [
        "grafana_raytpu.json", "prometheus.yml"]


def test_concurrent_ships_lose_no_update():
    """The driver's store takes ships on many registry threads at once:
    with the interpreter switching threads every microsecond, every
    event, frame and count lands once."""
    import sys
    import threading

    from raytpu_torch.runtime import records, serialization

    n_threads, ships = 16, 40

    def ship_all(k):
        for i in range(ships):
            events = [{"kind": "task", "id": f"t{k}-{i}",
                       "transition": "FINISHED", "ts": time.time(),
                       "mono": 0.0, "node_id": "", "worker_id": f"w{k}",
                       "attempt": 0}]
            frames = [[f"worker:{k:012x}.{0:012x}", i + 1, time.time(),
                       [["c", "tp_stress_total", [], [], 1.0]]]]
            records.ingest(serialization.dumps(
                (events, 0, frames, 0, [], 0)))

    records.reset()
    threads = [threading.Thread(target=ship_all, args=(k,))
               for k in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
    finally:
        sys.setswitchinterval(old)
    try:
        assert not any(t.is_alive() for t in threads)
        n = n_threads * ships
        stats = records.ship_stats()
        assert (stats["ships"], stats["events"], stats["frames"]) == (n, n, n)
        assert stats["lag_s"]["count"] == n
        assert records.event_store().stats()["entities"]["task"] == n
        res = records.metric_store().query("tp_stress_total", since_s=600.0)
        assert sum(v for _, v in res["points"]) == n
        assert res["series_matched"] == n_threads
    finally:
        records.reset()


# ---- across the port's processes -------------------------------------------

# Module-level so that an actor process ships it (the shipper walks the
# metrics alive in its process).
HITS = port_metrics.Counter("raytpu_serve_requests_total",
                            tag_keys=("deployment", "tenant"))


class Hitter:
    """Counts hits on ``raytpu_serve_requests_total`` in its process."""

    def hit(self, n: int, deployment: str) -> float:
        for _ in range(n):
            HITS.inc(tags={"deployment": deployment, "tenant": "t"})
        return HITS.value

    def identity(self) -> str:
        from raytpu_torch.runtime import records

        return records.identity()

    def reship(self) -> int:
        """A requeued ship sent twice: the same frames reach the driver
        two times over."""
        from raytpu_torch.runtime import api, records

        HITS.inc(tags={"deployment": "reship", "tenant": "t"})
        blob = records.collect_ship(force=True)
        records.requeue_ship(blob)
        again = records.collect_ship(force=True)
        api._ask_registry("ship", blob)
        api._ask_registry("ship", again)
        return len(blob)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def armed():
    """Metrics shipping armed through the environment before the module's
    actors start (their forkserver reads it), the driver's store reset;
    everything restored at the end."""
    from raytpu_torch.runtime import records

    saved = os.environ.get(port_metrics.ENV_SHIP)
    was = port_metrics.enabled()
    port_metrics.enable_metrics_ship(env=True)
    records.reset()
    cls = runtime.remote(Hitter)
    yield cls
    runtime.shutdown()
    records.reset()
    if saved is None:
        os.environ.pop(port_metrics.ENV_SHIP, None)
    else:
        os.environ[port_metrics.ENV_SHIP] = saved
    if not was:
        port_metrics.disable_metrics_ship()


def series_total(deployment: str) -> float:
    from raytpu_torch import state

    res = state.query_metrics("raytpu_serve_requests_total",
                              tags={"deployment": deployment},
                              since_s=3600.0)
    return sum(v for _, v in res["points"])


def poll(fn, what: str, timeout: float = T):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_an_actor_s_counter_reaches_the_driver_exactly_once(armed):
    from raytpu_torch.cluster import constants

    a = armed.remote()
    assert runtime.get(a.hit.remote(5, "once"), timeout=T) == 5.0
    poll(lambda: series_total("once") == 5.0, "the first ship")
    # Several ship periods later nothing counted twice.
    time.sleep(2.5 * constants.METRICS_SHIP_PERIOD_S)
    assert series_total("once") == 5.0
    assert runtime.get(a.hit.remote(2, "once"), timeout=T) == 7.0
    poll(lambda: series_total("once") == 7.0, "the second ship")
    runtime.kill(a)


def test_a_reshipped_batch_merges_once(armed):
    from raytpu_torch.runtime import records

    a = armed.remote()
    before = records.metric_store().stats()["frames_deduped"]
    assert runtime.get(a.reship.remote(), timeout=T) > 0
    assert series_total("reship") == 1.0
    assert records.metric_store().stats()["frames_deduped"] > before
    runtime.kill(a)


def test_a_reaped_worker_s_series_are_marked_dead(armed):
    from raytpu_torch import state
    from raytpu_torch.runtime import records

    dying, living = armed.remote(), armed.remote()
    runtime.get([dying.hit.remote(3, "dying"),
                 living.hit.remote(4, "living")], timeout=T)
    uid = runtime.get(dying.identity.remote(), timeout=T)
    poll(lambda: series_total("dying") == 3.0
         and series_total("living") == 4.0, "both ships")

    def procs():
        return {s["tags"]["proc"] for s in state.list_metric_series(
            "raytpu_serve_requests_total")}

    assert any(p.startswith(f"worker:{uid}.") for p in procs())
    runtime.kill(dying)
    poll(lambda: not any(p.startswith(f"worker:{uid}.") for p in procs()),
         "the dead worker's series to go")
    assert series_total("dying") == 0.0
    assert series_total("living") == 4.0
    # A late frame from the dead worker is rejected, not resurrected.
    rejected = records.metric_store().stats()["frames_rejected"]
    records.metric_store().push([_cframe(
        f"worker:{uid}.{0:012x}", 99, time.time(),
        "raytpu_serve_requests_total", 9.0, ("deployment", "tenant"),
        ("dying", "t"))])
    assert records.metric_store().stats()["frames_rejected"] == rejected + 1
    assert series_total("dying") == 0.0
    runtime.kill(living)


def test_metrics_server_serves_the_driver_s_store(armed):
    from raytpu_torch.runtime import records

    a = armed.remote()
    runtime.get(a.hit.remote(2, "scraped"), timeout=T)
    poll(lambda: series_total("scraped") == 2.0, "the ship")
    port = free_port()
    assert port_metrics.start_metrics_server(port)
    try:
        assert port_metrics.start_metrics_server(port)  # idempotent
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=T) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert text == records.prometheus_text()
        [line] = [ln for ln in text.splitlines()
                  if ln.startswith("raytpu_serve_requests_total{")
                  and 'deployment="scraped"' in ln]
        assert line.endswith(" 2")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=T)
        assert err.value.code == 404
    finally:
        port_metrics.stop_metrics_server(port)
    port_metrics.stop_metrics_server(port)  # a no-op
    runtime.kill(a)
