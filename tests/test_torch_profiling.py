"""The port's profiling tools (raytpu_torch/util/profiler.py's sampling
half, raytpu_torch/util/profstore.py, raytpu_torch/util/memprofile.py)
held to the JAX package's on the CPU.

- The pure functions: ``fold_threads``, ``merge_collapsed``,
  ``diff_collapsed``, ``to_collapsed_text``, ``flamegraph_svg``,
  ``profile_to_svg`` and ``top_table`` give output identical to the JAX
  package's for the same dicts (made with numpy from a seed), but where
  the JAX flamegraph cuts a frame's label inside an escaped character
  and its SVG does not parse (the port's does);
- ``sample_for`` finds a hot function in both packages;
- the shipping ring's cases (tests/test_profiling.py's
  ``TestProfShipping``) and ``ProfileStore``'s (its
  ``TestProfileStore``), each one test parametrised over both packages;
- the same shipped frames through both packages' stores give equal
  ``merged``, ``diff``, ``proc_rows`` and ``stats``.
"""

import importlib
import threading

import numpy as np
import pytest

PACKAGES = ("raytpu", "raytpu_torch")


def _mod(package: str, name: str):
    return importlib.import_module(f"{package}.util.{name}")


@pytest.fixture(params=PACKAGES)
def prof(request):
    """One package's profiler, enabled, with a clean ship buffer and a
    fixed identity; restored (and disabled) on exit."""
    profiler = _mod(request.param, "profiler")
    metrics = _mod(request.param, "metrics")
    failpoints = _mod(request.param, "failpoints")
    was = profiler.profiling_enabled()
    profiler.reset_prof_shipping()
    profiler.enable_profiling()
    old_id = metrics._proc_id[0]
    metrics.set_shipper_identity("node:aaaaaaaaaaaa")
    yield profiler, failpoints
    profiler.reset_prof_shipping()
    if not was:
        profiler.disable_profiling()
    failpoints.clear()
    metrics._proc_id[0] = old_id


class _Busy:
    """A background thread with a recognizable stack: ``sample_for``
    skips the calling thread."""

    def __enter__(self):
        self._stop = threading.Event()

        def _spin_target_raytpu_torch_test():
            while not self._stop.is_set():
                sum(i * i for i in range(200))

        self._t = threading.Thread(target=_spin_target_raytpu_torch_test,
                                   name="prof-busy", daemon=True)
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        assert not self._t.is_alive()
        return False


def _frame(proc, seq, ts, collapsed=None, samples=1, window=0.1):
    return [proc, seq, ts, dict(collapsed or {"a;b": samples}),
            samples, window]


def _collapsed(rng, n: int, threads: int = 3) -> dict:
    """``n`` random stacks over a small frame vocabulary, each under one
    of ``threads`` thread names (pool serials included)."""
    frames = [f"fn{i} (mod{i % 4}.py:{10 * i + 1})" for i in range(9)]
    names = ["MainThread"] + [f"ThreadPoolExecutor-0_{i}"
                              for i in range(threads - 1)]
    out = {}
    for _ in range(n):
        depth = int(rng.integers(1, 6))
        stack = [names[int(rng.integers(len(names)))]] + [
            frames[int(i)] for i in rng.integers(0, len(frames), depth)]
        key = ";".join(stack)
        out[key] = out.get(key, 0) + int(rng.integers(1, 50))
    return out


# -- the pure functions: identical output ---------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_pure_functions_give_the_jax_package_s_output(seed):
    jax_p, port_p = (_mod(p, "profiler") for p in PACKAGES)
    rng = np.random.default_rng(seed)
    a, b = _collapsed(rng, 40), _collapsed(rng, 25, threads=5)
    for fn, args in (
            ("fold_threads", (a,)),
            ("merge_collapsed", ([a, b],)),
            ("diff_collapsed", (a, b)),
            ("diff_collapsed", (jax_p.fold_threads(a),
                                jax_p.fold_threads(b))),
            ("to_collapsed_text", (a,))):
        assert getattr(port_p, fn)(*args) == getattr(jax_p, fn)(*args), fn
    assert port_p.merge_collapsed([b, a], fold=True) == \
        jax_p.merge_collapsed([b, a], fold=True)
    assert port_p.flamegraph_svg(a, title="t <&>", width=900) == \
        jax_p.flamegraph_svg(a, title="t <&>", width=900)
    profile = {"collapsed": b, "samples": 77, "hz": 50.0, "pid": 123}
    assert port_p.profile_to_svg(profile) == jax_p.profile_to_svg(profile)
    assert port_p._cap_stacks(a, 7) == jax_p._cap_stacks(a, 7)


def test_the_svg_parses_where_a_label_is_cut_inside_an_entity():
    """The JAX package cuts a frame's escaped label, so a cut inside the
    ``&lt;`` of ``<genexpr>`` leaves its SVG malformed (not copied: the
    port cuts the name, then escapes it). Labels without such characters
    render as the JAX package's (above)."""
    import xml.etree.ElementTree as ET

    jax_p, port_p = (_mod(p, "profiler") for p in PACKAGES)
    collapsed = {"MainThread;run (a.py:1);<genexpr> (a.py:3)": 5,
                 "MainThread;run (a.py:1);<listcomp> (b.py:9)": 1}
    widths = [w for w in range(100, 400)
              if _parses(jax_p.flamegraph_svg(collapsed, width=w)) is None]
    assert widths  # widths at which the JAX package's SVG is malformed
    for w in widths:
        root = ET.fromstring(port_p.flamegraph_svg(collapsed, width=w))
        texts = [t.text for t in root.iter()
                 if t.tag.endswith("text") and t.text]
        assert any(t.startswith("<gen") for t in texts)


def _parses(svg: str):
    import xml.etree.ElementTree as ET

    try:
        return ET.fromstring(svg)
    except ET.ParseError:
        return None


def test_an_empty_profile_renders_alike():
    jax_p, port_p = (_mod(p, "profiler") for p in PACKAGES)
    assert port_p.flamegraph_svg({}) == jax_p.flamegraph_svg({})
    assert port_p.to_collapsed_text({}) == jax_p.to_collapsed_text({})


@pytest.mark.parametrize("seed", range(3))
def test_top_table_gives_the_jax_package_s_output(seed):
    rng = np.random.default_rng(seed)
    top = [{"stack": [f"m{i}.py:{int(rng.integers(1, 99))}"
                      for i in range(int(rng.integers(0, 4)))],
            "kb": int(rng.integers(0, 5000)),
            "count": int(rng.integers(1, 900))} for _ in range(40)]
    profile = {"pid": 42, "total_kb": 123456, "peak_kb": 234567,
               "rss_kb": None if seed == 2 else 345678, "top": top,
               "window_only": bool(seed % 2)}
    jax_m, port_m = (_mod(p, "memprofile") for p in PACKAGES)
    for limit in (5, 25, 100):
        assert port_m.top_table(profile, limit) == \
            jax_m.top_table(profile, limit)


def test_memory_profile_sees_a_window_s_allocations():
    memprofile = _mod("raytpu_torch", "memprofile")
    held = []

    def allocate():
        for _ in range(200):
            held.append(bytearray(4096))

    t = threading.Timer(0.05, allocate)
    t.start()
    prof = memprofile.memory_profile(duration_s=0.3, trace_frames=4,
                                     stop_after=True)
    t.join(timeout=5)
    assert set(prof) == {"collapsed", "total_kb", "peak_kb", "rss_kb",
                         "top", "window_only", "pid", "duration_s",
                         "trace_frames"}
    assert prof["window_only"] and prof["total_kb"] >= 700
    assert any("test_torch_profiling.py" in k for k in prof["collapsed"])
    assert memprofile.top_table(prof).count("\n") >= 1


@pytest.mark.parametrize("package", PACKAGES)
def test_sample_for_finds_the_hot_function(package):
    profiler = _mod(package, "profiler")
    with _Busy():
        prof = profiler.sample_for(0.3, hz=100, include_idle=False)
    assert set(prof) == {"collapsed", "samples", "duration_s", "hz", "pid"}
    assert prof["samples"] > 5
    hot = [k for k in prof["collapsed"]
           if "_spin_target_raytpu_torch_test" in k]
    assert hot and all(k.startswith("prof-busy;") for k in hot)


# -- shipping: snapshot / drain / requeue / discard ------------------------


def test_snapshot_enqueues_identified_frame(prof):
    profiler, _ = prof
    with _Busy():
        assert profiler.prof_snapshot(window_s=0.2, hz=100)
    frames, dropped = profiler.prof_drain()
    assert dropped == 0
    assert len(frames) == 1
    proc, seq, ts, collapsed, samples, window_s = frames[0]
    assert proc == "node:aaaaaaaaaaaa"
    assert seq == 1
    assert samples > 0 and collapsed
    assert any("_spin_target_raytpu_torch_test" in k for k in collapsed)
    assert not any(k.startswith("prof-busy;") for k in collapsed)


def test_seq_is_monotonic_per_process(prof):
    profiler, _ = prof
    with _Busy():
        assert profiler.prof_snapshot(window_s=0.1, hz=100)
        assert profiler.prof_snapshot(window_s=0.1, hz=100)
    frames, _ = profiler.prof_drain()
    assert [f[1] for f in frames] == [1, 2]


def test_requeue_preserves_order_and_drop_watermark(prof):
    profiler, _ = prof
    with _Busy():
        for _ in range(3):
            assert profiler.prof_snapshot(window_s=0.05, hz=100)
    frames, dropped = profiler.prof_drain()
    assert len(frames) == 3 and dropped == 0
    profiler.prof_requeue(frames, dropped)
    again, dropped2 = profiler.prof_drain()
    assert [f[1] for f in again] == [f[1] for f in frames]
    assert dropped2 == 0


def test_discard_reowes_lost_frames_exactly_once(prof):
    profiler, _ = prof
    with _Busy():
        for _ in range(2):
            assert profiler.prof_snapshot(window_s=0.05, hz=100)
    frames, dropped = profiler.prof_drain()
    profiler.prof_discard(frames, dropped)
    with _Busy():
        assert profiler.prof_snapshot(window_s=0.05, hz=100)
    more, dropped2 = profiler.prof_drain()
    assert len(more) == 1
    assert dropped2 == len(frames)
    _, dropped3 = profiler.prof_drain()
    assert dropped3 == 0


def test_buffer_overflow_drops_oldest_and_counts(prof, monkeypatch):
    profiler, _ = prof
    monkeypatch.setattr(profiler, "_PROF_BUFFER_MAX", 2)
    with _Busy():
        for _ in range(4):
            assert profiler.prof_snapshot(window_s=0.05, hz=100)
    frames, dropped = profiler.prof_drain()
    assert len(frames) == 2
    assert dropped == 2
    assert [f[1] for f in frames] == [3, 4]


def test_ingest_relays_frames_and_upstream_drops(prof):
    profiler, _ = prof
    f = _frame("worker:aaaaaaaaaaaa.bbbbbbbbbbbb", 1, 1000.0)
    profiler.prof_ingest([f], dropped=3)
    frames, dropped = profiler.prof_drain()
    assert frames == [f]
    assert dropped == 3


def test_snapshot_failpoint_drops_without_queueing(prof):
    profiler, failpoints = prof
    failpoints.cfg("profile.snapshot", "drop", env=False)
    try:
        with _Busy():
            assert not profiler.prof_snapshot(window_s=0.05, hz=100)
        assert profiler.prof_pending() == 0
        assert profiler.prof_drain() == ([], 0)
    finally:
        failpoints.off("profile.snapshot")


def test_peek_is_nondestructive(prof):
    profiler, _ = prof
    f = _frame("node:aaaaaaaaaaaa", 1, 1000.0)
    profiler.prof_ingest([f])
    assert profiler.prof_peek() == [f]
    assert profiler.prof_pending() == 1


def test_disabled_flag_is_one_boolean(prof):
    profiler, _ = prof
    profiler.disable_profiling()
    assert not profiler.profiling_enabled()
    profiler.enable_profiling()
    assert profiler.profiling_enabled()


def test_continuous_profiler_snapshots_on_its_period(prof):
    profiler, _ = prof
    with _Busy():
        cp = profiler.start_continuous(period_s=0.2, window_s=0.05, hz=100)
        try:
            assert profiler.start_continuous() is cp  # one a process
            for _ in range(100):
                if profiler.prof_pending() >= 2:
                    break
                threading.Event().wait(0.05)
        finally:
            profiler.stop_continuous()
    frames, _ = profiler.prof_drain()
    assert len(frames) >= 2
    assert [f[1] for f in frames] == list(range(1, len(frames) + 1))


# -- the store ---------------------------------------------------------------


@pytest.fixture(params=PACKAGES)
def pstore(request):
    """A factory of one package's ProfileStore under a fake clock."""
    cls = _mod(request.param, "profstore").ProfileStore

    def make(**over):
        t = over.pop("t", [1000.0])
        kw = dict(max_bytes=1_000_000, ring_slots=8, clock=lambda: t[0])
        kw.update(over)
        return cls(**kw), t

    return make


def test_push_dedups_reshipped_frames(pstore):
    store, _ = pstore()
    f = _frame("node:aaaaaaaaaaaa", 1, 1000.0, {"a;b": 5}, samples=5)
    assert store.push([f]) == 1
    assert store.push([f]) == 0
    st = store.stats()
    assert st["frames_applied"] == 1
    assert st["frames_deduped"] == 1
    assert store.merged(60.0, now=1001.0)["samples"] == 5


def test_malformed_frames_counted_not_fatal(pstore):
    store, _ = pstore()
    bad = [["node:a", "x", 1.0, {}, 1, 0.1],
           ["node:a", 1, 1.0, "notadict", 1, 0.1],
           ["short"]]
    assert store.push(bad) == 0
    assert store.stats()["frames_dropped"] == 3


def test_ring_slots_cap_per_proc(pstore):
    store, _ = pstore(ring_slots=3)
    for i in range(5):
        store.push([_frame("node:aaaaaaaaaaaa", i + 1, 1000.0 + i,
                           {"s": 1})])
    st = store.stats()
    assert st["frames"] == 3
    assert st["frames_evicted"] == 2
    assert store.merged(600.0, now=1010.0)["samples"] == 3


def test_byte_cap_evicts_globally_oldest_fifo(pstore):
    store, _ = pstore(max_bytes=400, ring_slots=100)
    big = {f"stack-{i:03d};leaf": 1 for i in range(10)}
    for i in range(6):
        proc = "node:aaaaaaaaaaaa" if i % 2 else "node:bbbbbbbbbbbb"
        store.push([_frame(proc, i // 2 + 1, 1000.0 + i, big)])
    st = store.stats()
    assert st["bytes"] <= 400
    assert st["frames_evicted"] > 0
    rows = store.proc_rows()
    assert sum(r["frames"] for r in rows) == st["frames"]


def test_tombstone_drops_the_process_s_frames_and_rejects_late(pstore):
    """The port's ids: ``worker:<id>.<pid hex>`` and ``driver:<id>``,
    tombstoned by the process's id as the JAX store tombstones a
    node's."""
    store, _ = pstore()
    uid = "aaaaaaaaaaaa"
    store.push([
        _frame(f"worker:{uid}.{7:012x}", 1, 1000.0),
        _frame(f"driver:{uid}", 1, 1000.0),
        _frame("worker:cccccccccccc.000000000007", 1, 1000.0),
    ])
    assert store.mark_proc_dead(uid) == 2
    st = store.stats()
    assert st["dead_procs"] == [uid]
    assert {r["proc"] for r in store.proc_rows()} == \
        {"worker:cccccccccccc.000000000007"}
    assert store.push([_frame(f"worker:{uid}.{7:012x}", 2, 1001.0)]) == 0
    assert store.stats()["frames_rejected"] == 1
    store.revive_proc(uid)
    assert store.push([_frame(f"worker:{uid}.{7:012x}", 3, 1002.0)]) == 1


def test_merged_window_filters_by_time_and_proc(pstore):
    store, _ = pstore()
    store.push([_frame("node:aaaaaaaaaaaa", 1, 900.0, {"old": 1}),
                _frame("node:aaaaaaaaaaaa", 2, 995.0, {"new": 2},
                       samples=2),
                _frame("node:bbbbbbbbbbbb", 1, 996.0, {"new": 4},
                       samples=4)])
    res = store.merged(10.0, now=1000.0)
    assert res["collapsed"] == {"new": 6}
    assert res["procs"] == ["node:aaaaaaaaaaaa", "node:bbbbbbbbbbbb"]
    only_b = store.merged(10.0, procs=["node:bbbbbbbbbbbb"], now=1000.0)
    assert only_b["collapsed"] == {"new": 4}


def test_diff_is_recent_minus_baseline(pstore):
    store, _ = pstore()
    store.push([_frame("node:aaaaaaaaaaaa", 1, 850.0,
                       {"steady": 5, "gone": 3}, samples=8),
                _frame("node:aaaaaaaaaaaa", 2, 950.0,
                       {"steady": 5, "spike": 7}, samples=12)])
    res = store.diff(recent_s=100.0, now=1000.0)
    assert res["delta"] == {"gone": -3, "spike": 7}


def test_upstream_drops_attributed_per_proc(pstore):
    store, _ = pstore()
    store.note_upstream_drops(4, proc="node:aaaaaaaaaaaa")
    store.note_upstream_drops(2)
    assert store.stats()["upstream_drops"] == 6
    rows = {r["proc"]: r for r in store.proc_rows()}
    assert rows["node:aaaaaaaaaaaa"]["dropped"] == 4


@pytest.mark.parametrize("seed", range(3))
def test_the_same_frames_read_alike_in_both_stores(seed):
    rng = np.random.default_rng(seed)
    procs = [f"worker:{i:012x}.{i + 100:012x}" for i in range(4)]
    frames, seqs = [], {p: 0 for p in procs}
    for _ in range(60):
        p = procs[int(rng.integers(len(procs)))]
        seqs[p] += int(rng.integers(0, 3))  # duplicates and gaps
        frames.append(_frame(p, max(1, seqs[p]),
                             float(900 + rng.integers(0, 100)),
                             {f"s{int(k)};leaf": int(rng.integers(1, 9))
                              for k in rng.integers(0, 12, 4)},
                             samples=int(rng.integers(1, 30))))
    stores = []
    for package in PACKAGES:
        store = _mod(package, "profstore").ProfileStore(
            max_bytes=6000, ring_slots=10, clock=lambda: 1000.0)
        for i in range(0, len(frames), 7):
            store.push(frames[i:i + 7])
        store.note_upstream_drops(3, proc=procs[0])
        store.mark_proc_dead(procs[1].split(":")[1][:12])
        stores.append(store)
    jax_s, port_s = stores
    assert port_s.merged(50.0) == jax_s.merged(50.0)
    assert port_s.merged(200.0, 20.0, procs=procs[:3]) == \
        jax_s.merged(200.0, 20.0, procs=procs[:3])
    assert port_s.diff(30.0) == jax_s.diff(30.0)
    assert port_s.proc_rows() == jax_s.proc_rows()
    assert port_s.stats() == jax_s.stats()
