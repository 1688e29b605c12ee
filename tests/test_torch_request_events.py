"""Request lifecycle events of the port's serving plane
(raytpu_torch/util/task_events.py, emitted by the scheduler, the engine
and LLMDeployment) against the JAX package's, on tiny Llama in fp32 with
the JAX weights carried across: the same traffic through both engines,
with request events, tracing and profiling on in both, gives each
request the same transitions in the same order, with the same tags and
data (tests/test_request_events.py's contracts). Scenarios: staggered
arrivals, a chunked prompt, a prefix-cache hit, a preemption with
resume, and aborts in ``waiting``, in ``running`` and mid-prefill. Also:
the disabled path records nothing, a deployment's request context tags
its events, and a KV handoff's events and counters (one pull, one that
falls back) match the JAX replica body's.

This module holds the harness that tests/test_torch_metrics.py and
tests/test_torch_tracing.py run too: ``observing`` turns the flags on
in both packages and puts every one back as it was, and ``SCENARIOS``
are driven step by step (``run_scenario``) with arrivals and aborts
fixed by step number."""

import collections
import contextlib
import os
import types

import pytest

from raytpu.inference import InferenceEngine as JaxEngine
from raytpu.inference import SamplingParams as JaxSampling
from raytpu.inference import disagg as jax_disagg
from raytpu.inference import engine as jax_engine
from raytpu.inference import prefix_cache as jax_prefix_cache
from raytpu.inference import PagedKVCache as JaxPagedKVCache
from raytpu.inference import Scheduler as JaxScheduler
from raytpu.inference import Sequence as JaxSequence
from raytpu.util import metrics as jax_metrics
from raytpu.util import profiler as jax_profiler
from raytpu.util import serve_slo as jax_serve_slo
from raytpu.util import stepprof as jax_stepprof
from raytpu.util import task_events as jax_task_events
from raytpu.util import tracing as jax_tracing
from raytpu_torch.inference import InferenceEngine, SamplingParams
from raytpu_torch.inference import PagedKVCache, Scheduler, Sequence
from raytpu_torch.inference import disagg, engine, prefix_cache
from raytpu_torch.util import (metrics, profiler, serve_slo, stepprof,
                               task_events, tracing)

from test_torch_disagg import FaultyPeer
from test_torch_engine import PROMPTS, weights  # noqa: F401
from test_torch_serving import (ENGINE_OPTIONS, jax_replicas,  # noqa: F401
                                port_deployment, watched)

JAX = types.SimpleNamespace(
    name="jax", engine=jax_engine, prefix_cache=jax_prefix_cache,
    disagg=jax_disagg, metrics=jax_metrics, serve_slo=jax_serve_slo,
    task_events=jax_task_events, tracing=jax_tracing,
    profiler=jax_profiler, stepprof=jax_stepprof)
PORT = types.SimpleNamespace(
    name="port", engine=engine, prefix_cache=prefix_cache, disagg=disagg,
    metrics=metrics, serve_slo=serve_slo, task_events=task_events,
    tracing=tracing, profiler=profiler, stepprof=stepprof)
PACKAGES = (JAX, PORT)
# Keys of an event that are the clock's or the process's, not the
# request's.
UNCOMPARED = ("ts", "mono", "node_id", "worker_id")


def _flags(pkg):
    """(is on, turn on, turn off) of each of the three flags."""
    ev, tr, pr = pkg.task_events, pkg.tracing, pkg.profiler
    return [(ev.request_events_enabled, ev.enable_request_events,
             ev.disable_request_events),
            (tr.enabled, tr.enable_tracing, tr.disable_tracing),
            (pr.profiling_enabled, pr.enable_profiling,
             pr.disable_profiling)]


@contextlib.contextmanager
def observing(events=True, spans=True, profile=True):
    """Request events, tracing and profiling as asked in both packages,
    every root span sampled, the event rings and span buffers empty;
    every flag and the sample rate back as they were on the way out (they
    are process-wide, and one file's tests share a process)."""
    want = (events, spans, profile)
    saved = [[is_on() for is_on, _, _ in _flags(pkg)] for pkg in PACKAGES]
    rates = [pkg.tracing._sample_rate for pkg in PACKAGES]
    try:
        for pkg in PACKAGES:
            for (_, on, off), w in zip(_flags(pkg), want):
                (on if w else off)()
            pkg.tracing._sample_rate = 1.0  # every root span records
            pkg.task_events.clear()
            pkg.tracing.clear_spans()
        yield
    finally:
        for pkg, states, rate in zip(PACKAGES, saved, rates):
            for (_, on, off), was in zip(_flags(pkg), states):
                (on if was else off)()
            pkg.tracing._sample_rate = rate
            pkg.task_events.clear()
            pkg.tracing.clear_spans()


def infer_counters(pkg) -> dict:
    """Every ``raytpu_infer_*`` counter of a package's serving plane."""
    out = {}
    for mod in (pkg.engine, pkg.prefix_cache, pkg.disagg):
        for obj in vars(mod).values():
            if isinstance(obj, pkg.metrics.Counter) and \
                    obj._name.startswith("raytpu_infer_"):
                out[obj._name] = obj
    return out


def infer_gauges(pkg) -> dict:
    return {obj._name: obj for obj in vars(pkg.engine).values()
            if isinstance(obj, pkg.metrics.Gauge)}


def reading(pkg) -> dict:
    """The process-wide series a run moves: every counter's total, the
    wasted ledger by tags, and the TTFT and step-time histograms'
    counts."""
    return {
        "counters": {name: c.value for name, c in
                     infer_counters(pkg).items()},
        "wasted": dict(pkg.serve_slo.tokens_wasted._values),
        "ttft_count": len(pkg.engine._ttft_hist.observations),
        "step_count": len(pkg.stepprof.step_profiler("infer")
                          ._step.observations),
    }


def delta(before: dict, after: dict) -> dict:
    out = {}
    for key, value in after.items():
        if isinstance(value, dict):
            out[key] = {k: v - before[key].get(k, 0.0)
                        for k, v in value.items()
                        if v - before[key].get(k, 0.0)}
        else:
            out[key] = value - before[key]
    return out


def request_events(pkg) -> dict:
    """Each request's events in order, without clock or process keys
    (the JAX ring also takes task events, should another test have left
    that recorder on)."""
    by_id = collections.defaultdict(list)
    for ev in pkg.task_events.get_events():
        if ev["kind"] == "request":
            by_id[ev["id"]].append({k: v for k, v in ev.items()
                                    if k not in UNCOMPARED})
    return dict(by_id)


def transitions(events: list) -> list:
    return [ev["transition"] for ev in events]


def infer_spans(pkg) -> collections.Counter:
    """The multiset of (name, attributes) of the engine's spans."""
    return collections.Counter(
        (s["name"], tuple(sorted(s["attributes"].items())))
        for s in pkg.tracing.get_spans() if s["name"].startswith("infer."))


SYSTEM = list(range(1, 17))
# name: (engine options, arrivals {step: [(id, prompt, tenant)]},
#        aborts {step: [id]}, new tokens)
SCENARIOS = {
    "staggered": (dict(page_size=8, max_num_seqs=4, max_model_len=64),
                  {3 * i: [(f"r{i}", p, "acme" if i % 2 else "")]
                   for i, p in enumerate(PROMPTS)}, {}, 8),
    "chunked": (dict(page_size=4, max_num_seqs=4, max_model_len=48,
                     prefill_chunk=8),
                {0: [("long", list(range(2, 22)), "acme"),
                     ("short", [5, 6, 7], "")],
                 2: [("mid", list(range(60, 73)), "globex")]}, {}, 8),
    "prefix_hit": (dict(page_size=8, max_num_seqs=4, max_model_len=64),
                   {0: [("p0", SYSTEM + [30], "acme")],
                    2: [("p1", SYSTEM + [31], "acme")],
                    4: [("p2", SYSTEM + [32, 33], "")]}, {}, 6),
    "preemption": (dict(page_size=4, num_pages=6, max_num_seqs=2,
                        max_model_len=24),
                   {0: [("a", list(range(1, 8)), "acme"),
                        ("b", list(range(20, 25)), "globex")]}, {}, 8),
    # One sequence at a time: "wait" is aborted while waiting, "run"
    # while decoding, "chunky" between two of its prefill chunks.
    "aborts": (dict(page_size=4, max_num_seqs=1, max_model_len=48,
                    prefill_chunk=8),
               {0: [("run", list(range(1, 7)), "acme"),
                    ("wait", list(range(11, 15)), "")],
                3: [("chunky", list(range(20, 40)), "acme")],
                5: [("after", [3, 4, 5, 6, 7], "")]},
               {2: ["wait"], 3: ["run"], 5: ["chunky"]}, 8),
}
DEPLOYMENT = "app#LLMDeployment"


def drive(eng, sampling, arrivals: dict, aborts: dict) -> dict:
    """Step ``eng`` until the traffic is done: before step n, abort the
    ids ``aborts`` names for it and add the requests ``arrivals`` does
    (tagged with the deployment and their tenant). Returns each
    request's tokens."""
    out = {rid: [] for reqs in arrivals.values() for rid, _, _ in reqs}
    last = max(list(arrivals) + list(aborts))
    step = 0
    while step <= last or eng.has_unfinished():
        for rid in aborts.get(step, []):
            assert eng.abort(rid)
        for rid, prompt, tenant in arrivals.get(step, []):
            seq = eng.add_request(rid, prompt, sampling)
            seq.deployment, seq.tenant = DEPLOYMENT, tenant
        for o in eng.step():
            out[o.request_id].append(o.token_id)
        step += 1
    return out


def observe(pkg, eng, sampling, arrivals: dict, aborts: dict) -> dict:
    """Drive one engine with the flags as they are and read what its
    observability recorded: tokens, events, spans, the deltas of the
    process-wide series, the gauges after the run and after
    ``note_idle``, and the engine's own call counts."""
    pkg.task_events.clear()
    pkg.tracing.clear_spans()
    before = reading(pkg)
    tokens = drive(eng, sampling, arrivals, aborts)
    moved = delta(before, reading(pkg))
    gauges = {name: g.value for name, g in infer_gauges(pkg).items()}
    eng.note_idle()
    idle = {name: g.value for name, g in infer_gauges(pkg).items()}
    return {"tokens": tokens, "events": request_events(pkg),
            "dropped": pkg.task_events.dropped_count(),
            "spans": infer_spans(pkg), "delta": moved, "gauges": gauges,
            "idle": idle, "stats": eng.stats(),
            "scheduler": (len(eng.scheduler.running),
                          len(eng.scheduler.waiting),
                          eng.cache.utilization())}


def run_scenario(weights, name: str, **flags) -> dict:
    """One scenario through a fresh engine of each package, flags on
    (or as ``flags`` say) in both: ``{"jax": ..., "port": ...}``."""
    jax_cfg, params, model = weights
    engine_kw, arrivals, aborts, new = SCENARIOS[name]
    with observing(**flags):
        return {
            "jax": observe(JAX, JaxEngine(jax_cfg, params, **engine_kw),
                           JaxSampling(max_new_tokens=new), arrivals,
                           aborts),
            "port": observe(PORT, InferenceEngine(model, device="cpu",
                                                  **engine_kw),
                            SamplingParams(max_new_tokens=new), arrivals,
                            aborts),
        }


@pytest.fixture(scope="module")
def scenario_runs(weights):
    """Each scenario run once per module, on first use."""
    cache = {}

    def get(name: str) -> dict:
        if name not in cache:
            cache[name] = run_scenario(weights, name)
        return cache[name]

    return get


# -- the engine's traffic, both packages ----------------------------------


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_request_events_match_jax(name, scenario_runs):
    runs = scenario_runs(name)
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["tokens"] == jax_run["tokens"]
    assert port_run["events"] == jax_run["events"]
    assert set(port_run["events"]) == set(port_run["tokens"])
    assert jax_run["dropped"] == port_run["dropped"] == 0
    for rid, events in port_run["events"].items():
        tenant = next(t for reqs in SCENARIOS[name][1].values()
                      for r, _, t in reqs if r == rid)
        assert {(ev["deployment"], ev["tenant"]) for ev in events} == \
            {(DEPLOYMENT, tenant)}


@pytest.mark.parametrize("name", ["staggered", "chunked", "prefix_hit"])
def test_each_request_walks_the_jax_order(name, scenario_runs):
    # The JAX engine samples the first token inside the call that ends
    # the prefill, so FIRST_TOKEN comes before PREFILL_END.
    for rid, events in scenario_runs(name)["port"]["events"].items():
        assert transitions(events) == [
            "ADMITTED", "PREFILL_START", "FIRST_TOKEN", "PREFILL_END",
            "FINISHED"], rid
        start, finished = events[1]["data"], events[-1]["data"]
        assert finished == {"tokens_out": SCENARIOS[name][3],
                            "reason": "length"}
        assert start["prompt_tokens"] == next(
            len(p) for reqs in SCENARIOS[name][1].values()
            for r, p, _ in reqs if r == rid)


def test_prefix_hit_prefill_starts_past_the_cached_pages(scenario_runs):
    events = scenario_runs("prefix_hit")["port"]["events"]
    cached = {rid: evs[1]["data"]["cached"] for rid, evs in events.items()}
    assert cached == {"p0": 0, "p1": 16, "p2": 16}


def test_preemption_emits_preempted_and_resumed(scenario_runs):
    runs = scenario_runs("preemption")
    events = runs["port"]["events"]
    assert runs["port"]["stats"]["num_preemptions"] >= 1
    victims = [rid for rid, evs in events.items()
               if "PREEMPTED" in transitions(evs)]
    assert victims
    for rid in victims:
        trs = transitions(events[rid])
        # Announced once: a resume prefill re-runs the known tokens and
        # RESUMED covers it.
        assert trs.count("PREFILL_START") == 1
        assert trs.index("PREEMPTED") < trs.index("RESUMED")
        assert trs[-1] == "FINISHED"
        preempted = next(ev for ev in events[rid]
                         if ev["transition"] == "PREEMPTED")
        assert preempted["data"]["tokens_discarded"] > 0


def test_aborts_in_waiting_running_and_mid_prefill(scenario_runs):
    events = scenario_runs("aborts")["port"]["events"]
    assert transitions(events["wait"]) == ["ABORTED"]
    assert transitions(events["run"]) == [
        "ADMITTED", "PREFILL_START", "FIRST_TOKEN", "PREFILL_END",
        "ABORTED"]
    # Aborted between its chunks: started, never ended.
    assert transitions(events["chunky"]) == [
        "ADMITTED", "PREFILL_START", "ABORTED"]
    assert transitions(events["after"])[-1] == "FINISHED"


def test_disabled_path_records_nothing(weights):
    """Every flag off: no event, no span, no step observation, in either
    package; the always-on counters still move, as in the JAX package."""
    runs = run_scenario(weights, "chunked", events=False, spans=False,
                        profile=False)
    for run in runs.values():
        assert run["events"] == {} and not run["spans"]
        assert run["delta"]["step_count"] == 0
        assert run["delta"]["counters"][
            "raytpu_infer_prefill_tokens_total"] > 0
    assert runs["port"]["tokens"] == runs["jax"]["tokens"]
    assert runs["port"]["delta"] == runs["jax"]["delta"]


# -- the scheduler alone (tests/test_request_events.py:160-216) -----------


def _scheduler(pages, jax_package=False):
    cache_cls, sched_cls = ((JaxPagedKVCache, JaxScheduler) if jax_package
                            else (PagedKVCache, Scheduler))
    kw = {} if jax_package else {"device": "cpu"}
    cache = cache_cls(num_layers=1, num_pages=pages, page_size=4,
                      num_kv_heads=1, head_dim=1, **kw)
    return sched_cls(cache, max_num_seqs=8, max_model_len=64)


def _seq(rid, prompt_len, tenant="acme", jax_package=False):
    s = (JaxSequence if jax_package else Sequence)(
        request_id=rid, prompt=list(range(1, prompt_len + 1)))
    s.deployment = DEPLOYMENT
    s.tenant = tenant
    return s


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p.name)
def test_preemption_books_wasted_tokens_and_timeline(pkg):
    jax_package = pkg is JAX
    with observing(spans=False, profile=False):
        sched = _scheduler(5, jax_package)  # 4 usable pages
        a = _seq("ra", 8, jax_package=jax_package)
        b = _seq("rb", 7, jax_package=jax_package)
        before = dict(pkg.serve_slo.tokens_wasted._values)
        sched.add(a)
        sched.add(b)
        assert sched.schedule().prefills == [a, b]
        a.cached_len, b.cached_len = 8, 7
        a.generated.append(1)
        b.generated.append(4)
        # a needs a 3rd page for token 9; none free: b (youngest) is
        # preempted to recompute.
        assert sched.schedule().preempted == [b]
        after = dict(pkg.serve_slo.tokens_wasted._values)
        key = ("preempt_recompute", DEPLOYMENT, "acme")
        assert after[key] - before.get(key, 0.0) == 1.0
        sched.finish(a, "stop")
        sched.schedule()
        trs = [(e["id"], e["transition"])
               for e in pkg.task_events.get_events()]
    assert trs == [("ra", "ADMITTED"), ("rb", "ADMITTED"),
                   ("rb", "PREEMPTED"), ("ra", "FINISHED"),
                   ("rb", "RESUMED")]


def test_abort_in_waiting_emits_aborted():
    with observing(spans=False, profile=False):
        sched = _scheduler(9)
        sched.add(_seq("rw", 4))
        assert sched.abort("rw")
        (ev,) = [e for e in task_events.get_events()
                 if e["transition"] == "ABORTED"]
    assert ev["id"] == "rw" and ev["tenant"] == "acme"


def test_disabled_scheduler_path_emits_nothing():
    with observing(events=False, spans=False, profile=False):
        sched = _scheduler(9)
        a = _seq("rq", 4)
        sched.add(a)
        sched.schedule()
        sched.finish(a, "stop")
        assert task_events.get_events() == []


# -- the recorder --------------------------------------------------------


def test_vocabulary_is_the_jax_package_s():
    assert task_events.RequestTransition.ALL == \
        jax_task_events.RequestTransition.ALL
    assert task_events.REQUEST_ENV_VAR == jax_task_events.REQUEST_ENV_VAR


def test_disabled_emit_is_noop():
    with observing(events=False, spans=False, profile=False):
        task_events.emit_request("r1", "RECEIVED", deployment="d",
                                 tenant="t")
        assert task_events.get_events() == []


def test_event_shape_matches_jax_and_carries_the_trace_id():
    shapes = []
    with observing(profile=False):
        for pkg in PACKAGES:
            with pkg.tracing.span("outer"):
                pkg.task_events.emit_request(
                    "r1", "ROUTED", deployment="app#Dep", tenant="acme",
                    data={"replica": "rid-1"}, error="x" * 300)
            (ev,) = pkg.task_events.get_events()
            (span,) = pkg.tracing.get_spans()
            assert ev["trace_id"] == span["trace_id"]
            shapes.append({k: v for k, v in ev.items()
                           if k not in UNCOMPARED + ("trace_id",)})
    assert shapes[0] == shapes[1]
    assert len(shapes[1]["error"]) == 256


def test_full_ring_drops_the_oldest_and_counts(monkeypatch):
    with observing(spans=False, profile=False):
        monkeypatch.setattr(task_events, "_ring",
                            collections.deque(maxlen=3))
        for i in range(5):
            task_events.emit_request(f"r{i}", "QUEUED")
        assert [e["id"] for e in task_events.get_events()] == \
            ["r2", "r3", "r4"]
        assert task_events.dropped_count() == 2
        task_events.clear()
        assert task_events.dropped_count() == 0


def test_enable_with_env_exports_the_flag(monkeypatch):
    monkeypatch.delenv(task_events.REQUEST_ENV_VAR, raising=False)
    with observing(events=False, spans=False, profile=False):
        task_events.enable_request_events(env=True)
        assert task_events.request_events_enabled()
        assert os.environ[task_events.REQUEST_ENV_VAR] == "1"
        task_events.disable_request_events(env=True)
        assert task_events.REQUEST_ENV_VAR not in os.environ


# -- LLMDeployment: request context tags, the KV handoff ------------------

PROMPT = list(range(1, 20))  # two full pages of 8 shipped, a 3-token tail


def _generate_in_context(pkg, dep, ctx: dict, prompt, n: int) -> list:
    """Stream one request with ``ctx`` as the package's request
    context."""
    from raytpu.serve._private import replica as jax_replica
    from raytpu_torch.inference import serving

    var = (jax_replica if pkg is JAX else serving)._request_context
    token = var.set(ctx)
    try:
        return list(dep.generate(prompt, max_new_tokens=n))
    finally:
        var.reset(token)


def test_deployment_tags_its_events_from_the_request_context(jax_replicas):
    jax_dep = jax_replicas("llama")
    dep = port_deployment(jax_dep, "llama")
    ctx = {"request_id": "tagged-1", "deployment": DEPLOYMENT,
           "tenant": "acme"}
    got = {}
    with watched(dep), observing(spans=False, profile=False):
        for pkg, d in ((JAX, jax_dep), (PORT, dep)):
            toks = _generate_in_context(pkg, d, ctx, [1, 2, 3, 4, 5], 3)
            got[pkg.name] = (toks, request_events(pkg)["tagged-1"])
        # Mid-stream, the request's tags are held; after it, nothing is.
        from raytpu_torch.inference import serving

        token = serving._request_context.set(dict(ctx, request_id="mid"))
        try:
            stream = dep.generate([1, 2, 3], max_new_tokens=4)
            next(stream)
            assert dep._req_info == {"mid": {"deployment": DEPLOYMENT,
                                             "tenant": "acme"}}
            stream.close()
        finally:
            serving._request_context.reset(token)
        assert dep._req_info == {}
    assert got["port"] == got["jax"]
    toks, events = got["port"]
    assert len(toks) == 3 and transitions(events) == [
        "ADMITTED", "PREFILL_START", "FIRST_TOKEN", "PREFILL_END",
        "FINISHED"]
    assert {(e["deployment"], e["tenant"]) for e in events} == \
        {(DEPLOYMENT, "acme")}


def test_completed_request_leaves_no_residue(jax_replicas):
    dep = port_deployment(jax_replicas("llama"), "llama")
    with watched(dep):
        toks = list(dep.generate(list(range(1, 6)), max_new_tokens=3))
        assert len(toks) == 3
        assert dep._live == set() and dep._req_info == {}


@pytest.mark.parametrize("fail", [None, "read"], ids=["pull", "fallback"])
def test_handoff_events_and_counters_match_jax(fail, jax_replicas,
                                               monkeypatch):
    """A decode replica pulls a prompt's pages from its prefill peer
    (or from a peer lost halfway through the stream, and falls back to a
    local prefill): the same events for the request, in order, and the
    same moves of the handoff, prefix and token counters and of the
    wasted ledger, in both packages."""
    from raytpu import serve
    from raytpu.cluster import constants as jax_tuning
    from raytpu_torch.cluster import constants as tuning

    # A many-chunk stream, so a peer lost halfway fails a read.
    for constants in (jax_tuning, tuning):
        monkeypatch.setattr(constants, "KV_STREAM_CHUNK_BYTES", 1000)
    ctx = {"request_id": "h1", "deployment": DEPLOYMENT, "tenant": "acme"}
    jax_prefill = serve.LLMDeployment._target(
        model="llama", engine_options=ENGINE_OPTIONS, seed=0,
        role="prefill")
    jax_decode = serve.LLMDeployment._target(
        model="llama", engine_options=ENGINE_OPTIONS, seed=0,
        role="decode", prefill=FaultyPeer(jax_prefill, fail)
        if fail else jax_prefill)
    got = {}
    try:
        prefill = port_deployment(jax_prefill, "llama", role="prefill")
        decode = port_deployment(
            jax_prefill, "llama", role="decode",
            prefill=FaultyPeer(prefill, fail) if fail else prefill)
        with watched(decode, prefill), observing(spans=False,
                                                 profile=False):
            for pkg, dep in ((JAX, jax_decode), (PORT, decode)):
                before = reading(pkg)
                toks = _generate_in_context(pkg, dep, ctx, PROMPT, 4)
                got[pkg.name] = (toks, request_events(pkg)["h1"],
                                 delta(before, reading(pkg)))
    finally:
        jax_decode.shutdown()
        jax_prefill.shutdown()
    assert got["port"] == got["jax"]
    toks, events, moved = got["port"]
    handoff = [e for e in events if e["transition"].startswith("HANDOFF")]
    assert handoff[0]["data"] == {"pages_wanted": 2}
    counters = moved["counters"]
    if fail:
        assert handoff[1]["data"] == {"tokens_grafted": 0,
                                      "fallback": True}
        assert counters["raytpu_infer_handoff_fallbacks_total"] == 1
        assert counters["raytpu_infer_handoff_aborts_total"] == 1
        assert moved["wasted"] == {
            ("handoff_fallback", DEPLOYMENT, "acme"): len(PROMPT)}
    else:
        assert handoff[1]["data"] == {"tokens_grafted": 16,
                                      "fallback": False}
        assert counters["raytpu_infer_handoff_pages_total"] == 2
        assert "raytpu_infer_handoff_fallbacks_total" not in counters
        assert moved["wasted"] == {}
    # The prefill replica's own request (the prefill it runs for the
    # export) carries the caller's id, then the decode replica's.
    # (It finishes with its first token, before its PREFILL_END.)
    assert transitions(events) == [
        "HANDOFF_START", "ADMITTED", "PREFILL_START", "FIRST_TOKEN",
        "FINISHED", "PREFILL_END", "HANDOFF_END", "ADMITTED",
        "PREFILL_START", "FIRST_TOKEN", "PREFILL_END", "FINISHED"]
