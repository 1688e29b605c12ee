"""The port's metrics (raytpu_torch/util/metrics.py, serve_slo.py,
stepprof.py and the ``raytpu_infer_*`` series of the engine, the prefix
cache and the KV handoff) against the JAX package's, on tiny Llama in
fp32 with the JAX weights carried across. The same traffic through both
engines (tests/test_torch_request_events.py's scenarios, flags on in
both) moves every ``raytpu_infer_*`` counter and the wasted ledger by the
same amounts, leaves the same gauges after the run and after
``note_idle``, and observes the TTFT and step-time histograms as often.
Also: the serve SLO instruments (tests/test_request_events.py's
``TestServeSLOInstruments``), the cardinality fold
(tests/test_metrics_pipeline.py's ``TestCardinalityCap``), the process-
wide prefix counters, the peak table, the device-memory gauges' CPU
no-op, the MFU gauge, and the analytic decode FLOPs against XLA's
``cost_analysis`` of the JAX decode program."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.inference import InferenceEngine as JaxEngine
from raytpu.models import gpt2 as jax_gpt2
from raytpu.models.gpt2 import GPT2 as JaxGPT2
from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
from raytpu.util.stepprof import cost_analysis_flops
from raytpu_torch.inference import (InferenceEngine, PagedKVCache,
                                    PrefixCache, SamplingParams)
from raytpu_torch.models.convert import gpt2_state_from_jax
from raytpu_torch.models.gpt2 import GPT2, GPT2Config
from raytpu_torch.util import metrics, serve_slo, stepprof

from test_torch_engine import weights  # noqa: F401
from test_torch_request_events import (JAX, PORT, SCENARIOS,  # noqa: F401
                                       infer_counters, infer_gauges,
                                       observing, scenario_runs)

RATE_GAUGES = ("raytpu_infer_prefill_tokens_per_s",
               "raytpu_infer_decode_tokens_per_s")


def test_both_packages_have_the_same_series():
    assert set(infer_counters(PORT)) == set(infer_counters(JAX))
    assert len(infer_counters(PORT)) == 10
    assert set(infer_gauges(PORT)) == set(infer_gauges(JAX))
    assert len(infer_gauges(PORT)) == 5


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_counter_and_ledger_deltas_match_jax(name, scenario_runs):
    runs = scenario_runs(name)
    jax_moved, port_moved = runs["jax"]["delta"], runs["port"]["delta"]
    assert port_moved["counters"] == jax_moved["counters"]
    assert port_moved["wasted"] == jax_moved["wasted"]
    stats = runs["port"]["stats"]
    counters = port_moved["counters"]
    # The token counters move as the engine's own totals do.
    assert counters["raytpu_infer_prefill_tokens_total"] == \
        stats["prefill_tokens"]
    assert counters["raytpu_infer_decode_tokens_total"] == \
        stats["decode_tokens"]
    if name == "prefix_hit":
        assert counters["raytpu_infer_prefix_hits_total"] == 2
        assert counters["raytpu_infer_prefix_hit_tokens_total"] == 32
    if name == "preemption":
        assert port_moved["wasted"] and all(
            key[0] == "preempt_recompute" for key in port_moved["wasted"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_histogram_counts_match_jax(name, scenario_runs):
    runs = scenario_runs(name)
    jax_moved, port_moved = runs["jax"]["delta"], runs["port"]["delta"]
    assert port_moved["ttft_count"] == jax_moved["ttft_count"]
    assert port_moved["step_count"] == jax_moved["step_count"]
    # One TTFT a request that got a token, one step time a decode step.
    assert port_moved["ttft_count"] == sum(
        bool(t) for t in runs["port"]["tokens"].values())
    assert port_moved["step_count"] == \
        len(runs["port"]["stats"]["decode_batch_hist"])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gauges_after_the_run_and_idle_match_jax(name, scenario_runs):
    runs = scenario_runs(name)
    jax_run, port_run = runs["jax"], runs["port"]
    for key in ("gauges", "idle"):
        for gauge, value in port_run[key].items():
            if gauge in RATE_GAUGES:
                # Rates are the host clock's: zero or not, as in JAX.
                assert (value == 0) == (jax_run[key][gauge] == 0), gauge
            else:
                assert value == jax_run[key][gauge], gauge
    running, waiting, kv = port_run["scheduler"]
    assert port_run["gauges"]["raytpu_infer_running_requests"] == running
    assert port_run["gauges"]["raytpu_infer_waiting_requests"] == waiting
    assert port_run["gauges"]["raytpu_infer_kv_page_utilization"] == kv
    assert all(port_run["idle"][g] == 0.0 for g in RATE_GAUGES)


# -- serve SLO instruments (tests/test_request_events.py) -----------------


def _slo(module):
    return (dict(module.tokens_delivered._values),
            dict(module.tokens_wasted._values))


def _moved(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0)}


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_zero_tokens_book_nothing(pkg):
    before = _slo(pkg.serve_slo)
    pkg.serve_slo.delivered(0, "d", "t")
    pkg.serve_slo.wasted("abort", 0, "d", "t")
    after = _slo(pkg.serve_slo)
    assert _moved(before[0], after[0]) == {}
    assert _moved(before[1], after[1]) == {}


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=lambda p: p.name)
def test_tenant_defaults_and_cause_tagging(pkg):
    before = _slo(pkg.serve_slo)
    pkg.serve_slo.delivered(3, "dep", "")
    pkg.serve_slo.wasted("preempt_recompute", 2, "dep", "acme")
    after = _slo(pkg.serve_slo)
    assert _moved(before[0], after[0]) == {("dep", "default"): 3.0}
    assert _moved(before[1], after[1]) == {
        ("preempt_recompute", "dep", "acme"): 2.0}


def test_latency_histograms_book_by_deployment_and_tenant():
    hist = serve_slo.ttft_hist
    before = len(hist.observations_by_tag.get(("dep", "default"), []))
    for observe in (serve_slo.observe_ttft, serve_slo.observe_tpot,
                    serve_slo.observe_e2e, serve_slo.observe_queue):
        observe(0.02, "dep", "")
    assert len(hist.observations_by_tag[("dep", "default")]) == before + 1
    for h in (serve_slo.tpot_hist, serve_slo.e2e_hist,
              serve_slo.queue_hist):
        assert 0.02 in h.observations_by_tag[("dep", "default")]


# -- the cardinality fold (tests/test_metrics_pipeline.py) ----------------


def _dropped() -> float:
    """Folds counted, over every metric (the fold counter's own series
    fold too while a test shrinks the cap)."""
    counter = metrics._series_dropped
    return counter.value if counter is not None else 0.0


def test_overflow_folds_into_other_and_counts_drops(monkeypatch):
    monkeypatch.setattr(metrics, "_MAX_SERIES", 2)
    c = metrics.Counter("tp_card_total", "t", tag_keys=("user",))
    before = _dropped()
    for i in range(5):
        c.inc(tags={"user": f"u{i}"})
    assert set(c._values) == {("u0",), ("u1",), (metrics.OTHER_TAG_VALUE,)}
    assert c.value == 5.0  # folding never loses increments
    assert _dropped() == before + 3


def test_drop_counter_never_reports_itself(monkeypatch):
    monkeypatch.setattr(metrics, "_MAX_SERIES", 1)
    g = metrics.Gauge("tp_card_g", "t", tag_keys=("k",))
    g.set(1.0, tags={"k": "a"})
    g.set(2.0, tags={"k": "b"})  # folds; must not recurse
    assert g.values == {("a",): 1.0, (metrics.OTHER_TAG_VALUE,): 2.0}
    assert _dropped() >= 1


def test_tenant_series_get_reserved_headroom(monkeypatch):
    monkeypatch.setattr(metrics, "_MAX_SERIES", 2)
    monkeypatch.setattr(metrics, "_TENANT_RESERVED", 3)
    c = metrics.Counter("tp_card_tenant_total", "t",
                        tag_keys=("deployment", "tenant"))
    for i in range(4):
        c.inc(tags={"deployment": f"d{i}", "tenant": ""})
    assert (metrics.OTHER_TAG_VALUE,) * 2 in c._values
    c.inc(tags={"deployment": "d9", "tenant": "acme"})
    c.inc(tags={"deployment": "d9", "tenant": "globex"})
    assert ("d9", "acme") in c._values and ("d9", "globex") in c._values
    before = _dropped()
    c.inc(tags={"deployment": "d9", "tenant": "initech"})
    assert ("d9", "initech") not in c._values
    assert _dropped() == before + 1
    c.inc(tags={"deployment": "dA", "tenant": metrics.OTHER_TAG_VALUE})
    assert ("dA", metrics.OTHER_TAG_VALUE) not in c._values
    assert c.value == 8.0


def test_fold_matches_jax_on_the_same_tags(monkeypatch):
    from raytpu.util import metrics as jax_metrics

    tables = []
    for mod, name in ((jax_metrics, "tp_port_fold_jax_total"),
                      (metrics, "tp_port_fold_total")):
        monkeypatch.setattr(mod, "_MAX_SERIES", 3)
        monkeypatch.setattr(mod, "_TENANT_RESERVED", 2)
        c = mod.Counter(name, "t", tag_keys=("deployment", "tenant"))
        for i in range(9):
            c.inc(i + 1, tags={"deployment": f"d{i % 5}",
                               "tenant": ("", "acme", "globex")[i % 3]})
        tables.append(dict(c._values))
    assert tables[0] == tables[1]


def test_tags_are_checked():
    h = metrics.Histogram("tp_tags_seconds", "t", boundaries=(0.1, 1.0),
                          tag_keys=("deployment",))
    with pytest.raises(ValueError, match="missing tag"):
        h.observe(0.5)
    with pytest.raises(ValueError, match="unknown tag"):
        h.set_default_tags({"tenant": "x"})
    h.set_default_tags({"deployment": "dep"})
    h.observe(0.5)
    assert h.observations == [0.5]
    assert h.observations_by_tag == {("dep",): [0.5]}
    with pytest.raises(ValueError, match="only increase"):
        metrics.Counter("tp_neg_total").inc(-1)


def test_port_mints_no_name_the_jax_package_does_not_declare():
    from raytpu.util.metrics import DECLARED_METRICS as JAX_DECLARED

    assert set(metrics.DECLARED_METRICS) <= set(JAX_DECLARED)


# -- the prefix counters are process-wide, as in JAX ----------------------


def test_prefix_cache_stats_read_the_process_wide_counters():
    caches = []
    for _ in range(2):
        kv = PagedKVCache(1, 12, 4, 1, 8, device="cpu")
        caches.append((kv, PrefixCache(kv)))
    (kv_a, pc_a), (kv_b, pc_b) = caches
    before = pc_b.stats()
    prompt = list(range(1, 10))
    assert kv_a.allocate("a", len(prompt))
    pc_a.register("a", prompt, len(prompt))
    assert len(pc_a.match(prompt, max_pages=2)) == 2
    # A lookup in one cache moves what every cache of the process reads.
    after = pc_b.stats()
    assert after["lookups"] - before["lookups"] == 1
    assert after["hits"] - before["hits"] == 1
    assert after["hit_tokens"] - before["hit_tokens"] == 8
    assert after["registered_pages"] == before["registered_pages"] == 0


# -- the step profiler ----------------------------------------------------


def test_peak_flops_resolution(monkeypatch):
    monkeypatch.delenv(stepprof.ENV_PEAK_FLOPS, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stepprof.device_peak_flops() == stepprof._FALLBACK_PEAK_FLOPS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert stepprof.device_peak_flops() == 989e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA Unknown Card")
    assert stepprof.device_peak_flops() == stepprof._FALLBACK_PEAK_FLOPS
    assert stepprof.peak_for_name("NVIDIA Unknown Card") is None
    monkeypatch.setenv(stepprof.ENV_PEAK_FLOPS, "5e14")
    assert stepprof.device_peak_flops() == 5e14


def test_observe_hbm_is_a_quiet_no_op_on_the_cpu():
    prof = stepprof.StepProfiler("infer")
    prof.observe_hbm(torch.device("cpu"))
    assert prof._hbm_used.values == {} and prof._hbm_peak.values == {}


def test_step_profiler_kinds():
    assert stepprof.step_profiler("infer") is stepprof.step_profiler("infer")
    train = stepprof.StepProfiler("train")
    assert train._mfu._name == "raytpu_train_mfu"
    assert train._step._name == "raytpu_train_step_seconds"
    with pytest.raises(ValueError):
        stepprof.StepProfiler("serve")
    train.observe_step(0.5, flops=1e9)
    assert train._step.observations == [0.5]
    assert train._mfu.value == pytest.approx(1e9 / 0.5 / train.peak_flops())
    train.observe_step(0.0, flops=1e9)  # no time, no observation
    assert train._step.observations == [0.5]


def test_mfu_gauge_is_flops_over_step_time_over_peak(weights, monkeypatch):
    """On the engine's path: each decode step observes its time, and the
    MFU gauge is the step's analytic FLOPs over that time over the
    peak."""
    monkeypatch.setenv(stepprof.ENV_PEAK_FLOPS, "1e9")
    prof = stepprof.step_profiler("infer")
    monkeypatch.setattr(prof, "_peak", None)
    monkeypatch.setattr(prof, "_flops", {})
    eng = InferenceEngine(weights[2], device="cpu", page_size=8,
                          max_num_seqs=4, max_model_len=64)
    steps0 = len(prof._step.observations)
    four = SamplingParams(max_new_tokens=4)
    with observing(events=False, spans=False):
        eng.add_request("m0", list(range(1, 12)), four)
        eng.add_request("m1", list(range(3, 7)), four)
        while eng.has_unfinished():
            eng.step()
        last = prof._step.observations[-1]
        mfu = prof._mfu.value
    assert len(prof._step.observations) - steps0 == \
        len(eng.stats()["decode_batch_hist"])
    # The last step's key: both sequences finish in it, at batch 2, m0
    # with 14 tokens in 2 pages of 8.
    flops = prof._flops[("decode", 2, 2)]
    assert flops == eng.decode_flops(2, 2)
    assert mfu == pytest.approx(min(1.0, flops / last / 1e9), rel=1e-12)
    monkeypatch.setattr(prof, "_peak", None)


# XLA's count of the JAX decode program (reference paged attention) over
# the analytic one, measured on these tiny configs at batch buckets 1, 2
# and 4 and table widths 2, 4 and 8: Llama 1.0111-1.0131, GPT-2
# 1.0197-1.0229. XLA also counts the elementwise work (norms, rotary,
# softmax, residuals, GELU), which the analytic count leaves out and
# which weighs most where the model is narrowest; at these widths it is
# under 3 % of the products.
XLA_EXTRA = 0.03


def _gpt2_weights():
    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32,
                               attn_impl="reference",
                               paged_attn="reference", remat=False)
    params = jax_gpt2.init_params(JaxGPT2(jcfg), jcfg, seed=0, batch=1)
    pcfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
    model = GPT2(pcfg, device="cpu")
    import jax

    model.load_state_dict(gpt2_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pcfg))
    return jcfg, params, model


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_decode_flops_against_xla_cost_analysis(family, weights):
    jax_cfg, params, model = weights if family == "llama" \
        else _gpt2_weights()
    kw = dict(page_size=8, max_num_seqs=4, max_model_len=64)
    jax_eng = JaxEngine(jax_cfg, params, **kw)
    port_eng = InferenceEngine(model, device="cpu", **kw)
    for bucket, pages in ((1, 2), (4, 8)):
        zeros = jnp.zeros(bucket, jnp.int32)
        xla = cost_analysis_flops(
            jax_eng._decode_fn, jax_eng._params, jax_eng.cache.k,
            jax_eng.cache.v, zeros, zeros, zeros,
            jnp.zeros((bucket, pages), jnp.int32),
            jnp.ones(bucket, jnp.int32))
        ours = port_eng.decode_flops(bucket, pages)
        assert 0.0 <= xla / ours - 1.0 <= XLA_EXTRA, (bucket, pages,
                                                      xla, ours)
