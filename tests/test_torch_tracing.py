"""The port's tracing (raytpu_torch/util/tracing.py and the engine's
``infer.*`` spans) against the JAX package's, on tiny Llama in fp32 with
the JAX weights carried across: the same traffic through both engines
(tests/test_torch_request_events.py's scenarios, flags on in both)
records the same multiset of (span name, attributes), one span per
engine call of each kind. Also the span machinery (tests/test_tracing.py's
contracts): the shared no-op when disabled, nesting under the ambient
context, unsampled roots, ``run_with_trace``, ``traced``, the local
timeline, the environment arming, and ``profile`` writing a chrome trace
on the CPU."""

import json
import os

import pytest

from raytpu_torch.inference import InferenceEngine, SamplingParams
from raytpu_torch.util import tracing

from test_torch_engine import weights  # noqa: F401
from test_torch_request_events import (SCENARIOS, observing,  # noqa: F401
                                       scenario_runs)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_span_sets_match_jax(name, scenario_runs):
    runs = scenario_runs(name)
    assert runs["port"]["spans"] == runs["jax"]["spans"]
    # One span a model forward, by kind and bucket, as the engine counts
    # its calls (its keys are "<bucket>" or "<bucket>x<table width>").
    stats = runs["port"]["stats"]
    spans, calls = {}, {}
    for (span_name, attrs), c in runs["port"]["spans"].items():
        key = (span_name, dict(attrs)["bucket"])
        spans[key] = spans.get(key, 0) + c
    for span_name, kind in (("infer.prefill", "prefill_calls"),
                            ("infer.prefill_chunk", "chunk_prefill_calls"),
                            ("infer.decode", "decode_calls")):
        for bucket, c in stats[kind].items():
            key = (span_name, int(bucket.split("x")[0]))
            calls[key] = calls.get(key, 0) + c
    assert spans == calls
    if name == "chunked":
        chunks = [dict(a) for (s, a) in runs["port"]["spans"]
                  if s == "infer.prefill_chunk"]
        assert {"request_id", "start", "take", "bucket"} == set(chunks[0])


def test_disabled_span_is_the_shared_noop():
    with observing(spans=False, events=False, profile=False):
        s = tracing.span("x", {"a": 1})
        assert s is tracing._NOOP_SPAN
        with s as attrs:
            attrs["b"] = 2
        assert tracing.get_spans() == []
        assert tracing.current_trace() is None


def test_spans_nest_under_the_ambient_context():
    with observing(events=False, profile=False):
        with tracing.span("outer", {"k": 1}) as attrs:
            outer_ctx = tracing.current_trace()
            attrs["late"] = "yes"
            with tracing.span("inner"):
                inner_ctx = tracing.current_trace()
        assert tracing.current_trace() is None
        inner, outer = tracing.get_spans()
    assert inner["parent_span_id"] == outer["span_id"] == outer_ctx.span_id
    assert inner["trace_id"] == outer["trace_id"] == inner_ctx.trace_id
    assert outer["parent_span_id"] is None
    assert outer["attributes"] == {"k": 1, "late": "yes"}
    assert outer["duration_s"] >= inner["duration_s"] >= 0.0
    assert inner["error"] is None


def test_a_span_records_the_error_it_ends_with():
    with observing(events=False, profile=False):
        with pytest.raises(KeyError):
            with tracing.span("boom"):
                raise KeyError("k")
        (s,) = tracing.get_spans()
    assert s["error"] == repr(KeyError("k"))


def test_unsampled_roots_record_nothing():
    with observing(events=False, profile=False):  # restores the rate
        tracing._sample_rate = 0.0
        with tracing.span("dropped"):
            ctx = tracing.current_trace()
            with tracing.span("child"):
                pass
        assert ctx is not None and not ctx.sampled
        assert tracing.get_spans() == []


def test_run_with_trace_reanchors_a_context():
    with observing(events=False, profile=False):
        tc = tracing.TraceContext.root()
        assert tracing.run_with_trace(tc, "hop", lambda x: x + 1, 1) == 2
        (s,) = tracing.get_spans()
    assert s["name"] == "hop" and s["trace_id"] == tc.trace_id
    assert s["parent_span_id"] == tc.span_id


def test_traced_decorator_and_the_local_timeline(tmp_path):
    @tracing.traced()
    def work(x):
        return x * 2

    with observing(events=False, profile=False):
        assert work(3) == 6
        path = tmp_path / "timeline.json"
        events = tracing.timeline(str(path))
        dumped = tracing.dump()
    (ev,) = events
    assert ev["name"].endswith("work") and ev["ph"] == "X"
    assert ev["pid"] == os.getpid() and "trace_id" in ev["args"]
    assert json.loads(path.read_text()) == events
    assert dumped["pid"] == os.getpid() and len(dumped["spans"]) == 1


def test_enable_with_env_exports_the_arming(monkeypatch):
    monkeypatch.delenv(tracing.ENV_VAR, raising=False)
    monkeypatch.delenv(tracing.SAMPLE_ENV_VAR, raising=False)
    monkeypatch.setattr(tracing, "_sample_rate", 1.0)
    with observing(spans=False, events=False, profile=False):
        tracing.enable_tracing(sample_rate=0.5, env=True)
        assert tracing.enabled()
        assert os.environ[tracing.ENV_VAR] == "1"
        assert os.environ[tracing.SAMPLE_ENV_VAR] == "0.5"
        tracing.disable_tracing(env=True)
        assert not tracing.enabled()
        assert tracing.ENV_VAR not in os.environ


def test_env_names_are_the_jax_package_s():
    from raytpu.util import tracing as jax_tracing

    for name in ("ENV_VAR", "SAMPLE_ENV_VAR", "BUFFER_ENV_VAR"):
        assert getattr(tracing, name) == getattr(jax_tracing, name)


def test_profile_writes_a_chrome_trace_on_the_cpu(weights, tmp_path):
    """Two decode steps of the engine inside ``profile``: the trace file
    exists and holds the steps' CPU operators (on the card it holds the
    kernels too, chip_smoke.py's phase 21)."""
    eng = InferenceEngine(weights[2], device="cpu", page_size=8,
                          max_num_seqs=4, max_model_len=64)
    for i in range(2):
        eng.add_request(f"q{i}", list(range(1 + i, 9 + i)),
                        SamplingParams(max_new_tokens=6))
    eng.step()  # both prefills
    with tracing.profile(str(tmp_path / "prof")) as prof:
        eng.step()
        eng.step()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "prof")
    trace = json.loads(open(prof.trace_path).read())
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert eng.stats()["decode_batch_hist"] == [2, 2]
