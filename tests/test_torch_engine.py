"""Token identity between the port's InferenceEngine
(raytpu_torch/inference/engine.py, on the CPU) and the JAX package's
raytpu.inference.InferenceEngine, on tiny Llama in fp32 with the same
weights: staggered requests across decode batch buckets, a prefix-cache
hit, chunked prefill, preemption-resume and seeded temperature sampling
(the scenarios of tests/test_inference.py and
tests/test_paged_attention.py). tests/test_torch_gpt2_serve.py runs the
same cases on tiny GPT-2: ``_both`` takes the family from ``weights``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.inference import InferenceEngine as JaxEngine
from raytpu.inference import SamplingParams as JaxSampling
from raytpu.models.llama import Llama as JaxLlama
from raytpu.models.llama import LlamaConfig as JaxLlamaConfig
from raytpu.models.llama import init_params
from raytpu_torch.inference import InferenceEngine, SamplingParams
from raytpu_torch.inference import prefix_cache
from raytpu_torch.models.convert import llama_state_from_jax
from raytpu_torch.models.llama import Llama, LlamaConfig

JCFG = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                           attn_impl="reference", paged_attn="reference",
                           remat=False)
PCFG = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
GREEDY = dict(max_new_tokens=8)


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, the port's model with the same weights)."""
    params = init_params(JaxLlama(JCFG), JCFG, seed=0, batch=1)
    model = Llama(PCFG, device="cpu")
    model.load_state_dict(llama_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), PCFG))
    return JCFG, params, model


def _run(engine, sampling, arrivals):
    """Drive ``engine`` step by step; ``arrivals`` maps a step number to
    the (request id, prompt) pairs added before that step. Returns the
    tokens of each request."""
    out = {rid: [] for reqs in arrivals.values() for rid, _ in reqs}
    step = 0
    while step <= max(arrivals) or engine.has_unfinished():
        for rid, prompt in arrivals.get(step, []):
            engine.add_request(rid, prompt, sampling)
        for o in engine.step():
            out[o.request_id].append(o.token_id)
        step += 1
    return out


def _both(weights, arrivals, sampling_kw, sequential=False, **engine_kw):
    jax_cfg, params, model = weights
    jax_eng = JaxEngine(jax_cfg, params, **engine_kw)
    port_eng = InferenceEngine(model, device="cpu", **engine_kw)
    runs = []
    for eng, sampling in ((jax_eng, JaxSampling(**sampling_kw)),
                          (port_eng, SamplingParams(**sampling_kw))):
        if sequential:  # one request at a time: later ones hit warm pages
            toks = {}
            for _, reqs in sorted(arrivals.items()):
                toks.update(_run(eng, sampling, {0: reqs}))
            runs.append(toks)
        else:
            runs.append(_run(eng, sampling, arrivals))
    assert runs[0] == runs[1]
    assert all(len(t) for t in runs[1].values())
    return port_eng.stats()


PROMPTS = [list(range(1, 9)), list(range(3, 25)), [7, 8],
           list(range(40, 50))]


def test_staggered_requests_across_buckets(weights):
    arrivals = {3 * i: [(f"r{i}", p)] for i, p in enumerate(PROMPTS)}
    stats = _both(weights, arrivals, GREEDY, page_size=8, max_num_seqs=4,
                  max_model_len=64)
    assert len({k.split("x")[0] for k in stats["decode_calls"]}) >= 2


def test_prefix_cache_hit(weights):
    system = list(range(1, 17))
    arrivals = {i: [(f"p{i}", system + [30 + i])] for i in range(3)}
    # The prefix counters are process-wide: read this run's.
    hits0 = prefix_cache._hit_tokens_total.value
    stats = _both(weights, arrivals, dict(max_new_tokens=6), sequential=True,
                  page_size=8, max_num_seqs=4, max_model_len=64)
    assert stats["prefix_cache"]["hit_tokens"] - hits0 > 0
    assert stats["chunk_prefill_calls"]


def test_chunked_prefill(weights):
    arrivals = {0: [("long", list(range(2, 22))), ("short", [5, 6, 7])],
                2: [("mid", list(range(60, 73)))]}
    stats = _both(weights, arrivals, GREEDY, page_size=4, max_num_seqs=4,
                  max_model_len=48, prefill_chunk=8)
    assert sum(stats["chunk_prefill_calls"].values()) >= 3


def test_preemption_resume(weights):
    arrivals = {0: [("a", list(range(1, 8))), ("b", list(range(20, 25)))]}
    stats = _both(weights, arrivals, GREEDY, page_size=4, num_pages=6,
                  max_num_seqs=2, max_model_len=24)
    assert stats["num_preemptions"] >= 1


def test_temperature_sampling_same_seeds(weights):
    arrivals = {0: [("t0", [5, 6, 7]), ("t1", list(range(1, 9)))]}
    _both(weights, arrivals, dict(max_new_tokens=6, temperature=0.8,
                                  top_k=12, seed=123),
          page_size=8, max_num_seqs=4, max_model_len=64)
