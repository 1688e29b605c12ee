"""The port's GPT-2 inference half (raytpu_torch/models/gpt2.py) and its
engine branch (raytpu_torch/inference/engine.py) against the JAX
package's, on tiny GPT-2 in fp32 with the JAX weights carried across by
raytpu_torch/models/convert.py: one attention layer's prefill, prefill
chunk and decode step against JAX's methods running the Pallas kernels
in interpret mode, the three inference forwards' logits and the K/V they
write, and token identity of the two engines on the traffic cases of
tests/test_torch_engine.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_engine as engine_cases
from raytpu.models.gpt2 import GPT2 as JaxGPT2
from raytpu.models.gpt2 import CausalSelfAttention as JaxAttention
from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
from raytpu.models.gpt2 import gpt2_decode as jax_decode
from raytpu.models.gpt2 import gpt2_prefill as jax_prefill
from raytpu.models.gpt2 import gpt2_prefill_chunk as jax_chunk
from raytpu.models.gpt2 import init_params, layer_params
from raytpu_torch.models.convert import gpt2_state_from_jax
from raytpu_torch.models.gpt2 import (GPT2, GPT2Config, gpt2_decode,
                                      gpt2_prefill, gpt2_prefill_chunk)

# fp32 on both sides. One attention layer: 1e-5, the JAX package's bound
# for paged attention (tests/test_paged_attention.py); logits after two
# layers: 1e-4, its bound for fp32 results through several matmuls.
ATTN_TOL = 1e-5
TOL = 1e-4

JCFG = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32,
                           attn_impl="reference", paged_attn="reference",
                           remat=False)
# The attention methods against the Pallas kernels, interpreted.
JCFG_INTERPRET = dataclasses.replace(JCFG, attn_impl="interpret",
                                     paged_attn="interpret")
PCFG = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)
HEADS, HEAD_DIM = PCFG.n_head, PCFG.n_embd // PCFG.n_head
PAGE, NUM_PAGES = 8, 13


@pytest.fixture(scope="module", params=["scanned", "unrolled"])
def models(request):
    cfg = dataclasses.replace(JCFG, scan_layers=request.param == "scanned")
    params = init_params(JaxGPT2(cfg), cfg, seed=0, batch=1)
    model = GPT2(PCFG, device="cpu", seed=1)
    model.load_state_dict(gpt2_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), PCFG))
    return params, model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _pools(rng, n_layer=PCFG.n_layer):
    shape = (NUM_PAGES, PAGE, HEADS, HEAD_DIM)
    return ([rng.standard_normal(shape).astype(np.float32)
             for _ in range(n_layer)],
            [rng.standard_normal(shape).astype(np.float32)
             for _ in range(n_layer)])


def _torch(pools):
    return [torch.from_numpy(x.copy()) for x in pools]


def _chunk_inputs():
    """A chunk of 12 real tokens at positions 10..21, padded to 16 with
    page-0 dests and position 0, after 10 cached tokens."""
    table = np.array([[3, 5, 7, 0]], np.int32)
    start, take, bucket = 10, 12, 16
    pos = np.zeros(bucket, np.int32)
    pos[:take] = np.arange(start, start + take)
    dests = np.array([table[0, p // PAGE] * PAGE + p % PAGE
                      for p in pos[:take]] + list(range(bucket - take)),
                     np.int32)
    return table, pos, dests, take


def _decode_inputs():
    """Three live sequences and one dummy row (page 0, context 1)."""
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]],
                      np.int32)
    positions = np.array([20, 9, 3, 0], np.int32)
    dests = np.array([tables[i, p // PAGE] * PAGE + p % PAGE
                      for i, p in enumerate(positions)], np.int32)
    return tables, positions, dests, positions + 1


# ---- one attention layer ---------------------------------------------


def _attn(models):
    """(JAX layer-0 attention params, the port's layer-0 attention)."""
    params, model = models
    return layer_params(params, 0)["attn"], model.h[0].attn


def test_attention_prefill_matches_jax(models):
    jp, attn = _attn(models)
    x = np.random.default_rng(0).standard_normal(
        (2, 24, PCFG.n_embd)).astype(np.float32)
    y, k, v = JaxAttention(JCFG_INTERPRET).apply(
        {"params": jp}, jnp.asarray(x), method="prefill")
    with torch.no_grad():
        p_y, p_k, p_v = attn.prefill(torch.from_numpy(x))
    assert p_k.shape == (2, 24, HEADS, HEAD_DIM)
    for a, b in ((p_y, y), (p_k, k), (p_v, v)):
        _close(a, b, ATTN_TOL)


def test_attention_prefill_chunk_matches_jax(models):
    jp, attn = _attn(models)
    rng = np.random.default_rng(1)
    (kp,), (vp,) = _pools(rng, 1)
    table, pos, dests, take = _chunk_inputs()
    x = rng.standard_normal((1, len(pos), PCFG.n_embd)).astype(np.float32)
    y, new_k, new_v = JaxAttention(JCFG_INTERPRET).apply(
        {"params": jp}, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(dests), jnp.asarray(table), jnp.asarray(pos),
        method="prefill_chunk")
    pk, pv = _torch([kp, vp])
    with torch.no_grad():
        p_y = attn.prefill_chunk(
            torch.from_numpy(x), pk, pv,
            torch.from_numpy(dests.astype(np.int64)),
            torch.from_numpy(table), torch.from_numpy(pos))
    _close(p_y[:, :take], np.asarray(y)[:, :take], ATTN_TOL)
    # Page 0 is scratch: padding rows write it in no set order.
    _close(pk[1:], np.asarray(new_k)[1:], ATTN_TOL)
    _close(pv[1:], np.asarray(new_v)[1:], ATTN_TOL)


def test_attention_decode_step_matches_jax(models):
    jp, attn = _attn(models)
    rng = np.random.default_rng(2)
    (kp,), (vp,) = _pools(rng, 1)
    tables, _, dests, context_lens = _decode_inputs()
    x = rng.standard_normal((4, PCFG.n_embd)).astype(np.float32)
    y, new_k, new_v = JaxAttention(JCFG_INTERPRET).apply(
        {"params": jp}, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(dests), jnp.asarray(tables), jnp.asarray(context_lens),
        method="decode_step")
    pk, pv = _torch([kp, vp])
    with torch.no_grad():
        p_y = attn.decode_step(
            torch.from_numpy(x), pk, pv,
            torch.from_numpy(dests.astype(np.int64)),
            torch.from_numpy(tables), torch.from_numpy(context_lens))
    _close(p_y[:3], np.asarray(y)[:3], ATTN_TOL)
    _close(pk[1:], np.asarray(new_k)[1:], ATTN_TOL)
    _close(pv[1:], np.asarray(new_v)[1:], ATTN_TOL)


# ---- the three inference forwards -------------------------------------


def test_prefill_matches_jax(models):
    params, model = models
    tokens = np.random.default_rng(0).integers(0, PCFG.vocab_size, (2, 24))
    logits, ks, vs = jax_prefill(JCFG, params, jnp.asarray(tokens))
    with torch.no_grad():
        p_logits, p_ks, p_vs = gpt2_prefill(model, torch.from_numpy(tokens))
    assert p_logits.dtype == torch.float32
    _close(p_logits, logits)
    for a, b in zip(p_ks + p_vs, ks + vs):
        _close(a, b)


def test_prefill_chunk_matches_jax(models):
    params, model = models
    rng = np.random.default_rng(1)
    k_pools, v_pools = _pools(rng)
    table, pos, dests, take = _chunk_inputs()
    tokens = rng.integers(0, PCFG.vocab_size, (1, len(pos)))
    logits, new_k, new_v = jax_chunk(
        JCFG, params, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(dests), jnp.asarray(table),
        [jnp.asarray(x) for x in k_pools], [jnp.asarray(x) for x in v_pools])
    pk, pv = _torch(k_pools), _torch(v_pools)
    with torch.no_grad():
        p_logits = gpt2_prefill_chunk(
            model, torch.from_numpy(tokens), torch.from_numpy(pos),
            torch.from_numpy(dests.astype(np.int64)),
            torch.from_numpy(table), pk, pv)
    _close(p_logits[:, :take], np.asarray(logits)[:, :take])
    for a, b in zip(pk + pv, new_k + new_v):
        _close(a[1:], np.asarray(b)[1:])


def test_decode_matches_jax(models):
    params, model = models
    rng = np.random.default_rng(2)
    k_pools, v_pools = _pools(rng)
    tables, positions, dests, context_lens = _decode_inputs()
    tokens = rng.integers(0, PCFG.vocab_size, 4)
    logits, new_k, new_v = jax_decode(
        JCFG, params, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(dests), jnp.asarray(tables), jnp.asarray(context_lens),
        [jnp.asarray(x) for x in k_pools], [jnp.asarray(x) for x in v_pools])
    pk, pv = _torch(k_pools), _torch(v_pools)
    with torch.no_grad():
        p_logits = gpt2_decode(
            model, torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(dests.astype(np.int64)),
            torch.from_numpy(tables), torch.from_numpy(context_lens), pk, pv)
    _close(p_logits[:3], np.asarray(logits)[:3])
    for a, b in zip(pk + pv, new_k + new_v):
        _close(a[1:], np.asarray(b)[1:])


# ---- the engine --------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, the port's model with the same weights),
    the family the engine cases below run on."""
    params = init_params(JaxGPT2(JCFG), JCFG, seed=0, batch=1)
    model = GPT2(PCFG, device="cpu")
    model.load_state_dict(gpt2_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), PCFG))
    return JCFG, params, model


def test_engine_pools_hold_gpt2_heads(weights):
    from raytpu_torch.inference import InferenceEngine

    eng = InferenceEngine(weights[2], device="cpu", page_size=PAGE)
    assert eng.cache.k[0].shape[1:] == (PAGE, HEADS, HEAD_DIM)
    assert eng.cache.k[0].dtype == PCFG.dtype
    assert len(eng.cache.k) == PCFG.n_layer


# The traffic cases of tests/test_torch_engine.py, each driving the JAX
# engine and the port's with this module's ``weights``: staggered
# requests across decode buckets, a prefix-cache hit, chunked prefill,
# preemption-resume and seeded temperature sampling.
test_staggered_requests_across_buckets = \
    engine_cases.test_staggered_requests_across_buckets
test_prefix_cache_hit = engine_cases.test_prefix_cache_hit
test_chunked_prefill = engine_cases.test_chunked_prefill
test_preemption_resume = engine_cases.test_preemption_resume
test_temperature_sampling_same_seeds = \
    engine_cases.test_temperature_sampling_same_seeds
