"""The port's Llama inference forwards (raytpu_torch/models/llama.py)
against the JAX package's, with the JAX weights carried across by
raytpu_torch/models/convert.py in both parameter layouts (scanned and
unrolled): prefill, chunked prefill and decode logits, and the K/V they
write into the page pools, in fp32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.models.llama import Llama as JaxLlama
from raytpu.models.llama import LlamaConfig as JaxLlamaConfig
from raytpu.models.llama import init_params
from raytpu.models.llama import llama_decode as jax_decode
from raytpu.models.llama import llama_prefill as jax_prefill
from raytpu.models.llama import llama_prefill_chunk as jax_chunk
from raytpu_torch.models.convert import llama_state_from_jax
from raytpu_torch.models.llama import (Llama, LlamaConfig, llama_decode,
                                       llama_prefill, llama_prefill_chunk)

# fp32 on both sides, attention by the plain versions. The two libraries
# sum the matmuls in different orders, so the logits after two layers
# agree to about 1e-5; 1e-4 is the bound the JAX package uses for fp32
# results that pass through several matmuls (tests/test_ops.py).
TOL = 1e-4

JCFG = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                           attn_impl="reference", paged_attn="reference",
                           remat=False)
PCFG = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
PAGE, NUM_PAGES = 8, 13


@pytest.fixture(scope="module", params=["scanned", "unrolled"])
def models(request):
    cfg = dataclasses.replace(JCFG,
                              scan_layers=request.param == "scanned")
    params = init_params(JaxLlama(cfg), cfg, seed=0, batch=1)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = Llama(PCFG, device="cpu", seed=1)
    model.load_state_dict(llama_state_from_jax(np_params, PCFG))
    return params, model


def _pools(rng):
    shape = (NUM_PAGES, PAGE, PCFG.n_kv_head, PCFG.head_dim)
    return ([rng.standard_normal(shape).astype(np.float32)
             for _ in range(PCFG.n_layer)],
            [rng.standard_normal(shape).astype(np.float32)
             for _ in range(PCFG.n_layer)])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=TOL,
                               rtol=TOL)


def test_converter_covers_every_parameter(models):
    params, model = models
    state = llama_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params), PCFG)
    assert set(state) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert tuple(state[name].shape) == tuple(p.shape), name


def test_prefill_matches_jax(models):
    params, model = models
    tokens = np.random.default_rng(0).integers(0, PCFG.vocab_size, (2, 24))
    logits, ks, vs = jax_prefill(JCFG, params, jnp.asarray(tokens))
    with torch.no_grad():
        p_logits, p_ks, p_vs = llama_prefill(model, torch.from_numpy(tokens))
    _close(p_logits, logits)
    for a, b in zip(p_ks + p_vs, ks + vs):
        _close(a, b)


def test_prefill_chunk_matches_jax(models):
    # A chunk of 12 real tokens at positions 10..21, padded to 16 with
    # page-0 dests and position 0, after 10 cached tokens.
    params, model = models
    rng = np.random.default_rng(1)
    k_pools, v_pools = _pools(rng)
    table = np.array([[3, 5, 7, 0]], np.int32)
    start, take, bucket = 10, 12, 16
    pos = np.zeros(bucket, np.int32)
    pos[:take] = np.arange(start, start + take)
    dests = np.array([table[0, p // PAGE] * PAGE + p % PAGE
                      for p in pos[:take]] + list(range(bucket - take)),
                     np.int32)
    tokens = rng.integers(0, PCFG.vocab_size, (1, bucket))
    logits, new_k, new_v = jax_chunk(
        JCFG, params, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(dests), jnp.asarray(table),
        [jnp.asarray(x) for x in k_pools], [jnp.asarray(x) for x in v_pools])
    pk = [torch.from_numpy(x.copy()) for x in k_pools]
    pv = [torch.from_numpy(x.copy()) for x in v_pools]
    with torch.no_grad():
        p_logits = llama_prefill_chunk(
            model, torch.from_numpy(tokens), torch.from_numpy(pos),
            torch.from_numpy(dests.astype(np.int64)),
            torch.from_numpy(table), pk, pv)
    _close(p_logits[:, :take], np.asarray(logits)[:, :take])
    # Page 0 is scratch: padding rows write it in no set order.
    for a, b in zip(pk + pv, new_k + new_v):
        _close(a[1:], np.asarray(b)[1:])


def test_decode_matches_jax(models):
    # Three live sequences and one dummy row (page 0, context 1).
    params, model = models
    rng = np.random.default_rng(2)
    k_pools, v_pools = _pools(rng)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [0, 0, 0]],
                      np.int32)
    positions = np.array([20, 9, 3, 0], np.int32)
    dests = np.array([tables[i, p // PAGE] * PAGE + p % PAGE
                      for i, p in enumerate(positions)], np.int32)
    context_lens = positions + 1
    tokens = rng.integers(0, PCFG.vocab_size, 4)
    logits, new_k, new_v = jax_decode(
        JCFG, params, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(dests), jnp.asarray(tables), jnp.asarray(context_lens),
        [jnp.asarray(x) for x in k_pools], [jnp.asarray(x) for x in v_pools])
    pk = [torch.from_numpy(x.copy()) for x in k_pools]
    pv = [torch.from_numpy(x.copy()) for x in v_pools]
    with torch.no_grad():
        p_logits = llama_decode(
            model, torch.from_numpy(tokens), torch.from_numpy(positions),
            torch.from_numpy(dests.astype(np.int64)),
            torch.from_numpy(tables), torch.from_numpy(context_lens), pk, pv)
    _close(p_logits[:3], np.asarray(logits)[:3])
    for a, b in zip(pk + pv, new_k + new_v):
        _close(a[1:], np.asarray(b)[1:])


def test_rmsnorm_and_rope_are_split_halves_in_fp32():
    from raytpu_torch.models.llama import RMSNorm, apply_rope, rope_tables

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=gen).bfloat16()
    out = RMSNorm(8, torch.bfloat16)(x)
    xf = x.float()
    want = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + 1e-5))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.to(torch.bfloat16))
    cos, sin = rope_tables(8, torch.arange(5), 10000.0)
    q = torch.randn(1, 1, 5, 8, generator=gen)
    r = apply_rope(q, cos, sin)
    # Channel i pairs with channel i + 4 (split halves).
    assert torch.allclose(r[..., 0], q[..., 0] * cos[:, 0]
                          - q[..., 4] * sin[:, 0])
