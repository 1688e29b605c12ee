"""The port's flash attention forward (raytpu_torch/ops/flash_attention.py)
against the JAX package's: the plain PyTorch version against the JAX
reference and against the Pallas kernel run by the interpreter, on the
same numpy inputs, in fp32. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.ops.flash_attention import _attn_fwd_reference
from raytpu.ops.flash_attention import _fit_block, _flash_forward_pallas
from raytpu.ops.flash_attention import flash_attention as jax_flash
from raytpu_torch.ops.flash_attention import (LAUNCHES, flash_attention,
                                              flash_attention_reference)

# The JAX package's own bound for fp32 attention forward
# (tests/test_ops.py).
TOL = 2e-5


def _inputs(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _port(q, k, v, **kw):
    o, lse = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 16, 32), (2, 4, 64, 16),
                                   (2, 3, 128, 64)])
def test_plain_forward_matches_jax_reference(causal, shape):
    b, h, t, d = shape
    q, k, v = _inputs(t + d, b, h, t, d)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_ref = jax_flash(jq, jk, jv, causal=causal, force="reference")
    _, lse_ref = _attn_fwd_reference(jq, jk, jv, causal, d ** -0.5)
    o, lse = _port(q, k, v, causal=causal)
    assert o.shape == (b, h, t, d) and lse.shape == (b, h, t, 1)
    assert lse.dtype == np.float32
    np.testing.assert_allclose(o, np.asarray(o_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse, np.asarray(lse_ref), atol=TOL, rtol=TOL)


def test_plain_forward_matches_pallas_interpret():
    # The real TPU kernel, run by the Pallas interpreter on the CPU.
    q, k, v = _inputs(3, 1, 2, 128, 32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    o_kernel = jax_flash(jq, jk, jv, causal=True, force="interpret")
    _, lse_kernel = _flash_forward_pallas(jq, jk, jv, True, 32 ** -0.5,
                                          512, 512, interpret=True)
    o, lse = _port(q, k, v, causal=True)
    np.testing.assert_allclose(o, np.asarray(o_kernel), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse, np.asarray(lse_kernel), atol=TOL,
                               rtol=TOL)


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 2, 8, 16))
    before = LAUNCHES.count
    o, lse = flash_attention(q, k, v)
    o_ref, lse_ref = flash_attention_reference(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    assert LAUNCHES.count == before


def test_bf16_keeps_output_dtype_and_fp32_lse():
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(6, 1, 2, 8, 16))
    o, lse = flash_attention(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


def test_rejects_bad_shapes_and_selectors():
    q, k, v = (torch.from_numpy(x) for x in _inputs(7, 1, 2, 8, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, force="kernel-or-else")


# The TPU kernel's fitted key block and the blocks tried: the kernel walks
# 64-key tiles on the card; the Pallas kernel here at the blocks
# _fit_block gives these requests.
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal,t_q,t_kv", [(True, 128, 128),
                                             (False, 128, 128),
                                             (True, 64, 128)],
                         ids=["causal", "full", "cross-length-causal"])
def test_bf16_rounded_mirror_matches_pallas_interpret(causal, t_q, t_kv, d,
                                                      block):
    # The mirror (keys in the TPU kernel's blocks, P rounded to bf16 before
    # P V, l summed from the fp32 P) against the interpreted Pallas kernel
    # in its default dot mode "input", on the same bf16 inputs. The two
    # round the same fp32 values at the same points and differ only in the
    # order of their fp32 sums, so the output must lie under a quarter of
    # the unrounded plain version's relative norm distance: that one
    # differs by the rounding of P (about 2**-8 relative), which the final
    # rounding to bf16 turns into one-step differences in a few elements
    # in a hundred; a mirror that forgot to round lands there and fails.
    scale = d ** -0.5
    rng = np.random.default_rng(41 + t_q + d + block)
    q = rng.standard_normal((1, 2, t_q, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, t_kv, d)).astype(np.float32)
            for _ in range(2))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_kernel, lse_kernel = _flash_forward_pallas(jq, jk, jv, causal, scale,
                                                 block, block, interpret=True)
    want = np.asarray(o_kernel, np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(x, np.float32)).bfloat16()
                  for x in (jq, jk, jv))

    def distance(**kw):
        o, lse = flash_attention_reference(tq, tk, tv, causal, scale, **kw)
        return (np.linalg.norm(o.float().numpy() - want)
                / np.linalg.norm(want)), lse.numpy()

    fitted = _fit_block(t_kv, block, True)
    mirror, lse = distance(round_operands=True, block_k=fitted)
    plain, _ = distance()
    assert mirror < plain / 4, (mirror, plain)
    np.testing.assert_allclose(lse, np.asarray(lse_kernel), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("block_k", [16, 48])
def test_rounded_mirror_in_fp32_is_the_dense_plain_version(block_k):
    # Rounding to fp32 changes nothing; the block walk only reorders fp32
    # sums (about 1e-7).
    q, k, v = (torch.from_numpy(x) for x in _inputs(13, 1, 2, 96, 32))
    dense = flash_attention_reference(q, k, v, True)
    mirror = flash_attention_reference(q, k, v, True, round_operands=True,
                                       block_k=block_k)
    for a, b in zip(mirror, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("block_k", [8, 32, 128])
@pytest.mark.parametrize("causal,t_q,t_kv", [(True, 64, 64), (False, 64, 64),
                                             (True, 40, 96)],
                         ids=["causal", "full", "cross-length-causal"])
def test_block_walk_without_rounding_matches_dense(causal, t_q, t_kv,
                                                   block_k):
    rng = np.random.default_rng(17 + t_q + block_k)
    q = torch.from_numpy(rng.standard_normal((2, 2, t_q, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, t_kv, 16)).astype(
        np.float32)) for _ in range(2))
    walk = flash_attention_reference(q, k, v, causal, block_k=block_k)
    dense = flash_attention_reference(q, k, v, causal)
    for a, b in zip(walk, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
