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
from raytpu.ops.flash_attention import _flash_forward_pallas
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
