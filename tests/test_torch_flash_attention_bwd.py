"""The port's flash attention backward (raytpu_torch/ops/flash_attention.py)
against the JAX package's: the plain PyTorch backward against the JAX
reference (``_attn_bwd_reference``) and against ``jax.vjp`` through the
Pallas dQ and dK/dV kernels run by the interpreter, on the same numpy
inputs; the autograd Function against ``gradcheck``. The CUDA kernels
themselves run only on the card (chip_smoke.py holds them against the
plain backward there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.ops.flash_attention import (_attn_bwd_reference,
                                        _attn_fwd_reference, _flash_fwd)
from raytpu.ops.flash_attention import flash_attention as jax_flash
from raytpu_torch.ops.flash_attention import (
    BWD_DKV_LAUNCHES, BWD_DQ_LAUNCHES, LAUNCHES, flash_attention,
    flash_attention_backward, flash_attention_backward_reference)

# The JAX package's bounds for attention gradients (tests/test_ops.py):
# fp32 1e-4; bf16 5e-2, where both sides round their outputs to bf16 and
# the Pallas kernels also feed P and dS to the matrix unit in bf16.
TOL = 1e-4
BF16_TOL = 5e-2


def _inputs(seed, b, h, t_q, t_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
    k = rng.standard_normal((b, h, t_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, t_kv, d)).astype(np.float32)
    g = rng.standard_normal((b, h, t_q, d)).astype(np.float32)
    return q, k, v, g


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    """(o, dq, dk, dv) from torch.autograd through the port's op."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in (q, k, v))
    o, _ = flash_attention(q, k, v, causal=causal)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v),
                                     torch.from_numpy(g).to(dtype))
    return [x.float().numpy() for x in (o.detach(), dq, dk, dv)]


def _jax_grads(q, k, v, g, causal, force, dtype=jnp.float32):
    jq, jk, jv, jg = (jnp.asarray(x, dtype) for x in (q, k, v, g))
    o, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                force=force), jq, jk, jv)
    return [np.asarray(x, np.float32) for x in (o, *vjp(jg))]


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 16, 16, 32), (2, 3, 64, 64, 16),
                                   (1, 2, 24, 40, 32)],
                         ids=["small", "batched", "cross-length"])
def test_plain_backward_matches_jax_reference(causal, shape):
    b, h, t_q, t_kv, d = shape
    q, k, v, g = _inputs(t_q + t_kv + d, b, h, t_q, t_kv, d)
    scale = d ** -0.5
    o, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal=causal,
                                                 force="reference"),
                     *(jnp.asarray(x) for x in (q, k, v)))
    _, lse = _attn_fwd_reference(*(jnp.asarray(x) for x in (q, k, v)),
                                 causal, scale)
    want = _attn_bwd_reference(*(jnp.asarray(x) for x in (q, k, v)), o, lse,
                               jnp.asarray(g), causal, scale)
    got = flash_attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v, np.array(o),
                                        np.array(lse), g)), causal, scale)
    _close([x.numpy() for x in got], [np.asarray(x) for x in want], TOL)
    # And through autograd, against jax.vjp of the JAX op.
    _close(_port_grads(q, k, v, g, causal),
           _jax_grads(q, k, v, g, causal, "reference"), TOL)


@pytest.mark.parametrize("causal,t_q,t_kv", [(True, 64, 64), (False, 64, 64),
                                             (True, 32, 64)],
                         ids=["causal", "full", "cross-length-causal"])
def test_plain_backward_matches_pallas_interpret(causal, t_q, t_kv):
    # The real TPU dQ and dK/dV kernels, run by the Pallas interpreter.
    q, k, v, g = _inputs(11 + t_q, 1, 2, t_q, t_kv, 32)
    _close(_port_grads(q, k, v, g, causal),
           _jax_grads(q, k, v, g, causal, "interpret"), TOL)


def test_bf16_backward_matches_pallas_interpret():
    q, k, v, g = _inputs(4, 1, 2, 64, 64, 64)
    got = _port_grads(q, k, v, g, True, dtype=torch.bfloat16)
    want = _jax_grads(q, k, v, g, True, "interpret", dtype=jnp.bfloat16)
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("causal,t_q,t_kv,d", [(True, 128, 128, 64),
                                               (False, 128, 128, 64),
                                               (True, 64, 128, 32)],
                         ids=["causal", "full", "cross-length-causal"])
def test_bf16_rounded_mirror_matches_pallas_interpret(causal, t_q, t_kv, d):
    # The mirror (P rounded to bf16 before the dV product, dS before the dQ
    # and dK products) against jax.vjp through the interpreted Pallas
    # kernels in their default dot mode "input", both fed the o and lse of
    # the JAX forward. The two round the same fp32 values at the same
    # points and differ only in the order of their fp32 sums, so each
    # gradient must lie under a quarter of the unrounded plain backward's
    # relative norm distance: that one differs by the roundings of P and
    # dS (each about 2**-8 relative), which the final rounding to bf16
    # turns into one-step differences in a few elements in a hundred
    # (about 2.6e-3 in norm at these shapes); a mirror that forgot to
    # round lands there and fails.
    scale = d ** -0.5
    q, k, v, g = (jnp.asarray(x, jnp.bfloat16)
                  for x in _inputs(31 + t_q + d, 1, 2, t_q, t_kv, d))
    o, (*_, lse) = _flash_fwd(q, k, v, causal, scale, "interpret")
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                                force="interpret"), q, k, v)
    want = [np.asarray(x, np.float32) for x in vjp(g)]
    args = [torch.from_numpy(np.array(x, np.float32)).bfloat16()
            for x in (q, k, v, o)] + [torch.from_numpy(np.array(lse))]
    gt = torch.from_numpy(np.array(g, np.float32)).bfloat16()

    def distances(round_operands):
        got = flash_attention_backward_reference(
            *args, gt, causal, scale, round_operands=round_operands)
        return [np.linalg.norm(x.float().numpy() - w) / np.linalg.norm(w)
                for x, w in zip(got, want)]

    mirror, plain = distances(True), distances(False)
    assert all(m < p / 4 for m, p in zip(mirror, plain)), (mirror, plain)


def test_rounded_mirror_is_plain_in_fp32():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(12, 1, 2, 16, 24, 16))
    o, lse = flash_attention(q, k, v)
    a = flash_attention_backward_reference(q, k, v, o, lse, g, True, 0.25)
    b = flash_attention_backward_reference(q, k, v, o, lse, g, True, 0.25,
                                           round_operands=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_bf16_keeps_gradient_dtypes():
    q, k, v = (torch.from_numpy(x).bfloat16().requires_grad_()
               for x in _inputs(5, 1, 2, 8, 8, 16)[:3])
    o, lse = flash_attention(q, k, v)
    o.float().sum().backward()
    assert lse.dtype == torch.float32 and not lse.requires_grad
    assert {x.grad.dtype for x in (q, k, v)} == {torch.bfloat16}


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_passes_gradcheck(causal):
    q, k, v = (torch.from_numpy(x).double().requires_grad_()
               for x in _inputs(6, 1, 2, 6, 8, 4)[:3])
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, causal=causal)[0],
        (q, k, v), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_reference_selector_and_cpu_path_agree():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(7, 1, 2, 16, 16, 16))
    o, lse = flash_attention(q, k, v)
    a = flash_attention_backward(q, k, v, o, lse, g, causal=True,
                                 sm_scale=0.25)
    b = flash_attention_backward(q, k, v, o, lse, g, causal=True,
                                 sm_scale=0.25, force="reference")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        flash_attention_backward(q, k, v, o, lse, g, causal=True,
                                 sm_scale=0.25, force="kernel")


def test_cpu_tensor_launches_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(8, 1, 2, 16, 16, 16)[:3])
    before = (LAUNCHES.count, BWD_DQ_LAUNCHES.count, BWD_DKV_LAUNCHES.count)
    o, _ = flash_attention(q, k, v)
    o.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (LAUNCHES.count, BWD_DQ_LAUNCHES.count,
            BWD_DKV_LAUNCHES.count) == before


def test_no_grad_saves_nothing():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(9, 1, 1, 8, 8, 16)[:3])
    with torch.no_grad():
        o, lse = flash_attention(q, k, v)
    assert o.grad_fn is None and lse.grad_fn is None
