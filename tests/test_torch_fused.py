"""The port's RMSNorm and SwiGLU (raytpu_torch/ops/fused.py) against the
JAX package's (raytpu/ops/fused.py): the plain version against the JAX
reference and against the Pallas kernel run by the interpreter, on the
same numpy inputs; the Flax RMSNorm of raytpu.models.llama against that
kernel (which makes routing Llama's norms through it sound); the
autograd Function's backward against jax.grad. The CUDA kernel itself
runs only on the card (chip_smoke.py holds it against the plain version
there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.models.llama import RMSNorm as FlaxRMSNorm
from raytpu.ops.fused import rmsnorm as jax_rmsnorm
from raytpu.ops.fused import swiglu as jax_swiglu
from raytpu_torch.models.llama import RMSNorm
from raytpu_torch.ops import _native, fused
from raytpu_torch.ops.fused import (LAUNCHES, rmsnorm, rmsnorm_reference,
                                    swiglu)

# The JAX package's own bound for rmsnorm in fp32 (tests/test_ops.py);
# bf16 outputs may differ by one bf16 step (2**-8 relative) where the two
# fp32 results sit on either side of a rounding boundary: 3e-2, the JAX
# package's bf16 bound.
TOL = 1e-5
BF16_TOL = 3e-2
# Gradients in fp32 through a mean and an rsqrt: 1e-4, the JAX package's
# bound for fp32 gradients (tests/test_ops.py).
GRAD_TOL = 1e-4


def _x(seed, shape, scale_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    s = (1.0 + 0.3 * rng.standard_normal(shape[-1])).astype(scale_dtype)
    return x, s


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


CASES = {
    "64x128": ((64, 128), np.float32, 1e-6),
    "3x5x128": ((3, 5, 128), np.float32, 1e-6),
    "300_rows": ((300, 128), np.float32, 1e-6),  # crosses the 256-row pad
    "eps_1e-5": ((64, 128), np.float32, 1e-5),
    "bf16_scale": ((64, 128), jnp.bfloat16, 1e-6),
    "ragged_d": ((10, 100), np.float32, 1e-5),
}


@pytest.mark.parametrize("force", ["reference", "interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_rmsnorm_matches_jax(case, force):
    shape, scale_dtype, eps = CASES[case]
    x, s = _x(len(case), shape, scale_dtype)
    want = jax_rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=eps, force=force)
    ts = torch.from_numpy(np.asarray(s, np.float32))
    if scale_dtype is not np.float32:
        ts = ts.to(torch.bfloat16)
    before = LAUNCHES.count
    got = rmsnorm(torch.from_numpy(x), ts, eps=eps)
    assert LAUNCHES.count == before  # CPU tensors never reach the kernel
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, TOL)
    _close(rmsnorm_reference(torch.from_numpy(x), ts, eps), want, TOL)


@pytest.mark.parametrize("force", ["reference", "interpret"])
def test_bf16_rmsnorm_matches_jax(force):
    x, s = _x(7, (48, 256))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax_rmsnorm(jx, jnp.asarray(s), eps=1e-5, force=force)
    got = rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(s),
                  eps=1e-5)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), BF16_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flax_rmsnorm_is_the_kernel_function(dtype):
    # Every Llama norm is Flax's RMSNorm(eps=1e-5) on x already in the
    # compute dtype: the same function as rmsnorm(eps=1e-5), whose TPU
    # kernel the port's Llama RMSNorm routes through.
    x, s = _x(11, (2, 24, 128))
    jx = jnp.asarray(x).astype(dtype)
    norm = FlaxRMSNorm(dtype=dtype)
    flax_out = norm.apply({"params": {"scale": jnp.asarray(s)}}, jx)
    kernel = jax_rmsnorm(jx, jnp.asarray(s), eps=1e-5, force="interpret")
    assert flax_out.dtype == kernel.dtype == dtype
    tol = TOL if dtype == jnp.float32 else BF16_TOL
    _close(np.asarray(flax_out, np.float32), np.asarray(kernel, np.float32),
           tol)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    port = RMSNorm(128, tdt)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(s))
        got = port(torch.from_numpy(np.array(jx.astype(jnp.float32))
                                    ).to(tdt))
    _close(got.float(), np.asarray(flax_out, np.float32), tol)


def test_port_rmsnorm_refuses_x_outside_the_compute_dtype():
    with pytest.raises(TypeError):
        RMSNorm(8, torch.bfloat16)(torch.ones(2, 8))


@pytest.mark.parametrize("shape", [(16, 128), (2, 7, 64)])
def test_rmsnorm_backward_matches_jax_grad(shape):
    x, s = _x(13, shape)
    gout = np.random.default_rng(14).standard_normal(shape).astype(
        np.float32)
    norm = FlaxRMSNorm(dtype=jnp.float32)

    def f(xx, ss):
        out = norm.apply({"params": {"scale": ss}}, xx)
        return jnp.sum(out * jnp.asarray(gout))

    jdx, jds = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    out = rmsnorm(tx, ts, eps=1e-5)
    dx, ds = torch.autograd.grad(out, (tx, ts), torch.from_numpy(gout))
    assert dx.dtype == ds.dtype == torch.float32
    _close(dx, jdx, GRAD_TOL)
    _close(ds, jds, GRAD_TOL)


def test_rmsnorm_backward_in_bf16_keeps_the_dtypes():
    # dx in x's dtype, dscale in the scale's (fp32 in every Llama norm).
    x, s = _x(15, (4, 32))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    out = rmsnorm(tx, ts, eps=1e-5)
    dx, ds = torch.autograd.grad(out.float().sum(), (tx, ts))
    assert out.dtype == dx.dtype == torch.bfloat16
    assert ds.dtype == torch.float32


def test_rmsnorm_backward_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 16, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    s = (1 + 0.1 * torch.randn(16, generator=gen, dtype=torch.float64)
         ).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: rmsnorm(a, b, eps=1e-5),
                                    (x, s))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    wg, wu = (0.1 * rng.standard_normal((64, 176)).astype(np.float32)
              for _ in range(2))
    want = jax_swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    got = swiglu(*(torch.from_numpy(a) for a in (x, wg, wu)))
    _close(got, want, TOL)


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("n_rows", [1, 8, 512, 8192])
def test_row_plan_covers_the_rows_within_the_card(n_rows, n_sm, monkeypatch):
    # The planner is plain host arithmetic: it must not touch the device
    # (a read would stall the host-bound decode step), so here every CUDA
    # query raises.
    def no_device(*_a, **_k):
        raise AssertionError("plan_rows read the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    monkeypatch.setattr(torch.cuda, "current_device", no_device)
    for row_bytes in [16, 256, 8192, 8200, 16384, 48128, 48144, 100000,
                      116224, fused._MAX_ROW_BYTES - 16,
                      fused._MAX_ROW_BYTES]:
        blocks, stages, threads = fused.plan_rows(n_rows, row_bytes, n_sm)
        assert all(type(v) is int for v in (blocks, stages, threads))
        if row_bytes % 16:  # the element path: one block a row
            assert (blocks, stages, threads) == (n_rows, 0, 0)
            continue
        assert 1 <= blocks <= n_rows
        # Every row has a block (block b walks b, b + blocks, ...), and no
        # stage waits for a row its block never walks.
        assert 1 <= stages <= min(fused._STAGES, -(-n_rows // blocks))
        assert 32 <= threads <= fused._THREADS and threads % 32 == 0
        budget = (fused._SMEM_DEFAULT if row_bytes <= fused._SMEM_DEFAULT
                  else fused._MAX_ROW_BYTES)
        assert stages * row_bytes <= budget
        if n_rows * row_bytes <= fused._WAVE_BYTES:
            # One wave: no more blocks than the card holds at once.
            assert blocks <= n_sm * fused._resident(threads, stages,
                                                    row_bytes)
        else:
            assert blocks == -(-n_rows // fused._STREAM_WALK)


def test_row_plan_shapes_at_the_main_paths():
    # On an H100 (132 SMs), Llama rows of 4096 bf16 (8 KB): decode and a
    # prefill chunk take one row a block; Mixtral's 4096 rows a persistent
    # grid of 128-thread blocks, 8 an SM, 3 rows in flight; Llama train's
    # 8192 rows (64 MB) blocks of two rows; a ragged row the element path.
    assert fused.plan_rows(8, 8192, 132) == (8, 1, 256)
    assert fused.plan_rows(512, 8192, 132) == (512, 1, 256)
    assert fused.plan_rows(4096, 8192, 132) == (1056, 3, 128)
    assert fused.plan_rows(8192, 8192, 132) == (4096, 2, 256)
    assert fused.plan_rows(8192, 16384, 132) == (4096, 2, 256)
    assert fused.plan_rows(64, 8200, 132) == (64, 0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_direct_call_and_function_give_the_same_tensor(dtype, monkeypatch):
    # Without a wanted gradient the wrapper skips the autograd Function;
    # with one it goes through it, and the Function returns both gradients.
    x, s = _x(21, (6, 64))
    tx, ts = torch.from_numpy(x).to(dtype), torch.from_numpy(s)
    applied = []
    apply = fused._RMSNorm.apply
    monkeypatch.setattr(fused._RMSNorm, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    with torch.no_grad():
        direct = rmsnorm(tx, ts, eps=1e-5)
    plain = rmsnorm(tx, ts, eps=1e-5)  # grad mode on, nothing wants one
    assert applied == [] and direct.grad_fn is None
    lx, ls = tx.clone().requires_grad_(), ts.clone().requires_grad_()
    through = rmsnorm(lx, ls, eps=1e-5)
    assert applied == [1] and through.grad_fn is not None
    assert torch.equal(direct, through.detach())
    assert torch.equal(direct, plain)
    dx, ds = torch.autograd.grad(through.float().sum(), (lx, ls))
    assert dx.shape == lx.shape and ds.shape == ls.shape
    assert torch.isfinite(dx.float()).all() and torch.isfinite(ds).all()


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bf16_scale_gives_what_its_fp32_copy_gives(x_dtype):
    # bf16 -> fp32 is exact, so the kernel may read a bf16 scale as it is.
    x, s = _x(23, (9, 128))
    tx = torch.from_numpy(x).to(x_dtype)
    sb = torch.from_numpy(s).bfloat16()
    assert torch.equal(rmsnorm(tx, sb, eps=1e-5),
                       rmsnorm(tx, sb.float(), eps=1e-5))


class _Stub:
    """What check_inputs reads of a tensor, for refusals that need a CUDA
    tensor to reach."""

    def __init__(self, contiguous=True, ptr=256, index=0):
        self.is_cuda, self.device, self.dtype = True, f"cuda:{index}", None
        self._contiguous, self._ptr, self._index = contiguous, ptr, index

    def get_device(self):
        return self._index

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


def test_rmsnorm_keeps_every_refusal_it_can_show_without_a_card():
    x = torch.ones(4, 64)
    with pytest.raises(ValueError, match="scale"):
        rmsnorm(x, torch.ones(63))
    with pytest.raises(ValueError, match="force"):
        rmsnorm(x, torch.ones(64), force="kernel")
    with pytest.raises(TypeError):  # the kernel takes fp32 and bf16 only
        fused._rmsnorm_cuda(x.half(), torch.ones(64), 1e-5)
    with pytest.raises(ValueError, match="shared"):  # a row over 227 KB
        fused._rmsnorm_cuda(torch.ones(2, 60000), torch.ones(60000), 1e-5)
    with pytest.raises(ValueError, match="CUDA"):  # off the card
        fused._rmsnorm_cuda(x, torch.ones(64), 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(torch.ones(4, 64, device="meta"), torch.ones(64))
    # One pass over the tensors: another device, a non-contiguous or a
    # misaligned tensor.
    ok = _Stub()
    _native.check_inputs("rmsnorm", 0, None, ok, ok)
    for bad in (_Stub(index=1), _Stub(contiguous=False), _Stub(ptr=264)):
        with pytest.raises(ValueError):
            _native.check_inputs("rmsnorm", 0, None, ok, bad)
    with pytest.raises(TypeError):
        _native.check_inputs("flash_attention", 0, torch.bfloat16, ok)
