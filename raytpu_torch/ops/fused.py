"""RMSNorm and SwiGLU, the port of :mod:`raytpu.ops.fused`.

:func:`rmsnorm` normalises the last dimension of ``x`` ``[..., D]``:
``x_f32 * rsqrt(mean(x_f32**2) + eps) * scale``, cast back to x's dtype.
On a CUDA tensor it launches the hand-written kernel ``csrc/rmsnorm.cu``
(the counterpart of the TPU kernel ``raytpu/ops/fused.py::
_rmsnorm_kernel``) or raises; on a CPU tensor it runs the plain version
:func:`rmsnorm_reference`. ``force="reference"`` picks the plain version
on either device, on purpose; nothing falls back to it.

It is differentiable in ``x`` and ``scale``. The JAX package has no
backward kernel for RMSNorm (XLA differentiates it), so the backward is
plain torch in fp32, recomputed from the saved ``x`` and ``scale``.

:func:`swiglu` is plain torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from raytpu_torch.ops import _native

LAUNCHES = _native.LaunchCounter()
# The kernel stages a row in shared memory: at most 227 KB of it a block.
_MAX_ROW_BYTES = 232448


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """The plain version, in ``_rmsnorm_ref``'s op order: the mean of the
    fp32 squares, then ``(x_f32 * rsqrt(var + eps)) * scale``, cast to
    x's dtype (fp32 math; float64 input stays float64)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _rmsnorm_backward(x, scale, g, eps):
    """``(dx, dscale)`` of :func:`rmsnorm_reference` for the output
    gradient ``g``, in fp32: with ``r = rsqrt(mean(x**2) + eps)`` and
    ``n = x r``, ``dscale = sum(g n)`` over the rows and ``dx = r (g s -
    n mean(g s n))``."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, gf, sf = x.to(acc), g.to(acc), scale.to(acc)
    r = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    n = xf * r
    gs = gf * sf
    dx = r * (gs - n * torch.mean(gs * n, dim=-1, keepdim=True))
    dscale = (gf * n).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _plain(x: torch.Tensor, force: Optional[str]) -> bool:
    """True where the plain version runs: on request, or on the CPU."""
    if force not in (None, "reference"):
        raise ValueError(f"rmsnorm: force={force!r}; use None or "
                         f"'reference'")
    return force == "reference" or x.device.type == "cpu"


class _RMSNorm(torch.autograd.Function):
    """``(x, scale) -> out`` by the kernel or the plain version; the
    backward recomputes from the saved ``x`` and ``scale``."""

    @staticmethod
    def forward(ctx, x, scale, eps, force):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if _plain(x, force):
            return rmsnorm_reference(x, scale, eps)
        return _rmsnorm_cuda(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _rmsnorm_backward(x, scale, g, ctx.eps)
        return dx, dscale, None, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
            force: Optional[str] = None) -> torch.Tensor:
    """RMSNorm over the last dim. ``x``: ``[..., D]``; ``scale``: ``[D]``.
    The result has x's dtype. ``force``: ``None`` (the kernel on CUDA
    tensors, the plain version on CPU tensors) or ``"reference"``."""
    if scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"match x {tuple(x.shape)} in its last dim")
    return _RMSNorm.apply(x, scale, float(eps), force)


def _rmsnorm_cuda(x, scale, eps):
    what = "rmsnorm"
    code = _native.dtype_code(what, x.dtype)
    d = x.shape[-1]
    if d * x.element_size() > _MAX_ROW_BYTES:
        raise ValueError(f"{what}: a row of {d} x {x.dtype} does not fit "
                         f"one block's {_MAX_ROW_BYTES} bytes of shared "
                         f"memory")
    # The wrapper's layout work: [..., D] -> [N, D] contiguous rows, and
    # the scale in fp32 (exact for a bf16 scale; JAX's type promotion).
    x2 = x.reshape(-1, d).contiguous()
    s = scale.to(torch.float32).contiguous()
    _native.check_inputs(what, x.device, x.dtype, x2)
    _native.check_inputs(what, x.device, torch.float32, s)
    out = torch.empty_like(x2)
    if out.numel() == 0:
        return out.view(x.shape)
    lib = _native.load(what)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rt_rmsnorm(x2.data_ptr(), s.data_ptr(), out.data_ptr(),
                            x2.shape[0], d, code, float(eps), stream)
    _native.check_launch(lib, rc, what)
    LAUNCHES.count += 1
    return out.view(x.shape)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor) -> torch.Tensor:
    """SwiGLU gate ``silu(x @ w_gate) * (x @ w_up)``, ``w_*`` ``[in,
    out]`` as in the JAX package: plain torch, which the JAX package
    leaves to XLA's fusion."""
    return F.silu(x @ w_gate) * (x @ w_up)
