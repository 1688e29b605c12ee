"""RMSNorm and SwiGLU, the port of :mod:`raytpu.ops.fused`.

:func:`rmsnorm` normalises the last dimension of ``x`` ``[..., D]``:
``x_f32 * rsqrt(mean(x_f32**2) + eps) * scale``, cast back to x's dtype.
On a CUDA tensor it launches the hand-written kernel ``csrc/rmsnorm.cu``
(the counterpart of the TPU kernel ``raytpu/ops/fused.py::
_rmsnorm_kernel``) or raises; on a CPU tensor it runs the plain version
:func:`rmsnorm_reference`. ``force="reference"`` picks the plain version
on either device, on purpose; nothing falls back to it.

It is differentiable in ``x`` and ``scale``: where a gradient is wanted
(grad mode on, and ``x`` or ``scale`` requires it) the call goes through
an autograd Function; elsewhere, as in serving, straight to the kernel.
The JAX package has no backward kernel for RMSNorm (XLA differentiates
it), so the backward is plain torch in fp32, recomputed from the saved
``x`` and ``scale``.

The kernel reads the scale in its own type (fp32 or bf16), so the
wrapper launches nothing but the kernel. Rows of a multiple of 16 bytes
stream through a ring of shared-memory stages on a grid planned from the
row count and size (:func:`plan_rows`: a row a block, a persistent wave,
or walks of two rows); other rows take one block each.

:func:`swiglu` is plain torch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from raytpu_torch.ops import _native

LAUNCHES = _native.LaunchCounter()
# The kernel stages a row in shared memory: at most 227 KB of it a block.
_MAX_ROW_BYTES = 232448
# The ring's plan, kept equal to csrc/rmsnorm.cu's kThreads, kMinBlocks,
# kMaxStages and kSmemDefault. A block has at most 256 threads; its launch
# bounds keep the kernel within 64 registers a thread, so an SM holds at
# least 1024 of its threads. A block keeps up to 3 rows in flight, as many
# as fit the 47 KB it takes without opting in to more (a wider row: as
# many as fit 227 KB, at least one).
_THREADS = 256
_SM_THREADS = 1024
_SM_BLOCKS = 32        # resident blocks an SM, Hopper's most
_SM_SMEM = 233472      # shared memory of an SM, 228 KB
_BLOCK_SMEM = 1024 + 128  # the 1 KB each block reserves, the static part
_STAGES = 3
_SMEM_DEFAULT = 47 * 1024
# Where x outgrows four fifths of Hopper's 50 MB L2 it streams from device
# memory, and there blocks that walk many rows lost 3-8 % of device time to
# walks of two rows on an H100 (an x of 48 MB lost, 32 MB won; PERF.md), so
# above it each block walks _STREAM_WALK rows.
_WAVE_BYTES = 40 * 1024 * 1024
_STREAM_WALK = 2


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


def _threads(units: int, per: int) -> int:
    """Threads for about ``per`` 16-byte units each: whole warps, at most
    ``_THREADS``."""
    return min(_THREADS, 32 * -(-units // (32 * per)))


def _resident(threads: int, stages: int, row_bytes: int) -> int:
    """Blocks an SM holds at once, by threads, registers and shared
    memory."""
    return max(1, min(_SM_BLOCKS, _SM_THREADS // threads,
                      _SM_SMEM // (stages * row_bytes + _BLOCK_SMEM)))


def plan_rows(n_rows: int, row_bytes: int,
              n_sm: int) -> Tuple[int, int, int]:
    """``(blocks, stages, threads)`` of the kernel for ``n_rows`` rows of
    ``row_bytes`` each on a card of ``n_sm`` SMs, from what the host knows
    without reading the device. ``stages`` 0: the element path, one block
    a row (a row whose bytes are not a multiple of 16 can be neither bulk
    copied nor loaded in 16-byte vectors; the kernel picks its threads).
    Else the ring, in one of three shapes:

    - rows that fit on the card at once, 256 threads a block (about two
      units a thread): one row a block, nothing to walk;
    - more rows, x up to ``_WAVE_BYTES``: a persistent grid of as many
      blocks as the card holds at once, of about four units a thread
      (more, smaller blocks keep more rows in flight), each walking its
      rows with up to ``_STAGES`` in flight;
    - a larger x: blocks of ``_STREAM_WALK`` rows, the second in flight
      while the first is reduced."""
    if row_bytes % 16 or n_rows <= 0:
        return n_rows, 0, 0
    units = row_bytes // 16
    budget = _SMEM_DEFAULT if row_bytes <= _SMEM_DEFAULT else _MAX_ROW_BYTES
    stages = max(1, min(_STAGES, budget // row_bytes))
    threads = _threads(units, 2)
    if n_rows * row_bytes > _WAVE_BYTES:
        blocks = -(-n_rows // _STREAM_WALK)
    elif n_rows <= n_sm * _resident(threads, 1, row_bytes):
        blocks = n_rows
    else:
        threads = _threads(units, 4)
        blocks = min(n_rows, n_sm * _resident(threads, stages, row_bytes))
    return blocks, min(stages, -(-n_rows // blocks)), threads


_plan = functools.lru_cache(maxsize=1024)(plan_rows)


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
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, float(eps), force)
    if _plain(x, force):
        return rmsnorm_reference(x, scale, eps)
    return _rmsnorm_cuda(x, scale, eps)


def _rmsnorm_cuda(x, scale, eps):
    what = "rmsnorm"
    code = _native.dtype_code(what, x.dtype)
    d = x.shape[-1]
    row_bytes = d * x.element_size()
    if row_bytes > _MAX_ROW_BYTES:
        raise ValueError(f"{what}: a row of {d} x {x.dtype} does not fit "
                         f"one block's {_MAX_ROW_BYTES} bytes of shared "
                         f"memory")
    # The kernel takes x as [N, D] contiguous rows and the scale in fp32 or
    # bf16 as it is; another float type goes to fp32 (JAX's promotion).
    if not x.is_contiguous():
        x = x.contiguous()
    scode = _native.DTYPE_CODES.get(scale.dtype)
    if scode is None:
        scale, scode = scale.float(), 0
    if not scale.is_contiguous():
        scale = scale.contiguous()
    index = x.get_device()
    _native.check_inputs(what, index, None, x, scale)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    n_rows = out.numel() // d
    blocks, stages, threads = _plan(n_rows, row_bytes,
                                    _native.sm_count(index))
    _native.launch(what, index, x.data_ptr(), scale.data_ptr(),
                   out.data_ptr(), n_rows, d, code, scode, float(eps), blocks,
                   stages, threads)
    LAUNCHES.count += 1
    return out


def swiglu(x: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor) -> torch.Tensor:
    """SwiGLU gate ``silu(x @ w_gate) * (x @ w_up)``, ``w_*`` ``[in,
    out]`` as in the JAX package: plain torch, which the JAX package
    leaves to XLA's fusion."""
    return F.silu(x @ w_gate) * (x @ w_up)
