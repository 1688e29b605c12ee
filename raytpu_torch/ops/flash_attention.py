"""Flash attention forward, the port of :mod:`raytpu.ops.flash_attention`.

:func:`flash_attention` takes ``q`` ``[B, H, T_q, D]`` and ``k``, ``v``
``[B, H, T_kv, D]`` and returns ``(o, lse)``: ``o`` ``[B, H, T_q, D]`` in
q's dtype and the log-sum-exp ``lse`` ``[B, H, T_q, 1]`` in fp32 (kept
for the backward pass of a later training slice). The causal diagonal
is bottom-aligned (``key <= query + T_kv - T_q``), as in the JAX
package. The JAX docstring's ill-defined ``T_q > T_kv`` causal case
(rows that see nothing) is not part of the contract.

On a CUDA tensor it launches the hand-written kernel
``csrc/flash_attention.cu`` (the counterpart of the TPU kernel
``raytpu/ops/flash_attention.py::_flash_kernel``) or raises; on a CPU
tensor it runs :func:`flash_attention_reference`, the plain PyTorch
version. ``force="reference"`` picks the plain version on either device,
on purpose; nothing falls back to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raytpu_torch.ops import _native

NEG_INF = -1e30
LAUNCHES = _native.LaunchCounter()


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense fp32 attention, in the op order of the JAX reference
    (``_attn_fwd_reference``): fp32 einsum, ``where`` mask, logsumexp,
    exp, fp32 einsum."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        t_q, t_k = q.shape[2], k.shape[2]
        mask = torch.ones((t_q, t_k), dtype=torch.bool,
                          device=q.device).tril(t_k - t_q)
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    force: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward on ``[B, H, T, D]``; returns ``(o, lse)``.

    ``force``: ``None`` (the kernel on a CUDA tensor, the plain version
    on a CPU tensor) or ``"reference"`` (the plain version).
    """
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B, H, T, D] with matching B, H, D")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if force == "reference" or (force is None and q.device.type == "cpu"):
        return flash_attention_reference(q, k, v, causal, sm_scale)
    if force is not None:
        raise ValueError(f"flash_attention: force={force!r}; use None or "
                         f"'reference'")
    return _flash_cuda(q, k, v, causal, sm_scale)


def _flash_cuda(q, k, v, causal, sm_scale):
    what = "flash_attention"
    code = _native.dtype_code(what, q.dtype)
    _native.check_inputs(what, q.device, q.dtype, q, k, v)
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    if d not in _native.HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {_native.HEAD_DIMS}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t_q, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    lib = _native.load(what)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rt_flash_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), code, b * h, t_q, t_kv, d, int(causal),
            float(sm_scale), stream)
    _native.check_launch(lib, rc, what)
    LAUNCHES.count += 1
    return o, lse
