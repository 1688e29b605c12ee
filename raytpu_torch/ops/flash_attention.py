"""Flash attention, the port of :mod:`raytpu.ops.flash_attention`.

:func:`flash_attention` takes ``q`` ``[B, H, T_q, D]`` and ``k``, ``v``
``[B, H, T_kv, D]`` and returns ``(o, lse)``: ``o`` ``[B, H, T_q, D]`` in
q's dtype and the log-sum-exp ``lse`` ``[B, H, T_q, 1]`` in fp32 (at
least). It is differentiable in ``q``, ``k`` and ``v`` (``lse`` is not):
a :class:`torch.autograd.Function`, the counterpart of the JAX package's
``jax.custom_vjp``, saves ``(q, k, v, o, lse)`` and recomputes the scores
in the backward pass. The causal diagonal is bottom-aligned
(``key <= query + T_kv - T_q``), as in the JAX package. The JAX
docstring's ill-defined ``T_q > T_kv`` causal case (rows that see
nothing) is not part of the contract.

On CUDA tensors the forward launches the hand-written kernel
``csrc/flash_attention.cu`` (the counterpart of the TPU kernel
``raytpu/ops/flash_attention.py::_flash_kernel``) and the backward the
kernels ``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu`` (for
``::_flash_bwd_dq_kernel`` and ``::_flash_bwd_dkv_kernel``), or raises;
on CPU tensors both run the plain PyTorch versions
(:func:`flash_attention_reference`,
:func:`flash_attention_backward_reference`). ``force="reference"`` picks
the plain versions on either device, on purpose; nothing falls back to
them. The bf16 kernels run on the tensor cores and round P (forward and
backward) and dS (backward) to bf16 before their products, where the
TPU kernels round them; ``flash_attention_reference(...,
round_operands=True, block_k=64)`` and
``flash_attention_backward_reference(..., round_operands=True)`` are
their mirrors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raytpu_torch.ops import _native

NEG_INF = -1e30
LAUNCHES = _native.LaunchCounter()         # forward kernel
BWD_DQ_LAUNCHES = _native.LaunchCounter()  # backward dQ kernel
BWD_DKV_LAUNCHES = _native.LaunchCounter()  # backward dK/dV kernel


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the plain versions' accumulation type: fp32, or float64
    for float64 input (so ``gradcheck`` can run them)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _causal_mask(t_q: int, t_k: int, device) -> torch.Tensor:
    return torch.ones((t_q, t_k), dtype=torch.bool,
                      device=device).tril(t_k - t_q)


def blockwise_attention(q, k, v, visible, sm_scale: float, block_k: int,
                        round_to: Optional[torch.dtype] = None):
    """The TPU kernels' online softmax, in plain PyTorch: ``q`` ``[..., T_q,
    D]`` against ``k``, ``v`` ``[..., T_k, D]`` (all in the accumulation
    type), the keys walked in blocks of ``block_k`` in the order of
    ``_flash_kernel`` and ``_paged_kernel``::

        S = Q K^T * scale, masked entries -1e30 (``visible`` False)
        m' = max(m, rowmax S);  P = exp(S - m');  c = exp(m - m')
        l = l c + rowsum P      (from the unrounded P)
        O = O c + P V           (P rounded to ``round_to`` first, if given)

    Returns ``(O / max(l, 1e-30), m + log l)``, unrounded."""
    m = torch.full((*q.shape[:-1], 1), NEG_INF, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*q.shape[:-1], v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    for k0 in range(0, k.shape[-2], block_k):
        s = torch.einsum("...qd,...kd->...qk", q,
                         k[..., k0:k0 + block_k, :]) * sm_scale
        if visible is not None:
            s = torch.where(visible[..., k0:k0 + block_k], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        c = torch.exp(m - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        if round_to is not None:
            p = p.to(round_to).to(p.dtype)
        acc = acc * c + torch.einsum("...qk,...kd->...qd", p,
                                     v[..., k0:k0 + block_k, :])
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l, m + torch.log(l)


def flash_attention_reference(q, k, v, causal: bool = True,
                              sm_scale: Optional[float] = None, *,
                              round_operands: bool = False,
                              block_k: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense attention in fp32, in the op order of the JAX reference
    (``_attn_fwd_reference``): einsum, ``where`` mask, logsumexp, exp,
    einsum.

    With ``round_operands`` or ``block_k`` it is the mirror of the
    kernels instead (:func:`blockwise_attention`): the keys walked in
    blocks of ``block_k`` (all in one if None) in the TPU kernel's order,
    and with ``round_operands`` P rounded to the input type before P V,
    where the TPU kernel in its default dot mode ``"input"`` rounds it
    (``p.astype(mxu)``) and the bf16 CUDA kernel feeds it to the tensor
    cores; l is summed from the unrounded P. The rounding is a no-op for
    fp32 input."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    mask = _causal_mask(q.shape[2], k.shape[2], q.device) if causal else None
    if round_operands or block_k is not None:
        o, lse = blockwise_attention(
            _acc(q), _acc(k), _acc(v), mask, sm_scale, block_k or k.shape[2],
            q.dtype if round_operands else None)
        return o.to(q.dtype), lse
    s = torch.einsum("bhqd,bhkd->bhqk", _acc(q), _acc(k)) * sm_scale
    if causal:
        s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.einsum("bhqk,bhkd->bhqd", p, _acc(v))
    return o.to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, o, lse, g, causal: bool,
                                       sm_scale: float, *,
                                       round_operands: bool = False
                                       ) -> Tuple[torch.Tensor, ...]:
    """Gradients ``(dq, dk, dv)`` of the attention output against the
    output gradient ``g``, dense in fp32, in the op order of the JAX
    reference (``_attn_bwd_reference``).

    ``round_operands`` gives the mirror of the kernels: P is rounded to
    the input type before the dV product and dS before the dQ and dK
    products, where the TPU kernels round them in their default dot mode
    ``"input"`` (``p.astype(mxu)``, ``ds.astype(mxu)``) and the bf16 CUDA
    kernels feed them to the tensor cores. A no-op for fp32 input."""
    qf, kf, vf, gf = (_acc(x) for x in (q, k, v, g))

    def operand(x):
        return x.to(q.dtype).to(x.dtype) if round_operands else x

    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * sm_scale
    if causal:
        s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s,
                        NEG_INF)
    p = torch.exp(s - lse)
    dv = torch.einsum("bhqk,bhqd->bhkd", operand(p), gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    delta = torch.sum(gf * _acc(o), dim=-1, keepdim=True)
    ds = operand(p * (dp - delta) * sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _plain(x: torch.Tensor, force: Optional[str]) -> bool:
    """True where the plain version runs: on request, or on the CPU."""
    if force not in (None, "reference"):
        raise ValueError(f"flash_attention: force={force!r}; use None or "
                         f"'reference'")
    return force == "reference" or x.device.type == "cpu"


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (o, lse)`` with the flash backward: the forward
    saves ``(q, k, v, o, lse)``; the backward recomputes the scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, force):
        if _plain(q, force):
            o, lse = flash_attention_reference(q, k, v, causal, sm_scale)
        else:
            o, lse = _flash_cuda(q, k, v, causal, sm_scale)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.force = causal, sm_scale, force
        return o, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, g.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale, force=ctx.force)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    force: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention on ``[B, H, T, D]``; returns ``(o, lse)``,
    differentiable in ``q``, ``k`` and ``v``.

    ``force``: ``None`` (the kernels on CUDA tensors, the plain versions
    on CPU tensors) or ``"reference"`` (the plain versions).
    """
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B, H, T, D] with matching B, H, D")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, float(sm_scale), force)


def flash_attention_backward(q, k, v, o, lse, g, *, causal: bool,
                             sm_scale: float, force: Optional[str] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv)`` from the forward's ``o`` and ``lse`` and the
    output gradient ``g``: the two backward kernels on CUDA tensors, the
    plain version on CPU tensors or with ``force="reference"``."""
    if _plain(q, force):
        return flash_attention_backward_reference(q, k, v, o, lse, g, causal,
                                                  sm_scale)
    # delta = rowsum(dO * O), outside the kernels as in the JAX package.
    delta = torch.sum(g.float() * o.float(), dim=-1)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal, sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal, sm_scale)
    return dq, dk, dv


def _flash_cuda(q, k, v, causal, sm_scale):
    what = "flash_attention"
    code = _native.dtype_code(what, q.dtype)
    index = q.get_device()
    _native.check_inputs(what, index, q.dtype, q, k, v)
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    if d not in _native.HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {_native.HEAD_DIMS}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t_q, 1), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _native.launch(what, index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   o.data_ptr(), lse.data_ptr(), code, b * h, t_q, t_kv, d,
                   int(causal), float(sm_scale))
    LAUNCHES.count += 1
    return o, lse


def _check_bwd(what, q, k, v, g, lse, delta) -> Tuple[int, int]:
    """Raise unless the backward kernels take these inputs; returns the
    dtype code and the device index."""
    code = _native.dtype_code(what, q.dtype)
    index = q.get_device()
    _native.check_inputs(what, index, q.dtype, q, k, v, g)
    _native.check_inputs(what, index, torch.float32, lse, delta)
    b, h, t_q, d = q.shape
    if d not in _native.HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {_native.HEAD_DIMS}")
    if g.shape != q.shape or lse.numel() != b * h * t_q \
            or delta.numel() != b * h * t_q:
        raise ValueError(f"{what}: g {tuple(g.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} do "
                         f"not match q {tuple(q.shape)}")
    return code, index


def flash_bwd_dq(q, k, v, g, lse, delta, causal: bool, sm_scale: float):
    """dQ by the CUDA kernel ``csrc/flash_bwd_dq.cu``; ``lse`` and
    ``delta`` hold one fp32 value per query row."""
    what = "flash_bwd_dq"
    code, index = _check_bwd(what, q, k, v, g, lse, delta)
    b, h, t_q, d = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _native.launch(what, index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), code, b * h, t_q, k.shape[2], d,
                   int(causal), float(sm_scale))
    BWD_DQ_LAUNCHES.count += 1
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, causal: bool, sm_scale: float):
    """``(dK, dV)`` by the CUDA kernel ``csrc/flash_bwd_dkv.cu``."""
    what = "flash_bwd_dkv"
    code, index = _check_bwd(what, q, k, v, g, lse, delta)
    b, h, t_q, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _native.launch(what, index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), code, b * h, t_q,
                   k.shape[2], d, int(causal), float(sm_scale))
    BWD_DKV_LAUNCHES.count += 1
    return dk, dv
