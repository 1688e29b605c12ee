"""Paged attention over the inference KV page pool, the port of
:mod:`raytpu.ops.paged_attention`.

Layouts are the JAX package's: ``q`` ``[B, T, H, D]`` (decode: T=1;
chunked prefill: B=1); pools ``[num_pages, page_size, KV, D]``;
``block_tables`` ``[B, P]`` page ids (dead columns may name any valid
page, page 0 by convention); ``positions`` ``[B, T]`` absolute
positions. A token at position p attends slots 0..p. The kernel reads
only ``positions[:, 0]``: a query's tokens are consecutive, as every
caller builds them. Rows that are padding give garbage the caller drops.

On a CUDA tensor :func:`paged_attention` launches the hand-written
kernel ``csrc/paged_attention.cu`` (the counterpart of the TPU kernel
``raytpu/ops/paged_attention.py::_paged_kernel``) or raises; on a CPU
tensor it runs :func:`paged_attention_reference`, the plain PyTorch
version. ``force="reference"`` picks the plain version on either device,
on purpose; nothing falls back to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from raytpu_torch.ops import _native

NEG_INF = -1e30
LAUNCHES = _native.LaunchCounter()


def gather_kv_pages(pages: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Materialise ``[B, P*page_size, KV, D]`` from the page pool: the
    plain version's gather, which the kernel never makes."""
    b = block_tables.shape[0]
    _, _, kv, d = pages.shape
    return pages[block_tables.long()].reshape(b, -1, kv, d)


def paged_attention_reference(q, k_pages, v_pages, block_tables, positions,
                              *, sm_scale: float) -> torch.Tensor:
    """Dense fp32 attention over the gathered pages, in the op order of
    the JAX reference (``paged_attention_reference``): gather, repeat
    kv heads, fp32 einsum, ``where`` mask, softmax, fp32 einsum."""
    h = q.shape[2]
    kv = k_pages.shape[2]
    ks = gather_kv_pages(k_pages, block_tables)
    vs = gather_kv_pages(v_pages, block_tables)
    if kv != h:
        rep = h // kv
        ks = ks.repeat_interleave(rep, dim=2)
        vs = vs.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,blhd->bhtl", q.float(), ks.float()) * sm_scale
    # Slot l holds token l of the sequence; a query token at absolute
    # position p sees slots 0..p.
    slots = torch.arange(ks.shape[1], device=q.device)
    visible = slots[None, None, :] <= positions[:, :, None]
    s = torch.where(visible[:, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtl,blhd->bthd", p, vs.float())
    return o.to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, positions, *,
                    sm_scale: Optional[float] = None,
                    force: Optional[str] = None) -> torch.Tensor:
    """Attention of ``q`` against the paged KV cache; ``[B, T, H, D]``
    in q's dtype.

    ``force``: ``None`` (the kernel on a CUDA tensor, the plain version
    on a CPU tensor) or ``"reference"`` (the plain version).
    """
    b, t, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != d or h % k_pages.shape[2] \
            or block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(positions.shape) != (b, t):
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, positions "
            f"{tuple(positions.shape)} do not fit [B,T,H,D], "
            f"[N,page_size,KV,D] (H a multiple of KV), [B,P], [B,T]")
    if sm_scale is None:
        sm_scale = d ** -0.5
    if force == "reference" or (force is None and q.device.type == "cpu"):
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         positions, sm_scale=sm_scale)
    if force is not None:
        raise ValueError(f"paged_attention: force={force!r}; use None or "
                         f"'reference'")
    return _paged_cuda(q, k_pages, v_pages, block_tables, positions,
                       sm_scale)


def _paged_cuda(q, k_pages, v_pages, block_tables, positions, sm_scale):
    what = "paged_attention"
    code = _native.dtype_code(what, q.dtype)
    _native.check_inputs(what, q.device, q.dtype, q, k_pages, v_pages)
    _native.check_inputs(what, q.device, torch.int32, block_tables,
                         positions)
    b, t, h, d = q.shape
    num_pages, page_size, kv, _ = k_pages.shape
    if d not in _native.HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {_native.HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _native.load(what)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            code, b, t, h, kv, d, num_pages, page_size,
            block_tables.shape[1], float(sm_scale), stream)
    _native.check_launch(lib, rc, what)
    LAUNCHES.count += 1
    return out
