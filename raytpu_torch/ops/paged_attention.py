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

In bf16 the kernel takes one of two paths by the rows of one (sequence,
kv head), ``T * H / KV``. Up to :data:`DECODE_ROWS` (decode) it splits
each sequence's walk over the table into :func:`plan_splits`' splits,
chosen from shapes the host knows (never from the contexts, so no
device read), and combines their partial softmax states in a second
kernel: one wrapper call, two CUDA launches when there is more than one
split; :func:`paged_decode_split_reference` is that walk and combine in
plain PyTorch. Longer chunks run on the tensor cores. Both round P to
bf16 before P V, as the TPU kernel does (``p.astype(q.dtype)``);
``paged_attention_reference(..., round_operands=True,
block_k=page_size)`` is the mirror of the TPU kernel's walk.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raytpu_torch.ops import _native
from raytpu_torch.ops.flash_attention import blockwise_attention

NEG_INF = -1e30
LAUNCHES = _native.LaunchCounter()
# bf16 rows of one (sequence, kv head), T * H / KV, up to which the kernel
# takes its split decode path (the rest: the tensor-core chunk path); the
# kernel's kDecRows.
DECODE_ROWS = 16
# The split planner's aims: about this many decode blocks per SM in all,
# and no split shorter than this many slots (a split costs a block's set-up
# and a partial's write and read).
SPLIT_BLOCKS_PER_SM = 8
SPLIT_MIN_SLOTS = 256


def gather_kv_pages(pages: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Materialise ``[B, P*page_size, KV, D]`` from the page pool: the
    plain version's gather, which the kernel never makes."""
    b = block_tables.shape[0]
    _, _, kv, d = pages.shape
    return pages[block_tables.long()].reshape(b, -1, kv, d)


def _heads_first(q, k_pages, v_pages, block_tables):
    """``q`` ``[B, H, T, D]`` and the gathered K, V ``[B, H, L, D]`` (kv
    heads repeated to the query heads), all fp32."""
    h = q.shape[2]
    kv = k_pages.shape[2]
    ks = gather_kv_pages(k_pages, block_tables)
    vs = gather_kv_pages(v_pages, block_tables)
    if kv != h:
        ks = ks.repeat_interleave(h // kv, dim=2)
        vs = vs.repeat_interleave(h // kv, dim=2)
    return (x.float().transpose(1, 2) for x in (q, ks, vs))


def _visible(positions, n_slots: int) -> torch.Tensor:
    """``[B, 1, T, L]``: slot l holds token l of the sequence; a query
    token at absolute position p sees slots 0..p."""
    slots = torch.arange(n_slots, device=positions.device)
    return (slots[None, None, :] <= positions[:, :, None])[:, None]


def paged_attention_reference(q, k_pages, v_pages, block_tables, positions,
                              *, sm_scale: float,
                              round_operands: bool = False,
                              block_k: Optional[int] = None) -> torch.Tensor:
    """Dense fp32 attention over the gathered pages, in the op order of
    the JAX reference (``paged_attention_reference``): gather, repeat
    kv heads, fp32 einsum, ``where`` mask, softmax, fp32 einsum.

    With ``round_operands`` or ``block_k`` it is the mirror of the TPU
    kernel instead (:func:`blockwise_attention`): the gathered slots
    walked in blocks of ``block_k`` (the TPU kernel's block is a page;
    all in one if None), and with ``round_operands`` P rounded to q's
    type before P V (``p.astype(q.dtype)``), l summed from the unrounded
    P. The rounding is a no-op for fp32 input."""
    qf, ks, vs = _heads_first(q, k_pages, v_pages, block_tables)
    visible = _visible(positions, ks.shape[2])
    if round_operands or block_k is not None:
        o, _ = blockwise_attention(qf, ks, vs, visible, sm_scale,
                                   block_k or ks.shape[2],
                                   q.dtype if round_operands else None)
        return o.transpose(1, 2).to(q.dtype)
    s = torch.einsum("bhtd,bhld->bhtl", qf, ks) * sm_scale
    s = torch.where(visible, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhtl,bhld->bthd", p, vs)
    return o.to(q.dtype)


def plan_splits(n_pg: int, page_size: int, batch: int, kv_heads: int,
                n_sm: int) -> Tuple[int, int]:
    """``(n_split, pages_per_split)`` of the decode path, from what the
    host knows without reading the device: the table width ``n_pg``,
    ``page_size``, the batch, the kv heads and the card's SM count.
    Split s takes the table's pages ``[s * pages_per_split, (s + 1) *
    pages_per_split)``; every page lies in exactly one split and no
    split is empty. About ``SPLIT_BLOCKS_PER_SM * n_sm`` blocks in all
    (batch * kv_heads * n_split), no split under ``SPLIT_MIN_SLOTS``
    slots unless the table is; one split when batch * kv_heads fills
    the card already."""
    if n_pg <= 0:
        return 1, 1
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // max(1, batch * kv_heads))
    most = n_pg * page_size // SPLIT_MIN_SLOTS
    pages = -(-n_pg // max(1, min(want, most)))
    return -(-n_pg // pages), pages


def paged_decode_split_reference(q, k_pages, v_pages, block_tables,
                                 positions, *, sm_scale: float, n_split: int,
                                 pages_per_split: int) -> torch.Tensor:
    """The kernel's decode path, split walk and combine, in plain
    PyTorch: split s of a sequence attends the slots of its table pages
    ``[s * pages_per_split, (s + 1) * pages_per_split)`` (partial state
    m_s = rowmax S, l_s = rowsum P, acc_s = P V with P = exp(S - m_s),
    masked entries 0); a split that starts past the sequence's last
    visible slot, ``positions[:, 0] + T``, is dropped; the combine
    rescales the rest by exp(m_s - m), m their largest m_s, and returns
    sum(acc_s e^(m_s - m)) / max(sum(l_s e^(m_s - m)), 1e-30) in q's
    type."""
    t = q.shape[1]
    page_size = k_pages.shape[1]
    qf, ks, vs = _heads_first(q, k_pages, v_pages, block_tables)
    n_slots = ks.shape[2]
    visible = _visible(positions, n_slots)
    span = pages_per_split * page_size
    n_keys = torch.clamp(positions[:, 0].long() + t, max=n_slots)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        sl = slice(s * span, min((s + 1) * span, n_slots))
        sc = torch.einsum("bhtd,bhld->bhtl", qf, ks[:, :, sl]) * sm_scale
        sc = torch.where(visible[..., sl], sc, NEG_INF)
        m_s = sc.amax(-1, keepdim=True)
        p = torch.where(visible[..., sl], torch.exp(sc - m_s), 0.0)
        live = (s * span < n_keys)[:, None, None, None]
        ms.append(torch.where(live, m_s, -torch.inf))
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhtl,bhld->bhtd", p, vs[:, :, sl]))
    m = torch.stack(ms).amax(0)
    f = [torch.exp(m_s - m) for m_s in ms]  # 0 for dropped splits
    num = sum(fs * a for fs, a in zip(f, accs))
    den = sum(fs * x for fs, x in zip(f, ls))
    return (num / torch.clamp_min(den, 1e-30)).transpose(1, 2).to(q.dtype)


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
    index = q.get_device()
    _native.check_inputs(what, index, q.dtype, q, k_pages, v_pages)
    _native.check_inputs(what, index, torch.int32, block_tables, positions)
    b, t, h, d = q.shape
    num_pages, page_size, kv, _ = k_pages.shape
    n_pg = block_tables.shape[1]
    if d not in _native.HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {_native.HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_split, pages = 1, max(n_pg, 1)
    workspace = None
    rows = t * (h // kv)
    if q.dtype == torch.bfloat16 and rows <= DECODE_ROWS:
        n_split, pages = plan_splits(n_pg, page_size, b, kv,
                                     _native.sm_count(index))
        if n_split > 1:  # the splits' partials: acc[d], m, l per row
            workspace = torch.empty(b * kv * n_split * rows * (d + 2),
                                    dtype=torch.float32, device=q.device)
    _native.launch(what, index, q.data_ptr(), k_pages.data_ptr(),
                   v_pages.data_ptr(), block_tables.data_ptr(),
                   positions.data_ptr(), out.data_ptr(),
                   None if workspace is None else workspace.data_ptr(), code,
                   b, t, h, kv, d, num_pages, page_size, n_pg, n_split, pages,
                   float(sm_scale))
    LAUNCHES.count += 1
    return out
