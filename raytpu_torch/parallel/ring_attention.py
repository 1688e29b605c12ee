"""Ring attention — sequence/context parallelism over a ring of ranks:
the port of :mod:`raytpu.parallel.ring_attention`.

The sequence is sharded over the ``sp`` mesh axis; K/V blocks rotate
around the ring by :func:`~raytpu_torch.collective.mesh_ops.ppermute`
(one hop a step) while each rank accumulates its queries' attention with
the blockwise-stable softmax of flash attention (running max and
denominator). What stands in for ``shard_map`` is
:func:`~raytpu_torch.collective.mesh_ops.group_call`: every rank of the
mesh runs :func:`ring_attention` on its shard, one process a rank. The
block update is plain fp32 torch in the JAX op order (the JAX one is
``jnp`` outside any Pallas kernel): the ``-1e30`` mask and the diagonal
block first.

Differentiable end to end (``ppermute``'s transpose is the inverse
permutation), so the same code path serves training.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from raytpu_torch.collective import mesh_ops
from raytpu_torch.parallel.mesh import Mesh, PartitionSpec as P

F32 = torch.float32
_MASKED = -1e30


def _block_attn_update(q, k, v, m, l, o, mask, sm_scale):
    """One flash-attention accumulation step against a K/V block.

    q: [B,H,Tq,D]; k,v: [B,H,Tk,D]; m,l: [B,H,Tq,1]; o: [B,H,Tq,D].
    """
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if mask is not None:
        s = torch.where(mask, s, _MASKED)
    m_block = torch.amax(s, dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_block)
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1, keepdim=True)
    o_new = o * corr + torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32))
    return m_new, l_new, o_new


def _ring_attention_local(q, k, v, axis_name: str, causal: bool,
                          sm_scale: float):
    """Per-rank body. q,k,v: [B,H,T_local,D]."""
    n = mesh_ops.axis_size(axis_name)
    my = mesh_ops.axis_index(axis_name)
    tq = q.shape[2]
    dev = q.device

    q32 = q.to(F32)
    m = torch.full(q.shape[:3] + (1,), _MASKED, dtype=F32, device=dev)
    l = torch.zeros(q.shape[:3] + (1,), dtype=F32, device=dev)
    o = torch.zeros(q.shape[:3] + (q.shape[3],), dtype=F32, device=dev)

    qpos = my * tq + torch.arange(tq, device=dev)[:, None]
    perm = [(i, (i + 1) % n) for i in range(n)]
    kt, vt = k, v
    for t in range(n):
        # After t forward rotations, this rank holds the chunk that
        # originated at ring position (my - t) mod n.
        src = (my - t) % n
        mask = None
        if causal:
            kpos = src * tq + torch.arange(tq, device=dev)[None, :]
            mask = (kpos <= qpos)[None, None]  # [1, 1, Tq, Tk]
        m, l, o = _block_attn_update(q32, kt.to(F32), vt.to(F32), m, l, o,
                                     mask, sm_scale)
        if t + 1 < n:  # the last hop's blocks would go unread
            kt = mesh_ops.ppermute(kt, axis_name, perm)
            vt = mesh_ops.ppermute(vt, axis_name, perm)
    return (o / torch.clamp(l, min=1e-30)).to(q.dtype)


def ring_attention(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Per-shard ring attention; call inside ``group_call`` with the
    sequence dim sharded on `axis_name`. Shapes [B, H, T_local, D]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _ring_attention_local(q, k, v, axis_name, causal, sm_scale)


def ring_attention_sharded(q, k, v, mesh: Mesh, *, axis_name: str = "sp",
                           causal: bool = True,
                           sm_scale: Optional[float] = None):
    """Entry for global [B, H, T, D] tensors, the same on every rank: the
    T dim is sharded over `axis_name` and the result assembled."""
    spec = P(None, None, axis_name, None)
    fn = functools.partial(ring_attention, axis_name=axis_name,
                           causal=causal, sm_scale=sm_scale)
    return mesh_ops.group_call(mesh, fn, q, k, v,
                               in_specs=(spec, spec, spec), out_specs=spec)


def reference_attention(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """Unsharded reference for tests. [B, H, T, D]."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(F32), k.to(F32)) * sm_scale
    if causal:
        t = q.shape[2]
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(F32)).to(q.dtype)
