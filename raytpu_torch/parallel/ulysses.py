"""Ulysses-style sequence parallelism: all_to_all head/sequence reshard,
the port of :mod:`raytpu.parallel.ulysses`.

The alternative to ring attention for moderate context: tokens arrive
sequence-sharded over ``sp``; one tiled
:func:`~raytpu_torch.collective.mesh_ops.all_to_all` re-shards to
head-sharded with the *full* sequence local, attention runs locally, and
a second ``all_to_all`` restores sequence sharding. What stands in for
``shard_map`` is :func:`~raytpu_torch.collective.mesh_ops.group_call`,
one process a rank. ``attn_fn`` defaults to
:func:`~raytpu_torch.parallel.ring_attention.reference_attention`, as in
JAX; the port's :func:`raytpu_torch.ops.flash_attention` may be passed
(its ``(o, lse)`` gives ``o``), and then runs its kernels on CUDA
tensors, forward and backward.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

from raytpu_torch.collective import mesh_ops
from raytpu_torch.parallel.mesh import Mesh, PartitionSpec as P


def _reference(q, k, v, causal=True):
    from raytpu_torch.parallel.ring_attention import reference_attention

    return reference_attention(q, k, v, causal=causal)


def _local(q, k, v, axis_name: str, causal: bool, attn_fn):
    # [B, H, T/n, D] -> all_to_all -> [B, H/n, T, D]
    def seq_to_head(x):
        return mesh_ops.all_to_all(x, axis_name, split_axis=1, concat_axis=2)

    def head_to_seq(x):
        return mesh_ops.all_to_all(x, axis_name, split_axis=2, concat_axis=1)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    out = attn_fn(qh, kh, vh, causal=causal)
    if isinstance(out, tuple):  # the port's flash_attention: (o, lse)
        out = out[0]
    return head_to_seq(out)


def ulysses_attention(q, k, v, *, axis_name: str = "sp", causal: bool = True,
                      attn_fn: Optional[Callable] = None):
    """Call inside ``group_call``; q,k,v [B, H, T_local, D]; H must be
    divisible by the axis size."""
    return _local(q, k, v, axis_name, causal, attn_fn or _reference)


def ulysses_attention_sharded(q, k, v, mesh: Mesh, *,
                              axis_name: str = "sp", causal: bool = True,
                              attn_fn: Optional[Callable] = None):
    spec = P(None, None, axis_name, None)
    fn = functools.partial(ulysses_attention, axis_name=axis_name,
                           causal=causal, attn_fn=attn_fn)
    return mesh_ops.group_call(mesh, fn, q, k, v,
                               in_specs=(spec, spec, spec), out_specs=spec)
