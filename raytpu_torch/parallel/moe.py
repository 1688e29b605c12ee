"""Expert parallelism — dense-dispatch MoE over the ``ep`` axis: the port
of :mod:`raytpu.parallel.moe`.

Top-1 gating with capacity, einsum dispatch (dense one-hot routing:
static shapes, no scatter), a tiled
:func:`~raytpu_torch.collective.mesh_ops.all_to_all` over ``ep`` so each
rank runs only its local experts, and the transposed einsum to combine.
What stands in for ``shard_map`` is
:func:`~raytpu_torch.collective.mesh_ops.group_call`, one process a
rank. Everything is differentiable; gate gradients flow through the
combine weights. The gating and the dispatch are fp32, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from raytpu_torch.collective import mesh_ops

F32 = torch.float32


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: fp32 rows, all zero where ``idx`` lies outside
    [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default
    is exact)."""
    return F.gelu(x, approximate="tanh")


def moe_dispatch(x, gate_logits, expert_fn: Callable, *,
                 num_experts: int, capacity_factor: float = 1.25,
                 axis_name: str = "ep"):
    """Inside ``group_call``. x: [T_local, D];
    gate_logits: [T_local, E].

    expert_fn(idx_local, xs) -> ys applies this rank's expert
    `idx_local` to xs [capacity_total, D].
    """
    n_dev = mesh_ops.axis_size(axis_name)
    t_local, d = x.shape
    e = num_experts
    if e % n_dev != 0:
        raise ValueError(f"num_experts {e} not divisible by ep size {n_dev}")
    e_local = e // n_dev
    capacity = max(1, int(capacity_factor * t_local / e))

    gates = torch.softmax(gate_logits.to(F32), dim=-1)
    expert_idx = torch.argmax(gates, dim=-1)  # [T], the first maximum
    gate_val = torch.amax(gates, dim=-1)  # [T]

    # Position of each token within its expert's buffer.
    onehot = _one_hot(expert_idx, e)  # [T, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0  # [T, E], -1 elsewhere
    pos_in_expert = torch.sum(pos, dim=-1).to(torch.int32)  # [T]
    keep = (pos_in_expert < capacity).to(F32)

    # Dense dispatch tensor [T, E, C].
    pos_oh = _one_hot(pos_in_expert, capacity)
    dispatch = onehot[:, :, None] * pos_oh[:, None, :]
    dispatch = dispatch * keep[:, None, None]
    combine = dispatch * gate_val[:, None, None]

    # Route: [T,E,C] x [T,D] -> [E,C,D]
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.to(F32))
    # all_to_all over ep: rank j gets every rank's buffers for ITS local
    # experts, the sources side by side: [E, C, D] -> [e_local, n*C, D].
    expert_in = mesh_ops.all_to_all(expert_in, axis_name, split_axis=0,
                                    concat_axis=1)

    outs = []
    for le in range(e_local):
        outs.append(expert_fn(le, expert_in[le]))
    expert_out = torch.stack(outs)  # [e_local, n*C, D]

    # Reverse route: send each source's chunk back home.
    # [e_local, n*C, D] -> [E, C, D]
    expert_out = mesh_ops.all_to_all(expert_out, axis_name, split_axis=1,
                                     concat_axis=0)
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return y.to(x.dtype)


class MoELayer:
    """Functional MoE layer: params = {gate: [D,E], wi: [E,D,F], wo: [E,F,D]}.

    Use inside ``group_call`` with experts sharded over `ep` (each rank
    holds its e_local slices of wi/wo)."""

    def __init__(self, num_experts: int, capacity_factor: float = 1.25,
                 axis_name: str = "ep", activation: Callable = gelu_tanh):
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.axis_name = axis_name
        self.activation = activation

    def init(self, generator: torch.Generator, d_model: int, d_ff: int,
             e_local: int, device=None):
        """Normal draws from ``generator`` (on its device, or ``device``),
        scaled as the JAX layer's."""
        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device)

        scale = d_model ** -0.5
        return {
            "gate": normal(d_model, self.num_experts) * scale,
            "wi": normal(e_local, d_model, d_ff) * scale,
            "wo": normal(e_local, d_ff, d_model) * (d_ff ** -0.5),
        }

    def __call__(self, params, x):
        """x: [T_local, D] inside ``group_call``."""
        gate_logits = x.to(F32) @ params["gate"].to(F32)

        def expert_fn(le, xs):
            h = self.activation(xs @ params["wi"][le].to(F32))
            return h @ params["wo"][le].to(F32)

        return moe_dispatch(
            x, gate_logits, expert_fn,
            num_experts=self.num_experts,
            capacity_factor=self.capacity_factor,
            axis_name=self.axis_name,
        )
