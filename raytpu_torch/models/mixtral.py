"""Mixtral, the sparse-MoE decoder, the port of :mod:`raytpu.models.mixtral`
for training on one card.

Llama blocks (:class:`~raytpu_torch.models.llama.LlamaAttention`, whose
attention runs the flash kernels through the GQA repeat, and
:class:`~raytpu_torch.models.llama.RMSNorm`, the RMSNorm kernel) whose FFN
is :class:`MoEFFN`: top-k routed experts with a capacity, in the JAX
package's dense one-hot dispatch formulation, with no collective unless
:func:`shard_experts` spreads the experts over a mesh's ``ep`` axis.
Parameters are fp32 (Flax's default) and cast to ``config.dtype`` at use;
the names follow the JAX tree (``layers.{i}.moe.router`` ...), so
:func:`raytpu_torch.models.convert.mixtral_state_from_jax` maps one onto
the other.

- ``Mixtral(config)(tokens)`` returns ``(fp32 logits, aux)``: the
  router's load-balance loss comes back as a value, the mean over the
  layers, where the JAX model sows it. A store on the module would run
  again when remat recomputes a block in the backward pass;
- :func:`mixtral_loss_fn` — cross-entropy plus ``router_aux_coef * aux``;
- :func:`make_train_step` — the Llama step with that loss.

Under remat ``"dots"`` the policy of :mod:`raytpu_torch.models.common`
saves ``aten.mm`` outputs and runs ``aten.bmm`` again, so the MoE layer
writes its products so that the policy sees what JAX's
``dots_with_no_batch_dims_saveable`` sees: the router, dispatch and
combine products (no batch dimension) as ``torch.mm``, the three expert
products (batched over the experts) as ``torch.bmm``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from raytpu_torch.collective import mesh_ops
from raytpu_torch.models.common import remat_call
from raytpu_torch.models.gpt2 import mean_nll
from raytpu_torch.models.llama import (Linear, Llama, LlamaAttention,
                                       LlamaConfig, RMSNorm, lm_logits)
from raytpu_torch.models.llama import make_train_step as _llama_step
from raytpu_torch.parallel.mesh import PartitionSpec as P
from raytpu_torch.parallel.sharding import TRANSFORMER_RULES

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    n_expert: int = 8
    n_expert_per_tok: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    @classmethod
    def tiny(cls) -> "MixtralConfig":
        return cls(vocab_size=512, block_size=128, n_layer=2, n_head=4,
                   n_kv_head=2, n_embd=128, n_inter=256, n_expert=4,
                   n_expert_per_tok=2)

    @property
    def n_params_active(self) -> int:
        """The parameters a token is routed through: Llama's count with
        ``n_expert_per_tok`` experts in place of its one MLP, and the
        router."""
        c = self
        return c.n_params_approx + c.n_layer * (
            (c.n_expert_per_tok - 1) * 3 * c.n_embd * c.n_inter
            + c.n_embd * c.n_expert)


def expert_capacity(c: MixtralConfig, n: int) -> int:
    """Slots per expert for ``n`` tokens, in Python floats as the JAX
    package computes it."""
    return max(1, int(c.capacity_factor * n * c.n_expert_per_tok
                      / c.n_expert))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: fp32 rows, all zero where ``idx`` lies outside
    [0, n) (``F.one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def dispatch_masks(topi: torch.Tensor, topw: torch.Tensor, n_expert: int,
                   capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine), each fp32 [k*N, E, C], for the routes ``topi``
    [N, k] with weights ``topw`` [N, k], in the JAX package's slot-major
    stream: slot 0 of every token claims a place before slot 1. A route's
    place is the JAX package's ``sum(cumsum(onehot) * onehot - 1)`` over
    the experts, which is its count at its expert minus E; a negative
    place or one at or past the capacity gets no slot."""
    k, n = topi.shape[1], topi.shape[0]
    flat_idx = topi.t().reshape(k * n)
    flat_w = topw.t().reshape(k * n)
    onehot = _one_hot(flat_idx, n_expert)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    pos_in_e = pos.sum(-1).to(torch.int32)
    keep = (pos_in_e < capacity).to(F32)
    dispatch = onehot[:, :, None] * _one_hot(pos_in_e, capacity)[:, None, :] \
        * keep[:, None, None]
    return dispatch, dispatch * flat_w[:, None, None]


class MoEFFN(nn.Module):
    """Top-k routed SwiGLU experts with a capacity. Routing and dispatch in
    fp32 (the router product included), the expert products in the
    compute dtype. ``forward`` returns ``(y, aux)``, aux the Switch-style
    load-balance loss ``E * sum_e(frac_routed_e * mean_prob_e)``."""

    def __init__(self, c: MixtralConfig):
        super().__init__()
        self.config = c
        e, d, f = c.n_expert, c.n_embd, c.n_inter
        self.router = Linear(d, e, F32, F32)
        self.wi = nn.Parameter(torch.empty(e, d, f))
        self.wg = nn.Parameter(torch.empty(e, d, f))
        self.wo = nn.Parameter(torch.empty(e, f, d))
        # The mesh whose ``ep`` axis the experts are sharded over (see
        # shard_experts), else None: all experts here.
        self.mesh = None

    def _experts(self, expert_in):
        """The SwiGLU experts this module holds on their rows of the
        dispatch, [E', C, D] -> [E', C, D]."""
        dt = self.config.dtype
        h = (F.silu(torch.bmm(expert_in, self.wg.to(dt)))
             * torch.bmm(expert_in, self.wi.to(dt)))
        return torch.bmm(h, self.wo.to(dt))

    def route(self, xf) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(probs [N, E], topw [N, k], topi [N, k]) for the rows ``xf``
        [N, D], all from fp32. Ties go to the lower expert, as in
        ``jax.lax.top_k``: a stable descending sort, then its first k."""
        probs = torch.softmax(self.router(xf.to(F32)), dim=-1)
        topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = self.config.n_expert_per_tok
        topw, topi = topw[:, :k], topi[:, :k]
        return probs, topw / topw.sum(-1, keepdim=True), topi

    def forward(self, x):
        c = self.config
        dt = c.dtype
        b, t, d = x.shape
        n, k, e = b * t, c.n_expert_per_tok, c.n_expert
        xf = x.reshape(n, d)
        probs, topw, topi = self.route(xf)
        top1 = _one_hot(topi[:, 0], e)
        aux = e * torch.sum(top1.mean(0) * probs.mean(0))
        dispatch, combine = dispatch_masks(topi, topw, e,
                                           expert_capacity(c, n))
        cap = dispatch.shape[2]
        # "sec,sd->ecd" and "sec,ecd->sd" as 2-D products (saved by
        # "dots"); the expert products batched over e (run again).
        x_rep = xf.to(F32).repeat(k, 1)                      # [kN, D]
        expert_in = torch.mm(dispatch.reshape(k * n, e * cap).t(), x_rep)
        expert_in = expert_in.reshape(e, cap, d).to(dt)
        if self.mesh is None:
            expert_out = self._experts(expert_in)           # [E, C, D]
        else:
            # Each rank runs its E / ep experts on their rows of the
            # dispatch; the outputs are gathered over ep.
            expert_out = mesh_ops.group_call(
                self.mesh, self._experts, expert_in, in_specs=P("ep"),
                out_specs=P("ep"))
        y = torch.mm(combine.reshape(k * n, e * cap),
                     expert_out.to(F32).reshape(e * cap, d))  # [kN, D]
        y = y.reshape(k, n, d).sum(0)
        return y.reshape(b, t, d).to(dt), aux


class MixtralBlock(nn.Module):
    def __init__(self, c: MixtralConfig, param_dtype: torch.dtype,
                 scale_dtype: torch.dtype):
        super().__init__()
        self.input_norm = RMSNorm(c.n_embd, c.dtype, param_dtype=scale_dtype)
        self.attn = LlamaAttention(c, param_dtype)
        self.post_attn_norm = RMSNorm(c.n_embd, c.dtype,
                                      param_dtype=scale_dtype)
        self.moe = MoEFFN(c)

    def forward(self, x, attn_impl=None, norm_impl=None):
        """``(x + attention + MoE, aux)``."""
        x = x + self.attn.prefill(self.input_norm(x, norm_impl),
                                  attn_impl)[0]
        y, aux = self.moe(self.post_attn_norm(x, norm_impl))
        return x + y, aux


class Mixtral(Llama):
    """A Mixtral decoder: a :class:`~raytpu_torch.models.llama.Llama` with
    fp32 parameters whose blocks are :class:`MixtralBlock`, made on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``) from
    ``seed`` by the JAX package's init scheme: Llama's, and the router
    lecun-normal (truncated at two standard deviations), ``wi`` and
    ``wg`` normal with std ``n_embd**-0.5`` and ``wo`` with std
    ``n_inter**-0.5`` (not truncated)."""

    block_class = MixtralBlock

    def __init__(self, config: MixtralConfig, device=None, seed: int = 0):
        super().__init__(config, device, seed, param_dtype=F32)

    def init_param(self, name: str, p: torch.Tensor,
                   g: torch.Generator) -> None:
        c = self.config
        if name.endswith((".wi", ".wg")):
            p.normal_(0.0, c.n_embd ** -0.5, generator=g)
        elif name.endswith(".wo"):
            p.normal_(0.0, c.n_inter ** -0.5, generator=g)
        else:
            super().init_param(name, p, g)

    def forward(self, tokens):
        """``tokens`` [B, T] -> (fp32 logits [B, T, V], the mean of the
        layers' aux losses); each block under ``config.remat``."""
        c = self.config
        x = self.embed(tokens)
        auxes: List[torch.Tensor] = []
        for layer in self.layers:
            x, aux = remat_call(layer, c.remat, x, c.attn_impl, c.norm_impl)
            auxes.append(aux)
        aux = torch.stack(auxes).sum() / max(1, c.n_layer)
        return lm_logits(self, self.final_norm(x, c.norm_impl)), aux


EXPERT_WEIGHTS = ("wi", "wg", "wo")


def shard_experts(model: Mixtral, mesh) -> Mixtral:
    """Shard a built model's experts over the ``ep`` axis of ``mesh`` (a
    :class:`raytpu_torch.parallel.mesh.Mesh`), in place: each rank keeps
    the rows of ``wi``, ``wg`` and ``wo`` that the rule table's
    ``Shard(0)`` gives it (E / ep experts) as plain local parameters, and
    every other parameter whole. Tokens stay replicated over ``ep``, as in
    the JAX package's test: the routing and the dispatch run whole on
    every rank, each rank runs its experts, and their outputs are
    gathered over the ``ep`` group before the combine
    (:func:`raytpu_torch.collective.mesh_ops.group_call`). Every rank
    computes the same loss; its gradients are the unsharded ones, the
    experts' their rows. A collective: every rank of the mesh calls it.
    """
    others = {a: n for a, n in mesh.shape.items() if a != "ep" and n > 1}
    if others:
        raise NotImplementedError(
            f"Mixtral over the mesh axes {others}: the port shards its "
            f"experts over ep only; tensor-parallel (tp) and fsdp products "
            f"are ROADMAP.md Queue 1, item 2")
    if "ep" not in mesh.shape:
        raise ValueError(f"shard_experts: {mesh} has no ep axis")
    n, index = mesh.shape["ep"], mesh.axis_index("ep")
    for name, moe in model.named_modules():
        if not isinstance(moe, MoEFFN):
            continue
        for leaf in EXPERT_WEIGHTS:
            p = getattr(moe, leaf)
            spec = TRANSFORMER_RULES.spec_for(f"{name}.{leaf}", p.dim(), mesh)
            if spec[0] != ("ep" if n > 1 else None) or any(spec[1:]):
                raise ValueError(f"{name}.{leaf}: the rules give {spec}, "
                                 f"not the experts' rows over ep")
            rows = p.shape[0] // n
            local = p.detach()[index * rows:(index + 1) * rows].clone()
            setattr(moe, leaf, nn.Parameter(local))
        moe.mesh = mesh
    return model


def mixtral_loss_fn(model: Mixtral, tokens):
    """Mean next-token cross-entropy in fp32 plus ``router_aux_coef``
    times the router's load-balance loss."""
    logits, aux = model(tokens)
    return (mean_nll(logits[:, :-1], tokens[:, 1:])
            + model.config.router_aux_coef * aux)


def make_train_step(model: Mixtral, optimizer: torch.optim.Optimizer
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``train_step(tokens) -> loss``: the Llama step with
    :func:`mixtral_loss_fn`."""
    return _llama_step(model, optimizer, loss_fn=mixtral_loss_fn)
