"""Llama decoder, the port of :mod:`raytpu.models.llama`.

RMSNorm, rotary embeddings, grouped-query attention and SwiGLU, with the
parameter names of the JAX tree (``embed_tokens``, ``layers.{i}.attn.
q_proj`` ...) so :mod:`raytpu_torch.models.convert` maps one onto the
other. Every norm is :func:`raytpu_torch.ops.rmsnorm` (the CUDA kernel on
the card). Parameters are stored in ``param_dtype`` and cast to the
compute dtype ``config.dtype`` at use: fp32 for training, as with Flax's
default, and bf16 (the compute dtype) for serving by default.

Training, as in the JAX package:

- ``Llama(config)(tokens)`` — the training forward, fp32 logits from the
  untied head, each block under ``config.remat`` (``"dots"`` by default;
  :mod:`raytpu_torch.models.common`);
- :func:`llama_loss_fn` and :func:`make_train_step`, as GPT-2's.

The three inference forwards the engine runs are plain functions over a
:class:`Llama`:

- :func:`llama_prefill` — a whole prompt, attention by
  :func:`raytpu_torch.ops.flash_attention`;
- :func:`llama_prefill_chunk` — one chunk of a prompt against the paged
  cache, attention by :func:`raytpu_torch.ops.paged_attention`;
- :func:`llama_decode` — one token per sequence against the paged cache.

Where the JAX code returns updated page pools (``.at[dests].set``), the
port writes the new K/V into the pools in place
(:func:`raytpu_torch.models.common.write_kv`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from raytpu_torch import resolve_device
from raytpu_torch.models.common import (lecun_normal_, make_step,
                                        remat_call, remat_mode, write_kv)
from raytpu_torch.models.gpt2 import _chunked_xent, mean_nll
from raytpu_torch.ops.flash_attention import flash_attention
from raytpu_torch.ops.fused import rmsnorm
from raytpu_torch.ops.paged_attention import paged_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    block_size: int = 2048
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: int = 4               # grouped-query attention
    n_embd: int = 768
    n_inter: int = 2048              # SwiGLU hidden
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # Rematerialization per block in training: False/"none" | True/"full"
    # | "dots" (raytpu_torch.models.common).
    remat: Any = "dots"
    # Kernel choice of attention, paged attention and RMSNorm: None runs
    # the CUDA kernel on a CUDA tensor and the plain version on a CPU
    # tensor; "reference" runs the plain version on either (to compare the
    # two on the card).
    attn_impl: Optional[str] = None
    paged_attn: Optional[str] = None
    norm_impl: Optional[str] = None
    # Cross-entropy chunking: 0 = one [B, T, V] fp32 logits buffer; N > 0 =
    # the head N rows at a time, recomputed in the backward pass.
    loss_chunk: int = 0

    def __post_init__(self):
        remat_mode(self.remat)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=512, block_size=128, n_layer=2, n_head=4,
                   n_kv_head=2, n_embd=128, n_inter=352)

    @classmethod
    def small(cls) -> "LlamaConfig":  # ~125M, GPT-2-small class
        return cls()

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls(vocab_size=32000, block_size=4096, n_layer=32,
                   n_head=32, n_kv_head=32, n_embd=4096, n_inter=11008)

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_params_approx(self) -> int:
        c = self
        attn = c.n_embd * (c.n_head + 2 * c.n_kv_head) * c.head_dim \
            + c.n_head * c.head_dim * c.n_embd
        mlp = 3 * c.n_embd * c.n_inter
        return 2 * c.vocab_size * c.n_embd + c.n_layer * (attn + mlp)


class RMSNorm(nn.Module):
    """Flax's ``RMSNorm(dtype=...)`` by :func:`raytpu_torch.ops.rmsnorm`:
    fp32 math, the scale applied before the cast. The kernel writes x's
    dtype, which is the compute dtype wherever a Llama calls it."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-5,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=param_dtype))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x, force: Optional[str] = None):
        if x.dtype != self.dtype:
            raise TypeError(f"RMSNorm: x is {x.dtype}, the compute dtype is "
                            f"{self.dtype}")
        return rmsnorm(x, self.scale, eps=self.eps, force=force)


class Linear(nn.Module):
    """Flax ``nn.Dense(use_bias=False, dtype=...)``: ``weight`` ``[out,
    in]`` in the parameter dtype, cast to the compute dtype at use (a
    no-op where the two are equal)."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in,
                                               dtype=param_dtype))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x, self.weight.to(self.dtype))


def rope_tables(head_dim: int, positions: torch.Tensor, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables for rotary embeddings, fp32, [T, head_dim/2]."""
    freqs = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim))
    angles = positions.float()[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Rotate split halves (not interleaved pairs); x is [B, H, T, D]."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[None, None].to(x.dtype)
    sin = sin[None, None].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope_single(x, cos, sin):
    """Rotate one token per sequence; x is [B, H, D], cos/sin [B, D/2]."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[:, None].to(x.dtype)
    sin = sin[:, None].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(nn.Module):
    """GQA attention with the three inference entry points."""

    def __init__(self, c: LlamaConfig, param_dtype: torch.dtype):
        super().__init__()
        self.n_head, self.n_kv_head = c.n_head, c.n_kv_head
        self.head_dim, self.rope_theta = c.head_dim, c.rope_theta
        d = c.head_dim
        self.q_proj = Linear(c.n_embd, c.n_head * d, c.dtype, param_dtype)
        self.k_proj = Linear(c.n_embd, c.n_kv_head * d, c.dtype, param_dtype)
        self.v_proj = Linear(c.n_embd, c.n_kv_head * d, c.dtype, param_dtype)
        self.o_proj = Linear(c.n_head * d, c.n_embd, c.dtype, param_dtype)

    def prefill(self, x, attn_impl: Optional[str] = None):
        """Full-sequence causal attention over ``x`` [B, T, E]; returns
        ``(out [B, T, E], k [B, T, KV, D], v [B, T, KV, D])``, k roped
        and before the GQA repeat: what belongs in the paged cache."""
        b, t, _ = x.shape
        h, kv, d = self.n_head, self.n_kv_head, self.head_dim
        q = self.q_proj(x).view(b, t, h, d).transpose(1, 2)
        k = self.k_proj(x).view(b, t, kv, d).transpose(1, 2)
        v = self.v_proj(x).view(b, t, kv, d).transpose(1, 2)
        cos, sin = rope_tables(d, torch.arange(t, device=x.device),
                               self.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_cache, v_cache = k.transpose(1, 2), v.transpose(1, 2)
        if kv != h:
            # GQA: query head i reads kv head i // rep (jnp.repeat order).
            rep = h // kv
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        y, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, force=attn_impl)
        y = y.transpose(1, 2).reshape(b, t, h * d)
        return self.o_proj(y), k_cache, v_cache

    def prefill_chunk(self, x, k_pages, v_pages, dests, block_tables,
                      positions, paged_attn: Optional[str] = None):
        """Attention of one prompt CHUNK ``x`` [1, T, E] at absolute
        ``positions`` [T] (int32) against the paged cache. The chunk's
        K/V go to ``dests`` [T] first, so the chunk attends to itself;
        then each token sees every cached slot <= its position through
        ``block_tables`` [1, P]. Returns ``out [1, T, E]``."""
        b, t, _ = x.shape
        h, kv, d = self.n_head, self.n_kv_head, self.head_dim
        q = self.q_proj(x).view(b, t, h, d).transpose(1, 2)
        k = self.k_proj(x).view(b, t, kv, d).transpose(1, 2)
        v = self.v_proj(x).view(b, t, kv, d)
        cos, sin = rope_tables(d, positions, self.rope_theta)
        q = apply_rope(q, cos, sin).transpose(1, 2)
        k = apply_rope(k, cos, sin).transpose(1, 2)
        write_kv(k_pages, dests, k[0])
        write_kv(v_pages, dests, v[0])
        o = paged_attention(q.contiguous(), k_pages, v_pages, block_tables,
                            positions[None, :], force=paged_attn)
        return self.o_proj(o.reshape(b, t, h * d))

    def decode_step(self, x, k_pages, v_pages, dests, block_tables,
                    positions, context_lens, paged_attn: Optional[str] = None):
        """One token per sequence: ``x`` [B, E] at ``positions`` [B];
        its K/V go to ``dests`` [B], then it attends to slots
        0..context_lens-1 (int32) through ``block_tables`` [B, P].
        Returns ``out [B, E]``."""
        b, _ = x.shape
        h, kv, d = self.n_head, self.n_kv_head, self.head_dim
        q = self.q_proj(x).view(b, h, d)
        k = self.k_proj(x).view(b, kv, d)
        v = self.v_proj(x).view(b, kv, d)
        cos, sin = rope_tables(d, positions, self.rope_theta)
        q = apply_rope_single(q, cos, sin)
        k = apply_rope_single(k, cos, sin)
        write_kv(k_pages, dests, k)
        write_kv(v_pages, dests, v)
        o = paged_attention(q[:, None].contiguous(), k_pages, v_pages,
                            block_tables, (context_lens - 1)[:, None],
                            force=paged_attn)
        return self.o_proj(o[:, 0].reshape(b, h * d))


class LlamaMLP(nn.Module):
    def __init__(self, c: LlamaConfig, param_dtype: torch.dtype):
        super().__init__()
        self.gate_proj = Linear(c.n_embd, c.n_inter, c.dtype, param_dtype)
        self.up_proj = Linear(c.n_embd, c.n_inter, c.dtype, param_dtype)
        self.down_proj = Linear(c.n_inter, c.n_embd, c.dtype, param_dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig, param_dtype: torch.dtype,
                 scale_dtype: torch.dtype):
        super().__init__()
        self.input_norm = RMSNorm(c.n_embd, c.dtype, param_dtype=scale_dtype)
        self.attn = LlamaAttention(c, param_dtype)
        self.post_attn_norm = RMSNorm(c.n_embd, c.dtype,
                                      param_dtype=scale_dtype)
        self.mlp = LlamaMLP(c, param_dtype)

    def forward(self, x, attn_impl: Optional[str] = None,
                norm_impl: Optional[str] = None):
        """The training block (JAX's ``LlamaBlock.__call__``)."""
        x = x + self.attn.prefill(self.input_norm(x, norm_impl),
                                  attn_impl)[0]
        return x + self.mlp(self.post_attn_norm(x, norm_impl))


class Llama(nn.Module):
    """A Llama decoder with its weights made on ``device`` (``cuda``
    unless the caller passes ``"cpu"``) from ``seed``, by the JAX
    package's init scheme: projections and the head lecun-normal
    (truncated at two standard deviations), the embedding normal with
    std ``n_embd**-0.5``, norm scales 1.

    ``param_dtype``: the parameters' dtype. ``None`` keeps projections,
    head and embedding in ``config.dtype`` and the norm scales in fp32,
    the serving layout; training passes ``torch.float32``, Flax's
    default."""

    # Built as ``block_class(config, param_dtype, scale_dtype)`` per layer.
    block_class = LlamaBlock

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        wdt = param_dtype or c.dtype
        sdt = param_dtype or torch.float32
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(c.vocab_size, c.n_embd,
                                             dtype=wdt)
            self.layers = nn.ModuleList(self.block_class(c, wdt, sdt)
                                        for _ in range(c.n_layer))
            self.final_norm = RMSNorm(c.n_embd, c.dtype, param_dtype=sdt)
            self.lm_head = Linear(c.n_embd, c.vocab_size, c.dtype, wdt)
        self.to_empty(device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                self.init_param(name, p, g)

    def init_param(self, name: str, p: torch.Tensor,
                   g: torch.Generator) -> None:
        """Draw the parameter ``name`` from ``g`` in place."""
        if name.endswith(".scale"):
            p.fill_(1.0)
        elif name.startswith("embed_tokens."):
            p.normal_(0.0, self.config.n_embd ** -0.5, generator=g)
        else:
            lecun_normal_(p, g)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def embed(self, tokens):
        """The embedding rows of ``tokens`` in the compute dtype."""
        return F.embedding(tokens, self.embed_tokens.weight).to(
            self.config.dtype)

    def forward(self, tokens, return_hidden: bool = False):
        """``tokens`` [B, T] -> fp32 logits [B, T, V] (or, with
        ``return_hidden``, the final norm's output [B, T, E]); each block
        under ``config.remat``."""
        c = self.config
        x = self.embed(tokens)
        for layer in self.layers:
            x = remat_call(layer, c.remat, x, c.attn_impl, c.norm_impl)
        x = self.final_norm(x, c.norm_impl)
        if return_hidden:
            return x
        return lm_logits(self, x)


def lm_logits(model: Llama, x):
    """Untied LM head: a product in the compute dtype, then fp32 (Flax's
    ``nn.Dense(dtype=bf16)`` then ``.astype(f32)``)."""
    return model.lm_head(x).float()


def llama_loss_fn(model: Llama, tokens):
    """Mean next-token cross-entropy in fp32; with ``loss_chunk > 0`` the
    head runs a chunk of rows at a time on the ``lm_head`` weight, with
    fp32 logits, as the JAX package's GPT-2 ``_chunked_xent``."""
    c = model.config
    targets = tokens[:, 1:]
    if c.loss_chunk:
        x = model(tokens, return_hidden=True)
        return _chunked_xent(x[:, :-1], targets, model.lm_head.weight, c)
    return mean_nll(model(tokens)[:, :-1], targets)


def make_train_step(model: Llama, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``train_step(tokens) -> loss``: loss and gradients of ``loss_fn``
    (:func:`llama_loss_fn` by default), then one optimizer step, updating
    the model's parameters in place."""
    return make_step(model, optimizer, loss_fn or llama_loss_fn)


def llama_prefill(model: Llama, tokens):
    """Prefill forward: ``tokens`` [B, T] -> (fp32 logits [B, T, V],
    per-layer roped K [B, T, KV, D] list, per-layer V list)."""
    c = model.config
    x = model.embed(tokens)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in model.layers:
        y, k, v = layer.attn.prefill(layer.input_norm(x, c.norm_impl),
                                     c.attn_impl)
        ks.append(k)
        vs.append(v)
        x = x + y
        x = x + layer.mlp(layer.post_attn_norm(x, c.norm_impl))
    return lm_logits(model, model.final_norm(x, c.norm_impl)), ks, vs


def llama_prefill_chunk(model: Llama, tokens, positions, dests, block_tables,
                        k_caches, v_caches):
    """Chunked-prefill forward: ``tokens`` [1, T] at absolute
    ``positions`` [T] -> fp32 logits [1, T, V]; the chunk's K/V are
    written into ``k_caches`` / ``v_caches`` (one pool per layer) in
    place. See :meth:`LlamaAttention.prefill_chunk`."""
    c = model.config
    x = model.embed(tokens)
    for layer, kc, vc in zip(model.layers, k_caches, v_caches):
        x = x + layer.attn.prefill_chunk(
            layer.input_norm(x, c.norm_impl), kc, vc, dests, block_tables,
            positions, c.paged_attn)
        x = x + layer.mlp(layer.post_attn_norm(x, c.norm_impl))
    return lm_logits(model, model.final_norm(x, c.norm_impl))


def llama_decode(model: Llama, tokens, positions, dests, block_tables,
                 context_lens, k_caches, v_caches):
    """Single-token decode forward: ``tokens`` [B] -> fp32 logits
    [B, V]; each token's K/V are written into the pools in place. See
    :meth:`LlamaAttention.decode_step`."""
    c = model.config
    x = model.embed(tokens)
    for layer, kc, vc in zip(model.layers, k_caches, v_caches):
        x = x + layer.attn.decode_step(
            layer.input_norm(x, c.norm_impl), kc, vc, dests, block_tables,
            positions, context_lens, c.paged_attn)
        x = x + layer.mlp(layer.post_attn_norm(x, c.norm_impl))
    return lm_logits(model, model.final_norm(x, c.norm_impl))
