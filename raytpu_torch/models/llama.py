"""Llama decoder for inference, the port of :mod:`raytpu.models.llama`.

RMSNorm, rotary embeddings, grouped-query attention and SwiGLU, with the
parameter names of the JAX tree (``embed_tokens``, ``layers.{i}.attn.
q_proj`` ...) so :mod:`raytpu_torch.models.convert` maps one onto the
other. The three inference forwards the engine runs are plain functions
over a :class:`Llama`, as in the JAX package:

- :func:`llama_prefill` — a whole prompt, attention by
  :func:`raytpu_torch.ops.flash_attention`;
- :func:`llama_prefill_chunk` — one chunk of a prompt against the paged
  cache, attention by :func:`raytpu_torch.ops.paged_attention`;
- :func:`llama_decode` — one token per sequence against the paged cache.

Where the JAX code returns updated page pools (``.at[dests].set``), the
port writes the new K/V into the pools in place (:func:`write_kv`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from raytpu_torch import resolve_device
from raytpu_torch.ops.flash_attention import flash_attention
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
    # Attention implementation: None runs the CUDA kernel on a CUDA
    # tensor and the plain version on a CPU tensor; "reference" runs the
    # plain version on either (to compare the two on the card).
    attn_impl: Optional[str] = None
    paged_attn: Optional[str] = None

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


class RMSNorm(nn.Module):
    """fp32 math and an fp32 scale; the result is cast after the scale."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (normed * self.scale).to(self.dtype)


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


def write_kv(pages: torch.Tensor, dests: torch.Tensor,
             x: torch.Tensor) -> None:
    """Write ``x`` [N, KV, D] into the flat slots ``dests`` [N] (int64)
    of ``pages`` [num_pages, page_size, KV, D], IN PLACE: the JAX code's
    functional ``pages.at[dests].set(x)`` becomes ``index_copy_``.
    Padding rows all name slots of scratch page 0."""
    pages.view(-1, *pages.shape[2:]).index_copy_(0, dests, x.to(pages.dtype))


class LlamaAttention(nn.Module):
    """GQA attention with the three inference entry points."""

    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.n_head, self.n_kv_head = c.n_head, c.n_kv_head
        self.head_dim, self.rope_theta = c.head_dim, c.rope_theta
        d = c.head_dim
        self.q_proj = nn.Linear(c.n_embd, c.n_head * d, bias=False,
                                dtype=c.dtype)
        self.k_proj = nn.Linear(c.n_embd, c.n_kv_head * d, bias=False,
                                dtype=c.dtype)
        self.v_proj = nn.Linear(c.n_embd, c.n_kv_head * d, bias=False,
                                dtype=c.dtype)
        self.o_proj = nn.Linear(c.n_head * d, c.n_embd, bias=False,
                                dtype=c.dtype)

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
    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(c.n_embd, c.n_inter, bias=False,
                                   dtype=c.dtype)
        self.up_proj = nn.Linear(c.n_embd, c.n_inter, bias=False,
                                 dtype=c.dtype)
        self.down_proj = nn.Linear(c.n_inter, c.n_embd, bias=False,
                                   dtype=c.dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, c: LlamaConfig):
        super().__init__()
        self.input_norm = RMSNorm(c.n_embd, c.dtype)
        self.attn = LlamaAttention(c)
        self.post_attn_norm = RMSNorm(c.n_embd, c.dtype)
        self.mlp = LlamaMLP(c)


class Llama(nn.Module):
    """The weights of a Llama decoder, made on ``device`` (``cuda``
    unless the caller passes ``"cpu"``) from ``seed``: normal with std
    fan_in**-0.5 for projections, 1 for the embedding, norm scales 1."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(c.vocab_size, c.n_embd,
                                             dtype=c.dtype)
            self.layers = nn.ModuleList(LlamaBlock(c)
                                        for _ in range(c.n_layer))
            self.final_norm = RMSNorm(c.n_embd, c.dtype)
            self.lm_head = nn.Linear(c.n_embd, c.vocab_size, bias=False,
                                     dtype=c.dtype)
        self.to_empty(device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("scale"):
                    p.fill_(1.0)
                elif name.startswith("embed_tokens"):
                    p.normal_(0.0, 1.0, generator=g)
                else:
                    p.normal_(0.0, p.shape[1] ** -0.5, generator=g)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device


def lm_logits(model: Llama, x):
    """Untied LM head in the activation dtype; fp32 logits."""
    return F.linear(x, model.lm_head.weight).float()


def llama_prefill(model: Llama, tokens):
    """Prefill forward: ``tokens`` [B, T] -> (fp32 logits [B, T, V],
    per-layer roped K [B, T, KV, D] list, per-layer V list)."""
    c = model.config
    x = model.embed_tokens(tokens)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for layer in model.layers:
        y, k, v = layer.attn.prefill(layer.input_norm(x), c.attn_impl)
        ks.append(k)
        vs.append(v)
        x = x + y
        x = x + layer.mlp(layer.post_attn_norm(x))
    return lm_logits(model, model.final_norm(x)), ks, vs


def llama_prefill_chunk(model: Llama, tokens, positions, dests, block_tables,
                        k_caches, v_caches):
    """Chunked-prefill forward: ``tokens`` [1, T] at absolute
    ``positions`` [T] -> fp32 logits [1, T, V]; the chunk's K/V are
    written into ``k_caches`` / ``v_caches`` (one pool per layer) in
    place. See :meth:`LlamaAttention.prefill_chunk`."""
    c = model.config
    x = model.embed_tokens(tokens)
    for layer, kc, vc in zip(model.layers, k_caches, v_caches):
        x = x + layer.attn.prefill_chunk(
            layer.input_norm(x), kc, vc, dests, block_tables, positions,
            c.paged_attn)
        x = x + layer.mlp(layer.post_attn_norm(x))
    return lm_logits(model, model.final_norm(x))


def llama_decode(model: Llama, tokens, positions, dests, block_tables,
                 context_lens, k_caches, v_caches):
    """Single-token decode forward: ``tokens`` [B] -> fp32 logits
    [B, V]; each token's K/V are written into the pools in place. See
    :meth:`LlamaAttention.decode_step`."""
    c = model.config
    x = model.embed_tokens(tokens)
    for layer, kc, vc in zip(model.layers, k_caches, v_caches):
        x = x + layer.attn.decode_step(
            layer.input_norm(x), kc, vc, dests, block_tables, positions,
            context_lens, c.paged_attn)
        x = x + layer.mlp(layer.post_attn_norm(x))
    return lm_logits(model, model.final_norm(x))
