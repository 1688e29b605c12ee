"""GPT-2, the port of :mod:`raytpu.models.gpt2`: training, and the three
inference forwards the engine runs.

Parameters are fp32 and compute runs in ``config.dtype`` (bf16 by
default), as with Flax's default ``param_dtype``: every layer casts its
fp32 weights at use, so gradients reach the fp32 parameters through the
casts and the optimizer updates fp32 values. Parameter names follow the
JAX tree (``wte``, ``h.{i}.attn.c_attn`` ...) so
:func:`raytpu_torch.models.convert.gpt2_state_from_jax` maps one onto the
other. Attention is :func:`raytpu_torch.ops.flash_attention`, whose
backward runs the hand-written dQ and dK/dV kernels on the card.

- :class:`GPT2` — the model; ``GPT2(config)(tokens)`` gives fp32 logits
  from the weight-tied head;
- :func:`gpt2_loss_fn` — next-token cross-entropy (``loss_chunk > 0``
  computes the head a chunk of rows at a time, each chunk recomputed in
  the backward pass);
- :func:`make_train_step` — one step of loss, backward and optimizer;
- :func:`gpt2_prefill`, :func:`gpt2_prefill_chunk` and
  :func:`gpt2_decode` — the inference forwards over a :class:`GPT2`, with
  the signatures of the Llama ones (:mod:`raytpu_torch.models.llama`):
  a whole prompt through :func:`raytpu_torch.ops.flash_attention`, a
  chunk of a prompt and one token per sequence through
  :func:`raytpu_torch.ops.paged_attention`. GPT-2 has no RoPE: ``wpe``
  is looked up at the absolute positions, and KV heads equal query
  heads.

In torch the model and the optimizer hold the state, so the train step
is ``train_step(tokens) -> loss`` where the JAX package passes
``(params, opt_state)`` through a pure function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from raytpu_torch import resolve_device
from raytpu_torch.models.common import (Dense, lecun_normal_, make_step,
                                        on_meta, remat_call, remat_mode,
                                        to_empty, write_kv)
from raytpu_torch.ops.flash_attention import flash_attention
from raytpu_torch.ops.paged_attention import paged_attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # padded to a multiple of 128
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    # Dropout rate after attention's c_proj and after the MLP, in the
    # training forward only (``GPT2.forward(..., deterministic=False,
    # generator=g)``); the loss and the inference forwards never drop.
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    # Rematerialization per block (raytpu_torch.models.common): True/"full"
    # saves nothing and recomputes the block in the backward pass;
    # "dots" saves the matmul outputs; False/"none" saves every
    # activation.
    remat: Any = True
    # Kernel choice of attention and of paged attention (serving): None
    # runs the CUDA kernels on a CUDA tensor and the plain versions on a
    # CPU tensor; "reference" runs the plain versions on either (to
    # compare the two on the card).
    attn_impl: Optional[str] = None
    paged_attn: Optional[str] = None
    # Cross-entropy chunking: 0 = one [B, T, V] fp32 logits buffer; N > 0 =
    # the head N rows at a time, recomputed in the backward pass.
    loss_chunk: int = 0

    def __post_init__(self):
        remat_mode(self.remat)
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout}: use 0 <= rate < 1")

    @classmethod
    def small(cls) -> "GPT2Config":  # 124M
        return cls()

    @classmethod
    def tiny(cls) -> "GPT2Config":
        return cls(vocab_size=512, block_size=128, n_layer=2, n_head=2,
                   n_embd=128)

    @property
    def n_params_approx(self) -> int:
        c = self
        per_block = 12 * c.n_embd * c.n_embd
        return c.vocab_size * c.n_embd + c.block_size * c.n_embd + \
            c.n_layer * per_block + 2 * c.n_embd


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=...)``: statistics in fp32 with the fast
    variance E[x^2] - E[x]^2 (clipped at 0), eps 1e-6, fp32 ``scale`` and
    ``bias``, the result cast to the compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mu) * mul + self.bias).to(self.dtype)


class CausalSelfAttention(nn.Module):
    """Multi-head attention: the training forward and the three inference
    entry points. KV heads equal query heads; no RoPE."""

    def __init__(self, c: GPT2Config):
        super().__init__()
        self.n_head = c.n_head
        self.c_attn = Dense(c.n_embd, 3 * c.n_embd, c.dtype)
        self.c_proj = Dense(c.n_embd, c.n_embd, c.dtype)

    def _qkv(self, x):
        """``x`` [..., E] -> q, k, v, each [..., H, D]."""
        e = x.shape[-1]
        return (y.unflatten(-1, (self.n_head, e // self.n_head))
                for y in self.c_attn(x).split(e, dim=-1))

    def forward(self, x, attn_impl: Optional[str] = None):
        return self.prefill(x, attn_impl)[0]

    def prefill(self, x, attn_impl: Optional[str] = None):
        """Causal attention over ``x`` [B, T, E]; returns ``(out [B, T, E],
        k [B, T, H, D], v [B, T, H, D])``, k and v as the paged cache
        holds them."""
        b, t, e = x.shape
        q, k, v = self._qkv(x)
        # [B, T, H, D] -> [B, H, T, D], contiguous for the kernels.
        y, _ = flash_attention(*(z.transpose(1, 2).contiguous()
                                 for z in (q, k, v)),
                               causal=True, force=attn_impl)
        return self.c_proj(y.transpose(1, 2).reshape(b, t, e)), k, v

    def prefill_chunk(self, x, k_pages, v_pages, dests, block_tables,
                      positions, paged_attn: Optional[str] = None):
        """Attention of one prompt CHUNK ``x`` [1, T, E] at absolute
        ``positions`` [T] (int32) against the paged cache: the chunk's K/V
        go to ``dests`` [T] first, then each token sees every cached slot
        <= its position through ``block_tables`` [1, P]. Returns
        ``out [1, T, E]``."""
        b, t, e = x.shape
        q, k, v = self._qkv(x)
        write_kv(k_pages, dests, k[0])
        write_kv(v_pages, dests, v[0])
        o = paged_attention(q.contiguous(), k_pages, v_pages, block_tables,
                            positions[None, :], force=paged_attn)
        return self.c_proj(o.reshape(b, t, e))

    def decode_step(self, x, k_pages, v_pages, dests, block_tables,
                    context_lens, paged_attn: Optional[str] = None):
        """One token per sequence: ``x`` [B, E]; its K/V go to ``dests``
        [B], then it attends to slots 0..context_lens-1 (int32) through
        ``block_tables`` [B, P]. Returns ``out [B, E]``."""
        b, e = x.shape
        q, k, v = self._qkv(x)
        write_kv(k_pages, dests, k)
        write_kv(v_pages, dests, v)
        o = paged_attention(q[:, None].contiguous(), k_pages, v_pages,
                            block_tables, (context_lens - 1)[:, None],
                            force=paged_attn)
        return self.c_proj(o[:, 0].reshape(b, e))


class MLP(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        self.c_fc = Dense(c.n_embd, 4 * c.n_embd, c.dtype)
        self.c_proj = Dense(4 * c.n_embd, c.n_embd, c.dtype)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, c: GPT2Config):
        super().__init__()
        self.ln_1 = LayerNorm(c.n_embd, c.dtype)
        self.attn = CausalSelfAttention(c)
        self.ln_2 = LayerNorm(c.n_embd, c.dtype)
        self.mlp = MLP(c)
        self.rate = c.dropout

    def forward(self, x, attn_impl: Optional[str] = None, keep=None):
        return self.run(x, lambda attn, h: attn(h, attn_impl), keep)

    def run(self, x, attend, keep=None):
        """The block (the JAX package's ``_block_apply``) with
        ``attend(attn, h)`` for its attention on the normed input ``h``:
        the training forward, a prefill, a chunk or a decode step.
        ``keep``: None, or the two dropout masks (:func:`dropout_keep`)
        of attention's output and the MLP's."""
        attn_keep, mlp_keep = keep if keep is not None else (None, None)
        x = x + dropout(attend(self.attn, self.ln_1(x)), attn_keep,
                        self.rate)
        return x + dropout(self.mlp(self.ln_2(x)), mlp_keep, self.rate)


def dropout_keep(rate: float, shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """A dropout mask drawn as Flax's ``nn.Dropout`` draws one: True
    (kept) where a uniform draw is below ``1 - rate``, the form of
    ``jax.random.bernoulli``. The draws are torch's, not JAX's."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(y: torch.Tensor, keep: Optional[torch.Tensor],
            rate: float) -> torch.Tensor:
    """Flax's ``nn.Dropout`` given its mask: ``where(keep, y / (1 -
    rate), 0)``, the survivors divided in ``y``'s dtype as JAX divides
    them; ``keep`` None is the identity."""
    if keep is None:
        return y
    return torch.where(keep, y / (1.0 - rate), y.new_zeros(()))


class _Bf16TiedHead(torch.autograd.Function):
    """``x [N, E] @ w [V, E]^T`` for bf16 ``x`` and ``w`` with fp32 logits
    (fp32 accumulation, no bf16 rounding of the product), as
    ``dot_general(..., preferred_element_type=f32)``. JAX's transpose
    multiplies the logits' fp32 gradient ``g`` by the bf16 operands in
    fp32 and rounds each result to bf16. Here ``g`` is split into two bf16
    parts, ``hi + lo``, which hold it to 2**-16 of its value, so each
    gradient is two bf16 products with fp32 output, far cheaper than one
    fp32 product, and is then rounded to bf16 as in JAX."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        hi = g.to(torch.bfloat16)
        lo = (g - hi).to(torch.bfloat16)

        def split_mm(a_hi, a_lo, b):  # (a_hi + a_lo) @ b, rounded to bf16
            return (torch.mm(a_hi, b, out_dtype=torch.float32)
                    + torch.mm(a_lo, b, out_dtype=torch.float32)
                    ).to(torch.bfloat16)

        return split_mm(hi, lo, w), split_mm(hi.t(), lo.t(), x)


def tied_logits(x, wte: torch.Tensor, dtype: torch.dtype):
    """fp32 logits ``x @ wte.to(dtype)^T`` for ``x`` ``[..., E]``. On the
    card in bf16, bf16 products with fp32 output (``torch.mm``'s
    ``out_dtype``, which has no CPU backend); elsewhere the operands
    rounded to ``dtype`` and multiplied in fp32, the same function: a
    product of two bf16 numbers is exact in fp32."""
    w = wte.to(dtype)
    if x.is_cuda and dtype == torch.bfloat16:
        return _Bf16TiedHead.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


class GPT2(nn.Module):
    """GPT-2 with its weights made on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``) from ``seed``, by the JAX package's init
    scheme: Dense kernels lecun-normal (truncated at two standard
    deviations), biases 0, embeddings normal with std ``n_embd**-0.5``,
    LayerNorm scales 1 and biases 0; all fp32."""

    def __init__(self, config: GPT2Config, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        with on_meta():
            self.wte = nn.Embedding(c.vocab_size, c.n_embd)
            self.wpe = nn.Embedding(c.block_size, c.n_embd)
            self.h = nn.ModuleList(Block(c) for _ in range(c.n_layer))
            self.ln_f = LayerNorm(c.n_embd, c.dtype)
        to_empty(self, dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".scale"):
                    p.fill_(1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                elif name.startswith(("wte.", "wpe.")):
                    p.normal_(0.0, c.n_embd ** -0.5, generator=g)
                else:
                    lecun_normal_(p, g)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def embed(self, tokens, positions):
        """``wte[tokens] + wpe[positions]``, both in the compute dtype."""
        dt = self.config.dtype
        return (F.embedding(tokens, self.wte.weight).to(dt)
                + F.embedding(positions, self.wpe.weight).to(dt))

    def forward(self, tokens, return_hidden: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``tokens`` [B, T] -> fp32 logits [B, T, V] (or, with
        ``return_hidden``, the final LayerNorm's output [B, T, E]).

        ``deterministic=False`` with ``config.dropout > 0`` drops after
        each block's attention and MLP, with masks drawn from
        ``generator`` (on the tokens' device), which must be given. Each
        layer's two masks are drawn before the layer runs and passed into
        it, so a rematerialized block runs again under the same masks.
        (The JAX package drops only with ``remat=False`` and unrolled
        layers: its ``nn.remat`` cannot take ``deterministic`` as a traced
        argument, and its layer scan splits only the ``params`` RNG, so no
        ``dropout`` RNG reaches a scanned block.)"""
        c = self.config
        drop = not deterministic and c.dropout > 0
        if drop and generator is None:
            raise ValueError("dropout needs an explicit torch.Generator")
        x = self.embed(tokens, torch.arange(tokens.shape[1],
                                            device=tokens.device))
        for block in self.h:
            keep = None
            if drop:
                keep = tuple(dropout_keep(c.dropout, x.shape, generator,
                                          x.device) for _ in range(2))
            x = remat_call(block, c.remat, x, c.attn_impl, keep)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return tied_logits(x, self.wte.weight, c.dtype)


def gpt2_loss_fn(model: GPT2, tokens):
    """Mean next-token cross-entropy in fp32: ``logsumexp(logits) -
    label logit`` over the first T-1 positions."""
    c = model.config
    targets = tokens[:, 1:]
    if c.loss_chunk:
        x = model(tokens, return_hidden=True)
        return _chunked_xent(x[:, :-1], targets, model.wte.weight, c)
    return mean_nll(model(tokens)[:, :-1], targets)


def mean_nll(logits, targets):
    """Mean of ``logsumexp(logits) - label logit`` over every position."""
    lse = torch.logsumexp(logits, dim=-1)
    label = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - label).mean()


def _chunked_xent(x, targets, wte, c):
    """Mean next-token NLL with the head ``x @ wte.T`` (``wte`` ``[V, E]``,
    GPT-2's tied embedding or Llama's ``lm_head``; fp32 logits) computed
    ``loss_chunk`` rows at a time; each chunk is checkpointed, so the
    backward pass recomputes its logits and peak memory holds one
    [chunk, V] fp32 buffer."""
    b, t, e = x.shape
    n = b * t
    chunk = min(c.loss_chunk, n)
    pad = (-n) % chunk
    xf = F.pad(x.reshape(n, e), (0, 0, 0, pad))
    tf = F.pad(targets.reshape(n), (0, pad))
    mask = (torch.arange(n + pad, device=x.device) < n).float()

    def chunk_nll(xc, tc, mc, w):
        logits = tied_logits(xc, w, c.dtype)
        lse = torch.logsumexp(logits, dim=-1)
        label = torch.gather(logits, -1, tc[:, None])[:, 0]
        return ((lse - label) * mc).sum()

    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, n + pad, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(chunk_nll, xf[sl], tf[sl], mask[sl], wte,
                                   use_reentrant=False)
    return total / n


def make_train_step(model: GPT2, optimizer: torch.optim.Optimizer
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``train_step(tokens) -> loss``: loss and gradients of
    :func:`gpt2_loss_fn`, then one optimizer step, updating the model's
    parameters in place. The returned loss is detached and stays on the
    device (reading it waits for the step)."""
    return make_step(model, optimizer, gpt2_loss_fn)


def _head(model: GPT2, x):
    c = model.config
    return tied_logits(model.ln_f(x), model.wte.weight, c.dtype)


def gpt2_prefill(model: GPT2, tokens):
    """Prefill forward: ``tokens`` [B, T] -> (fp32 logits [B, T, V],
    per-layer K [B, T, H, D] list, per-layer V list)."""
    c = model.config
    t = tokens.shape[1]
    x = model.embed(tokens, torch.arange(t, device=tokens.device)[None])
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []

    def attend(attn, h):
        y, k, v = attn.prefill(h, c.attn_impl)
        ks.append(k)
        vs.append(v)
        return y

    for block in model.h:
        x = block.run(x, attend)
    return _head(model, x), ks, vs


def gpt2_prefill_chunk(model: GPT2, tokens, positions, dests, block_tables,
                       k_caches, v_caches):
    """Chunked-prefill forward: ``tokens`` [1, T] at absolute
    ``positions`` [T] -> fp32 logits [1, T, V]; positions feed both the
    ``wpe`` lookup and the causal mask. The chunk's K/V are written into
    ``k_caches`` / ``v_caches`` (one pool per layer) in place."""
    c = model.config
    x = model.embed(tokens, positions[None])
    for block, kc, vc in zip(model.h, k_caches, v_caches):
        x = block.run(x, lambda attn, h: attn.prefill_chunk(
            h, kc, vc, dests, block_tables, positions, c.paged_attn))
    return _head(model, x)


def gpt2_decode(model: GPT2, tokens, positions, dests, block_tables,
                context_lens, k_caches, v_caches):
    """Single-token decode forward: ``tokens`` [B] at ``positions`` [B]
    (the ``wpe`` lookup) -> fp32 logits [B, V]; each token's K/V are
    written into the pools in place."""
    c = model.config
    x = model.embed(tokens, positions)
    for block, kc, vc in zip(model.h, k_caches, v_caches):
        x = block.run(x, lambda attn, h: attn.decode_step(
            h, kc, vc, dests, block_tables, context_lens, c.paged_attn))
    return _head(model, x)
