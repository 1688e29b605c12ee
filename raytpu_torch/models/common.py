"""What the port's models share: the JAX package's init of a projection,
rematerialisation of a block, the train step, and the write of new K/V
into the paged cache.

Remat follows the JAX package's ``remat`` option:

- ``False``/``"none"``: autograd saves every activation;
- ``True``/``"full"``: the block saves its input only and runs again in
  the backward pass (:func:`torch.utils.checkpoint.checkpoint`);
- ``"dots"``: as ``"full"``, but the outputs of the matrix products are
  saved and only the rest runs again, the counterpart of
  ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``. ``F.linear``
  reaches ``aten.mm`` (``aten.addmm`` with a bias) below autograd, where
  the selective-checkpoint policy :func:`dots_policy` sees it; batched
  products (``aten.bmm``) run again, as JAX's policy leaves them. The CUDA
  kernels and the autograd Functions around them are not products, so
  attention and RMSNorm run again too, as they do under JAX's policy.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# Standard deviation of a standard normal truncated to (-2, 2): JAX's
# lecun_normal divides by it so the truncated draw keeps variance 1/fan_in.
TRUNC_STD = 0.87962566103423978


def lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """Fill a weight ``[out, in]`` (or a convolution's ``[out, in, kh,
    kw]``) in place as JAX's ``lecun_normal``: normal with std
    ``fan_in**-0.5 / TRUNC_STD``, truncated at two of its standard
    deviations; ``fan_in`` is ``in`` (``in * kh * kw``)."""
    std = p[0].numel() ** -0.5 / TRUNC_STD
    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


def remat_mode(remat: Any) -> str:
    """``"none"``, ``"full"`` or ``"dots"`` for a config's ``remat``."""
    if remat is False or remat == "none":
        return "none"
    if remat is True or remat == "full":
        return "full"
    if remat == "dots":
        return "dots"
    raise ValueError(f"remat={remat!r}: use False/'none', True/'full' or "
                     f"'dots'")


# The products whose outputs "dots" saves: 2-D matrix products, no batch
# dimension (F.linear on [..., in] flattens to one of these).
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of :data:`SAVED_PRODUCTS`, recompute the rest."""
    if op in SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn: Callable, remat: Any, *args):
    """``fn(*args)`` under the remat mode ``remat``."""
    mode = remat_mode(remat)
    if mode == "none":
        return fn(*args)
    if mode == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, dots_policy))


def make_step(model: nn.Module, optimizer: torch.optim.Optimizer,
              loss_fn: Callable) -> Callable[[torch.Tensor], torch.Tensor]:
    """``train_step(tokens) -> loss``: ``loss_fn(model, tokens)`` and its
    gradients, then one optimizer step, updating the model's parameters
    in place. The returned loss is detached and stays on the device
    (reading it waits for the step)."""

    def train_step(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def write_kv(pages: torch.Tensor, dests: torch.Tensor,
             x: torch.Tensor) -> None:
    """Write ``x`` [N, KV, D] into the flat slots ``dests`` [N] (int64)
    of ``pages`` [num_pages, page_size, KV, D], IN PLACE: the JAX code's
    functional ``pages.at[dests].set(x)`` becomes ``index_copy_``.
    Padding rows all name slots of scratch page 0."""
    pages.view(-1, *pages.shape[2:]).index_copy_(0, dests, x.to(pages.dtype))
