"""What the port's models share: the JAX package's init of a projection,
Flax's ``Dense``, XLA's ``SAME`` padding, rematerialisation of a block,
the train step, and the write of new K/V into the paged cache.

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

import contextlib
import functools
from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

class _NoDefaultInit(TorchFunctionMode):
    """Skip ``torch.nn.init``'s functions (a module's default init) in
    this thread: the tensor comes back as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__module__", None) == "torch.nn.init":
            return args[0] if args else next(iter(kwargs.values()))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def on_meta():
    """Build modules on the meta device, skipping their default init:
    every model draws each parameter itself from its seed after
    :func:`to_empty`. A default init on a meta tensor runs torch's
    reference ops, whose first use imports ``torch._dynamo`` and
    ``sympy``: seconds in a fresh process, paid by every replica, trial
    and worker at its first model."""
    with torch.device("meta"), _NoDefaultInit():
        yield


def to_empty(module: nn.Module, device) -> None:
    """``module.to_empty(device=device)`` by ``torch.empty``: the
    module's ``empty_like`` of a meta tensor runs torch's reference op,
    which imports ``sympy`` at its first use (see :func:`on_meta`)."""
    module._apply(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                        device=device))


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


class Dense(nn.Module):
    """Flax ``nn.Dense(dtype=...)``: fp32 ``weight`` ``[out, in]`` and
    ``bias``, both cast with the input to the compute dtype at use."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim of size ``n`` for a
    window ``k`` at stride ``s``: the output has ceil(n / s) places, and
    the total padding splits as ``low = total // 2``, ``high = total -
    low``, so an odd total pads one more after than before (a 7x7 stride-2
    conv at 224 pads 2 and 3; a 3x3 stride-2 one at 56 pads 0 and 1)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


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
