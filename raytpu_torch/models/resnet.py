"""ResNet, the port of :mod:`raytpu.models.resnet` (the reference's
ResNet image-training benchmark family): basic blocks for ResNet-18,
bottleneck blocks for ResNet-50 and -101.

What the port keeps of the Flax model, and how:

- **Layout.** ``forward`` takes NHWC images, as the JAX model does;
  ``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW tensor
  in ``channels_last`` memory, with no copy, and the conv weights are
  ``channels_last`` too, so cuDNN runs its NHWC convolutions.
- **SAME padding.** XLA pads ``low = total // 2``, ``high = total -
  low`` (:func:`raytpu_torch.models.common.same_padding`): the 7x7
  stride-2 stem at 224 pads 2 and 3, the strided 3x3 convs and the max
  pool at even sizes 0 and 1. Where the two sides differ, an explicit
  ``F.pad`` (``-inf`` for the pool) precedes a conv or pool with
  ``padding=0``; where they agree, the conv pads itself.
- **BatchNorm** is Flax's, in :class:`BatchNorm`: statistics in fp32
  (``force_float32_reductions``) with the fast variance ``E[x^2] -
  E[x]^2`` clamped at 0, the running statistics updated as ``0.99 old +
  0.01 new`` with the *biased* batch variance, eps 1e-5; its state in
  buffers ``mean`` and ``var`` that ``state_dict`` carries. ``forward(x,
  train=True)`` normalises with the batch's statistics and updates the
  buffers in place, where Flax returns them under ``mutable``.
- **Head.** The spatial mean is taken in fp32 and rounded to the compute
  dtype, as ``jnp.mean`` of bf16 is; the head is an fp32 Dense.

Parameters are fp32 and compute runs in ``config.dtype`` (bf16 by
default). Module names are the port's own; the converter
(:func:`raytpu_torch.models.convert.resnet_state_from_jax`) maps Flax's
automatic ones onto them. Convolutions are ``F.conv2d``: the JAX package
runs them as XLA's, not as a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from raytpu_torch import resolve_device
from raytpu_torch.models.common import (Dense, lecun_normal_, on_meta,
                                        same_padding, to_empty)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)  # resnet-18
    num_filters: int = 64
    n_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    # Bottleneck (1x1 -> 3x3 -> 1x1 with 4x expansion) — the block the
    # 50/101/152 family is defined by; basic blocks otherwise.
    bottleneck: bool = False

    @classmethod
    def resnet18(cls, n_classes: int = 1000):
        return cls((2, 2, 2, 2), 64, n_classes)

    @classmethod
    def resnet50(cls, n_classes: int = 1000):
        return cls((3, 4, 6, 3), 64, n_classes, bottleneck=True)

    @classmethod
    def resnet101(cls, n_classes: int = 1000):
        return cls((3, 4, 23, 3), 64, n_classes, bottleneck=True)

    @classmethod
    def tiny(cls, n_classes: int = 10):
        return cls((1, 1), 16, n_classes)


def _pads(x: torch.Tensor, k: int, s: int):
    """SAME's (top, bottom), (left, right) for an NCHW ``x``."""
    return same_padding(x.shape[2], k, s), same_padding(x.shape[3], k, s)


class Conv(nn.Module):
    """Flax ``nn.Conv(features, (k, k), (s, s), use_bias=False,
    dtype=...)`` with SAME padding: an fp32 ``weight`` ``[out, in, k,
    k]``, cast with the input to the compute dtype at use."""

    def __init__(self, n_in: int, n_out: int, k: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, k, k))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x):
        (top, bottom), (left, right) = _pads(x, self.k, self.stride)
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=(top, left))


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (s, s), padding="SAME")``: padded with
    ``-inf``."""
    (top, bottom), (left, right) = _pads(x, k, s)
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        top = left = 0
    return F.max_pool2d(x, k, s, padding=(top, left))


class BatchNorm(nn.Module):
    """Flax 0.12's ``nn.BatchNorm(dtype=...)`` over the channels of an
    NCHW input (module docstring): fp32 ``scale`` and ``bias``, fp32
    buffers ``mean`` and ``var``; the result in the compute dtype."""

    momentum = 0.99
    eps = 1e-5

    def __init__(self, channels: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.empty(channels))
        self.register_buffer("var", torch.empty(channels))
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


class _Block(nn.Module):
    """What both blocks share: the projection of the input where the
    shapes differ (a strided 1x1 conv and its BN), and the residual."""

    expansion = 1

    def _projection(self, n_in: int, filters: int, strides: int,
                    dtype: torch.dtype) -> None:
        n_out = filters * self.expansion
        self.has_proj = n_in != n_out or strides != 1
        if self.has_proj:
            self.proj = Conv(n_in, n_out, 1, strides, dtype)
            self.proj_bn = BatchNorm(n_out, dtype)

    def residual(self, x, train: bool):
        if not self.has_proj:
            return x
        return self.proj_bn(self.proj(x), train)


class BasicBlock(_Block):
    """3x3 (strided) -> 3x3, with a 1x1 strided projection of the input
    where the shapes differ."""

    def __init__(self, n_in: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv_0 = Conv(n_in, filters, 3, strides, dtype)
        self.bn_0 = BatchNorm(filters, dtype)
        self.conv_1 = Conv(filters, filters, 3, 1, dtype)
        self.bn_1 = BatchNorm(filters, dtype)
        self._projection(n_in, filters, strides, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn_0(self.conv_0(x), train))
        y = self.bn_1(self.conv_1(y), train)
        return F.relu(y + self.residual(x, train))


class BottleneckBlock(_Block):
    """1x1 reduce -> 3x3 (strided) -> 1x1 expand (x4), the last BN's scale
    starting at 0 so each block starts as the identity."""

    expansion = 4

    def __init__(self, n_in: int, filters: int, strides: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv_0 = Conv(n_in, filters, 1, 1, dtype)
        self.bn_0 = BatchNorm(filters, dtype)
        self.conv_1 = Conv(filters, filters, 3, strides, dtype)
        self.bn_1 = BatchNorm(filters, dtype)
        self.conv_2 = Conv(filters, filters * 4, 1, 1, dtype)
        self.bn_2 = BatchNorm(filters * 4, dtype)
        self._projection(n_in, filters, strides, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn_0(self.conv_0(x), train))
        y = F.relu(self.bn_1(self.conv_1(y), train))
        y = self.bn_2(self.conv_2(y), train)
        return F.relu(y + self.residual(x, train))


class ResNet(nn.Module):
    """ResNet made on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``) from ``seed`` by the Flax init: conv and head kernels
    lecun-normal, the head's bias 0, BatchNorm scales 1 (0 for a
    bottleneck's last) and biases 0, running means 0 and variances 1."""

    def __init__(self, config: ResNetConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        block = BottleneckBlock if c.bottleneck else BasicBlock
        with on_meta():
            self.conv_init = Conv(3, c.num_filters, 7, 2, c.dtype)
            self.bn_init = BatchNorm(c.num_filters, c.dtype)
            self.blocks = nn.ModuleList()
            n_in = c.num_filters
            for i, block_count in enumerate(c.stage_sizes):
                for j in range(block_count):
                    filters = c.num_filters * 2 ** i
                    self.blocks.append(block(
                        n_in, filters, 2 if i > 0 and j == 0 else 1, c.dtype))
                    n_in = filters * block.expansion
            self.head = Dense(n_in, c.n_classes, torch.float32)
        to_empty(self, dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".scale"):
                    p.fill_(0.0 if c.bottleneck and name.endswith(
                        "bn_2.scale") else 1.0)
                elif name.endswith(".bias"):
                    p.zero_()
                else:
                    lecun_normal_(p, g)
            for name, b in self.named_buffers():
                b.fill_(0.0 if name.endswith(".mean") else 1.0)
        self.to(memory_format=torch.channels_last)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, x, train: bool = False):
        """Logits (fp32) of NHWC images ``x``; ``train`` normalises with
        the batch's statistics and updates the running ones."""
        c = self.config
        x = x.to(c.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x = max_pool_same(x, 3, 2)
        for blk in self.blocks:
            x = blk(x, train)
        x = x.float().mean((2, 3)).to(c.dtype)
        return self.head(x)
