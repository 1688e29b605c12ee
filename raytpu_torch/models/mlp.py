"""Small MLP classifier, the port of :mod:`raytpu.models.mlp` (the
fashion-MNIST model of the reference's torch DDP parity suite).

It takes what the JAX model takes: images ``[B, H, W, C]`` (NHWC) or
any ``[B, ...]``, flattened in that order by ``x.reshape(B, -1)``, so the
first Dense's rows line up with the JAX kernel's and
:func:`raytpu_torch.models.convert.mlp_state_from_jax` carries the
weights across as they are. Parameters are fp32, compute runs in
``dtype`` (Flax's ``Dense(dtype=...)``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from raytpu_torch import resolve_device
from raytpu_torch.models.common import (Dense, lecun_normal_, on_meta,
                                        to_empty)


class MLPClassifier(nn.Module):
    """``dense_{i}`` (ReLU after each) then ``head``, made on ``device``
    (``cuda`` unless the caller passes ``"cpu"``) from ``seed`` by the
    JAX package's init: kernels lecun-normal, biases 0. ``in_features``
    is what the JAX model infers at init: fashion-MNIST's 28 x 28 x 1 by
    default."""

    def __init__(self, hidden: Sequence[int] = (128, 128),
                 n_classes: int = 10, dtype: torch.dtype = torch.float32,
                 in_features: int = 28 * 28, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.hidden = tuple(hidden)
        with on_meta():
            n_in = in_features
            for i, h in enumerate(self.hidden):
                self.add_module(f"dense_{i}", Dense(n_in, h, dtype))
                n_in = h
            self.head = Dense(n_in, n_classes, dtype)
        to_empty(self, dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".bias"):
                    p.zero_()
                else:
                    lecun_normal_(p, g)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(len(self.hidden)):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)


def xent_loss(model: nn.Module, batch: Mapping[str, torch.Tensor]
              ) -> torch.Tensor:
    """Mean cross-entropy of ``model(batch["x"])`` against the integer
    labels ``batch["y"]``."""
    logp = F.log_softmax(model(batch["x"]), dim=-1)
    return -logp.gather(-1, batch["y"][:, None].long()).mean()
