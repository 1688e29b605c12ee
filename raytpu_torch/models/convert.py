"""Carry weights across from the JAX package's Llama parameter tree.

:func:`llama_state_from_jax` takes the tree that
``raytpu.models.llama.init_params`` (or a checkpoint) gives, with its
leaves already turned into numpy arrays, and returns a ``state_dict`` for
:class:`raytpu_torch.models.llama.Llama`. It reads both layouts of the
layer parameters: scanned (``"layers"``, every leaf with a leading layer
axis; the default ``scan_layers=True``) and unrolled (``"layers_{i}"``).
Flax ``Dense`` kernels are ``[in, out]`` and become ``nn.Linear`` weights
``[out, in]``; the embedding and the norm scales carry over as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_LINEARS = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
            "mlp": ("gate_proj", "up_proj", "down_proj")}
_NORMS = ("input_norm", "post_attn_norm")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


def _index(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _layer(params: Mapping, i: int) -> Mapping:
    """Layer ``i``'s parameters from either layout (the JAX package's
    ``layer_params``)."""
    if "layers" in params:
        return _index(params["layers"], i)
    return params[f"layers_{i}"]


def llama_state_from_jax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``Llama(config)`` from a numpy Flax tree."""
    state = {
        "embed_tokens.weight": _tensor(params["embed_tokens"]["embedding"]),
        "final_norm.scale": _tensor(params["final_norm"]["scale"]),
        "lm_head.weight": _tensor(params["lm_head"]["kernel"]).T.contiguous(),
    }
    for i in range(config.n_layer):
        lp = _layer(params, i)
        for norm in _NORMS:
            state[f"layers.{i}.{norm}.scale"] = _tensor(lp[norm]["scale"])
        for group, names in _LINEARS.items():
            for name in names:
                kernel = _tensor(lp[group][name]["kernel"])
                state[f"layers.{i}.{group}.{name}.weight"] = \
                    kernel.T.contiguous()
    return state
