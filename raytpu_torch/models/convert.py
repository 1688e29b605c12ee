"""Carry weights across from the JAX package's parameter trees.

:func:`llama_state_from_jax`, :func:`gpt2_state_from_jax` and
:func:`mixtral_state_from_jax` take the tree that
``raytpu.models.{llama,gpt2,mixtral}.init_params`` (or a checkpoint)
gives, with its leaves already turned into numpy arrays, and return a
``state_dict`` for the port's :class:`~raytpu_torch.models.llama.Llama`,
:class:`~raytpu_torch.models.gpt2.GPT2` or
:class:`~raytpu_torch.models.mixtral.Mixtral`. All read the two layouts
of the layer parameters: scanned (``"layers"`` / ``"h"``, every leaf with
a leading layer axis; the default ``scan_layers=True``) and unrolled
(``"layers_{i}"`` / ``"h_{i}"``). Flax ``Dense`` kernels are
``[in, out]`` and become weights ``[out, in]``; biases, embeddings, norm
parameters and Mixtral's stacked expert weights (``wi``, ``wg`` ``[E, D,
F]``, ``wo`` ``[E, F, D]``) carry over as they are. The same maps carry
gradients, which have the tree's structure.

:func:`mlp_state_from_jax` and :func:`resnet_state_from_jax` do the same
for :mod:`raytpu.models.mlp` and :mod:`raytpu.models.resnet`, whose
``init`` gives ``{"params": ...}`` (and, for the ResNet,
``"batch_stats"``). Conv kernels HWIO become weights OIHW; BatchNorm's
``scale`` and ``bias`` become its parameters, its ``mean`` and ``var``
the running buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import re

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


def _layer(params: Mapping, i: int, name: str = "layers") -> Mapping:
    """Layer ``i``'s parameters from either layout (the JAX package's
    ``layer_params``)."""
    if name in params:
        return _index(params[name], i)
    return params[f"{name}_{i}"]


def llama_state_from_jax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``Llama(config)`` from a numpy Flax tree."""
    return _decoder_state(params, config, _LINEARS)


def mixtral_state_from_jax(params: Mapping,
                           config) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``Mixtral(config)`` from a numpy Flax tree: the
    Llama layout, with each layer's ``moe`` (the router's kernel ``[D, E]``
    becomes a weight ``[E, D]``) where a Llama layer has its ``mlp``."""
    state = _decoder_state(params, config, {"attn": _LINEARS["attn"]})
    for i in range(config.n_layer):
        moe = _layer(params, i)["moe"]
        state[f"layers.{i}.moe.router.weight"] = \
            _tensor(moe["router"]["kernel"]).T.contiguous()
        for name in ("wi", "wg", "wo"):
            state[f"layers.{i}.moe.{name}"] = _tensor(moe[name])
    return state


def _decoder_state(params: Mapping, config,
                   linears: Mapping) -> Dict[str, torch.Tensor]:
    """Embedding, head, norms and the ``linears`` of every layer."""
    state = {
        "embed_tokens.weight": _tensor(params["embed_tokens"]["embedding"]),
        "final_norm.scale": _tensor(params["final_norm"]["scale"]),
        "lm_head.weight": _tensor(params["lm_head"]["kernel"]).T.contiguous(),
    }
    for i in range(config.n_layer):
        lp = _layer(params, i)
        for norm in _NORMS:
            state[f"layers.{i}.{norm}.scale"] = _tensor(lp[norm]["scale"])
        for group, names in linears.items():
            for name in names:
                kernel = _tensor(lp[group][name]["kernel"])
                state[f"layers.{i}.{group}.{name}.weight"] = \
                    kernel.T.contiguous()
    return state


_GPT2_DENSE = (("attn", "c_attn"), ("attn", "c_proj"), ("mlp", "c_fc"),
               ("mlp", "c_proj"))


def gpt2_state_from_jax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``GPT2(config)`` from a numpy Flax tree."""
    state = {
        "wte.weight": _tensor(params["wte"]["embedding"]),
        "wpe.weight": _tensor(params["wpe"]["embedding"]),
        "ln_f.scale": _tensor(params["ln_f"]["scale"]),
        "ln_f.bias": _tensor(params["ln_f"]["bias"]),
    }
    for i in range(config.n_layer):
        lp = _layer(params, i, "h")
        for ln in ("ln_1", "ln_2"):
            for leaf in ("scale", "bias"):
                state[f"h.{i}.{ln}.{leaf}"] = _tensor(lp[ln][leaf])
        for group, name in _GPT2_DENSE:
            dense = lp[group][name]
            state[f"h.{i}.{group}.{name}.weight"] = \
                _tensor(dense["kernel"]).T.contiguous()
            state[f"h.{i}.{group}.{name}.bias"] = _tensor(dense["bias"])
    return state


def _dense(state: Dict[str, torch.Tensor], name: str, dense: Mapping) -> None:
    state[f"{name}.weight"] = _tensor(dense["kernel"]).T.contiguous()
    state[f"{name}.bias"] = _tensor(dense["bias"])


def mlp_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``MLPClassifier`` from the numpy ``params`` of
    :class:`raytpu.models.mlp.MLPClassifier` (``dense_{i}`` and
    ``head``, the same names in both packages)."""
    state: Dict[str, torch.Tensor] = {}
    for name, dense in params.items():
        _dense(state, name, dense)
    return state


_BLOCK = re.compile(r"(Basic|Bottleneck)Block_(\d+)$")


def _conv(kernel) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(kernel).transpose(3, 2, 0, 1),
                                     order="C"))


def _batch_norm(state, name: str, params: Mapping,
                stats: Optional[Mapping]) -> None:
    state[f"{name}.scale"] = _tensor(params["scale"])
    state[f"{name}.bias"] = _tensor(params["bias"])
    if stats is not None:
        state[f"{name}.mean"] = _tensor(stats["mean"])
        state[f"{name}.var"] = _tensor(stats["var"])


def resnet_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for ``ResNet`` from the numpy variables of
    :class:`raytpu.models.resnet.ResNet`: ``{"params": ...,
    "batch_stats": ...}`` (without ``"batch_stats"``, as for a gradient
    tree, the running buffers are left out). Flax's names map as: the
    stem ``conv_init`` and ``BatchNorm_0`` to ``conv_init`` and
    ``bn_init``; ``{Basic,Bottleneck}Block_{i}`` to ``blocks.{i}``, in
    which ``Conv_j`` and ``BatchNorm_j`` are ``conv_j`` and ``bn_j`` for
    the main path's two (basic) or three (bottleneck) convs, and the next
    ones, where the block projects its input, ``proj`` and ``proj_bn``;
    ``head`` to ``head``."""
    params = variables["params"]
    stats = variables.get("batch_stats")

    def sub(tree, name):
        return None if tree is None else tree[name]

    state = {"conv_init.weight": _conv(params["conv_init"]["kernel"])}
    _batch_norm(state, "bn_init", params["BatchNorm_0"],
                sub(stats, "BatchNorm_0"))
    _dense(state, "head", params["head"])
    blocks = [(int(m.group(2)), m.group(1), name) for name in params
              if (m := _BLOCK.match(name))]
    for i, kind, name in sorted(blocks):
        n_convs = 3 if kind == "Bottleneck" else 2
        bp, bs = params[name], sub(stats, name)
        for j in range(n_convs + 1):
            if f"Conv_{j}" not in bp:
                continue
            dst = f"blocks.{i}." + (f"conv_{j}" if j < n_convs else "proj")
            state[f"{dst}.weight"] = _conv(bp[f"Conv_{j}"]["kernel"])
            _batch_norm(state, f"blocks.{i}." + (
                f"bn_{j}" if j < n_convs else "proj_bn"),
                bp[f"BatchNorm_{j}"], sub(bs, f"BatchNorm_{j}"))
    return state
