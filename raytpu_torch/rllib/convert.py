"""Carry the JAX package's RL weights across.

:func:`params_from_jax` takes a numpy parameter tree of
:mod:`raytpu.rllib` (what ``Learner.get_weights()`` returns, and the
``params`` of a JAX checkpoint's ``learner_state.pkl``) and returns the
parameters of the matching :mod:`raytpu_torch.rllib` module, named as the
net's ``state_dict``:

- the policy/value net and the Q net: ``pi_{i}``, ``pi_out``, ``vf_{i}``,
  ``vf_out``;
- the conv net: ``torso.conv_{i}``, ``torso.torso_out``, ``pi_out``,
  ``vf_out``;
- the Gaussian net: ``pi_{i}``, ``mean``, ``log_std``;
- SAC's ``{"pi", "q1", "q2"}`` (and a target tree ``{"q1", "q2"}``): a
  dict of such dicts, one per net.

Flax Dense kernels ``[in, out]`` become weights ``[out, in]``; Conv
kernels HWIO become OIHW; biases carry over. The conv torso flattens in
NHWC order in both packages, so ``torso_out`` needs no permutation. The
same map carries gradients, which have the tree's structure.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# Top-level keys of a tree that holds several nets (SAC).
_MULTI_NET = ("pi", "q1", "q2")


def _weight(kernel) -> torch.Tensor:
    k = np.asarray(kernel)
    if k.ndim == 4:  # Conv: HWIO -> OIHW
        k = k.transpose(3, 2, 0, 1)
    elif k.ndim == 2:  # Dense: [in, out] -> [out, in]
        k = k.T
    else:
        raise ValueError(f"kernel of shape {k.shape}: not Dense or Conv")
    return torch.from_numpy(np.array(k, order="C"))  # writable


def state_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One flax net's numpy params as a ``state_dict``: every layer ``{
    "kernel", "bias"}`` at path ``a/b`` becomes ``a.b.weight`` and
    ``a.b.bias``."""
    out = {}
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if "kernel" in sub:
            out[f"{path}.weight"] = _weight(sub["kernel"])
            out[f"{path}.bias"] = torch.from_numpy(np.array(sub["bias"]))
        else:
            out.update(state_from_jax(sub, f"{path}."))
    return out


def params_from_jax(tree: Mapping):
    """The port's parameters for a JAX RL params tree: a ``state_dict``
    of one net, or, for a tree of several nets (SAC's ``pi``/``q1``/
    ``q2``, its target ``q1``/``q2``), one per net."""
    if set(tree) <= set(_MULTI_NET):  # no single net has such layers
        return {name: state_from_jax(sub) for name, sub in tree.items()}
    return state_from_jax(tree)
