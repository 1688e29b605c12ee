"""Learner — the update plane: the port of
:mod:`raytpu.rllib.core.learner`.

The JAX learner compiles its update into one XLA program. The port's runs
eagerly on the learner's device: the loss of the algorithm, its gradients
by :func:`torch.autograd.grad` over the parameters the loss
differentiates (as ``jax.value_and_grad`` over its params argument),
optax's ``clip_by_global_norm`` rule, then Adam (``torch.optim.Adam``,
whose update is optax's ``adam``: the same bias corrections and eps
outside the square root). Metrics stay on the device until the update
ends and come back in one copy.

One learner only: the JAX package's ``num_learners > 1`` shards the
update over a mesh axis with an in-program ``pmean``; the port's
counterpart, gradients all-reduced over NCCL, waits for the port of the
parallel package (``ROADMAP.md``), so it raises.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raytpu_torch import resolve_device
from raytpu_torch.rllib.core.rl_module import Params, ieee_fp32


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Numpy (or tensor) batch entries as tensors on ``device``."""
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               else np.array(v, order="C")).to(device)
            for k, v in batch.items()}


def to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar metric tensors as floats, in one device-to-host copy."""
    values = torch.stack([torch.as_tensor(v).detach().float().reshape(())
                          for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


def host_copy(params: Params) -> Params:
    """A CPU copy of a (nested) parameter dict, detached."""
    return {k: (host_copy(v) if isinstance(v, dict)
                else v.detach().to("cpu", copy=True))
            for k, v in params.items()}


def device_copy(params: Params, device: torch.device,
                requires_grad: bool = False) -> Params:
    """A copy of a (nested) dict of tensors or numpy arrays on
    ``device``, never aliasing its source."""
    return {k: (device_copy(v, device, requires_grad) if isinstance(v, dict)
                else torch.as_tensor(v).detach().to(device, copy=True)
                .requires_grad_(requires_grad))
            for k, v in params.items()}


@torch.no_grad()
def load_params_(dst: Params, src: Params) -> None:
    """Copy a (nested) dict of tensors or numpy arrays into ``dst``'s
    tensors, in place."""
    for k, v in dst.items():
        if isinstance(v, dict):
            load_params_(v, src[k])
        else:
            v.copy_(torch.as_tensor(src[k]))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax's ``global_norm``: the L2 norm of all gradients together."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor,
                        max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: ``g / norm * max_norm`` when
    ``norm >= max_norm``, ``g`` otherwise (torch's ``clip_grad_norm_``
    divides by ``norm + 1e-6`` every time). No host sync."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return [g * scale for g in grads]


def apply_grads(optimizer: torch.optim.Optimizer,
                params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step of ``params`` with ``grads``, in place."""
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict with every tensor on the CPU."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, list):
            return [host(v) for v in x]
        return x
    return host(optimizer.state_dict())


class Learner:
    """Owns params + optimizer state; subclasses define the loss.

    ``compute_loss(params, batch) -> (loss, metrics_dict)`` takes the
    batch as tensors on the learner's device. Config keys: ``lr``,
    ``grad_clip``, ``num_learners``, ``seed``, ``device`` (None: the
    card, :func:`raytpu_torch.resolve_device`).
    """

    def __init__(self, module, config: Optional[Dict[str, Any]] = None):
        self.module = module
        self.config = dict(config or {})
        self.num_shards = int(self.config.get("num_learners", 1)) or 1
        if self.num_shards > 1:
            raise NotImplementedError(
                f"num_learners={self.num_shards}: the port has one learner; "
                f"several learners with gradients all-reduced over NCCL "
                f"wait for the parallel package's port (ROADMAP.md, "
                f"Queue 1: multi-learner over NCCL)")
        self.device = resolve_device(self.config.get("device"))
        seed = int(self.config.get("seed", 0))
        self.params = {k: v.requires_grad_() for k, v in
                       module.init_params(seed, self.device).items()}
        # torch's defaults are optax's (b1 0.9, b2 0.999, eps 1e-8).
        self.optimizer = torch.optim.Adam(self.params.values(),
                                          lr=self.config.get("lr", 3e-4))
        # Host-side draws (PPO's minibatch permutations), on the CPU so
        # the same seed draws the same on the CPU and on the card.
        self.generator = torch.Generator().manual_seed(seed)

    # -- the loss (override per algorithm) ------------------------------------

    def compute_loss(self, params: Params, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, dict]:
        raise NotImplementedError

    # -- update ---------------------------------------------------------------

    def _grad_step(self, batch: Dict[str, torch.Tensor]) -> dict:
        params = list(self.params.values())
        loss, metrics = self.compute_loss(self.params, batch)
        # A head the loss does not use (BC's value head) gets zeros, as
        # under jax.grad.
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        norm = global_norm(grads)
        clip = self.config.get("grad_clip", 40.0)
        if clip:
            grads = clip_by_global_norm(grads, norm, clip)
        apply_grads(self.optimizer, params, grads)
        metrics = dict(metrics)
        metrics["total_loss"] = loss
        metrics["grad_norm"] = norm
        return metrics

    def update(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One SGD step over the (already minibatched) batch."""
        with ieee_fp32(self.device):
            metrics = self._grad_step(to_device(batch, self.device))
        return to_host(metrics)

    # -- weights io -----------------------------------------------------------

    def get_weights(self) -> Params:
        return host_copy(self.params)

    def set_weights(self, weights: Params) -> None:
        load_params_(self.params, weights)

    def get_state(self) -> dict:
        return {"params": self.get_weights(),
                "opt_state": optimizer_state(self.optimizer)}

    def set_state(self, state: dict) -> None:
        self.set_weights(state["params"])
        # torch's load_state_dict keeps tensors already on the right
        # device and dtype, so a CPU learner would step the caller's
        # moments in place; the JAX package's arrays are immutable.
        self.optimizer.load_state_dict(copy.deepcopy(state["opt_state"]))


def compute_gae(rewards, values, terminateds, bootstrap_value,
                gamma: float, lam: float):
    """Generalized advantage estimation, time-major (T, B): a reverse
    loop over T, the JAX package's reverse scan. Reference analogue:
    ``rllib/evaluation/postprocessing.py`` ``compute_advantages``.
    Returns (advantages, value_targets)."""
    nonterminal = 1.0 - terminateds.float()
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + gamma * nonterminal * next_values - values
    advs = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + gamma * lam * nonterminal[t] * acc
        advs[t] = acc
    return advs, advs + values


def vtrace(behaviour_logp, target_logp, rewards, values, terminateds,
           bootstrap_value, gamma: float, clip_rho: float = 1.0,
           clip_c: float = 1.0):
    """V-trace off-policy correction (IMPALA, Espeholt et al. 2018);
    reference analogue: ``rllib/algorithms/impala/vtrace*``.

    All inputs time-major (T, B). Returns (vs, pg_advantages).
    """
    rhos = torch.exp(target_logp - behaviour_logp)
    clipped_rhos = torch.clamp(rhos, max=clip_rho)
    cs = torch.clamp(rhos, max=clip_c)
    nonterminal = 1.0 - terminateds.float()
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = clipped_rhos * (
        rewards + gamma * nonterminal * next_values - values)
    vs_minus_v = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in reversed(range(deltas.shape[0])):
        acc = deltas[t] + gamma * nonterminal[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    next_vs = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    pg_adv = clipped_rhos * (
        rewards + gamma * nonterminal * next_vs - values)
    return vs, pg_adv
