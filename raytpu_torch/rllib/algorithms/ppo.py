"""PPO — clipped-surrogate policy optimization: the port of
:mod:`raytpu.rllib.algorithms.ppo`.

Reference analogue: ``rllib/algorithms/ppo/ppo.py:403`` (training_step:
sample → learner update → weight sync) and ``ppo_learner.py`` /
``ppo_torch_learner.py`` (loss). The JAX package compiles the whole
update (GAE, advantage normalization, epoch shuffling, minibatch SGD)
into one program; the port runs the same steps eagerly on the learner's
device, one minibatch step after another.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from raytpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from raytpu_torch.rllib.core.learner import (Learner, compute_gae, to_device,
                                             to_host)
from raytpu_torch.rllib.core.rl_module import ieee_fp32


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 5e-5
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.num_epochs = 10
        self.minibatch_size = 128
        self.lambda_ = 0.95


class PPOLearner(Learner):
    """The PPO update over a whole rollout."""

    def compute_loss(self, params, batch):
        cfg = self.config
        logp, entropy, vf = self.module.logp_entropy(
            params, batch["obs"], batch["actions"])
        ratio = torch.exp(logp - batch["action_logp"])
        advs = batch["advantages"]
        surrogate = torch.minimum(
            advs * ratio,
            advs * torch.clamp(ratio, 1 - cfg["clip_param"],
                               1 + cfg["clip_param"]))
        policy_loss = -torch.mean(surrogate)
        vf_err = torch.clamp((vf - batch["value_targets"]) ** 2,
                             0.0, cfg["vf_clip_param"] ** 2)
        vf_loss = torch.mean(vf_err)
        ent = torch.mean(entropy)
        total = (policy_loss + cfg["vf_loss_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * ent)
        # approx-KL for monitoring (reference logs the same estimator)
        kl = torch.mean(batch["action_logp"] - logp)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": ent, "approx_kl": kl}

    # -- whole-rollout update -------------------------------------------------

    def minibatch_shape(self, n: int):
        """(num_minibatches, minibatch_size) for a rollout of ``n``
        samples."""
        mb = min(int(self.config["minibatch_size"]), n)
        return max(1, n // mb), mb

    def permutations(self, n: int) -> torch.Tensor:
        """Each epoch's shuffle of the ``n`` samples, cut to whole
        minibatches: int64 ``[num_epochs, num_mb, mb]`` on the CPU, from
        the learner's generator."""
        num_mb, mb = self.minibatch_shape(n)
        return torch.stack([
            torch.randperm(n, generator=self.generator)[: num_mb * mb]
            for _ in range(int(self.config["num_epochs"]))
        ]).reshape(-1, num_mb, mb)

    def _rollout_update(self, batch, perms: torch.Tensor):
        cfg = self.config
        with torch.no_grad():
            bootstrap_v = self.module.forward_train(
                self.params, batch["bootstrap_obs"])[1]
            advs, targets = compute_gae(
                batch["rewards"], batch["vf_preds"], batch["terminateds"],
                bootstrap_v, cfg["gamma"], cfg["lambda_"])
            # jnp.std: the population std.
            advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)

        T, B = batch["rewards"].shape
        flat = {
            # Structured (pixel) observations keep their trailing dims.
            "obs": batch["obs"].reshape((T * B,) + batch["obs"].shape[2:]),
            "actions": batch["actions"].reshape(T * B),
            "action_logp": batch["action_logp"].reshape(T * B),
            "advantages": advs.reshape(T * B),
            "value_targets": targets.reshape(T * B),
        }
        perms = perms.to(self.device)
        metrics = {}
        for epoch in perms:
            for idx in epoch:
                metrics = self._grad_step(
                    {k: v[idx] for k, v in flat.items()})
        return metrics  # those of the last minibatch of the last epoch

    def update(self, batch: Dict[str, Any],
               perms: Optional[torch.Tensor] = None) -> Dict[str, float]:
        """The update over one rollout (time-major arrays and
        ``bootstrap_obs``): ``num_epochs`` passes of minibatch steps, each
        pass over ``perms[epoch]`` (None: :meth:`permutations`)."""
        n = batch["rewards"].shape[0] * batch["rewards"].shape[1]
        if perms is None:
            perms = self.permutations(n)
        with ieee_fp32(self.device):
            metrics = self._rollout_update(to_device(batch, self.device),
                                           perms)
        return to_host(metrics)


class PPO(Algorithm):
    learner_class = PPOLearner

    def _learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {
            "gamma": c.gamma, "lambda_": c.lambda_,
            "clip_param": c.clip_param, "vf_clip_param": c.vf_clip_param,
            "vf_loss_coeff": c.vf_loss_coeff,
            "entropy_coeff": c.entropy_coeff,
            "num_epochs": c.num_epochs, "minibatch_size": c.minibatch_size,
        }

    def training_step(self) -> Dict[str, Any]:
        """Sample a rollout wave → the learner's update → weight sync
        (reference: ``ppo.py:403``)."""
        samples = self.env_runner_group.sample()
        steps = self._absorb_episodes(samples)
        batch = self._concat_time_major(samples)
        metrics = self.learner.update(batch)
        self.env_runner_group.sync_weights(self.learner.get_weights())
        metrics["_env_steps"] = steps
        return metrics
