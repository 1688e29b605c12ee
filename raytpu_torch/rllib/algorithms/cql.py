"""CQL — conservative Q-learning for offline continuous control: the port
of :mod:`raytpu.rllib.algorithms.cql`.

Reference analogue: ``rllib/algorithms/cql/cql.py`` (SAC + a conservative
penalty that pushes Q down on out-of-distribution actions, trained from a
fixed dataset). Built on the SAC learner: the critic loss gains
``min_q_weight * (logsumexp_a Q(s,a) - Q(s, a_data))`` over uniform
random actions plus the policy's action (CQL(H)); the rest of the step is
SAC's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from raytpu_torch.rllib.algorithms.bc import BC, BCConfig
from raytpu_torch.rllib.algorithms.sac import SACConfig, SACLearner
from raytpu_torch.rllib.core.rl_module import RLModuleSpec, SACModule


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or CQL)
        self.min_q_weight = 5.0
        self.num_cql_actions = 4        # sampled actions per state
        self.offline_dataset = None
        self.observation_dim = None
        self.action_dim = None
        self.action_low = None
        self.action_high = None
        self.updates_per_iteration = 50

    offline = BCConfig.offline  # same fluent section

    def rl_module_spec(self) -> RLModuleSpec:
        if self.env is not None:
            return super().rl_module_spec()
        if not (self.observation_dim and self.action_dim):
            raise ValueError(
                "offline training without an env needs "
                ".offline(observation_dim=..., action_dim=...)")
        return RLModuleSpec(
            module_class=SACModule, observation_dim=self.observation_dim,
            action_dim=self.action_dim, model_config=dict(self.model),
            continuous=True,
            action_low=(self.action_low if self.action_low is not None
                        else -1.0),
            action_high=(self.action_high if self.action_high is not None
                         else 1.0))


class CQLLearner(SACLearner):
    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """SAC's draws, plus ``rand`` (the ``num_cql_actions`` uniform
        actions a state, [n, B, action_dim], within the bounds) and
        ``cur`` (the normal noise of the policy's action, [B,
        action_dim])."""
        noise = super().draw_noise(batch_size)
        lo, hi, _ = self.module._bounds(self.device)
        n = int(self.config.get("num_cql_actions", 4))
        u = torch.rand((n, batch_size, self.module.action_dim),
                       generator=self.generator, device=self.device)
        noise["rand"] = lo + (hi - lo) * u
        noise["cur"] = torch.randn((batch_size, self.module.action_dim),
                                   generator=self.generator,
                                   device=self.device)
        return noise

    def critic_loss(self, batch, target, noise):
        m = self.module
        obs = batch["obs"]
        with torch.no_grad():
            cur_a, _ = m.sample(self.params, obs, noise=noise["cur"])
        q1, q2 = m.q_values(self.params, obs, batch["actions"])
        bellman = torch.mean((q1 - target) ** 2) + \
            torch.mean((q2 - target) ** 2)
        # OOD action set: uniform samples + the current policy action.
        rand_a = noise["rand"]
        r1, r2 = m.q_values(self.params,
                            obs.expand(rand_a.shape[0], *obs.shape), rand_a)
        p1, p2 = m.q_values(self.params, obs, cur_a)
        # Conservative gap: push down logsumexp over actions, push up
        # the dataset action (reference: CQL(H) objective).
        gap1 = torch.logsumexp(torch.cat([r1, p1[None]]), dim=0) - q1
        gap2 = torch.logsumexp(torch.cat([r2, p2[None]]), dim=0) - q2
        cql = torch.mean(gap1) + torch.mean(gap2)
        loss = bellman + float(self.config.get("min_q_weight", 5.0)) * cql
        return loss, {"qf_loss": loss, "bellman_loss": bellman,
                      "cql_penalty": cql, "q_mean": torch.mean(q1)}

    def _step(self, batch, noise) -> dict:
        metrics = super()._step(batch, noise)
        del metrics["alpha_loss"]  # the JAX package's CQL does not report it
        return metrics


class CQL(BC):
    """Inherits BC's offline plumbing (env-optional setup, dataset
    batches, eval-only runner group) and swaps in the conservative SAC
    learner."""

    learner_class = CQLLearner

    def _learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {"gamma": c.gamma, "tau": c.tau,
                "initial_alpha": c.initial_alpha,
                "target_entropy": c.target_entropy,
                "min_q_weight": c.min_q_weight,
                "num_cql_actions": c.num_cql_actions}

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        metrics: Dict[str, Any] = {}
        steps = 0
        for _ in range(c.updates_per_iteration):
            batch = self._next_batch()
            batch["obs"] = batch["obs"].astype(np.float32)
            batch["next_obs"] = batch["next_obs"].astype(np.float32)
            metrics = self.learner.update(batch)
            steps += len(batch["obs"])
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.learner.get_weights())
        metrics["_env_steps"] = steps
        return metrics
