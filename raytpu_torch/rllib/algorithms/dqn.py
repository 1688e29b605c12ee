"""DQN — replay + target network + double-Q: the port of
:mod:`raytpu.rllib.algorithms.dqn`.

Reference analogue: ``rllib/algorithms/dqn/dqn.py`` (training_step:
sample → store → replay-sample → update → target sync) and
``dqn_rainbow_torch_learner.py`` (double-Q loss). The target network is
a copy of the parameters, never the parameters themselves: the optimizer
steps them in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from raytpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from raytpu_torch.rllib.core.learner import Learner, device_copy
from raytpu_torch.rllib.core.rl_module import QModule, RLModuleSpec
from raytpu_torch.rllib.utils.replay_buffer import ReplayBuffer


class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DQN)
        self.lr = 5e-4
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # env steps
        self.train_batch_size = 32
        self.updates_per_step = 4
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 10_000
        self.double_q = True

    def rl_module_spec(self) -> RLModuleSpec:
        info = self.space_info()
        if info["continuous"]:
            raise ValueError("DQN requires a discrete action space; use "
                             "SAC (SACConfig) for continuous control")
        return RLModuleSpec(module_class=QModule,
                            observation_dim=info["obs_dim"],
                            action_dim=info["act_dim"],
                            model_config=dict(self.model))


def _taken(q, actions):
    return torch.gather(q, -1, actions[:, None].long())[:, 0]


class DQNLearner(Learner):
    def __init__(self, module, config):
        super().__init__(module, config)
        self.sync_target()

    def compute_loss(self, params, batch):
        cfg = self.config
        q = self.module.q_values(params, batch["obs"])
        q_taken = _taken(q, batch["actions"])
        with torch.no_grad():
            q_next_target = self.module.q_values(self.target_params,
                                                 batch["next_obs"])
            if cfg.get("double_q", True):
                best = torch.argmax(
                    self.module.q_values(params, batch["next_obs"]), dim=-1)
            else:
                best = torch.argmax(q_next_target, dim=-1)
            q_next = _taken(q_next_target, best)
            nonterminal = 1.0 - batch["terminateds"].float()
            target = batch["rewards"] + cfg["gamma"] * nonterminal * q_next
        # Huber loss (reference default).
        err = q_taken - target
        loss = torch.mean(torch.where(torch.abs(err) < 1.0, 0.5 * err ** 2,
                                      torch.abs(err) - 0.5))
        return loss, {"qf_loss": loss, "q_mean": torch.mean(q_taken)}

    def sync_target(self):
        self.target_params = device_copy(self.params, self.device)


class DQN(Algorithm):
    learner_class = DQNLearner

    def _learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {"gamma": c.gamma, "double_q": c.double_q}

    def setup(self, config):
        super().setup(config)
        self.buffer = ReplayBuffer(config.replay_buffer_capacity,
                                   seed=config.seed)
        self._since_target_sync = 0

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._timesteps_total / max(1, c.epsilon_timesteps))
        return c.epsilon_initial + frac * (c.epsilon_final
                                           - c.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        samples = self.env_runner_group.sample(epsilon=self._epsilon())
        steps = self._absorb_episodes(samples)
        # Flatten fragments into (s, a, r, s', done) transitions.
        for s in samples:
            self.buffer.add(self._replay_transitions(s))
        metrics: Dict[str, Any] = {"epsilon": self._epsilon(),
                                   "replay_size": len(self.buffer)}
        if len(self.buffer) >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.updates_per_step):
                metrics.update(self.learner.update(
                    self.buffer.sample(c.train_batch_size)))
            self._since_target_sync += steps
            if self._since_target_sync >= c.target_network_update_freq:
                self.learner.sync_target()
                self._since_target_sync = 0
            self.env_runner_group.sync_weights(self.learner.get_weights())
        metrics["_env_steps"] = steps
        return metrics
