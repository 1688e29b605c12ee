"""SAC — soft actor-critic for continuous control: the port of
:mod:`raytpu.rllib.algorithms.sac`.

Reference analogue: ``rllib/algorithms/sac/sac.py`` (training_step:
sample → replay → critic/actor/alpha updates → polyak target sync) and
``sac_torch_policy.py`` (twin-Q loss, auto entropy temperature). One
gradient step, as the JAX package's ``_step``: the critics, then the
actor through the critics *as just updated* with α from *before* α's
update, then α, then the polyak move of the target critics. Each loss
takes its gradients with :func:`torch.autograd.grad` over its own
parameters only, so the actor's loss leaves nothing in the critics'.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from raytpu_torch import resolve_device
from raytpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from raytpu_torch.rllib.core.learner import (apply_grads, device_copy,
                                             host_copy, load_params_,
                                             to_device, to_host)
from raytpu_torch.rllib.core.rl_module import (RLModuleSpec, SACModule,
                                               ieee_fp32)
from raytpu_torch.rllib.utils.replay_buffer import ReplayBuffer


class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or SAC)
        self.lr = 3e-4
        self.tau = 0.005                  # polyak coefficient
        self.initial_alpha = 1.0
        self.target_entropy = None        # None -> -action_dim
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.train_batch_size = 256
        self.updates_per_step = 1

    def rl_module_spec(self) -> RLModuleSpec:
        info = self.space_info()
        if not info["continuous"]:
            raise ValueError("SAC requires a continuous (Box) action space")
        return RLModuleSpec(
            module_class=SACModule, observation_dim=info["obs_dim"],
            action_dim=info["act_dim"], model_config=dict(self.model),
            continuous=True, action_low=info["low"], action_high=info["high"])


class SACLearner:
    """Self-contained learner (not the base Learner): SAC has three Adams
    (critics / actor / temperature) and target critics."""

    def __init__(self, module: SACModule, config: Dict[str, Any]):
        self.module = module
        self.config = dict(config)
        self.device = resolve_device(self.config.get("device"))
        seed = int(self.config.get("seed", 0))
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 7)
        self.params = device_copy(module.init_params(seed), self.device,
                                  requires_grad=True)
        self.sync_target()
        self.log_alpha = torch.tensor(
            math.log(self.config.get("initial_alpha", 1.0)),
            dtype=torch.float32, device=self.device, requires_grad=True)
        lr = self.config.get("lr", 3e-4)
        self.opt = {"pi": torch.optim.Adam(self._pi_params(), lr=lr),
                    "q": torch.optim.Adam(self._q_params(), lr=lr),
                    "alpha": torch.optim.Adam([self.log_alpha], lr=lr)}
        te = self.config.get("target_entropy")
        self.target_entropy = float(
            te if te is not None else -module.action_dim)

    def sync_target(self):
        self.target_q = device_copy(
            {"q1": self.params["q1"], "q2": self.params["q2"]}, self.device)

    def _pi_params(self):
        return list(self.params["pi"].values())

    def _q_params(self):
        return (list(self.params["q1"].values())
                + list(self.params["q2"].values()))

    def draw_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The step's random draws from the learner's generator: the
        standard normal noise of the next-state actions and of the
        actor's actions, each [B, action_dim]."""
        shape = (batch_size, self.module.action_dim)
        return {name: torch.randn(shape, generator=self.generator,
                                  device=self.device)
                for name in ("next", "pi")}

    def critic_loss(self, batch, target, noise):
        """(loss, metrics) of the twin critics against ``target``."""
        q1, q2 = self.module.q_values(self.params, batch["obs"],
                                      batch["actions"])
        loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
        return loss, {"qf_loss": loss, "q_mean": torch.mean(q1)}

    def _step(self, batch, noise) -> dict:
        m = self.module
        gamma, tau = self.config["gamma"], self.config["tau"]
        alpha = torch.exp(self.log_alpha).detach()
        with torch.no_grad():
            next_a, next_logp = m.sample(self.params, batch["next_obs"],
                                         noise=noise["next"])
            tq1, tq2 = m.q_values(self.target_q, batch["next_obs"], next_a)
            nonterminal = 1.0 - batch["terminateds"].float()
            target = batch["rewards"] + gamma * nonterminal * (
                torch.minimum(tq1, tq2) - alpha * next_logp)

        qf_loss, metrics = self.critic_loss(batch, target, noise)
        q_params = self._q_params()
        apply_grads(self.opt["q"], q_params,
                    torch.autograd.grad(qf_loss, q_params))

        a, logp = m.sample(self.params, batch["obs"], noise=noise["pi"])
        aq1, aq2 = m.q_values(self.params, batch["obs"], a)
        pi_loss = torch.mean(alpha * logp - torch.minimum(aq1, aq2))
        pi_params = self._pi_params()
        apply_grads(self.opt["pi"], pi_params,
                    torch.autograd.grad(pi_loss, pi_params))

        alpha_loss = -torch.mean(torch.exp(self.log_alpha)
                                 * (logp.detach() + self.target_entropy))
        apply_grads(self.opt["alpha"], [self.log_alpha],
                    torch.autograd.grad(alpha_loss, [self.log_alpha]))

        with torch.no_grad():
            for name in ("q1", "q2"):
                for k, t in self.target_q[name].items():
                    t.copy_((1 - tau) * t + tau * self.params[name][k])
        return {**metrics, "actor_loss": pi_loss, "alpha_loss": alpha_loss,
                "alpha": torch.exp(self.log_alpha)}

    def update(self, batch: Dict[str, Any],
               noise: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """One gradient step on a replay batch; ``noise`` as
        :meth:`draw_noise` gives it (None: drawn here)."""
        with ieee_fp32(self.device):
            batch = to_device(batch, self.device)
            noise = (self.draw_noise(len(batch["obs"])) if noise is None
                     else to_device(noise, self.device))
            return to_host(self._step(batch, noise))

    # Weight-sync / checkpoint surface shared with the base Learner.
    def get_weights(self):
        return host_copy(self.params)

    def set_weights(self, weights):
        load_params_(self.params, weights)

    def get_state(self):
        return {"params": self.get_weights(),
                "target_q": host_copy(self.target_q),
                "log_alpha": float(self.log_alpha)}

    def set_state(self, state):
        load_params_(self.params, state["params"])
        load_params_(self.target_q, state["target_q"])
        with torch.no_grad():
            self.log_alpha.fill_(state["log_alpha"])


class SAC(Algorithm):
    learner_class = SACLearner

    def _learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {"gamma": c.gamma, "tau": c.tau,
                "initial_alpha": c.initial_alpha,
                "target_entropy": c.target_entropy}

    def setup(self, config):
        super().setup(config)
        self.buffer = ReplayBuffer(config.replay_buffer_capacity,
                                   seed=config.seed)

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        samples = self.env_runner_group.sample()
        steps = self._absorb_episodes(samples)
        for s in samples:
            self.buffer.add(self._replay_transitions(s))
        metrics: Dict[str, Any] = {"replay_size": len(self.buffer)}
        if len(self.buffer) >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.updates_per_step):
                metrics.update(self.learner.update(
                    self.buffer.sample(c.train_batch_size)))
            self.env_runner_group.sync_weights(self.learner.get_weights())
        metrics["_env_steps"] = steps
        return metrics
