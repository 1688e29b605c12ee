"""APPO — PPO's clipped surrogate on v-trace-corrected advantages: the
port of :mod:`raytpu.rllib.algorithms.appo`.

Reference analogue: ``rllib/algorithms/appo/appo.py`` (APPO extends
IMPALA; ``appo_torch_learner.py``: surrogate clip on vtrace pg advantages
+ periodically-updated target network for the KL/value baseline,
``target_network_update_freq``). Inherits IMPALA's training_step and only
swaps the loss. The target network is a copy of the parameters, never
the parameters themselves: the optimizer steps them in place.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from raytpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                  IMPALALearner,
                                                  _time_major_forward)
from raytpu_torch.rllib.core.learner import device_copy, vtrace


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.clip_param = 0.2
        self.use_kl_loss = False
        self.kl_coeff = 0.2
        self.target_network_update_freq = 2  # training_step() calls


class APPOLearner(IMPALALearner):
    """IMPALA loss with the PPO clip: ratio against the *behavior* policy,
    advantages from v-trace against the target network's values."""

    def __init__(self, module, config):
        super().__init__(module, config)
        self.sync_target()

    def compute_loss(self, params, batch):
        cfg = self.config
        target_logp, entropy, values = _time_major_forward(
            self.module, params, batch)
        # v-trace targets from the target network: the stable baseline
        # the reference uses to decouple actor lag from the fast-moving
        # online critic; its rhos come from the target policy too (the
        # surrogate below already multiplies by the online/behavior
        # ratio).
        with torch.no_grad():
            t_logp, _, t_values = _time_major_forward(
                self.module, self.target_params, batch)
            bootstrap_v = self.module.forward_train(
                self.target_params, batch["bootstrap_obs"])[1]
            vs, pg_adv = vtrace(
                batch["action_logp"], t_logp,
                batch["rewards"], t_values,
                batch["terminateds"], bootstrap_v, cfg["gamma"],
                cfg["clip_rho_threshold"], cfg["clip_c_threshold"])

        ratio = torch.exp(target_logp - batch["action_logp"])
        clipped = torch.clamp(ratio, 1 - cfg["clip_param"],
                              1 + cfg["clip_param"])
        policy_loss = -torch.mean(torch.minimum(pg_adv * ratio,
                                                pg_adv * clipped))
        vf_loss = 0.5 * torch.mean((vs - values) ** 2)
        ent = torch.mean(entropy)
        total = (policy_loss + cfg["vf_loss_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * ent)
        if cfg.get("use_kl_loss"):
            # Sample-based KL(pi_behavior || pi): actions already come from
            # the behavior policy, so no extra importance weight.
            kl = torch.mean(batch["action_logp"] - target_logp)
            total = total + cfg["kl_coeff"] * kl
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": ent}

    def sync_target(self):
        self.target_params = device_copy(self.params, self.device)


class APPO(IMPALA):
    learner_class = APPOLearner

    def _learner_config(self) -> Dict[str, Any]:
        out = super()._learner_config()
        c = self.config
        out.update({"clip_param": c.clip_param,
                    "use_kl_loss": c.use_kl_loss, "kl_coeff": c.kl_coeff})
        return out

    def training_step(self) -> Dict[str, Any]:
        metrics = super().training_step()
        if self.iteration % max(1, self.config.target_network_update_freq) \
                == 0:
            self.learner.sync_target()
        return metrics
