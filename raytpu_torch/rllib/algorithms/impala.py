"""IMPALA — V-trace off-policy correction: the port of
:mod:`raytpu.rllib.algorithms.impala`.

Reference analogue: ``rllib/algorithms/impala/impala.py:667`` and
``vtrace_torch.py``. The JAX package keeps one sample task in flight per
remote runner and consumes fragments in arrival order; the port has only
the local runner (``num_env_runners=0``), so it runs the JAX package's
synchronous path: sample a fragment, update on it, sync the weights,
``num_fragments_per_step`` times an iteration.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from raytpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from raytpu_torch.rllib.core.learner import Learner, vtrace


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.clip_rho_threshold = 1.0
        self.clip_c_threshold = 1.0
        self.num_fragments_per_step = 4


def _time_major_forward(module, params, batch):
    """(logp, entropy, values) of the fragment's actions under
    ``params``, each (T, B)."""
    T, B = batch["rewards"].shape
    obs_flat = batch["obs"].reshape((T * B,) + batch["obs"].shape[2:])
    logp, entropy, vf = module.logp_entropy(
        params, obs_flat, batch["actions"].reshape(T * B))
    return logp.reshape(T, B), entropy.reshape(T, B), vf.reshape(T, B)


class IMPALALearner(Learner):
    def compute_loss(self, params, batch):
        cfg = self.config
        target_logp, entropy, values = _time_major_forward(
            self.module, params, batch)
        bootstrap_v = self.module.forward_train(
            params, batch["bootstrap_obs"])[1]
        vs, pg_adv = vtrace(
            batch["action_logp"], target_logp, batch["rewards"], values,
            batch["terminateds"], bootstrap_v, cfg["gamma"],
            cfg["clip_rho_threshold"], cfg["clip_c_threshold"])
        # vs/pg_adv are targets: no gradient flows through them.
        vs = vs.detach()
        pg_adv = pg_adv.detach()
        policy_loss = -torch.mean(pg_adv * target_logp)
        vf_loss = 0.5 * torch.mean((vs - values) ** 2)
        ent = torch.mean(entropy)
        total = (policy_loss + cfg["vf_loss_coeff"] * vf_loss
                 - cfg["entropy_coeff"] * ent)
        return total, {"policy_loss": policy_loss, "vf_loss": vf_loss,
                       "entropy": ent}


class IMPALA(Algorithm):
    learner_class = IMPALALearner

    def _learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {
            "gamma": c.gamma, "vf_loss_coeff": c.vf_loss_coeff,
            "entropy_coeff": c.entropy_coeff,
            "clip_rho_threshold": c.clip_rho_threshold,
            "clip_c_threshold": c.clip_c_threshold,
        }

    def training_step(self) -> Dict[str, Any]:
        runner = self.env_runner_group.local_runner
        metrics: Dict[str, Any] = {}
        steps = 0
        for _ in range(self.config.num_fragments_per_step):
            sample = runner.sample()
            steps += self._absorb_episodes([sample])
            metrics = self.learner.update(self._concat_time_major([sample]))
            runner.set_weights(self.learner.get_weights())
        metrics["_env_steps"] = steps
        return metrics
