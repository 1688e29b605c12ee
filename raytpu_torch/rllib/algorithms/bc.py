"""BC + MARWIL — offline / imitation learning from datasets: the port of
:mod:`raytpu.rllib.algorithms.bc`.

Reference analogue: ``rllib/algorithms/bc/bc.py`` (behavior cloning from
offline data) and ``rllib/algorithms/marwil/marwil.py`` (advantage-
weighted BC; BC is MARWIL with beta=0). The offline dataset is any object
with ``iter_batches(batch_size=, batch_format="numpy", drop_last=)``
(a :mod:`raytpu.data` dataset has it; the port does not import it). The
environment is OPTIONAL — only needed for greedy evaluation.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from raytpu_torch import resolve_device
from raytpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from raytpu_torch.rllib.core.learner import Learner
from raytpu_torch.rllib.core.rl_module import RLModuleSpec
from raytpu_torch.rllib.env.env_runner import EnvRunnerGroup


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.lr = 1e-3
        self.offline_dataset = None      # has iter_batches(...), see above
        self.observation_dim: Optional[int] = None
        self.action_dim: Optional[int] = None
        # MARWIL knobs (BC keeps beta=0 == plain imitation).
        self.action_low: Optional[float] = None
        self.action_high: Optional[float] = None
        self.beta = 0.0
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-2

    def offline(self, *, dataset=None, observation_dim: Optional[int] = None,
                action_dim: Optional[int] = None,
                action_low: Optional[float] = None,
                action_high: Optional[float] = None):
        if dataset is not None:
            self.offline_dataset = dataset
        if observation_dim is not None:
            self.observation_dim = observation_dim
        if action_dim is not None:
            self.action_dim = action_dim
        # Continuous offline algos (CQL) need the Box bounds when there is
        # no env to read them from; discrete BC ignores them.
        if action_low is not None:
            self.action_low = action_low
        if action_high is not None:
            self.action_high = action_high
        return self

    def rl_module_spec(self) -> RLModuleSpec:
        if self.env is not None:
            return super().rl_module_spec()
        if not (self.observation_dim and self.action_dim):
            raise ValueError(
                "offline training without an env needs "
                ".offline(observation_dim=..., action_dim=...)")
        return RLModuleSpec(observation_dim=self.observation_dim,
                            action_dim=self.action_dim,
                            model_config=dict(self.model))


class BCLearner(Learner):
    """Negative log-likelihood of the dataset actions (beta=0), or
    advantage-weighted NLL + value regression (MARWIL, beta>0) with the
    reference's moving-average advantage normalizer."""

    def __init__(self, module, config):
        super().__init__(module, config)
        self._ma_sqd_adv = 1.0  # host-side moving normalizer (reference)

    # The moving normalizer is training state: losing it across a
    # checkpoint resume would rescale MARWIL's advantage weights ~sqrt(ma)x.
    def get_state(self) -> dict:
        state = super().get_state()
        state["ma_sqd_adv"] = float(self._ma_sqd_adv)
        return state

    def set_state(self, state: dict) -> None:
        super().set_state(state)
        self._ma_sqd_adv = float(state.get("ma_sqd_adv", 1.0))

    def compute_loss(self, params, batch):
        cfg = self.config
        logp, entropy, vf = self.module.logp_entropy(
            params, batch["obs"], batch["actions"])
        beta = float(cfg.get("beta", 0.0))
        if beta > 0.0:
            adv = batch["returns"] - vf
            # Exponent clamp: before the moving normalizer warms up the
            # raw advantages can be ~returns-sized; exp would overflow to
            # inf and poison the loss (same guard as reference MARWIL's
            # normalized-advantage exponent).
            exponent = torch.clamp(beta * (adv / batch["adv_norm"]).detach(),
                                   -20.0, 10.0)
            weights = torch.exp(exponent)
            bc_loss = -torch.mean(weights * logp)
            vf_loss = torch.mean(adv ** 2)
            total = bc_loss + cfg.get("vf_coeff", 1.0) * vf_loss
            return total, {"bc_loss": bc_loss, "vf_loss": vf_loss,
                           "entropy": torch.mean(entropy),
                           "mean_sqd_adv": torch.mean(adv.detach() ** 2)}
        bc_loss = -torch.mean(logp)
        return bc_loss, {"bc_loss": bc_loss,
                         "entropy": torch.mean(entropy)}


class BC(Algorithm):
    learner_class = BCLearner

    def _learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {"beta": c.beta, "vf_coeff": c.vf_coeff}

    def setup(self, config: AlgorithmConfig):
        # Offline: no sampling plane required; build module + learner from
        # the configured dims, with an optional eval-only runner group.
        if config.offline_dataset is None:
            raise ValueError("BC/MARWIL require .offline(dataset=...)")
        self.device = resolve_device(config.device)
        spec = config.rl_module_spec()
        self.module = spec.build()
        self.learner = self.learner_class(self.module,
                                          self._base_learner_config())
        self.env_runner_group = None
        if config.env is not None:
            self.env_runner_group = EnvRunnerGroup({
                "env": config.env, "env_config": config.env_config,
                "module_spec": spec,
                "rollout_fragment_length": config.rollout_fragment_length,
                "num_envs_per_env_runner": 1,
                "seed": config.seed, "gamma": config.gamma,
                "env_to_module_connectors":
                    config.env_to_module_connectors,
                "module_to_env_connectors":
                    config.module_to_env_connectors,
                "device": self.device,
            }, 0)
            self.env_runner_group.sync_weights(self.learner.get_weights())
        self._batches: Optional[Iterator] = None

    def _next_batch(self) -> Dict[str, np.ndarray]:
        c = self.config
        batch = None
        for attempt in range(2):  # one epoch-boundary restart, no more
            if self._batches is None:
                self._batches = c.offline_dataset.iter_batches(
                    batch_size=c.train_batch_size, batch_format="numpy",
                    drop_last=True)
            try:
                batch = next(self._batches)
                break
            except StopIteration:  # epoch boundary: restart the stream
                self._batches = None
        if batch is None:
            raise ValueError(
                f"offline dataset yields no full batches at "
                f"train_batch_size={c.train_batch_size} — the dataset is "
                f"smaller than one batch")

        def to_array(v):
            v = np.asarray(v)
            if v.dtype == object:  # per-row vectors (e.g. obs) -> (B, d)
                v = np.stack([np.asarray(x) for x in v])
            return v

        return {k: to_array(v) for k, v in batch.items()}

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        batch = self._next_batch()
        batch["obs"] = batch["obs"].astype(np.float32)
        if c.beta > 0.0:
            if "returns" not in batch:
                raise ValueError(
                    "MARWIL (beta>0) needs a 'returns' column")
            # Moving-average advantage normalizer (host-side; reference:
            # marwil update_rate on the squared-advantage norm).
            metrics = self.learner.update({
                **batch,
                "adv_norm": np.float32(max(1e-8,
                                           np.sqrt(self._ma()))),
            })
            rate = c.moving_average_sqd_adv_norm_update_rate
            self.learner._ma_sqd_adv += rate * (
                metrics.get("mean_sqd_adv", 1.0)
                - self.learner._ma_sqd_adv)
        else:
            metrics = self.learner.update(batch)
        if self.env_runner_group is not None:
            self.env_runner_group.sync_weights(self.learner.get_weights())
        metrics["_env_steps"] = len(batch["obs"])
        return metrics

    def _ma(self) -> float:
        return float(self.learner._ma_sqd_adv)

    def evaluate(self) -> Dict[str, float]:
        if self.env_runner_group is None:
            raise ValueError("evaluation needs .environment(...)")
        return super().evaluate()

    def stop(self):
        if self.env_runner_group is not None:
            self.env_runner_group.stop()


class MARWILConfig(BCConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.beta = 1.0


class MARWIL(BC):
    """Advantage-weighted behavior cloning (reference:
    ``rllib/algorithms/marwil``); inherits the whole BC machinery."""
