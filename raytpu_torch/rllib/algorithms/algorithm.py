"""Algorithm + AlgorithmConfig — the training driver: the port of
:mod:`raytpu.rllib.algorithms.algorithm`.

Reference analogue: ``rllib/algorithms/algorithm.py`` (``Algorithm.step``
``:789``, ``training_step`` ``:1490``), ``algorithm_config.py`` (fluent
config: ``.environment().env_runners().training().learners()``). The
port adds one setting, ``.resources(device=...)``: the device of the
learner and of the env runner's policy, None for the card
(:func:`raytpu_torch.resolve_device`); ``"cpu"`` runs the plain path.
Checkpoints keep the JAX package's layout: ``learner_state.pkl`` (a
pickled learner state of CPU tensors) and ``algorithm_state.json``.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import time
from typing import Any, Dict, Optional, Type

import numpy as np

from raytpu_torch import resolve_device
from raytpu_torch.rllib.connectors import ConnectorPipeline
from raytpu_torch.rllib.core.rl_module import RLModuleSpec
from raytpu_torch.rllib.env.env_runner import EnvRunnerGroup
from raytpu_torch.rllib.env.envs import make_env


class AlgorithmConfig:
    """Fluent builder (reference: ``AlgorithmConfig``; SURVEY.md A9 lists
    the knobs that matter for parity: num_env_runners / num_learners)."""

    def __init__(self, algo_class: Optional[Type["Algorithm"]] = None):
        self.algo_class = algo_class
        # environment
        self.env = None
        self.env_config: Dict[str, Any] = {}
        # env runners
        self.num_env_runners = 0
        self.num_envs_per_env_runner = 1
        self.rollout_fragment_length = 64
        # training
        self.lr = 3e-4
        self.gamma = 0.99
        self.train_batch_size = 512
        self.grad_clip = 40.0
        self.model: Dict[str, Any] = {}
        # learners
        self.num_learners = 1
        # resources: the learner's and the runner's device (None: cuda)
        self.device = None
        # connectors (env->module obs transforms, module->env action
        # transforms); instances are prototypes — each runner deep-copies
        # so stateful connectors (FrameStack) never share state.
        self.env_to_module_connectors: list = []
        self.module_to_env_connectors: list = []
        # debugging
        self.seed: Optional[int] = None
        # evaluation
        self.evaluation_interval: Optional[int] = None
        self.evaluation_num_episodes = 5

    # -- fluent sections ------------------------------------------------------

    def environment(self, env=None, *, env_config: Optional[dict] = None):
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None):
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs):
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(
                    f"unknown config key {k!r} for "
                    f"{type(self).__name__}; known: "
                    f"{sorted(x for x in vars(self) if not x.startswith('_'))}"
                )
            setattr(self, k, v)
        return self

    def learners(self, *, num_learners: Optional[int] = None):
        if num_learners is not None:
            self.num_learners = num_learners
        return self

    def resources(self, *, device=None):
        if device is not None:
            self.device = device
        return self

    def connectors(self, *, env_to_module: Optional[list] = None,
                   module_to_env: Optional[list] = None):
        if env_to_module is not None:
            self.env_to_module_connectors = list(env_to_module)
        if module_to_env is not None:
            self.module_to_env_connectors = list(module_to_env)
        return self

    def debugging(self, *, seed: Optional[int] = None):
        if seed is not None:
            self.seed = seed
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_num_episodes: Optional[int] = None):
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_num_episodes is not None:
            self.evaluation_num_episodes = evaluation_num_episodes
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items()
                if k != "algo_class" and not k.startswith("_")}

    # -- build ----------------------------------------------------------------

    def space_info(self) -> Dict[str, Any]:
        env = make_env(self.env, self.env_config)
        obs_shape = ConnectorPipeline(
            self.env_to_module_connectors).transform_obs_shape(
            tuple(env.observation_space.shape))
        space = env.action_space
        # getattr: gymnasium Box has no .n at all (our Space sets n=None).
        if getattr(space, "n", None) is not None:
            return {"obs_dim": int(np.prod(obs_shape)),
                    "obs_shape": obs_shape, "act_dim": int(space.n),
                    "continuous": False, "low": 0.0, "high": 0.0}
        act_dim = int(np.prod(space.shape))
        # Per-dimension bounds (an env may mix e.g. [-1,1] and [-10,10]
        # dims); broadcast scalars up so the squashing policy rescales
        # each dim into its own interval.
        low = np.broadcast_to(np.asarray(space.low, np.float32),
                              space.shape).reshape(act_dim)
        high = np.broadcast_to(np.asarray(space.high, np.float32),
                               space.shape).reshape(act_dim)
        return {"obs_dim": int(np.prod(obs_shape)), "obs_shape": obs_shape,
                "act_dim": act_dim, "continuous": True,
                "low": low.tolist(), "high": high.tolist()}

    def rl_module_spec(self) -> RLModuleSpec:
        info = self.space_info()
        if info["continuous"]:
            # The categorical default module cannot score Box actions; a
            # confusing take_along_axis trace error would surface deep in
            # the learner otherwise.
            raise ValueError(
                f"{type(self).__name__}: env {self.env!r} has a continuous "
                f"(Box) action space; use SAC (SACConfig) for continuous "
                f"control, or supply a custom module spec")
        structured = len(info["obs_shape"]) > 1
        return RLModuleSpec(
            observation_dim=info["obs_dim"], action_dim=info["act_dim"],
            model_config=dict(self.model),
            observation_shape=info["obs_shape"] if structured else None,
            continuous=info["continuous"], action_low=info["low"],
            action_high=info["high"])

    def build(self) -> "Algorithm":
        if self.algo_class is None:
            raise ValueError("config has no algo_class; use PPOConfig() etc.")
        return self.algo_class(self)


class Algorithm:
    """Drives training_step() and aggregates results.

    Subclasses set ``learner_class`` and implement ``training_step()``
    returning a metrics dict.
    """

    learner_class = None

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_returns: list = []
        self.setup(config)

    # -- lifecycle ------------------------------------------------------------

    def setup(self, config: AlgorithmConfig):
        self.device = resolve_device(config.device)
        spec = config.rl_module_spec()
        runner_config = {
            "env": config.env,
            "env_config": config.env_config,
            "module_spec": spec,
            "rollout_fragment_length": config.rollout_fragment_length,
            "num_envs_per_env_runner": config.num_envs_per_env_runner,
            "seed": config.seed,
            "gamma": config.gamma,
            "env_to_module_connectors": config.env_to_module_connectors,
            "module_to_env_connectors": config.module_to_env_connectors,
            "device": self.device,
        }
        self.env_runner_group = EnvRunnerGroup(
            runner_config, config.num_env_runners)
        self.module = spec.build()
        self.learner = self.learner_class(self.module,
                                          self._base_learner_config())
        self.env_runner_group.sync_weights(self.learner.get_weights())

    def _base_learner_config(self) -> Dict[str, Any]:
        c = self.config
        return {"lr": c.lr, "grad_clip": c.grad_clip,
                "num_learners": c.num_learners, "seed": c.seed or 0,
                "device": self.device, **self._learner_config()}

    def _learner_config(self) -> Dict[str, Any]:
        return {}

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    # -- public ---------------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        """One iteration (reference: ``Algorithm.step``, ``:789``)."""
        t0 = time.monotonic()
        metrics = self.training_step()
        self.iteration += 1
        took = time.monotonic() - t0

        recent = self._episode_returns[-100:]
        result = {
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "time_this_iter_s": took,
            "env_steps_per_s": metrics.pop("_env_steps", 0) / max(took, 1e-9),
            "episode_return_mean": (float(np.mean(recent))
                                    if recent else float("nan")),
            "episode_return_max": (float(np.max(recent))
                                   if recent else float("nan")),
            "num_episodes": len(self._episode_returns),
            **metrics,
        }
        ci = self.config.evaluation_interval
        if ci and self.iteration % ci == 0:
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self) -> Dict[str, float]:
        return self.env_runner_group.evaluate(
            self.config.evaluation_num_episodes)

    def stop(self):
        self.env_runner_group.stop()

    # -- checkpointing (reference: Checkpointable save/restore) ---------------

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "learner_state.pkl"), "wb") as f:
            pickle.dump(self.learner.get_state(), f)
        with open(os.path.join(path, "algorithm_state.json"), "w") as f:
            json.dump({"iteration": self.iteration,
                       "timesteps_total": self._timesteps_total}, f)
        return path

    def restore(self, path: str) -> None:
        """Load what :meth:`save` wrote (a pickle: restore only
        checkpoints this program wrote)."""
        with open(os.path.join(path, "learner_state.pkl"), "rb") as f:
            self.learner.set_state(pickle.load(f))
        with open(os.path.join(path, "algorithm_state.json")) as f:
            st = json.load(f)
        self.iteration = st["iteration"]
        self._timesteps_total = st["timesteps_total"]
        if self.env_runner_group is not None:  # env-less offline algos
            self.env_runner_group.sync_weights(self.learner.get_weights())

    # -- helpers for subclasses -----------------------------------------------

    def _absorb_episodes(self, samples) -> int:
        steps = 0
        for s in samples:
            for ep in s.pop("episodes", []):
                self._episode_returns.append(ep["episode_return"])
            steps += s.get("env_steps", 0)
        self._timesteps_total += steps
        return steps

    @staticmethod
    def _replay_transitions(sample) -> Dict[str, np.ndarray]:
        """Flatten a time-major fragment into replay transitions (shared
        by the off-policy algorithms). Pure time-limit truncations are
        dropped: their stored next_obs is the post-reset state and
        terminateds=True would wrongly zero the Bellman bootstrap at a
        state that did not really terminate (reference SAC/DQN exclude
        truncations from the done mask)."""
        s = sample
        T, B = s["rewards"].shape
        next_obs = np.concatenate(
            [s["obs"][1:], s["bootstrap_obs"][None]], axis=0)
        keep = ~s["truncateds"].reshape(T * B)
        actions = s["actions"].reshape((T * B,) + s["actions"].shape[2:])
        return {
            "obs": s["obs"].reshape(T * B, -1)[keep],
            "actions": actions[keep],
            "rewards": s["rewards"].reshape(T * B)[keep],
            "terminateds": s["terminateds"].reshape(T * B)[keep],
            "next_obs": next_obs.reshape(T * B, -1)[keep],
        }

    @staticmethod
    def _concat_time_major(samples) -> Dict[str, np.ndarray]:
        """Concatenate runner fragments on the env (batch) axis."""
        out = {}
        for key in ("obs", "actions", "rewards", "terminateds",
                    "action_logp", "vf_preds"):
            out[key] = np.concatenate([s[key] for s in samples], axis=1)
        out["bootstrap_obs"] = np.concatenate(
            [s["bootstrap_obs"] for s in samples], axis=0)
        return out
