"""Gymnasium / ALE environment adapter (optional dependency).

Reference analogue: the reference's RLlib is built directly on Farama
gymnasium (``rllib/env/``; Atari configs under ``rllib/tuned_examples/ppo/``
use ``ALE/*-v5``). This image ships no gymnasium, so the adapter imports
it lazily: ``make_env("ALE/Pong-v5")`` works wherever gymnasium (+ale-py)
is installed and falls back to a clear error naming the built-in
:class:`~raytpu_torch.rllib.env.envs.CatchEnv` pixel env otherwise.

Atari specs get the standard preprocessing the reference applies
(grayscale, 84x84 resize, scaled float obs, 4-frame stack) via
``gymnasium.wrappers`` so a PPO module sees the canonical (84,84,4)
tensor.

The port's copy of :mod:`raytpu.rllib.env.gym_adapter` (numpy only,
unchanged): the port imports nothing of ``raytpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


def gymnasium_available() -> bool:
    try:
        import gymnasium  # noqa: F401

        return True
    except ImportError:
        return False


class GymnasiumEnv:
    """Wrap a ``gymnasium.make``-able env in the interface the rest of
    rllib consumes (same API shape: ``reset() -> (obs, info)``,
    ``step(a) -> (obs, r, terminated, truncated, info)``; spaces are
    duck-compatible — gymnasium ``Discrete`` has ``.n``, ``Box`` has
    ``.shape/.low/.high`` — so ``AlgorithmConfig.space_info`` reads them
    unchanged)."""

    def __init__(self, spec: str, config: Optional[dict] = None):
        config = dict(config or {})
        import gymnasium as gym

        kwargs = dict(config.get("env_kwargs", {}))
        env = gym.make(spec, **kwargs)
        if self._is_atari(spec) and config.get("atari_preprocess", True):
            env = self._atari_wrap(env, config)
        self._env = env
        self._spec = spec
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._discrete = getattr(env.action_space, "n", None) is not None

    @staticmethod
    def _is_atari(spec: str) -> bool:
        return spec.startswith("ALE/")

    @staticmethod
    def _atari_wrap(env, config: dict):
        from gymnasium import wrappers

        # ALE *-v5 envs frame-skip internally (frameskip=4), so the
        # preprocessing wrapper must not skip again.
        env = wrappers.AtariPreprocessing(
            env, frame_skip=1, grayscale_obs=True, scale_obs=True,
            screen_size=int(config.get("screen_size", 84)))
        n_stack = int(config.get("framestack", 4))
        if n_stack > 1:
            try:
                env = wrappers.FrameStackObservation(env, n_stack)
            except AttributeError:  # older gymnasium name
                env = wrappers.FrameStack(env, n_stack)
        return env

    def reset(self, *, seed: Optional[int] = None):
        obs, info = self._env.reset(seed=seed)
        return self._obs(obs), info

    def step(self, action):
        a: Any = int(action) if self._discrete else np.asarray(action)
        obs, reward, terminated, truncated, info = self._env.step(a)
        return (self._obs(obs), float(reward), bool(terminated),
                bool(truncated), info)

    @staticmethod
    def _obs(obs) -> np.ndarray:
        # LazyFrames (frame stack) and uint8 screens both become float32
        # arrays, the dtype every module in rllib/core consumes.
        return np.asarray(obs, dtype=np.float32)

    def close(self) -> None:
        try:
            self._env.close()
        except Exception:
            pass

    def __repr__(self) -> str:
        return f"GymnasiumEnv({self._spec!r})"
