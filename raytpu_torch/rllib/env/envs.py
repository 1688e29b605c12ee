"""Built-in environments + registry.

The reference uses Farama gymnasium throughout (``rllib/env/``); this
image has no gym, so we ship a numpy CartPole with the gymnasium API shape
(``reset() -> (obs, info)``, ``step(a) -> (obs, r, terminated, truncated,
info)``) and accept any user class with that interface. Reference
analogue for the registry: ``ray.tune.registry.register_env``.

The port's copy of :mod:`raytpu.rllib.env.envs` (numpy only): the port
imports nothing of ``raytpu``, so it keeps its own. It adds
:func:`env_registration`: the JAX package's remote runners are threads
that share the registry, the port's are spawned processes, which get the
config's ``(name, creator)`` pair handed over and register it themselves.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

_ENV_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_env(name: str, creator: Callable[..., Any]) -> None:
    _ENV_REGISTRY[name] = creator


def env_registration(spec) -> Optional[Tuple[str, Callable[..., Any]]]:
    """The ``(name, creator)`` pair a process of its own needs to make
    ``spec`` (None when ``spec`` is not a registered name), checked to
    pickle: a creator that does not (a lambda, a closure) raises here,
    naming the env, rather than later inside the process."""
    if not (isinstance(spec, str) and spec in _ENV_REGISTRY):
        return None
    creator = _ENV_REGISTRY[spec]
    try:
        pickle.dumps(creator)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise ValueError(
            f"env {spec!r} is registered with a creator that does not "
            f"pickle ({creator!r}), so remote env runners, which are "
            f"processes of their own, cannot make it; register a "
            f"module-level function or class instead") from exc
    return spec, creator


def make_env(spec, env_config: Optional[dict] = None):
    env_config = env_config or {}
    if isinstance(spec, str):
        if spec in _ENV_REGISTRY:
            return _ENV_REGISTRY[spec](env_config)
        # Unregistered names resolve through gymnasium when installed
        # (reference: RLlib treats any string as a gym id) — this is how
        # real Atari ("ALE/Pong-v5") plugs in; CatchEnv is the built-in
        # pixel fallback for images without gymnasium.
        from raytpu_torch.rllib.env.gym_adapter import (
            GymnasiumEnv, gymnasium_available)

        if gymnasium_available():
            return GymnasiumEnv(spec, env_config)
        raise ValueError(
            f"unknown env {spec!r}; register_env() it first, or install "
            f"gymnasium (+ale-py for ALE/* Atari ids) to resolve gym "
            f"ids directly (built-ins: {sorted(_ENV_REGISTRY)}; built-in "
            f"pixel fallback: 'Catch-v0')")
    if callable(spec):
        try:
            return spec(env_config)
        except TypeError:
            return spec()
    raise TypeError(f"env spec must be a name or callable, got {type(spec)}")


class Space:
    """Minimal space descriptor (gymnasium-API compatible subset)."""

    def __init__(self, shape: Tuple[int, ...], dtype, n: Optional[int] = None,
                 low=None, high=None):
        self.shape = shape
        self.dtype = dtype
        self.n = n  # discrete size, None for continuous
        self.low = low
        self.high = high

    @classmethod
    def discrete(cls, n: int) -> "Space":
        return cls((), np.int32, n=n)

    @classmethod
    def box(cls, low, high, shape) -> "Space":
        return cls(tuple(shape), np.float32, low=low, high=high)


class CartPoleEnv:
    """Classic cart-pole balancing (dynamics per Barto-Sutton-Anderson,
    matching gymnasium's CartPole-v1 constants)."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.max_steps = int(config.get("max_episode_steps", 500))
        self.observation_space = Space.box(-np.inf, np.inf, (4,))
        self.action_space = Space.discrete(2)
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = None
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(
            abs(x) > self.x_threshold or abs(theta) > self.theta_threshold)
        truncated = self._steps >= self.max_steps
        return (self._state.astype(np.float32), 1.0, terminated, truncated,
                {})


class VecCartPoleEnv:
    """Vectorized cart-pole: ``num_envs`` copies stepped as one batched
    numpy computation with auto-reset (reference analogue: gymnasium
    ``SyncVectorEnv`` / RLlib's vectorized sampling — but the dynamics
    themselves are batched, not a Python loop over envs). This is the
    sampling-plane answer to TPU-class learners: the policy forward is
    already batched, so the env must be too or host stepping dominates.

    ``step_batch(actions) -> (obs, rewards, terminated, truncated, info)``
    where done envs are auto-reset in the returned ``obs`` and their
    pre-reset observation is at ``info["final_obs"]``.
    """

    is_vector_env = True

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.num_envs = int(config.get("num_envs", 64))
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.max_steps = int(config.get("max_episode_steps", 500))
        self.observation_space = Space.box(-np.inf, np.inf, (4,))
        self.action_space = Space.discrete(2)
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = None
        self._steps = None

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(
            -0.05, 0.05, size=(self.num_envs, 4))
        self._steps = np.zeros(self.num_envs, dtype=np.int64)
        return self._state.astype(np.float32), {}

    def step_batch(self, actions):
        s = self._state
        x, x_dot, theta, theta_dot = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        force = np.where(np.asarray(actions) == 1, self.force_mag,
                         -self.force_mag)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot**2 * sintheta) \
            / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0
                           - self.masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1
        terminated = (np.abs(x) > self.x_threshold) | (
            np.abs(theta) > self.theta_threshold)
        truncated = (self._steps >= self.max_steps) & ~terminated
        done = terminated | truncated
        rewards = np.ones(self.num_envs, dtype=np.float32)
        final_obs = self._state.astype(np.float32)
        if done.any():
            n = int(done.sum())
            self._state[done] = self._rng.uniform(-0.05, 0.05, size=(n, 4))
            self._steps[done] = 0
        return (self._state.astype(np.float32), rewards, terminated,
                truncated, {"final_obs": final_obs})


class PendulumEnv:
    """Inverted pendulum swing-up (gymnasium Pendulum-v1 dynamics) — the
    continuous-control (Box action) smoke env for SAC."""

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.length = 1.0
        self.max_steps = int(config.get("max_episode_steps", 200))
        self.observation_space = Space.box(-np.inf, np.inf, (3,))
        self.action_space = Space.box(-self.max_torque, self.max_torque, (1,))
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = None
        self._steps = 0

    def _obs(self):
        th, thdot = self._state
        return np.array([np.cos(th), np.sin(th), thdot], np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform([-np.pi, -1.0], [np.pi, 1.0])
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        th, thdot = self._state
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.max_torque, self.max_torque))
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.length) * np.sin(th)
                         + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        self._state = (th, thdot)
        self._steps += 1
        truncated = self._steps >= self.max_steps
        return self._obs(), -float(cost), False, truncated, {}


class CatchEnv:
    """Pixel-observation catch: a ball falls one row per step; the paddle
    on the bottom row moves left/stay/right. Observation is a (rows, cols,
    1) float image — the Atari-class smoke env for CNN modules (reference
    scope: ``rllib/env`` Atari wrappers; bsuite's Catch is the classic
    minimal pixel env shape).
    """

    def __init__(self, config: Optional[dict] = None):
        config = config or {}
        self.rows = int(config.get("rows", 10))
        self.cols = int(config.get("cols", 5))
        self.observation_space = Space.box(0.0, 1.0,
                                           (self.rows, self.cols, 1))
        self.action_space = Space.discrete(3)
        self._rng = np.random.default_rng(config.get("seed"))
        self._ball = None
        self._paddle = 0

    def _obs(self):
        img = np.zeros((self.rows, self.cols, 1), np.float32)
        r, c = self._ball
        img[r, c, 0] = 1.0
        img[self.rows - 1, self._paddle, 0] = 1.0
        return img

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ball = (0, int(self._rng.integers(self.cols)))
        self._paddle = self.cols // 2
        return self._obs(), {}

    def step(self, action: int):
        self._paddle = int(np.clip(self._paddle + (int(action) - 1),
                                   0, self.cols - 1))
        r, c = self._ball
        self._ball = (r + 1, c)
        if self._ball[0] == self.rows - 1:
            reward = 1.0 if self._ball[1] == self._paddle else -1.0
            return self._obs(), reward, True, False, {}
        return self._obs(), 0.0, False, False, {}


register_env("CartPole-v1", CartPoleEnv)
register_env("Pendulum-v1", PendulumEnv)
register_env("Catch-v0", CatchEnv)
def _cartpole_v0(cfg):
    return CartPoleEnv({**(cfg or {}), "max_episode_steps": 200})


register_env("CartPole-v0", _cartpole_v0)
register_env("CartPole-v1-vec", VecCartPoleEnv)
