"""Connector pipelines — env↔module data transforms.

Reference analogue: ``rllib/connectors/`` (connector pipelines v2): small
composable transforms between the env's raw observations/actions and what
the RLModule consumes/produces, applied in the env runner on both
directions. Ours keeps the same split:

- **env→module** connectors transform each observation batch *before* the
  policy forward (and that transformed view is what lands in the sample
  fragment, so learners train on exactly what the policy saw).
- **module→env** connectors transform each action batch before
  ``env.step``.

Connectors may be stateful per env slot (``FrameStack``); state resets
when the runner reports a done. ``transform_obs_shape`` lets
AlgorithmConfig compute the module's observation shape without building a
runner.

The port's copy of :mod:`raytpu.rllib.connectors` (numpy only,
unchanged): the port imports nothing of ``raytpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


class Connector:
    """One transform. Batched: obs is (B, ...), actions (B, ...)."""

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        return batch

    def peek(self, batch: np.ndarray) -> np.ndarray:
        """Transform without advancing connector state (used for the
        bootstrap observation at fragment boundaries — the same obs is
        re-transformed for real at the next fragment's first step)."""
        return self(batch)

    def transform_obs_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return shape

    def on_episode_done(self, env_index: int) -> None:
        pass


class ObsScaler(Connector):
    """Multiply observations by a constant (e.g. 1/255 for uint8 pixels)."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def __call__(self, obs):
        return np.asarray(obs, np.float32) * self.scale


class FlattenObs(Connector):
    """Flatten structured observations to (B, -1) for MLP modules."""

    def __call__(self, obs):
        obs = np.asarray(obs)
        return obs.reshape(obs.shape[0], -1)

    def transform_obs_shape(self, shape):
        return (int(np.prod(shape)),)


class FrameStack(Connector):
    """Stack the last ``k`` observations on the channel axis (classic
    Atari preprocessing; reference: ``rllib/connectors/env_to_module/
    frame_stacking.py``). Stateful per env slot; resets on done."""

    def __init__(self, k: int):
        self.k = int(k)
        self._frames: Optional[np.ndarray] = None  # (B, ..., C*k)

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        if self._frames is None or self._frames.shape[0] != obs.shape[0]:
            self._frames = np.concatenate([obs] * self.k, axis=-1)
        else:
            c = obs.shape[-1]
            self._frames = np.concatenate(
                [self._frames[..., c:], obs], axis=-1)
        return self._frames

    def peek(self, obs):
        obs = np.asarray(obs, np.float32)
        if self._frames is None or self._frames.shape[0] != obs.shape[0]:
            return np.concatenate([obs] * self.k, axis=-1)
        c = obs.shape[-1]
        return np.concatenate([self._frames[..., c:], obs], axis=-1)

    def transform_obs_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] * self.k,)

    def on_episode_done(self, env_index: int) -> None:
        if self._frames is not None:
            # Zero the stale history; the post-reset episode starts with
            # zero-padded frames (standard Atari frame-stack semantics).
            self._frames[env_index] = 0.0


class ClipActions(Connector):
    """module→env: clip continuous actions into the env's Box bounds."""

    def __init__(self, low: float, high: float):
        self.low = float(low)
        self.high = float(high)

    def __call__(self, actions):
        return np.clip(np.asarray(actions), self.low, self.high)


class ConnectorPipeline:
    def __init__(self, connectors: Optional[Sequence[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, batch):
        for c in self.connectors:
            batch = c(batch)
        return batch

    def peek(self, batch):
        for c in self.connectors:
            batch = c.peek(batch)
        return batch

    def transform_obs_shape(self, shape):
        for c in self.connectors:
            shape = c.transform_obs_shape(tuple(shape))
        return tuple(shape)

    def on_episode_done(self, env_index: int) -> None:
        for c in self.connectors:
            c.on_episode_done(env_index)

    def __len__(self):
        return len(self.connectors)
