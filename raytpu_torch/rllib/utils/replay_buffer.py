"""Replay buffers (reference analogue:
``rllib/utils/replay_buffers/replay_buffer.py``).

The port's copy of :mod:`raytpu.rllib.utils.replay_buffer` (numpy only,
unchanged): the port imports nothing of ``raytpu``, so it keeps its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform circular transition buffer over numpy struct-of-arrays."""

    def __init__(self, capacity: int = 100_000,
                 seed: Optional[int] = None):
        self.capacity = capacity
        self._rng = np.random.default_rng(seed)
        self._store: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]) -> None:
        """Add flat transitions: every value shaped (N, ...)."""
        n = len(next(iter(batch.values())))
        if not self._store:
            for k, v in batch.items():
                v = np.asarray(v)
                self._store[k] = np.zeros((self.capacity,) + v.shape[1:],
                                          v.dtype)
        for k, v in batch.items():
            v = np.asarray(v)
            idx = (self._next + np.arange(n)) % self.capacity
            self._store[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self.capacity, self._size + n)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._store.items()}
