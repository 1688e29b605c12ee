"""Token sampling: greedy / temperature / top-k (a copy of
``raytpu/inference/sampling.py``, which is already plain numpy).

Sampling runs on the HOST over one row of fp32 logits with a
*per-request* ``numpy`` RNG, never a shared key: a request's random
stream depends only on its own seed and how many tokens it has
sampled, so outputs are invariant to batch composition. A request that
decodes alone and the same request decoding inside a continuously
batched group produce identical tokens — the property the engine's
greedy-matches-reference tests pin down, and the property that makes
continuous batching an invisible optimization rather than a behavior
change.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling and stop configuration.

    ``temperature <= 0`` selects greedy decoding (``top_k`` ignored);
    ``top_k <= 0`` means no top-k truncation. ``stop_token_ids`` end
    the sequence as soon as one is sampled (the stop token IS emitted,
    matching the reference serve semantics of streaming every token).
    """

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: np.random.Generator) -> int:
    """Sample one token id from a ``[vocab]`` fp32 logits row."""
    logits = np.asarray(logits, dtype=np.float64)
    if params.temperature <= 0.0:
        return int(np.argmax(logits))
    scaled = logits / max(params.temperature, 1e-6)
    if params.top_k > 0 and params.top_k < scaled.shape[0]:
        kth = np.partition(scaled, -params.top_k)[-params.top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    scaled = scaled - np.max(scaled)
    probs = np.exp(scaled)
    probs /= probs.sum()
    return int(rng.choice(probs.shape[0], p=probs))
