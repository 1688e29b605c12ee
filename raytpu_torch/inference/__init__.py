"""raytpu_torch.inference: the port of ``raytpu.inference``'s engine.

- :mod:`~raytpu_torch.inference.kv_cache` — paged KV cache with device
  tensor pools and host-side block tables;
- :mod:`~raytpu_torch.inference.prefix_cache` — content-hash prompt-page
  cache;
- :mod:`~raytpu_torch.inference.scheduler` — continuous-batching
  scheduler with preempt-to-recompute;
- :mod:`~raytpu_torch.inference.sampling` — greedy / temperature / top-k
  sampling with per-request RNGs;
- :mod:`~raytpu_torch.inference.engine` — :class:`InferenceEngine`;
- :mod:`~raytpu_torch.inference.serving` — :class:`LLMDeployment`, the
  replica body: a stepping loop of its own, streamed tokens, aborts;
- :mod:`~raytpu_torch.inference.disagg` — the KV-page handoff from a
  prefill replica to a decode replica.

The serve fabric that hosts a deployment (``@deployment``, the router,
the replica actor) is not ported yet.
"""

from raytpu_torch.inference.kv_cache import PagedKVCache
from raytpu_torch.inference.prefix_cache import PrefixCache
from raytpu_torch.inference.sampling import SamplingParams
from raytpu_torch.inference.scheduler import Scheduler, Sequence
from raytpu_torch.inference.engine import InferenceEngine, StepOutput
from raytpu_torch.inference.serving import LLMDeployment

__all__ = ["InferenceEngine", "LLMDeployment", "PagedKVCache",
           "PrefixCache", "SamplingParams", "Scheduler", "Sequence",
           "StepOutput"]
