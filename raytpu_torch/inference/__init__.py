"""raytpu_torch.inference: the port of ``raytpu.inference``'s engine.

- :mod:`~raytpu_torch.inference.kv_cache` — paged KV cache with device
  tensor pools and host-side block tables;
- :mod:`~raytpu_torch.inference.prefix_cache` — content-hash prompt-page
  cache;
- :mod:`~raytpu_torch.inference.scheduler` — continuous-batching
  scheduler with preempt-to-recompute;
- :mod:`~raytpu_torch.inference.sampling` — greedy / temperature / top-k
  sampling with per-request RNGs;
- :mod:`~raytpu_torch.inference.engine` — :class:`InferenceEngine`.

``serving.py`` (``LLMDeployment``) and ``disagg.py`` need the serve
fabric and are not ported yet.
"""

from raytpu_torch.inference.kv_cache import PagedKVCache
from raytpu_torch.inference.prefix_cache import PrefixCache
from raytpu_torch.inference.sampling import SamplingParams
from raytpu_torch.inference.scheduler import Scheduler, Sequence
from raytpu_torch.inference.engine import InferenceEngine, StepOutput

__all__ = ["InferenceEngine", "PagedKVCache", "PrefixCache",
           "SamplingParams", "Scheduler", "Sequence", "StepOutput"]
