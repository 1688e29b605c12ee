"""Replica-count autoscaling decisions from queue + engine metrics; the
port's copy of :mod:`raytpu.serve._private.autoscaling_policy`, as it is.

Reference analogue: ``python/ray/serve/_private/autoscaling_policy.py`` —
``AutoscalingPolicyManager.get_decision_num_replicas`` (``:12,30``): target
replicas = total (queued + ongoing) requests / target_ongoing_requests,
smoothed, bounded by [min, max], with upscale/downscale hysteresis windows
so transient spikes don't thrash replica churn (each churn on TPU costs a
re-jit warm-up, so the downscale delay defaults higher than the upscale).

For LLM deployments the request count alone under-reads load: one
request can pin a whole engine (long prompt, deep KV), and queueing
happens INSIDE the engine's admission queue where the router can't see
it. :class:`EnginePressure` carries the engine's own gauges
(``raytpu_infer_waiting_requests``, ``raytpu_infer_kv_page_utilization``,
TTFT p95) up from the replicas; the raw replica demand becomes the MAX
of the request-based estimate and each pressure-based one, and the same
smoothing + hysteresis applies after.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

from raytpu_torch.serve.config import AutoscalingConfig


@dataclasses.dataclass(frozen=True)
class EnginePressure:
    """Aggregated engine load across a deployment's replicas: summed
    admission-queue depth, worst KV-page occupancy, worst TTFT p95."""

    waiting_requests: float = 0.0
    kv_utilization: float = 0.0
    ttft_p95_s: float = 0.0


class AutoscalingPolicyManager:
    def __init__(self, config: AutoscalingConfig):
        self.config = config
        self._upscale_since: Optional[float] = None
        self._downscale_since: Optional[float] = None

    def _raw_demand(self, total_requests: float, current: int,
                    pressure: Optional[EnginePressure]) -> float:
        c = self.config
        raw = total_requests / c.target_ongoing_requests
        if pressure is None:
            return raw
        # Engine admission queue: tokens of demand the router can't
        # see. Scale so each replica carries target_engine_waiting.
        raw = max(raw, pressure.waiting_requests / c.target_engine_waiting)
        # KV occupancy: current replicas hold util*current "replicas
        # worth" of pages; above target, more replicas are needed to
        # bring per-replica occupancy back under it.
        if pressure.kv_utilization > c.target_kv_utilization:
            raw = max(raw, max(current, 1)
                      * pressure.kv_utilization / c.target_kv_utilization)
        if (c.target_ttft_s is not None
                and pressure.ttft_p95_s > c.target_ttft_s):
            raw = max(raw, max(current, 1)
                      * pressure.ttft_p95_s / c.target_ttft_s)
        return raw

    def desired(self, total_requests: float, current: int,
                pressure: Optional[EnginePressure] = None) -> int:
        c = self.config
        raw = self._raw_demand(total_requests, current, pressure)
        if raw > current:
            smoothed = current + (raw - current) * c.upscale_smoothing_factor
            target = math.ceil(smoothed)
        else:
            smoothed = current - (current - raw) * c.downscale_smoothing_factor
            target = math.ceil(smoothed)
        return max(c.min_replicas, min(c.max_replicas, target))

    def get_decision_num_replicas(
        self, total_requests: float, current: int,
        now: Optional[float] = None,
        engine_pressure: Optional[EnginePressure] = None,
    ) -> Optional[int]:
        """Return a new target or None (no change yet)."""
        now = time.monotonic() if now is None else now
        target = self.desired(total_requests, current, engine_pressure)
        if target > current:
            self._downscale_since = None
            if self._upscale_since is None:
                self._upscale_since = now
            if now - self._upscale_since >= self.config.upscale_delay_s:
                self._upscale_since = None
                return target
            return None
        if target < current:
            self._upscale_since = None
            if self._downscale_since is None:
                self._downscale_since = now
            if now - self._downscale_since >= self.config.downscale_delay_s:
                self._downscale_since = None
                return target
            return None
        self._upscale_since = None
        self._downscale_since = None
        return None
