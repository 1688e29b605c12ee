"""raytpu_torch.util: the port of ``raytpu.util``'s serving-plane
observability, in-process only, and the ambient tenant.

- :mod:`~raytpu_torch.util.metrics` — ``Counter`` / ``Gauge`` /
  ``Histogram`` with tags and the cardinality cap, the
  ``DECLARED_METRICS`` table of every name the port mints, delta frames
  shipped to the driver and ``start_metrics_server``;
- :mod:`~raytpu_torch.util.tracing` — spans, trace contexts (carried by
  every call of :mod:`raytpu_torch.runtime`), the local and the
  every-process chrome-trace timelines, and ``profile`` over
  ``torch.profiler``;
- :mod:`~raytpu_torch.util.task_events` — the flight recorder: task,
  actor, object and request transitions in a per-process ring, drained
  to the driver's ``TaskEventStore``;
- :mod:`~raytpu_torch.util.tsdb` — the driver's ``MetricStore`` and
  alert rules; :mod:`~raytpu_torch.util.metrics_export` — Prometheus
  and Grafana configs;
- :mod:`~raytpu_torch.util.serve_slo` — the serve SLO histograms and
  the goodput ledger;
- :mod:`~raytpu_torch.util.profiler` — the profiling flag, the sampling
  CPU profiler, flamegraphs and the continuous profiler whose frames
  ship to the driver's :mod:`~raytpu_torch.util.profstore`;
  :mod:`~raytpu_torch.util.memprofile` — allocation profiles
  (tracemalloc); :mod:`~raytpu_torch.util.stack_dump` — every process's
  stack, profile or spans, asked at once by the driver;
- :mod:`~raytpu_torch.util.http_server` — the HTTP/1.1 server (asyncio
  streams) that serve's proxy, the dashboard and the job server share;
- :mod:`~raytpu_torch.util.stepprof` — ``StepProfiler``: step times,
  MFU from an analytic FLOP count, device-memory gauges;
- :mod:`~raytpu_torch.util.tenancy` — the ambient tenant the serve
  router stamps into request metadata;
- :mod:`~raytpu_torch.util.failpoints` — named failpoints for chaos
  tests, armed in process or through ``RAYTPU_TORCH_FAILPOINTS``;
- :mod:`~raytpu_torch.util.events` — structured events (severity,
  label, fields) in a per-process ring, and a JSONL file where a log
  directory is set.

Each process's events and metric deltas ship to the driver
(:mod:`raytpu_torch.runtime.records`), which :mod:`raytpu_torch.state`
reads; spans are gathered on demand through the runtime's process tree
(``tracing.cluster_timeline``).

And the JAX package's ``raytpu.util`` names, its copies on the port's
runtime: :class:`ActorPool`, :class:`Queue` and the scheduling strategy
objects; :mod:`~raytpu_torch.util.usage_stats`, the libraries' local
usage record.
"""

from raytpu_torch.util.actor_pool import ActorPool
from raytpu_torch.util.queue import Queue
from raytpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy, PlacementGroupSchedulingStrategy)

__all__ = ["ActorPool", "Queue", "NodeAffinitySchedulingStrategy",
           "PlacementGroupSchedulingStrategy"]
