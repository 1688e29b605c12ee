"""raytpu_torch.util: the port of ``raytpu.util``'s serving-plane
observability, in-process only, and the ambient tenant.

- :mod:`~raytpu_torch.util.metrics` — ``Counter`` / ``Gauge`` /
  ``Histogram`` with tags and the cardinality cap, and the
  ``DECLARED_METRICS`` table of every name the port mints;
- :mod:`~raytpu_torch.util.tracing` — spans, trace contexts (carried by
  every call of :mod:`raytpu_torch.runtime`), the local and the
  every-process chrome-trace timelines, and ``profile`` over
  ``torch.profiler``;
- :mod:`~raytpu_torch.util.task_events` — the request lifecycle
  recorder (``RequestTransition``, ``emit_request``);
- :mod:`~raytpu_torch.util.serve_slo` — the serve SLO histograms and
  the goodput ledger;
- :mod:`~raytpu_torch.util.profiler` — the flag the step profiler reads;
- :mod:`~raytpu_torch.util.stepprof` — ``StepProfiler``: step times,
  MFU from an analytic FLOP count, device-memory gauges;
- :mod:`~raytpu_torch.util.tenancy` — the ambient tenant the serve
  router stamps into request metadata;
- :mod:`~raytpu_torch.util.failpoints` — named failpoints for chaos
  tests, armed in process or through ``RAYTPU_TORCH_FAILPOINTS``;
- :mod:`~raytpu_torch.util.events` — structured events (severity,
  label, fields) in a per-process ring, and a JSONL file where a log
  directory is set.

Nothing here ships to a head or serves a scrape endpoint: the port has
no cluster head (ROADMAP.md); spans are gathered on demand through the
runtime's process tree (``tracing.cluster_timeline``).
"""
