"""raytpu_torch.util: the port of ``raytpu.util``'s serving-plane
observability, in-process only.

- :mod:`~raytpu_torch.util.metrics` — ``Counter`` / ``Gauge`` /
  ``Histogram`` with tags and the cardinality cap, and the
  ``DECLARED_METRICS`` table of every name the port mints;
- :mod:`~raytpu_torch.util.tracing` — spans, trace contexts, the local
  chrome-trace timeline, and ``profile`` over ``torch.profiler``;
- :mod:`~raytpu_torch.util.task_events` — the request lifecycle
  recorder (``RequestTransition``, ``emit_request``);
- :mod:`~raytpu_torch.util.serve_slo` — the serve SLO histograms and
  the goodput ledger;
- :mod:`~raytpu_torch.util.profiler` — the flag the step profiler reads;
- :mod:`~raytpu_torch.util.stepprof` — ``StepProfiler``: step times,
  MFU from an analytic FLOP count, device-memory gauges.

Nothing here ships to a head or serves a scrape endpoint: the port has
no runtime to ship through (ROADMAP.md).
"""
