"""User-defined metrics: Counter / Gauge / Histogram; the port of
``raytpu/util/metrics.py``, in memory only.

The JAX package registers every metric with ``prometheus_client`` as
well and ships registry deltas to the head's store; the port does
neither (no head to ship to, ROADMAP.md, and registering the same
``raytpu_infer_*`` names would collide with the JAX package's in a
process that imports both). Values are read through ``value`` /
``values`` / ``observations`` / ``observations_by_tag``.

Tag-cardinality bound: each metric holds at most ``_MAX_SERIES``
(``RAYTPU_METRIC_MAX_SERIES``) distinct tag-sets; overflow folds into a
``{"tag": "<other>"}`` series and bumps
``raytpu_metrics_series_dropped_total``, with reserved headroom for
series that carry a real ``tenant`` tag.

Every metric name the port constructs is declared in
:data:`DECLARED_METRICS` (``tests/test_torch_port_rules.py`` checks the
call sites, as the JAX package's lint rule RTP015 does).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0, 30.0, 60.0)

# Every metric name the port itself constructs: the JAX package's names
# for the same series. Keep alphabetized within each section.
DECLARED_METRICS: Dict[str, str] = {
    # -- inference serving ---------------------------------------------
    "raytpu_infer_decode_mfu": "model FLOPs utilization per decode step",
    "raytpu_infer_decode_tokens_per_s": "decode throughput",
    "raytpu_infer_decode_tokens_total": "decode tokens generated",
    "raytpu_infer_handoff_aborts_total":
        "KV handoffs aborted mid-stream (peer death, TTL sweep)",
    "raytpu_infer_handoff_bytes_total":
        "payload bytes streamed in cross-replica KV handoffs",
    "raytpu_infer_handoff_fallbacks_total":
        "disaggregated pulls that fell back to a local prefill",
    "raytpu_infer_handoff_pages_total":
        "KV pages grafted via disaggregated prefill->decode handoff",
    "raytpu_infer_kv_page_utilization": "KV page pool utilization 0..1",
    "raytpu_infer_prefill_tokens_per_s": "prefill throughput",
    "raytpu_infer_prefill_tokens_total": "prefill tokens processed",
    "raytpu_infer_prefix_evictions_total": "prefix cache evictions",
    "raytpu_infer_prefix_hit_tokens_total": "prefix cache tokens reused",
    "raytpu_infer_prefix_hits_total": "prefix cache lookup hits",
    "raytpu_infer_prefix_lookups_total": "prefix cache lookups",
    "raytpu_infer_running_requests": "requests in the running batch",
    "raytpu_infer_step_seconds": "decode step wall time",
    "raytpu_infer_ttft_seconds": "time-to-first-token distribution",
    "raytpu_infer_waiting_requests": "requests queued for admission",
    # -- step profiling ------------------------------------------------
    "raytpu_hbm_peak_bytes": "device memory high-water mark",
    "raytpu_hbm_used_bytes": "device memory in use",
    "raytpu_train_mfu": "model FLOPs utilization per train step",
    "raytpu_train_step_seconds": "train step wall time",
    # -- serve ---------------------------------------------------------
    "raytpu_serve_e2e_seconds":
        "request end-to-end latency, by deployment and tenant",
    "raytpu_serve_queue_seconds":
        "replica queue wait (enqueue to semaphore)",
    "raytpu_serve_requests_total":
        "serve requests routed, by deployment and tenant",
    "raytpu_serve_tokens_delivered_total":
        "tokens streamed to consumers, by deployment and tenant",
    "raytpu_serve_tokens_wasted_total":
        "tokens whose work was discarded, by cause",
    "raytpu_serve_tpot_seconds":
        "inter-token latency (time per output token)",
    "raytpu_serve_ttft_seconds":
        "request time-to-first-token, by deployment and tenant",
    # -- metrics themselves --------------------------------------------
    "raytpu_metrics_series_dropped_total":
        "tag-sets folded into <other> by the cardinality cap",
}

# Tag-cardinality cap: distinct tag-sets per metric before folding into
# the ``<other>`` series. Module global so tests can patch it.
ENV_MAX_SERIES = "RAYTPU_METRIC_MAX_SERIES"
_MAX_SERIES = int(os.environ.get(ENV_MAX_SERIES, "") or 128)
OTHER_TAG_VALUE = "<other>"

# Reserved headroom past the cap for series carrying a REAL "tenant" tag
# value: per-tenant SLO series must not fold into ``<other>`` just
# because a free-form tag family filled the table first.
ENV_TENANT_RESERVED = "RAYTPU_METRIC_TENANT_RESERVED"
_TENANT_RESERVED = int(os.environ.get(ENV_TENANT_RESERVED, "") or 32)


def _sanitize(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


class _Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        self._name = _sanitize(name)
        self._description = description
        self._tag_keys: Tuple[str, ...] = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def set_default_tags(self, tags: Dict[str, str]) -> "_Metric":
        unknown = set(tags) - set(self._tag_keys)
        if unknown:
            raise ValueError(f"unknown tag keys: {sorted(unknown)}")
        self._default_tags = dict(tags)
        return self

    def _tag_tuple(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = {**self._default_tags, **(tags or {})}
        missing = set(self._tag_keys) - set(merged)
        if missing:
            raise ValueError(f"missing tag values for {sorted(missing)}")
        return tuple(merged[k] for k in self._tag_keys)

    def _fold(self, key: Tuple, table: Dict) -> Tuple[Tuple, bool]:
        """Cardinality cap (caller holds ``self._lock``): a key beyond
        ``_MAX_SERIES`` distinct tag-sets folds into the ``<other>``
        series. Keys whose "tenant" tag carries a real value get the
        reserved headroom (``_TENANT_RESERVED``) before folding. Every
        fold counts in ``raytpu_metrics_series_dropped_total`` tagged
        with the metric name."""
        if not self._tag_keys or key in table or len(table) < _MAX_SERIES:
            return key, False
        if "tenant" in self._tag_keys and \
                len(table) < _MAX_SERIES + _TENANT_RESERVED:
            tv = key[self._tag_keys.index("tenant")]
            if tv and tv != OTHER_TAG_VALUE:
                return key, False
        return (OTHER_TAG_VALUE,) * len(self._tag_keys), True


class Counter(_Metric):
    """Monotonic counter (reference: ``ray.util.metrics.Counter``)."""

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        key = self._tag_tuple(tags)
        with self._lock:
            key, folded = self._fold(key, self._values)
            self._values[key] = self._values.get(key, 0.0) + value
        if folded:
            _note_series_drop(self._name)

    @property
    def value(self) -> float:
        """The sum over every tag-set."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    """Point-in-time value (reference: ``ray.util.metrics.Gauge``)."""

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        key = self._tag_tuple(tags)
        with self._lock:
            key, folded = self._fold(key, self._values)
            self._values[key] = value
        if folded:
            _note_series_drop(self._name)

    @property
    def value(self) -> float:
        """The untagged value when one was set; otherwise the most
        recently introduced tag set's value (only deterministic for
        single-tag-set gauges)."""
        with self._lock:
            if () in self._values:
                return self._values[()]
            vals = list(self._values.values())
            return vals[-1] if vals else 0.0

    @property
    def values(self) -> Dict[Tuple, float]:
        """Per-tag-tuple snapshot (keys ordered by ``tag_keys``)."""
        with self._lock:
            return dict(self._values)


class Histogram(_Metric):
    """Bucketed distribution (reference: ``ray.util.metrics.Histogram``).
    The port keeps every observation; ``boundaries`` are the buckets a
    scrape would report."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        self._boundaries = tuple(boundaries or _DEFAULT_BUCKETS)
        super().__init__(name, description, tag_keys)
        self._observations: List[float] = []
        self._by_key: Dict[Tuple, List[float]] = {}

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        key = self._tag_tuple(tags)
        with self._lock:
            key, folded = self._fold(key, self._by_key)
            self._observations.append(value)
            self._by_key.setdefault(key, []).append(value)
        if folded:
            _note_series_drop(self._name)

    @property
    def observations(self) -> List[float]:
        """All observations in arrival order (tag-blind); per-tag series
        live in :attr:`observations_by_tag`."""
        with self._lock:
            return list(self._observations)

    @property
    def observations_by_tag(self) -> Dict[Tuple, List[float]]:
        """Observations keyed by tag tuple (ordered by ``tag_keys``)."""
        with self._lock:
            return {k: list(v) for k, v in self._by_key.items()}


# The fold counter is created lazily (the class must exist first) and
# never reports on itself: its own key space is bounded by the set of
# metric names, but self-reporting could recurse through ``inc``.
_series_dropped: Optional[Counter] = None
_series_dropped_lock = threading.Lock()


def _note_series_drop(metric_name: str) -> None:
    global _series_dropped
    if metric_name == "raytpu_metrics_series_dropped_total":
        return
    with _series_dropped_lock:
        if _series_dropped is None:
            _series_dropped = Counter(
                "raytpu_metrics_series_dropped_total",
                "tag-sets folded into <other> by the cardinality cap",
                tag_keys=("metric",))
    _series_dropped.inc(tags={"metric": metric_name})
