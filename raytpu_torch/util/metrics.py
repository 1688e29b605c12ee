"""User-defined metrics: Counter / Gauge / Histogram, and the shipping
pipeline to the driver's store; the port of ``raytpu/util/metrics.py``.

Values are kept in memory and read through ``value`` / ``values`` /
``observations`` / ``observations_by_tag``. The JAX package also
registers every metric with ``prometheus_client``; the port does not
(registering the same ``raytpu_infer_*`` names would collide with the
JAX package's in a process that imports both, and the card's machine
may not have the package).

Shipping (the JAX package's cluster pipeline, ``:430-556``): a process
snapshots its metrics' *deltas* (counter increments, gauge last-values,
histogram bucket increments) into primitive-only frames
(:func:`collect`), which ride to the driver's
:class:`~raytpu_torch.util.tsdb.MetricStore`
(:mod:`raytpu_torch.runtime.records`): on an actor's ship timer, and
with a task worker's done message. Same bounded-buffer /
requeue-on-failure contract as task-event shipping. As in the JAX
package, shipping is on unless ``RAYTPU_METRICS_SHIP`` is ``0``,
``false`` or ``False`` (:func:`enable_metrics_ship` turns it on or off
in process); disarmed, each ship site costs a single flag check
(:func:`enabled`).
:func:`start_metrics_server` serves the driver's store as Prometheus
text at ``/metrics``, as the JAX head's dashboard does.

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

import bisect
import os
import threading
import time
import weakref
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0, 30.0, 60.0)
_registry_lock = threading.Lock()
_instances: "weakref.WeakSet[_Metric]" = weakref.WeakSet()

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
        self._ship_state: Dict[Tuple, object] = {}
        with _registry_lock:
            _instances.add(self)

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

    def _delta_rows(self) -> List[list]:
        raise NotImplementedError


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

    def _delta_rows(self) -> List[list]:
        rows: List[list] = []
        with self._lock:
            for key, val in self._values.items():
                inc = val - self._ship_state.get(key, 0.0)
                if inc > 0:
                    rows.append(["c", self._name, list(self._tag_keys),
                                 list(key), inc])
                    self._ship_state[key] = val
        return rows


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

    def _delta_rows(self) -> List[list]:
        # Gauges ship every live tag-set each interval (not just on
        # change) so steady values still produce points.
        with self._lock:
            return [["g", self._name, list(self._tag_keys), list(key), val]
                    for key, val in self._values.items()]


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

    def _delta_rows(self) -> List[list]:
        rows: List[list] = []
        with self._lock:
            for key, obs in self._by_key.items():
                idx = self._ship_state.get(key, 0)
                new = obs[idx:]
                if not new:
                    continue
                counts = [0] * (len(self._boundaries) + 1)
                for v in new:
                    counts[bisect.bisect_left(self._boundaries, v)] += 1
                rows.append(["h", self._name, list(self._tag_keys),
                             list(key), list(self._boundaries), counts,
                             float(sum(new)), len(new)])
                self._ship_state[key] = len(obs)
        return rows


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


# ---------------------------------------------------------------------------
# Shipping: metric deltas -> primitive frames -> the driver's TSDB.
#
# Frame shape (primitives only):
#   [proc_id, seq, ts, rows]
# with rows one of
#   ["c", name, [tag_keys], [tag_vals], increment]
#   ["g", name, [tag_keys], [tag_vals], last_value]
#   ["h", name, [tag_keys], [tag_vals], [boundaries], [bucket_incs],
#    sum_inc, count_inc]
# ``seq`` is per-origin monotonic; the store drops seq <= last-applied so
# a requeued-and-reshipped frame merges idempotently.
# ---------------------------------------------------------------------------

ENV_SHIP = "RAYTPU_METRICS_SHIP"
ENV_BUFFER_MAX = "RAYTPU_METRICS_BUFFER_MAX"

_BUFFER_MAX = int(os.environ.get(ENV_BUFFER_MAX, "") or 256)
_ship_enabled = os.environ.get(ENV_SHIP, "") not in ("0", "false", "False")
_ship_lock = threading.Lock()
_frames: Deque[list] = deque()
_frames_dropped_total = 0
_frames_dropped_shipped = 0  # watermark: drops already reported downstream
_ship_seq = 0
_last_collect = [0.0]
_proc_id = [""]


def enabled() -> bool:
    """THE flag check: every ship site guards with exactly this call, so
    shipping disarmed costs one boolean read per tick."""
    return _ship_enabled


def enable_metrics_ship(env: bool = False) -> None:
    """Arm shipping. ``env=True`` exports ``RAYTPU_METRICS_SHIP=1`` so
    child processes inherit it (arm before the first child starts)."""
    global _ship_enabled
    _ship_enabled = True
    if env:
        os.environ[ENV_SHIP] = "1"


def disable_metrics_ship(env: bool = False) -> None:
    """Disarm shipping; ``env=True`` sets ``RAYTPU_METRICS_SHIP=0`` for
    children (the JAX package's default is on, so its disable writes
    ``0`` rather than unsetting the variable; the port keeps that)."""
    global _ship_enabled
    _ship_enabled = False
    if env:
        os.environ[ENV_SHIP] = "0"


def set_shipper_identity(proc_id: str) -> None:
    """Stamp outgoing frames with this process's identity
    (``driver:<hex12>`` / ``worker:<hex12>.<hex12>``, the first hex12
    drawn afresh in each process after its fork). The driver tombstones
    a reaped worker's series by it."""
    _proc_id[0] = str(proc_id)


def shipper_identity() -> str:
    return _proc_id[0] or f"pid:{os.getpid()}"


def collect(min_interval_s: float = 0.0, force: bool = False,
            now: Optional[float] = None) -> bool:
    """Snapshot metric deltas into one pending frame. Rate-limited by
    ``min_interval_s`` so a fast loop can call it every beat. Returns
    True iff a frame was produced."""
    if not _ship_enabled:
        return False
    if now is None:
        now = time.time()
    with _ship_lock:
        if not force and min_interval_s > 0 and \
                now - _last_collect[0] < min_interval_s:
            return False
        _last_collect[0] = now
    with _registry_lock:
        insts = list(_instances)
    rows: List[list] = []
    for m in insts:
        rows.extend(m._delta_rows())
    if not rows:
        return False
    global _ship_seq, _frames_dropped_total
    with _ship_lock:
        _ship_seq += 1
        frame = [shipper_identity(), _ship_seq, now, rows]
        if len(_frames) >= _BUFFER_MAX:
            _frames.popleft()
            _frames_dropped_total += 1
        _frames.append(frame)
    return True


def drain() -> Tuple[List[list], int]:
    """Take everything pending plus the not-yet-reported drop delta.
    On ship failure hand both back via :func:`requeue`: the watermark
    arithmetic keeps drop counts exact across retries."""
    global _frames_dropped_shipped
    with _ship_lock:
        frames = list(_frames)
        _frames.clear()
        dropped_delta = _frames_dropped_total - _frames_dropped_shipped
        _frames_dropped_shipped = _frames_dropped_total
    return frames, dropped_delta


def requeue(frames: List[list], dropped: int = 0) -> None:
    """Put a failed ship back at the FRONT of the buffer (oldest-first
    order preserved); overflow drops the oldest of the requeued batch."""
    if not frames and not dropped:
        return
    global _frames_dropped_total, _frames_dropped_shipped
    with _ship_lock:
        _frames_dropped_shipped -= dropped
        space = _BUFFER_MAX - len(_frames)
        if len(frames) > space:
            lost = len(frames) - max(space, 0)
            frames = frames[lost:]
            _frames_dropped_total += lost
        _frames.extendleft(reversed(frames))


def ingest(frames: List[list], dropped: int = 0) -> None:
    """Relay path: absorb another process's drained frames into this
    process's buffer; they ride its next ship."""
    global _frames_dropped_total
    with _ship_lock:
        _frames_dropped_total += int(dropped or 0)
        for f in frames or ():
            if len(_frames) >= _BUFFER_MAX:
                _frames.popleft()
                _frames_dropped_total += 1
            _frames.append(f)


def pending_frames() -> int:
    with _ship_lock:
        return len(_frames)


def reset_shipping() -> None:
    """Test isolation: clear the buffer, counters, and every metric's
    per-instance ship watermarks (so totals re-ship as fresh deltas)."""
    global _frames_dropped_total, _frames_dropped_shipped, _ship_seq
    with _ship_lock:
        _frames.clear()
        _frames_dropped_total = 0
        _frames_dropped_shipped = 0
        _ship_seq = 0
        _last_collect[0] = 0.0
    with _registry_lock:
        insts = list(_instances)
    for m in insts:
        with m._lock:
            m._ship_state.clear()


# ---------------------------------------------------------------------------
# The scrape endpoint: the driver's TSDB as Prometheus text.
# ---------------------------------------------------------------------------

_servers: Dict[int, tuple] = {}  # port -> (http server, thread)
_server_lock = threading.Lock()


def start_metrics_server(port: int = 8090) -> bool:
    """Serve ``GET /metrics``: the exposition of the driver's store
    (every process's shipped series, labeled by ``proc``;
    :func:`raytpu_torch.runtime.records.prometheus_text`), on
    ``http.server`` at ``127.0.0.1:port``. Idempotent per port; a second
    caller asking for a DIFFERENT port gets its own endpoint."""
    import http.server

    from raytpu_torch.runtime import records

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (the http.server name)
            if self.path.split("?", 1)[0] != "/metrics":
                self.send_error(404)
                return
            body = records.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # a scrape is not news
            pass

    with _server_lock:
        if port in _servers:
            return True
        server = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                 _Handler)
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name=f"raytpu-metrics-{port}",
                                  daemon=True)
        thread.start()
        _servers[port] = (server, thread)
        return True


def stop_metrics_server(port: int) -> None:
    """Shut down the scrape endpoint on ``port`` (no-op if not running)."""
    with _server_lock:
        entry = _servers.pop(port, None)
    if entry is None:
        return
    server, thread = entry
    server.shutdown()
    # shutdown() only stops the serve loop; the listening socket stays
    # bound until closed.
    server.server_close()
    thread.join(timeout=5)
