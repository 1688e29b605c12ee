"""The driver's bounded time-series store and SLO alert evaluator; a
copy of ``raytpu/util/tsdb.py``.

The JAX package keeps this TSDB inside its cluster head; the port's
driver holds one (:mod:`raytpu_torch.runtime.records`), fed by the
metric delta frames every process of the tree ships
(:mod:`raytpu_torch.util.metrics`), so the runtime can answer "what is
the tree doing right now, and what was it doing 10 minutes ago" without
any external scrape infrastructure.

Bounds (all hard, all enforced here):

- per series a **fine ring** (``fine_slots`` buckets of ``fine_step_s``,
  default 120 x 5 s = 10 min) and a **coarse ring** (``coarse_slots`` x
  ``coarse_step_s``, default 120 x 30 s = 1 h). When a fine slot is
  reused its old bucket *folds* into the coarse ring (staircase
  downsampling: counters sum, gauges keep the latest value, histogram
  buckets add): recent history is sharp, old history survives coarse;
- tag-sets are interned (one tuple shared by every series with the same
  tags) and every series carries an implicit ``proc`` tag, which is what
  makes cross-process aggregation a plain group-by;
- a byte-estimate accounting with per-kind FIFO eviction (like
  ``TaskEventStore``) keeps the whole store under ``max_bytes``;
- per-origin ``seq`` dedup makes delta pushes idempotent: a frame
  requeued by a failed ship and shipped twice applies once;
- dead processes are tombstoned (:meth:`mark_proc_dead`): their series
  drop and late frames from them are rejected, so a reaped worker can't
  resurrect stale series.

The store is clock-injectable (``clock=``) so ring/downsample/eviction
invariants are testable under a fake clock.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

QUANTILE_AGGS = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99}
AGGS = ("sum", "max", "min", "avg", "rate") + tuple(QUANTILE_AGGS)


class _Series:
    __slots__ = ("kind", "name", "tags", "boundaries", "cost",
                 "fine_ts", "fine_val", "coarse_ts", "coarse_val",
                 "total", "last", "last_ts",
                 "bucket_totals", "sum_total", "count_total")

    def __init__(self, kind: str, name: str, tags: Tuple[Tuple[str, str], ...],
                 fine_slots: int, coarse_slots: int,
                 boundaries: Optional[Tuple[float, ...]] = None):
        self.kind = kind
        self.name = name
        self.tags = tags
        self.boundaries = boundaries
        self.fine_ts = [0.0] * fine_slots
        self.fine_val: List[object] = [None] * fine_slots
        self.coarse_ts = [0.0] * coarse_slots
        self.coarse_val: List[object] = [None] * coarse_slots
        self.total = 0.0          # counters: cumulative sum of increments
        self.last = 0.0           # gauges: most recent value
        self.last_ts = 0.0
        nb = len(boundaries) + 1 if boundaries else 0
        self.bucket_totals = [0] * nb   # histograms: cumulative buckets
        self.sum_total = 0.0
        self.count_total = 0
        slots = fine_slots + coarse_slots
        per_slot = 16 + (nb + 2) * 8 if kind == "h" else 16
        self.cost = 200 + slots * per_slot + \
            sum(len(k) + len(str(v)) for k, v in tags)

    def _zero(self):
        if self.kind == "h":
            nb = len(self.boundaries) + 1
            return [[0] * nb, 0.0, 0]     # [bucket_incs, sum_inc, count_inc]
        return 0.0

    def _merge(self, slot_val, add):
        if self.kind == "g":
            return add                     # latest value wins
        if self.kind == "h":
            counts, s, c = slot_val
            acounts, asum, acount = add
            for i, v in enumerate(acounts):
                counts[i] += v
            return [counts, s + asum, c + acount]
        return slot_val + add              # counter: increments sum


class MetricStore:
    """Bounded in-memory TSDB behind the driver's state queries."""

    def __init__(self, max_bytes: int = 8_000_000,
                 fine_step_s: float = 5.0, fine_slots: int = 120,
                 coarse_step_s: float = 30.0, coarse_slots: int = 120,
                 clock: Callable[[], float] = time.time):
        self.max_bytes = int(max_bytes)
        self.fine_step = float(fine_step_s)
        self.fine_slots = int(fine_slots)
        self.coarse_step = float(coarse_step_s)
        self.coarse_slots = int(coarse_slots)
        self._clock = clock
        self._lock = threading.Lock()
        # (name, interned-tags) -> _Series, insertion-ordered per kind
        # for FIFO eviction.
        self._series: Dict[str, OrderedDict] = {
            "c": OrderedDict(), "g": OrderedDict(), "h": OrderedDict()}
        self._tag_intern: Dict[Tuple, Tuple] = {}
        self._bytes = 0
        self._proc_seq: Dict[str, int] = {}
        self._dead_procs: set = set()      # hex12 node prefixes
        self.frames_applied = 0
        self.frames_deduped = 0
        self.frames_rejected = 0           # tombstoned origin
        self.rows_dropped = 0              # malformed / kind conflict
        self.series_evicted = 0
        self.upstream_drops = 0            # frames lost before reaching us

    # -- ingest ------------------------------------------------------------

    def push(self, frames: List[list]) -> int:
        """Apply shipped delta frames; returns how many frames applied.
        Idempotent per origin: ``seq`` <= last-applied is a duplicate
        (a requeued-and-reshipped frame merges once)."""
        applied = 0
        with self._lock:
            for frame in frames or ():
                try:
                    proc, seq, ts, rows = frame
                    proc = str(proc)
                    seq = int(seq)
                    ts = float(ts)
                except (TypeError, ValueError):
                    self.rows_dropped += 1
                    continue
                if self._proc_dead(proc):
                    self.frames_rejected += 1
                    continue
                if seq <= self._proc_seq.get(proc, 0):
                    self.frames_deduped += 1
                    continue
                self._proc_seq[proc] = seq
                for row in rows:
                    self._apply_row(proc, ts, row)
                applied += 1
                self.frames_applied += 1
        return applied

    def _proc_dead(self, proc: str) -> bool:
        for p in self._dead_procs:
            if proc in (f"node:{p}", f"driver:{p}") or \
                    proc.startswith(f"worker:{p}."):
                return True
        return False

    def _apply_row(self, proc: str, ts: float, row: list) -> None:
        try:
            kind = row[0]
            name = str(row[1])
            keys = [str(k) for k in row[2]]
            vals = [str(v) for v in row[3]]
            if kind == "h":
                boundaries = tuple(float(b) for b in row[4])
                add = [[int(c) for c in row[5]], float(row[6]), int(row[7])]
                if len(add[0]) != len(boundaries) + 1:
                    raise ValueError("bucket count mismatch")
            elif kind in ("c", "g"):
                boundaries = None
                add = float(row[4])
            else:
                raise ValueError(f"unknown row kind {kind!r}")
        except (TypeError, ValueError, IndexError):
            self.rows_dropped += 1
            return
        tags = tuple(sorted({**dict(zip(keys, vals)), "proc": proc}.items()))
        tags = self._tag_intern.setdefault(tags, tags)
        table = self._series[kind]
        s = table.get((name, tags))
        if s is None:
            s = _Series(kind, name, tags, self.fine_slots, self.coarse_slots,
                        boundaries)
            if not self._make_room(kind, s.cost):
                self.rows_dropped += 1
                return
            table[(name, tags)] = s
            self._bytes += s.cost
        elif kind == "h" and s.boundaries != boundaries:
            self.rows_dropped += 1       # boundary change mid-flight
            return
        self._write(s, ts, add)

    def _make_room(self, kind: str, cost: int) -> bool:
        if cost > self.max_bytes:
            return False
        while self._bytes + cost > self.max_bytes:
            # FIFO-evict the oldest series of the same kind first (like
            # TaskEventStore's per-kind bound); fall back to the oldest
            # of any kind so one kind can't wedge the store.
            victim_table = None
            if self._series[kind]:
                victim_table = self._series[kind]
            else:
                for t in self._series.values():
                    if t:
                        victim_table = t
                        break
            if victim_table is None:
                return False
            _, victim = victim_table.popitem(last=False)
            self._bytes -= victim.cost
            self.series_evicted += 1
        return True

    def _write(self, s: _Series, ts: float, add) -> None:
        b = math.floor(ts / self.fine_step) * self.fine_step
        i = int(b / self.fine_step) % self.fine_slots
        if s.fine_ts[i] != b:
            if s.fine_ts[i] > b:
                return                    # older than the live window
            if s.fine_ts[i]:
                self._fold(s, i)
            s.fine_ts[i] = b
            s.fine_val[i] = s._zero()
        s.fine_val[i] = s._merge(s.fine_val[i], add)
        if s.kind == "c":
            s.total += add
        elif s.kind == "g":
            if ts >= s.last_ts:
                s.last, s.last_ts = add, ts
        else:
            for j, v in enumerate(add[0]):
                s.bucket_totals[j] += v
            s.sum_total += add[1]
            s.count_total += add[2]

    def _fold(self, s: _Series, i: int) -> None:
        """Staircase downsample: a reclaimed fine slot merges into the
        coarse ring before it is overwritten."""
        old_b = s.fine_ts[i]
        cb = math.floor(old_b / self.coarse_step) * self.coarse_step
        ci = int(cb / self.coarse_step) % self.coarse_slots
        if s.coarse_ts[ci] != cb:
            if s.coarse_ts[ci] > cb:
                return                    # beyond even the coarse window
            s.coarse_ts[ci] = cb
            s.coarse_val[ci] = s._zero()
        s.coarse_val[ci] = s._merge(s.coarse_val[ci], s.fine_val[i])

    def mark_proc_dead(self, node_hex12: str) -> int:
        """Tombstone every proc rooted at this node (daemon, driver,
        workers): drop their series now and reject any late frame, so a
        died-mid-ship node can't resurrect stale series."""
        p = str(node_hex12)[:12]
        removed = 0
        with self._lock:
            self._dead_procs.add(p)
            for table in self._series.values():
                doomed = [k for k, s in table.items()
                          if self._tags_proc_dead(s.tags, p)]
                for k in doomed:
                    self._bytes -= table[k].cost
                    del table[k]
                    removed += 1
            for proc in [q for q in self._proc_seq if self._proc_dead(q)]:
                del self._proc_seq[proc]
        return removed

    @staticmethod
    def _tags_proc_dead(tags: Tuple, p: str) -> bool:
        proc = dict(tags).get("proc", "")
        return proc in (f"node:{p}", f"driver:{p}") or \
            proc.startswith(f"worker:{p}.")

    def revive_proc(self, node_hex12: str) -> None:
        """A (re-)registered node sheds its tombstone so shipping
        resumes — the head-bounce / node-reconnect path."""
        with self._lock:
            self._dead_procs.discard(str(node_hex12)[:12])

    def seq_state(self) -> Dict:
        """JSON-safe export of the sequencing state a successor head
        needs for correctness: per-origin applied seqs (so re-shipped
        frames dedup instead of double-counting) and proc-death
        tombstones (so a dead origin's late frames stay rejected).
        Series data is intentionally NOT exported — it is lossy-bounded
        telemetry; the seq/tombstone state is what must not regress."""
        with self._lock:
            return {"proc_seq": dict(self._proc_seq),
                    "dead": sorted(self._dead_procs)}

    def restore_seq_state(self, state: Dict) -> None:
        """Merge a shipped :meth:`seq_state` into this store (takeover /
        restart path). Merge, not replace: per-origin seqs keep the MAX
        of both sides and tombstones union, so a restore can only make
        dedup stricter — never resurrect a dead origin or re-admit an
        already-applied frame."""
        if not isinstance(state, dict):
            return
        with self._lock:
            for proc, seq in (state.get("proc_seq") or {}).items():
                try:
                    seq = int(seq)
                except (TypeError, ValueError):
                    continue
                proc = str(proc)
                if seq > self._proc_seq.get(proc, 0):
                    self._proc_seq[proc] = seq
            for p in state.get("dead") or ():
                self._dead_procs.add(str(p)[:12])

    # -- query -------------------------------------------------------------

    def query(self, name: str, tags: Optional[Dict[str, str]] = None,
              agg: str = "sum", since_s: float = 600.0,
              step: Optional[float] = None,
              now: Optional[float] = None) -> Dict:
        """Cross-process aggregation over matching series.

        ``agg``: counters — ``sum`` (increments per bucket), ``rate``
        (increments/s), ``max``/``avg``/``min`` across per-series
        increments; gauges — ``sum``/``max``/``min``/``avg`` across
        series; histograms — ``p50/p90/p95/p99`` from merged buckets,
        ``avg`` from merged sum/count, ``rate`` = observations/s.
        """
        if agg not in AGGS:
            raise ValueError(f"unknown agg {agg!r} (want one of {AGGS})")
        if now is None:
            now = self._clock()
        since = now - float(since_s)
        out_step = float(step) if step else (
            self.fine_step if since_s <= self.fine_step * self.fine_slots
            else self.coarse_step)
        with self._lock:
            matched = [s for table in self._series.values()
                       for s in table.values()
                       if s.name == name and self._tags_match(s.tags, tags)]
            kind = matched[0].kind if matched else None
            per_series = [self._series_points(s, since, out_step)
                          for s in matched]
        points = self._aggregate(kind, per_series, agg, out_step)
        return {"name": name, "kind": kind, "agg": agg, "step": out_step,
                "series_matched": len(matched),
                "points": [[t, v] for t, v in sorted(points.items())]}

    @staticmethod
    def _tags_match(series_tags: Tuple, want: Optional[Dict]) -> bool:
        if not want:
            return True
        d = dict(series_tags)
        return all(d.get(k) == str(v) for k, v in want.items())

    def _series_points(self, s: _Series, since: float,
                       out_step: float) -> Dict[float, object]:
        """One series' buckets regridded to ``out_step``. Coarse and fine
        rings never double-count: a bucket lives in exactly one ring
        (fine until its slot is reclaimed, coarse after folding)."""
        out: Dict[float, object] = {}
        ts_of: Dict[float, float] = {}    # gauges: latest source bucket wins
        for ring_ts, ring_val in ((s.coarse_ts, s.coarse_val),
                                  (s.fine_ts, s.fine_val)):
            for b, v in zip(ring_ts, ring_val):
                if not b or b < since or v is None:
                    continue
                ob = math.floor(b / out_step) * out_step
                if ob not in out:
                    out[ob] = s._zero()
                    ts_of[ob] = -1.0
                if s.kind == "g":
                    if b > ts_of[ob]:
                        out[ob], ts_of[ob] = v, b
                else:
                    out[ob] = s._merge(out[ob], v)
        return out

    def _aggregate(self, kind: Optional[str],
                   per_series: List[Dict[float, object]], agg: str,
                   out_step: float) -> Dict[float, float]:
        merged: Dict[float, list] = {}
        for pts in per_series:
            for t, v in pts.items():
                merged.setdefault(t, []).append(v)
        out: Dict[float, float] = {}
        for t, vals in merged.items():
            if kind == "h":
                counts = [0] * len(vals[0][0])
                hsum, hcount = 0.0, 0
                for c, sm, ct in vals:
                    for i, x in enumerate(c):
                        counts[i] += x
                    hsum += sm
                    hcount += ct
                if agg in QUANTILE_AGGS:
                    boundaries = self._boundaries_for(kind, counts)
                    q = _bucket_quantile(counts, boundaries,
                                         QUANTILE_AGGS[agg])
                    if q is None:
                        continue
                    out[t] = q
                elif agg == "avg":
                    if hcount:
                        out[t] = hsum / hcount
                elif agg == "rate":
                    out[t] = hcount / out_step
                elif agg == "sum":
                    out[t] = hsum
                elif agg == "max":
                    out[t] = max((sm for _, sm, _ in vals), default=0.0)
                else:
                    out[t] = min((sm for _, sm, _ in vals), default=0.0)
            else:
                nums = [float(v) for v in vals]
                if agg == "sum":
                    out[t] = sum(nums)
                elif agg == "rate":
                    out[t] = sum(nums) / out_step
                elif agg == "max":
                    out[t] = max(nums)
                elif agg == "min":
                    out[t] = min(nums)
                elif agg == "avg":
                    out[t] = sum(nums) / len(nums)
                else:                     # quantile over a scalar kind:
                    out[t] = max(nums)    # degrade to max, never crash
        return out

    def _boundaries_for(self, kind: str, counts: List[int]
                        ) -> Tuple[float, ...]:
        # All series of one histogram name share boundaries (enforced at
        # _apply_row); grab them from any live histogram with this bucket
        # count. Caller holds no lock on _series here by design: this is
        # only reached from query() which already holds self._lock... so
        # read directly.
        for s in self._series["h"].values():
            if s.boundaries is not None and \
                    len(s.boundaries) + 1 == len(counts):
                return s.boundaries
        return tuple(float(i) for i in range(len(counts) - 1))

    def latest(self, name: str, tags: Optional[Dict[str, str]] = None,
               agg: str = "sum", now: Optional[float] = None
               ) -> Optional[float]:
        """Most recent aggregated value (short lookback window)."""
        res = self.query(name, tags=tags, agg=agg,
                         since_s=self.fine_step * 3, now=now)
        return res["points"][-1][1] if res["points"] else None

    def series(self, prefix: Optional[str] = None) -> List[Dict]:
        with self._lock:
            out = []
            for kind, table in self._series.items():
                for s in table.values():
                    if prefix and not s.name.startswith(prefix):
                        continue
                    out.append({"name": s.name, "kind": kind,
                                "tags": dict(s.tags)})
        return sorted(out, key=lambda d: (d["name"], sorted(d["tags"].items())))

    def prometheus_text(self) -> str:
        """Cluster-aggregated exposition: every shipped series with its
        ``proc`` label, cumulative totals (what Prometheus expects)."""
        lines: List[str] = []
        seen_header: set = set()
        with self._lock:
            allseries = [s for table in self._series.values()
                         for s in table.values()]
        for s in sorted(allseries, key=lambda x: (x.name, x.tags)):
            if s.name not in seen_header:
                seen_header.add(s.name)
                ptype = {"c": "counter", "g": "gauge",
                         "h": "histogram"}[s.kind]
                lines.append(f"# TYPE {s.name} {ptype}")
            lbl = _labels(s.tags)
            if s.kind == "c":
                lines.append(f"{s.name}{lbl} {_fmt(s.total)}")
            elif s.kind == "g":
                lines.append(f"{s.name}{lbl} {_fmt(s.last)}")
            else:
                cum = 0
                for b, c in zip(s.boundaries, s.bucket_totals):
                    cum += c
                    lines.append(
                        f"{s.name}_bucket{_labels(s.tags, le=_fmt(b))} {cum}")
                cum += s.bucket_totals[-1]
                lines.append(
                    f"{s.name}_bucket{_labels(s.tags, le='+Inf')} {cum}")
                lines.append(f"{s.name}_sum{lbl} {_fmt(s.sum_total)}")
                lines.append(f"{s.name}_count{lbl} {s.count_total}")
        return "\n".join(lines) + ("\n" if lines else "")

    def stats(self) -> Dict:
        with self._lock:
            return {
                "series": sum(len(t) for t in self._series.values()),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "series_evicted": self.series_evicted,
                "frames_applied": self.frames_applied,
                "frames_deduped": self.frames_deduped,
                "frames_rejected": self.frames_rejected,
                "rows_dropped": self.rows_dropped,
                "upstream_drops": self.upstream_drops,
                "dead_procs": len(self._dead_procs),
            }

    def note_upstream_drops(self, n: int) -> None:
        """Shippers count frames their bounded buffers had to drop; the
        head folds those counts here so truncation is visible, not
        silent (same contract as TaskEventStore's dropped counter)."""
        if n > 0:
            with self._lock:
                self.upstream_drops += int(n)


def _labels(tags: Tuple, **extra: str) -> str:
    items = list(tags) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{str(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _bucket_quantile(counts: List[int], boundaries: Tuple[float, ...],
                     q: float) -> Optional[float]:
    """Prometheus-style ``histogram_quantile``: linear interpolation
    inside the target bucket; the overflow bucket clamps to the highest
    boundary (same convention the reference uses for +Inf)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if not c:
            continue
        if cum + c >= target:
            if i >= len(boundaries):          # +Inf bucket
                return float(boundaries[-1]) if boundaries else None
            lo = float(boundaries[i - 1]) if i > 0 else 0.0
            hi = float(boundaries[i])
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return float(boundaries[-1]) if boundaries else None


# ---------------------------------------------------------------------------
# SLO alerts: threshold/duration rules over queried series, evaluated on
# the head's health-loop cadence and fired into the ops-event log.
# ---------------------------------------------------------------------------

_RULE_RE = re.compile(
    r"^\s*([A-Za-z_]\w*)\s*(?:\{([^}]*)\})?\s*(?::\s*(\w+))?\s*([<>]=?)\s*"
    r"([-+0-9.eE]+)\s*(?:for\s+([0-9.]+)\s*s?)?\s*$")


def _parse_selector(body: str) -> Dict[str, str]:
    """Parse the ``{k=v,...}`` tag selector of an alert-rule spec
    (e.g. ``raytpu_tenant_queued{tenant=acme} > 100 for 30s``).
    Values may be bare tokens or quoted; an empty body means no
    tag filter."""
    tags: Dict[str, str] = {}
    for pair in body.split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError(f"bad tag selector {pair!r}")
        k, v = pair.split("=", 1)
        k, v = k.strip(), v.strip().strip("'\"")
        if not k or not v:
            raise ValueError(f"bad tag selector {pair!r}")
        tags[k] = v
    return tags


class AlertRule:
    """One threshold/duration rule, e.g. parsed from
    ``raytpu_infer_ttft_seconds:p95 > 2.0 for 30s``."""

    def __init__(self, metric: str, op: str, threshold: float,
                 agg: str = "max", for_s: float = 0.0,
                 tags: Optional[Dict[str, str]] = None):
        if agg not in AGGS:
            raise ValueError(f"unknown agg {agg!r}")
        if op not in (">", "<", ">=", "<="):
            raise ValueError(f"unknown op {op!r}")
        self.metric = metric
        self.agg = agg
        self.op = op
        self.threshold = float(threshold)
        self.for_s = float(for_s)
        self.tags = dict(tags or {})

    @property
    def name(self) -> str:
        sel = ""
        if self.tags:
            sel = "{" + ",".join(
                f"{k}={self.tags[k]}" for k in sorted(self.tags)) + "}"
        return (f"{self.metric}{sel}:{self.agg} {self.op} "
                f"{_fmt(self.threshold)} for {_fmt(self.for_s)}s")

    def breached(self, value: float) -> bool:
        return {">": value > self.threshold,
                "<": value < self.threshold,
                ">=": value >= self.threshold,
                "<=": value <= self.threshold}[self.op]


def parse_alert_rules(spec: str) -> List[AlertRule]:
    """Parse a ``;``-separated rule list (the ``metrics_alert_rules``
    config knob). Malformed entries raise — a silently-dropped SLO rule
    is worse than a loud startup failure."""
    rules: List[AlertRule] = []
    for part in (spec or "").split(";"):
        if not part.strip():
            continue
        m = _RULE_RE.match(part)
        if not m:
            raise ValueError(f"bad alert rule: {part!r}")
        metric, sel, agg, op, thr, for_s = m.groups()
        rules.append(AlertRule(metric, op, float(thr), agg=agg or "max",
                               for_s=float(for_s) if for_s else 0.0,
                               tags=_parse_selector(sel) if sel else None))
    return rules


def serve_slo_preset_rules(spec: str, for_s: float = 30.0) -> List[AlertRule]:
    """Expand a per-tenant TTFT SLO preset (``tenant=seconds;...``) into
    alert rules. ``"acme=0.5; free-tier=2"`` becomes two p95 rules over
    ``raytpu_serve_ttft_seconds``, each scoped to its tenant's tag so a
    breach fires on the breaching tenant only. Tenant names may contain
    characters the generic rule grammar rejects (hyphens, dots), which
    is why this builds ``AlertRule`` objects directly instead of
    round-tripping through ``parse_alert_rules``. Malformed entries
    raise — same loud-startup policy as the generic parser."""
    rules: List[AlertRule] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad SLO preset (want tenant=seconds): {part!r}")
        tenant, thr = part.split("=", 1)
        tenant, thr = tenant.strip(), thr.strip()
        if not tenant or not thr:
            raise ValueError(f"bad SLO preset (want tenant=seconds): {part!r}")
        try:
            threshold = float(thr)
        except ValueError:
            raise ValueError(
                f"bad SLO preset threshold (want seconds): {part!r}")
        rules.append(AlertRule(
            "raytpu_serve_ttft_seconds", ">", threshold,
            agg="p95", for_s=for_s, tags={"tenant": tenant}))
    return rules


class AlertEvaluator:
    """Tick on the head's health-loop cadence; a rule fires once when
    its breach has been sustained ``for_s`` seconds and resolves when
    the breach clears (hysteresis lives in the duration, not here)."""

    def __init__(self, store: MetricStore, rules: List[AlertRule],
                 on_fire: Callable[[AlertRule, float], None],
                 on_resolve: Optional[Callable[[AlertRule, float], None]]
                 = None):
        self.store = store
        self.rules = list(rules)
        self.on_fire = on_fire
        self.on_resolve = on_resolve
        self._state: Dict[str, Dict] = {}

    def set_rules(self, rules: List[AlertRule]) -> None:
        self.rules = list(rules)
        live = {r.name for r in rules}
        for k in [k for k in self._state if k not in live]:
            del self._state[k]

    def firing(self) -> List[str]:
        return sorted(k for k, st in self._state.items() if st["firing"])

    def tick(self, now: Optional[float] = None) -> None:
        if now is None:
            now = self.store._clock()
        for rule in self.rules:
            try:
                value = self.store.latest(rule.metric, tags=rule.tags,
                                          agg=rule.agg, now=now)
            except ValueError:
                continue
            st = self._state.setdefault(
                rule.name, {"since": None, "firing": False})
            breach = value is not None and rule.breached(value)
            if breach:
                if st["since"] is None:
                    st["since"] = now
                if not st["firing"] and now - st["since"] >= rule.for_s:
                    st["firing"] = True
                    self.on_fire(rule, value)
            else:
                if st["firing"] and self.on_resolve is not None:
                    self.on_resolve(rule, value if value is not None else 0.0)
                st["since"] = None
                st["firing"] = False
