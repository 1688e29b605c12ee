"""The driver's profile store, fed by shipped collapsed-stack frames
(util/profiler.py continuous shipping); the port of
``raytpu/util/profstore.py`` (no JAX in it), whole. In the port it sits
at the driver beside the TSDB (``runtime/records.py``), and a
tombstone's prefix is a process's id (``worker:<id>.<pid hex>``), not a
node's.

The TSDB sibling: per-proc rings of thread-folded snapshots under one
hard byte cap with FIFO eviction, per-origin seq dedup so a requeued
re-ship merges once, and node-death tombstones matched by the same
hex12-prefix convention ``MetricStore`` uses — a node that died
mid-ship can neither resurrect stale stacks nor leak ring slots.

Queries: ``merged`` (one cluster flamegraph over a time window) and
``diff`` (recent window minus the preceding window, signed per stack),
serving ``python -m raytpu_torch profile --continuous/--diff`` and the
dashboard's ``GET /api/profile``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from raytpu_torch.util.profiler import diff_collapsed, merge_collapsed


class ProfileStore:
    """Bounded in-memory store behind the head's ``profile_*`` RPCs."""

    def __init__(self, max_bytes: int = 4_000_000,
                 ring_slots: int = 120,
                 clock: Callable[[], float] = time.time):
        self.max_bytes = int(max_bytes)
        self.ring_slots = int(ring_slots)
        self._clock = clock
        self._lock = threading.Lock()
        # proc -> deque[(ts, collapsed, samples, window_s, cost)]
        self._rings: Dict[str, Deque[tuple]] = {}
        self._proc_seq: Dict[str, int] = {}
        self._proc_dropped: Dict[str, int] = {}  # upstream sample-ship drops
        self._proc_last: Dict[str, float] = {}
        self._dead_procs: set = set()            # hex12 node prefixes
        self._bytes = 0
        self.frames_applied = 0
        self.frames_deduped = 0
        self.frames_rejected = 0                 # tombstoned origin
        self.frames_dropped = 0                  # malformed
        self.frames_evicted = 0
        self.upstream_drops = 0

    # -- ingest ------------------------------------------------------------

    @staticmethod
    def _cost(collapsed: Dict[str, int]) -> int:
        return 64 + sum(len(k) + 16 for k in collapsed)

    def push(self, frames: List[list]) -> int:
        """Apply shipped snapshot frames; returns how many applied.
        Idempotent per origin: ``seq`` <= last-applied is a duplicate."""
        applied = 0
        with self._lock:
            for frame in frames or ():
                try:
                    proc, seq, ts, collapsed, samples, window_s = frame
                    proc = str(proc)
                    seq = int(seq)
                    ts = float(ts)
                    samples = int(samples)
                    window_s = float(window_s)
                    if not isinstance(collapsed, dict):
                        raise TypeError("collapsed must be a dict")
                    collapsed = {str(k): int(v)
                                 for k, v in collapsed.items()}
                except (TypeError, ValueError):
                    self.frames_dropped += 1
                    continue
                if self._proc_dead(proc):
                    self.frames_rejected += 1
                    continue
                if seq <= self._proc_seq.get(proc, 0):
                    self.frames_deduped += 1
                    continue
                self._proc_seq[proc] = seq
                ring = self._rings.get(proc)
                if ring is None:
                    ring = self._rings[proc] = deque()
                cost = self._cost(collapsed)
                if len(ring) >= self.ring_slots:
                    old = ring.popleft()
                    self._bytes -= old[4]
                    self.frames_evicted += 1
                ring.append((ts, collapsed, samples, window_s, cost))
                self._bytes += cost
                self._proc_last[proc] = ts
                self._make_room()
                applied += 1
                self.frames_applied += 1
        return applied

    def _make_room(self) -> None:
        """FIFO-evict the globally-oldest snapshot until under the cap
        (proc count is small; a linear scan per eviction is fine)."""
        while self._bytes > self.max_bytes:
            victim = None
            oldest = float("inf")
            for proc, ring in self._rings.items():
                if ring and ring[0][0] < oldest:
                    oldest = ring[0][0]
                    victim = proc
            if victim is None:
                return
            old = self._rings[victim].popleft()
            self._bytes -= old[4]
            self.frames_evicted += 1
            if not self._rings[victim]:
                del self._rings[victim]

    def note_upstream_drops(self, n: int, proc: str = "") -> None:
        """Frames lost before reaching us (buffer overflow at the origin
        or a lost ship leg), attributed to the shipping carrier so
        ``raytpu top --profile`` can name the lossy proc."""
        n = int(n or 0)
        if n <= 0:
            return
        with self._lock:
            self.upstream_drops += n
            if proc:
                proc = str(proc)
                self._proc_dropped[proc] = \
                    self._proc_dropped.get(proc, 0) + n

    # -- liveness ----------------------------------------------------------

    def _proc_dead(self, proc: str) -> bool:
        for p in self._dead_procs:
            if proc in (f"node:{p}", f"driver:{p}") or \
                    proc.startswith(f"worker:{p}."):
                return True
        return False

    def mark_proc_dead(self, node_hex12: str) -> int:
        """Tombstone every proc rooted at this node: drop their rings
        now and reject any late frame (same contract as the TSDB)."""
        p = str(node_hex12)[:12]
        removed = 0
        with self._lock:
            self._dead_procs.add(p)
            doomed = [q for q in self._rings if self._proc_dead(q)]
            for q in doomed:
                ring = self._rings.pop(q)
                self._bytes -= sum(e[4] for e in ring)
                removed += len(ring)
            for q in [q for q in self._proc_seq if self._proc_dead(q)]:
                del self._proc_seq[q]
                self._proc_last.pop(q, None)
        return removed

    def revive_proc(self, node_hex12: str) -> None:
        """A (re-)registered node sheds its tombstone so shipping
        resumes — the head-bounce / node-reconnect path."""
        with self._lock:
            self._dead_procs.discard(str(node_hex12)[:12])

    # -- query -------------------------------------------------------------

    def merged(self, since_s: float = 600.0, until_s: float = 0.0,
               procs: Optional[List[str]] = None,
               now: Optional[float] = None) -> Dict:
        """One cluster-wide flamegraph: every snapshot whose ts falls in
        ``[now - since_s, now - until_s]``, merged deterministically."""
        if now is None:
            now = self._clock()
        lo, hi = now - float(since_s), now - float(until_s)
        parts: List[Dict[str, int]] = []
        samples = 0
        used: List[str] = []
        frames = 0
        with self._lock:
            for proc in sorted(self._rings):
                if procs and proc not in procs:
                    continue
                hit = False
                for ts, collapsed, n, _w, _c in self._rings[proc]:
                    if lo <= ts <= hi:
                        parts.append(collapsed)
                        samples += n
                        frames += 1
                        hit = True
                if hit:
                    used.append(proc)
        return {"collapsed": merge_collapsed(parts), "samples": samples,
                "frames": frames, "procs": used,
                "since_s": float(since_s), "until_s": float(until_s)}

    def diff(self, recent_s: float = 120.0,
             now: Optional[float] = None) -> Dict:
        """Signed delta: the last ``recent_s`` seconds minus the
        ``recent_s`` seconds before that — what got hotter since."""
        if now is None:
            now = self._clock()
        recent = self.merged(recent_s, 0.0, now=now)
        baseline = self.merged(2 * recent_s, recent_s, now=now)
        return {"delta": diff_collapsed(recent["collapsed"],
                                        baseline["collapsed"]),
                "recent": recent, "baseline": baseline,
                "recent_s": float(recent_s)}

    def proc_rows(self) -> List[Dict]:
        """Per-proc inventory for ``raytpu top --profile``."""
        with self._lock:
            procs = sorted(set(self._rings) | set(self._proc_dropped))
            return [{"proc": p,
                     "frames": len(self._rings.get(p, ())),
                     "samples": sum(e[2] for e in self._rings.get(p, ())),
                     "last_ts": self._proc_last.get(p, 0.0),
                     "dropped": self._proc_dropped.get(p, 0)}
                    for p in procs]

    def stats(self) -> Dict:
        with self._lock:
            return {"procs": len(self._rings),
                    "frames": sum(len(r) for r in self._rings.values()),
                    "bytes": self._bytes,
                    "max_bytes": self.max_bytes,
                    "frames_applied": self.frames_applied,
                    "frames_deduped": self.frames_deduped,
                    "frames_rejected": self.frames_rejected,
                    "frames_dropped": self.frames_dropped,
                    "frames_evicted": self.frames_evicted,
                    "upstream_drops": self.upstream_drops,
                    "dead_procs": sorted(self._dead_procs)}
