"""Allocation memory profiler (tracemalloc-based); the port of
``raytpu/util/memprofile.py`` (no JAX in it), whole.

Reference analogue: ``dashboard/modules/reporter/profile_manager.py``
(``memray attach`` memory profiles of any live worker). memray isn't
shippable in a zero-egress image, so the equivalent capability uses the
stdlib: ``tracemalloc`` traces every Python allocation with a bounded
traceback depth; a profile window starts tracing (if not already on),
waits, snapshots, and aggregates live allocations into collapsed stacks
keyed by allocation traceback — the same ``root;child;leaf size``
format the CPU profiler emits, so the one flamegraph renderer serves
both (frames weighted by KiB instead of samples).

What tracemalloc cannot see (and memray can): native allocations that
never cross the Python allocator (e.g. torch's CPU and CUDA buffers). The
process-level RSS reported alongside covers the gap at coarse grain.
"""

from __future__ import annotations

import os
import sys
import time
import tracemalloc
from typing import Dict, List, Optional


def _rss_kb() -> Optional[int]:
    """Resident set size in KiB from /proc (Linux; None elsewhere)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") // 1024)
    except Exception:  # noqa: BLE001 — non-Linux
        return None


_MAX_STACKS = 2000  # collapsed entries per profile; tail folds to <other>


def memory_profile(duration_s: float = 2.0, trace_frames: int = 16,
                   top_n: int = 40, stop_after: bool = False) -> dict:
    """Profile this process's live Python allocations.

    Starts ``tracemalloc`` if it isn't tracing (so the first call's
    window only sees allocations made DURING the window — stated in the
    result as ``window_only``), waits ``duration_s`` for the workload to
    allocate, then snapshots. Returns::

        {"collapsed": {stack: KiB}, "total_kb": ..., "peak_kb": ...,
         "rss_kb": ..., "top": [{"stack": [...], "kb": N, "count": M}],
         "window_only": bool, "pid": ..., "duration_s": ...}

    ``collapsed`` stacks are ``alloc;outer (file:line);...;leaf`` with
    KiB weights (sub-KiB sites aggregate in bytes first, so thousands
    of tiny allocations can't dwarf one real buffer), capped at the
    ``_MAX_STACKS`` largest sites with the tail folded into
    ``alloc;<other>`` — a long-lived worker may hold 100k+ distinct
    tracebacks and this dict travels over RPC. Feed to
    ``profiler.flamegraph_svg`` directly. ``stop_after=True`` turns
    tracing off afterwards (removes the ~2-4x allocation overhead,
    loses the baseline for the next call).
    """
    duration_s = max(0.0, min(float(duration_s), 120.0))
    trace_frames = max(1, min(int(trace_frames), 64))
    window_only = not tracemalloc.is_tracing()
    if window_only:
        tracemalloc.start(trace_frames)
    try:
        if duration_s:
            time.sleep(duration_s)
        snap = tracemalloc.take_snapshot()
        current, peak = tracemalloc.get_traced_memory()
        # start() is a no-op while tracing: report the depth actually
        # in effect, not the requested one.
        effective_frames = tracemalloc.get_traceback_limit()
    finally:
        if stop_after:
            tracemalloc.stop()
    stats = snap.statistics("traceback")
    by_bytes: Dict[str, int] = {}
    top: List[dict] = []
    for st in stats:  # statistics() is sorted by size, largest first
        frames = [f"{os.path.basename(fr.filename)}:{fr.lineno}"
                  for fr in st.traceback]  # oldest (root) first
        key = ";".join(["alloc"] + frames)
        if key in by_bytes or len(by_bytes) < _MAX_STACKS:
            by_bytes[key] = by_bytes.get(key, 0) + st.size
        else:
            by_bytes["alloc;<other>"] = \
                by_bytes.get("alloc;<other>", 0) + st.size
        if len(top) < top_n:
            top.append({"stack": frames, "kb": st.size // 1024,
                        "count": st.count})
    # Sub-KiB sites must not round up to 1 KiB each (2000 tiny sites
    # would overstate the flamegraph by ~2 MiB): fold them into the
    # <other> bucket in BYTES, then convert once.
    other_bytes = by_bytes.pop("alloc;<other>", 0)
    collapsed: Dict[str, int] = {}
    for k, b in by_bytes.items():
        kb = b // 1024
        if kb == 0:
            other_bytes += b
        else:
            collapsed[k] = kb
    if other_bytes:
        collapsed["alloc;<other>"] = max(1, other_bytes // 1024)
    return {"collapsed": collapsed,
            "total_kb": current // 1024,
            "peak_kb": peak // 1024,
            "rss_kb": _rss_kb(),
            "top": top,
            "window_only": window_only,
            "pid": os.getpid(),
            "duration_s": duration_s,
            "trace_frames": effective_frames}


def top_table(profile: dict, limit: int = 25) -> str:
    """Human-readable top-allocations table (memray's summary view)."""
    lines = [f"pid {profile.get('pid', '?')}: "
             f"python-live {profile.get('total_kb', 0):,} KiB, "
             f"peak {profile.get('peak_kb', 0):,} KiB, "
             f"rss {profile.get('rss_kb') or 0:,} KiB"
             + ("  [window-only trace]" if profile.get("window_only")
                else "")]
    for row in sorted(profile.get("top", []),
                      key=lambda r: -r["kb"])[:limit]:
        leaf = row["stack"][-1] if row["stack"] else "?"
        lines.append(f"{row['kb']:>10,} KiB  {row['count']:>7}x  {leaf}")
    return "\n".join(lines)
