"""Sampling CPU profiler, flamegraph rendering and continuous profiling;
the port of ``raytpu/util/profiler.py`` (no JAX in it), whole.

The JAX package samples in process because py-spy is not shippable in
a zero-egress image; so does the port: a background thread samples
``sys._current_frames()`` at a fixed rate for a bounded duration and
aggregates the samples into collapsed stacks (Brendan Gregg's
``root;child;leaf count`` format). Every process of the tree answers a
``profile`` request on its connection to the driver
(:func:`raytpu_torch.util.stack_dump.fanout_process_call`); the
dashboard renders the merged result as a self-contained SVG
flamegraph.

What in-process sampling cannot see: native code that holds the GIL
without returning to the interpreter (a CUDA launch is seen in the
Python frame that made it). Everything Python-visible, including time
*waiting* on locks and I/O, is captured; idle-looking leaf frames can be
filtered with ``include_idle=False``.

With ``RAYTPU_PROFILE_CONTINUOUS=1`` a process also runs the
duty-cycled :class:`ContinuousProfiler`, whose frames ship to the
driver's :class:`~raytpu_torch.util.profstore.ProfileStore`; the same
flag turns on the engine's step profiler
(:mod:`raytpu_torch.util.stepprof`).
"""

from __future__ import annotations

import hashlib
import html
import os
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

# Leaf code names that mean "this thread is parked, not burning CPU" —
# a heuristic (py-spy uses native-state instead), documented as such.
_IDLE_LEAVES = {
    "wait", "acquire", "select", "poll", "epoll", "accept", "recv",
    "recv_into", "read", "readline", "sleep", "get", "join",
    "_wait_for_tstate_lock", "wait_for", "run_forever", "_run_once",
    "select_poll", "flowcontrol",
}

# Frame labels cached per code object (function-level granularity:
# ``name (file:def-line)``). Formatting a label per frame per thread
# per sample is THE sampling cost — with a dozen threads it puts
# milliseconds of GIL stall into every sample — and def-line keys are
# also stabler across runs than instruction-pointer lines, so diff
# flamegraphs churn less. Code objects are interned for the process
# lifetime; the cache is bounded by the live code set.
_code_labels: Dict[object, str] = {}


def _code_label(code) -> str:
    label = _code_labels.get(code)
    if label is None:
        label = (f"{code.co_name} "
                 f"({os.path.basename(code.co_filename)}:"
                 f"{code.co_firstlineno})")
        _code_labels[code] = label
    return label


def sample_for(duration_s: float = 2.0, hz: float = 50.0,
               include_idle: bool = True) -> dict:
    """Sample this process's Python stacks for ``duration_s``.

    Returns ``{"collapsed": {stack: count}, "samples": N,
    "duration_s": ..., "hz": ..., "pid": ...}`` where each ``stack`` is
    ``thread-name;outermost (file:line);...;leaf (file:line)``.
    """
    duration_s = max(0.05, min(float(duration_s), 120.0))
    hz = max(1.0, min(float(hz), 500.0))
    interval = 1.0 / hz
    collapsed: Dict[str, int] = {}
    samples = 0
    me = threading.get_ident()
    # Thread names once per burst, not per sample (enumerate allocates
    # under a lock); a thread born mid-burst keys as ``thread-<tid>``.
    names = {t.ident: t.name for t in threading.enumerate()}
    deadline = time.monotonic() + duration_s
    while True:
        now = time.monotonic()
        if now >= deadline:
            break
        frames = sys._current_frames()
        for tid, frame in frames.items():
            if tid == me:
                continue  # never profile the profiler
            stack: List[str] = []
            f = frame
            while f is not None:
                stack.append(_code_label(f.f_code))
                f = f.f_back
            if not stack:
                continue
            if not include_idle:
                leaf_name = frame.f_code.co_name
                if leaf_name in _IDLE_LEAVES:
                    continue
            stack.reverse()  # root first
            key = ";".join([names.get(tid, f"thread-{tid}")] + stack)
            collapsed[key] = collapsed.get(key, 0) + 1
        samples += 1
        # Fixed-rate pacing; sampling cost eats into the sleep.
        time.sleep(max(0.0, interval - (time.monotonic() - now)))
    return {"collapsed": collapsed, "samples": samples,
            "duration_s": duration_s, "hz": hz, "pid": os.getpid()}


def fold_threads(collapsed: Dict[str, int]) -> Dict[str, int]:
    """Strip the leading thread-name segment and aggregate same-stack
    frames across threads, iterating sorted keys so the result is
    byte-identical across runs. Thread names carry unstable serials
    (``ThreadPoolExecutor-0_3``), so an unfolded merge makes every diff
    flamegraph churn on pool-thread identity instead of code."""
    out: Dict[str, int] = {}
    for key in sorted(collapsed or {}):
        folded = key.split(";", 1)[1] if ";" in key else key
        out[folded] = out.get(folded, 0) + int(collapsed[key])
    return {k: out[k] for k in sorted(out)}


def merge_collapsed(profiles, fold: bool = False) -> Dict[str, int]:
    """Merge several ``collapsed`` dicts (e.g. one per worker) with
    deterministic (sorted-key) aggregation; ``fold=True`` additionally
    folds same-stack frames across threads via :func:`fold_threads`."""
    out: Dict[str, int] = {}
    for p in profiles:
        src = fold_threads(p) if fold else (p or {})
        for k in sorted(src):
            out[k] = out.get(k, 0) + int(src[k])
    return {k: out[k] for k in sorted(out)}


def diff_collapsed(recent: Dict[str, int],
                   baseline: Dict[str, int]) -> Dict[str, int]:
    """Signed per-stack delta ``recent - baseline`` (zero rows elided,
    sorted keys). Positive = the stack grew; negative = it shrank."""
    out: Dict[str, int] = {}
    for k in sorted(set(recent or {}) | set(baseline or {})):
        d = int((recent or {}).get(k, 0)) - int((baseline or {}).get(k, 0))
        if d:
            out[k] = d
    return out


def to_collapsed_text(collapsed: Dict[str, int]) -> str:
    """The canonical one-line-per-stack text flamegraph.pl consumes."""
    return "\n".join(f"{k} {v}" for k, v in
                     sorted(collapsed.items())) + "\n"


# -- flamegraph rendering ------------------------------------------------

class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.children: Dict[str, "_Node"] = {}


def _build_tree(collapsed: Dict[str, int]) -> _Node:
    root = _Node("all")
    for stack, count in collapsed.items():
        root.value += count
        node = root
        for part in stack.split(";"):
            child = node.children.get(part)
            if child is None:
                child = node.children[part] = _Node(part)
            child.value += count
            node = child
    return root


def _color(name: str) -> str:
    """Deterministic warm color per frame (classic flamegraph look)."""
    h = hashlib.md5(name.encode()).digest()
    r = 205 + h[0] % 50
    g = 60 + h[1] % 130
    b = h[2] % 55
    return f"rgb({r},{g},{b})"


def flamegraph_svg(collapsed: Dict[str, int],
                   title: str = "CPU flamegraph",
                   width: int = 1200) -> str:
    """Self-contained SVG flamegraph (no JS required; hover shows the
    frame + sample share via native ``<title>`` tooltips)."""
    root = _build_tree(collapsed)
    row_h = 17
    min_w = 0.5  # px; narrower frames are dropped (invisible anyway)
    rects: List[str] = []
    max_depth = 0

    def layout(node: _Node, x: float, depth: int, scale: float):
        nonlocal max_depth
        max_depth = max(max_depth, depth)
        cx = x
        for name, child in sorted(node.children.items(),
                                  key=lambda kv: -kv[1].value):
            w = child.value * scale
            if w < min_w:
                cx += w
                continue
            y = depth * row_h
            pct = 100.0 * child.value / max(1, root.value)
            label = html.escape(name)
            # The name is cut before it is escaped: the JAX package cuts
            # the escaped label, which can split an entity ("&lt;" of a
            # "<genexpr>" frame) and leave the SVG malformed.
            rects.append(
                f'<g><title>{label} — {child.value} samples '
                f'({pct:.1f}%)</title>'
                f'<rect x="{cx:.2f}" y="{y}" width="{w:.2f}" '
                f'height="{row_h - 1}" fill="{_color(name)}" rx="1"/>'
                + (f'<text x="{cx + 3:.2f}" y="{y + 12}" '
                   f'font-size="11" font-family="monospace" '
                   f'clip-path="inset(0)">'
                   f'{html.escape(name[:max(1, int(w / 7))])}</text>'
                   if w > 25 else "")
                + "</g>")
            layout(child, cx, depth + 1, scale)
            cx += w
    if root.value > 0:
        layout(root, 0.0, 0, width / root.value)
    height = (max_depth + 2) * row_h + 30
    header = (f'<text x="4" y="16" font-size="13" '
              f'font-family="sans-serif">{html.escape(title)} — '
              f'{root.value} samples</text>')
    body = "".join(f'<g transform="translate(0,24)">{r}</g>'
                   for r in rects)
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}" '
            f'style="background:#fff">{header}{body}</svg>')


def profile_to_svg(profile: dict, title: Optional[str] = None) -> str:
    return flamegraph_svg(profile.get("collapsed", {}),
                          title or f"pid {profile.get('pid', '?')}, "
                                   f"{profile.get('samples', 0)} samples "
                                   f"@ {profile.get('hz', 0):g} Hz")


# ---------------------------------------------------------------------------
# Continuous profiling: always-on duty-cycled sampling + cluster shipping.
#
# Mirrors the metrics-shipping contract exactly (util/metrics.py): a
# bounded per-process frame buffer, per-origin monotonic seq for
# idempotent re-ship, watermark drop accounting across drain/requeue.
# In the port a process's frames ride its ship to the driver
# (runtime/records.py), beside its events and metric deltas.
#
# Frame shape (strict-wire primitives only):
#   [proc_id, seq, ts, collapsed, samples, window_s]
# with ``collapsed`` a thread-folded {stack: count} dict already capped
# to the top RAYTPU_PROFILE_STACKS_MAX stacks (remainder under "(other)").
# ---------------------------------------------------------------------------

ENV_PROFILE = "RAYTPU_PROFILE_CONTINUOUS"
ENV_PROFILE_PERIOD = "RAYTPU_PROFILE_PERIOD_S"
ENV_PROFILE_WINDOW = "RAYTPU_PROFILE_WINDOW_S"
ENV_PROFILE_HZ = "RAYTPU_PROFILE_HZ"
ENV_PROFILE_BUFFER_MAX = "RAYTPU_PROFILE_BUFFER_MAX"
ENV_PROFILE_STACKS_MAX = "RAYTPU_PROFILE_STACKS_MAX"

# Duty cycle: one PROFILE_WINDOW_S sampling burst at PROFILE_HZ every
# PROFILE_PERIOD_S (the JAX package's defaults).
_PROFILE_PERIOD_S = float(os.environ.get(ENV_PROFILE_PERIOD, "") or 10.0)
_PROFILE_WINDOW_S = float(os.environ.get(ENV_PROFILE_WINDOW, "") or 1.0)
_PROFILE_HZ = float(os.environ.get(ENV_PROFILE_HZ, "") or 25.0)
_PROF_BUFFER_MAX = int(os.environ.get(ENV_PROFILE_BUFFER_MAX, "") or 64)
_PROF_STACKS_MAX = int(os.environ.get(ENV_PROFILE_STACKS_MAX, "") or 200)

_profile_enabled = os.environ.get(ENV_PROFILE, "") in ("1", "true", "True")
_prof_lock = threading.Lock()
_prof_frames: Deque[list] = deque()
_prof_dropped_total = 0
_prof_dropped_shipped = 0  # watermark: drops already reported downstream
_prof_seq = 0


def profiling_enabled() -> bool:
    """THE flag check: every continuous-profiler and step-profiler
    emission site guards with exactly this call, so the default-off mode
    costs one boolean read per site."""
    return _profile_enabled


def enable_profiling(env: bool = False) -> None:
    global _profile_enabled
    _profile_enabled = True
    if env:
        os.environ[ENV_PROFILE] = "1"


def disable_profiling(env: bool = False) -> None:
    global _profile_enabled
    _profile_enabled = False
    if env:
        os.environ[ENV_PROFILE] = "0"


def _cap_stacks(collapsed: Dict[str, int],
                max_stacks: int) -> Dict[str, int]:
    """Bound one snapshot to the hottest ``max_stacks`` stacks (ties
    broken by key, so the cap is deterministic); everything below the
    cut folds into ``(other)`` — totals stay exact."""
    if len(collapsed) <= max_stacks:
        return collapsed
    ranked = sorted(collapsed.items(), key=lambda kv: (-kv[1], kv[0]))
    out = dict(sorted(ranked[:max_stacks]))
    rest = sum(v for _, v in ranked[max_stacks:])
    if rest:
        out["(other)"] = out.get("(other)", 0) + rest
    return out


def prof_snapshot(window_s: Optional[float] = None,
                  hz: Optional[float] = None) -> bool:
    """Sample one duty-cycle window and enqueue a bounded, thread-folded
    frame. Returns True iff a frame was produced."""
    from raytpu_torch.util.failpoints import DROP, failpoint
    if failpoint("profile.snapshot") is DROP:
        return False
    w = _PROFILE_WINDOW_S if window_s is None else float(window_s)
    h = _PROFILE_HZ if hz is None else float(hz)
    prof = sample_for(w, h, include_idle=True)
    collapsed = _cap_stacks(fold_threads(prof["collapsed"]),
                            _PROF_STACKS_MAX)
    if not collapsed:
        return False
    from raytpu_torch.util import metrics as _metrics
    global _prof_seq, _prof_dropped_total
    with _prof_lock:
        _prof_seq += 1
        frame = [_metrics.shipper_identity(), _prof_seq, time.time(),
                 collapsed, int(prof["samples"]), w]
        if len(_prof_frames) >= _PROF_BUFFER_MAX:
            _prof_frames.popleft()
            _prof_dropped_total += 1
        _prof_frames.append(frame)
    return True


def prof_drain() -> Tuple[List[list], int]:
    """Take everything pending plus the not-yet-reported drop delta; on
    ship failure hand both back via :func:`prof_requeue` (the watermark
    arithmetic keeps drop counts exact across retries)."""
    global _prof_dropped_shipped
    with _prof_lock:
        frames = list(_prof_frames)
        _prof_frames.clear()
        dropped_delta = _prof_dropped_total - _prof_dropped_shipped
        _prof_dropped_shipped = _prof_dropped_total
    return frames, dropped_delta


def prof_requeue(frames: List[list], dropped: int = 0) -> None:
    """Put a failed ship back at the FRONT of the buffer (oldest-first
    order preserved); overflow drops the oldest of the requeued batch."""
    if not frames and not dropped:
        return
    global _prof_dropped_total, _prof_dropped_shipped
    with _prof_lock:
        _prof_dropped_shipped -= dropped
        space = _PROF_BUFFER_MAX - len(_prof_frames)
        if len(frames) > space:
            lost = len(frames) - max(space, 0)
            frames = frames[lost:]
            _prof_dropped_total += lost
        _prof_frames.extendleft(reversed(frames))


def prof_discard(frames: List[list], dropped: int = 0) -> None:
    """A drained batch was LOST in flight (e.g. the ``profile.ship``
    failpoint dropped it): fold the lost frames into the drop counter
    and re-owe the already-watermarked drop delta, so the next
    successful drain reports every loss exactly once."""
    global _prof_dropped_total, _prof_dropped_shipped
    with _prof_lock:
        _prof_dropped_total += len(frames or ())
        _prof_dropped_shipped -= int(dropped or 0)


def prof_ingest(frames: List[list], dropped: int = 0) -> None:
    """Relay path: absorb another process's drained frames into this
    process's buffer (the JAX node daemon's; kept for its shape)."""
    global _prof_dropped_total
    with _prof_lock:
        _prof_dropped_total += int(dropped or 0)
        for f in frames or ():
            if len(_prof_frames) >= _PROF_BUFFER_MAX:
                _prof_frames.popleft()
                _prof_dropped_total += 1
            _prof_frames.append(f)


def prof_pending() -> int:
    with _prof_lock:
        return len(_prof_frames)


def prof_peek() -> List[list]:
    """Non-destructive copy of the pending buffer (post-mortem dumps:
    a crashing process's unshipped tail is evidence, not inventory)."""
    with _prof_lock:
        return list(_prof_frames)


def reset_prof_shipping() -> None:
    """Test isolation: clear the buffer, counters, and seq."""
    global _prof_dropped_total, _prof_dropped_shipped, _prof_seq
    with _prof_lock:
        _prof_frames.clear()
        _prof_dropped_total = 0
        _prof_dropped_shipped = 0
        _prof_seq = 0


class ContinuousProfiler:
    """Duty-cycled background sampler: one short ``sample_for`` burst
    every ``period_s``, snapshotting into the shipping buffer. The
    thread exists only when started; with profiling disabled it idles
    on the flag check and samples nothing."""

    def __init__(self, period_s: Optional[float] = None,
                 window_s: Optional[float] = None,
                 hz: Optional[float] = None):
        self.period_s = _PROFILE_PERIOD_S if period_s is None \
            else float(period_s)
        self.window_s = _PROFILE_WINDOW_S if window_s is None \
            else float(window_s)
        self.hz = _PROFILE_HZ if hz is None else float(hz)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="raytpu-profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.window_s + 1.0)
        self._thread = None
        self._stop = threading.Event()

    def _run(self) -> None:
        wait = max(0.05, self.period_s - self.window_s)
        while not self._stop.wait(wait):
            if profiling_enabled():
                prof_snapshot(self.window_s, self.hz)


_continuous: List[Optional[ContinuousProfiler]] = [None]


def start_continuous(period_s: Optional[float] = None,
                     window_s: Optional[float] = None,
                     hz: Optional[float] = None) -> ContinuousProfiler:
    """Idempotent per process: the driver and every process of the tree
    call this once (behind the flag) and share the singleton sampler."""
    with _prof_lock:
        cp = _continuous[0]
        if cp is None:
            cp = _continuous[0] = ContinuousProfiler(period_s, window_s, hz)
    cp.start()
    return cp


def stop_continuous() -> None:
    with _prof_lock:
        cp = _continuous[0]
        _continuous[0] = None
    if cp is not None:
        cp.stop()
