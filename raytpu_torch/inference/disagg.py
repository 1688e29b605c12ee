"""Disaggregated prefill/decode: streaming KV-page handoff between
replicas; the port of ``raytpu/inference/disagg.py``.

Reference analogue: vLLM's disaggregated prefill (``KVConnector``) and
Mooncake/DistServe-style P/D separation — long prompts prefill on
dedicated replicas so they never steal decode iterations from
interactive streams, and the finished KV pages move to the decode
replica instead of being recomputed.

The handoff is modeled as a *remote prefix-cache fill*, which keeps the
engine untouched end to end:

- **Source** (prefill replica): the prompt's full-page KV lives in the
  local :class:`~raytpu_torch.inference.prefix_cache.PrefixCache`
  (prefilled on demand). ``begin`` pins those pages by grafting them
  into a dummy *pin sequence* via ``allocate_shared`` — the retainer
  protocol then guarantees they cannot be evicted mid-stream — and
  serves chunk reads as per-page host copies. One page comes to the host
  at a time (the streaming grain); the pool is never flattened.
- **Sink** (decode replica): allocates its own pin sequence, stages
  incoming chunks at their wire offset in a final-size host region
  (out-of-order safe, coverage-verified), then seals: one scatter per
  layer writes the pages into the pool, the chain hashes are adopted
  into the local prefix cache, and the pin is released so the pages
  park *retained*. The very next ``generate`` for that prompt
  prefix-hits them through the ordinary scheduler admission path and
  starts at ``cached_len``.
- **Puller** (the decode side): reads the stream chunk by chunk, each
  chunk admitted through the process-wide transfer
  :class:`~raytpu_torch.cluster.transfer.ByteWindow`. Any failure (peer
  death, short read, armed failpoint) aborts the sink —
  pages freed on the spot — and returns 0, telling the caller to prefill
  locally; the source frees its pin either via the peer's best-effort
  ``kv_export_end`` or the TTL sweep.

The wire format is the JAX package's: a flat ``[layer][k|v][page]``
stream of ``page_bytes`` segments, and the same meta keys, with
``dtype`` spelled as numpy spells it (``"float32"``, ``"bfloat16"``), so
either package reads a stream the other wrote. numpy has no bfloat16, so
pages cross to and from the host as raw bytes (``torch.uint8`` views).

On the card a page read must not wait behind the decode steps the
stepping loop has queued since: ``begin`` records a CUDA event on the
device's default stream (every thread of a deployment launches there),
after the kernels that wrote the pages, and reads copy on a side stream
that waits on that event, so a read synchronises only with its own copy.

The four ``raytpu_infer_handoff_*_total`` counters are the JAX
package's, process-wide; :func:`stats` reads them. Its failpoint sites
are the JAX package's: ``disagg.read_chunk`` on the source at each chunk
read, ``disagg.pull_chunk`` on the puller before each chunk
(:mod:`raytpu_torch.util.failpoints`).
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raytpu_torch.cluster import constants as tuning
from raytpu_torch.cluster import transfer
from raytpu_torch.inference.prefix_cache import chain_hashes
from raytpu_torch.util.failpoints import failpoint
from raytpu_torch.util.metrics import Counter

_handoff_pages_total = Counter(
    "raytpu_infer_handoff_pages_total",
    "KV pages grafted via disaggregated prefill->decode handoff")
_handoff_bytes_total = Counter(
    "raytpu_infer_handoff_bytes_total",
    "Payload bytes streamed in cross-replica KV handoffs")
_handoff_aborts_total = Counter(
    "raytpu_infer_handoff_aborts_total",
    "KV handoffs aborted mid-stream (peer death, TTL sweep, failpoint)")
_handoff_fallbacks_total = Counter(
    "raytpu_infer_handoff_fallbacks_total",
    "Disaggregated pulls that fell back to a local (colocated) prefill")


def stats() -> Dict[str, int]:
    """The process-wide handoff counters (cumulative): pages grafted,
    payload bytes streamed, handoffs aborted mid-stream, pulls that fell
    back to a local prefill."""
    return {"pages": int(_handoff_pages_total.value),
            "bytes": int(_handoff_bytes_total.value),
            "aborts": int(_handoff_aborts_total.value),
            "fallbacks": int(_handoff_fallbacks_total.value)}


def _dtype_name(dtype: torch.dtype) -> str:
    """``np.dtype(x).name`` of the JAX package's pools for a torch dtype:
    ``"float32"``, ``"bfloat16"``, ``"float16"``."""
    return str(dtype).removeprefix("torch.")


@dataclass
class _Export:
    """One open KV export on the source side."""

    handoff_id: str
    pin_id: str
    page_ids: List[int]
    page_bytes: int
    total_bytes: int
    opened: float
    # The CUDA event recorded at ``begin`` after the writes of the pages
    # (None for pools on the CPU).
    ready: Any = None
    # (segment index, backing array, byte view) of the segment served
    # last — chunk reads walk segments in order, so one entry suffices.
    seg_cache: Optional[Tuple[int, Any, memoryview]] = field(default=None)


class KVHandoffSource:
    """Source half of a KV handoff; one per engine, owned by the
    serving layer.

    Locking contract: ``begin``/``end``/``abort_all``/``sweep`` mutate
    the engine's page bookkeeping and must run under the deployment's
    engine lock. ``read`` only touches pinned (immutable) pages and the
    internal export table, so it runs lock-free — a slow stream never
    blocks the stepping loop.
    """

    def __init__(self, engine):
        self.engine = engine
        self._exports: Dict[str, _Export] = {}
        self._lock = threading.Lock()
        self._stream = None  # the side stream of page reads on the card

    def begin(self, prompt: Sequence[int],
              max_pages: Optional[int] = None) -> Optional[dict]:
        """Pin the prompt's cached full-page prefix and open an export.

        Returns the handoff meta dict, or None when nothing is cached
        (the caller may prefill and retry, or give up). Requires the
        engine lock.
        """
        eng = self.engine
        pc = eng.prefix_cache
        if pc is None:
            return None
        self.sweep()
        prompt = [int(t) for t in prompt]
        ps = eng.page_size
        # Cap one token short of the prompt, mirroring scheduler
        # admission: the decode side must run >= 1 token through the
        # model to have logits to sample from, so the final page of an
        # exactly-page-aligned prompt is never worth shipping.
        cap = (len(prompt) - 1) // ps
        if max_pages is not None:
            cap = min(cap, int(max_pages))
        if cap <= 0:
            return None
        pages = pc.match(prompt, max_pages=cap)
        if not pages:
            return None
        pin_id = f"kvship-{uuid.uuid4().hex[:12]}"
        # Retainer-protocol pin: graft every exported page into a dummy
        # sequence (all-prefix, zero tail). Referenced pages are never
        # on the eviction list, so the stream reads stable bytes.
        if not eng.cache.allocate_shared(pin_id, len(pages) * ps, pages):
            return None
        cache = eng.cache
        page_bytes = (ps * cache.num_kv_heads * cache.head_dim
                      * cache.dtype.itemsize)
        total = cache.num_layers * 2 * len(pages) * page_bytes
        ready = None
        if cache.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.default_stream(cache.device))
        hid = uuid.uuid4().hex
        with self._lock:
            self._exports[hid] = _Export(
                handoff_id=hid, pin_id=pin_id, page_ids=list(pages),
                page_bytes=page_bytes, total_bytes=total,
                opened=time.monotonic(), ready=ready)
        return {
            "handoff_id": hid,
            "num_pages": len(pages),
            "tokens_covered": len(pages) * ps,
            "page_size": ps,
            "num_layers": cache.num_layers,
            "kv_heads": cache.num_kv_heads,
            "head_dim": cache.head_dim,
            "dtype": _dtype_name(cache.dtype),
            "page_bytes": page_bytes,
            "total_bytes": total,
        }

    def read(self, handoff_id: str, offset: int, length: int) -> bytes:
        """Serve one chunk of the export's flat byte stream.

        Layout: ``[layer][k|v][page]`` segments of ``page_bytes`` each.
        Chunks are sliced from per-page host copies — page-granular, so
        at most one page crosses to the host per segment, never the pool.
        """
        failpoint("disagg.read_chunk")
        with self._lock:
            ex = self._exports.get(handoff_id)
        if ex is None:
            raise KeyError(f"unknown KV handoff {handoff_id!r}")
        offset, length = int(offset), int(length)
        if offset < 0 or length < 0 or offset + length > ex.total_bytes:
            raise ValueError(
                f"KV chunk [{offset}, {offset + length}) outside export "
                f"of {ex.total_bytes} bytes")
        out = bytearray()
        while length > 0:
            seg, seg_off = divmod(offset, ex.page_bytes)
            take = min(length, ex.page_bytes - seg_off)
            view = self._segment_view(ex, seg)
            out += view[seg_off:seg_off + take]
            offset += take
            length -= take
        return bytes(out)

    def _segment_view(self, ex: _Export, seg: int) -> memoryview:
        cached = ex.seg_cache
        if cached is not None and cached[0] == seg:
            return cached[2]
        n = len(ex.page_ids)
        layer, rest = divmod(seg, 2 * n)
        kind, pidx = divmod(rest, n)
        pool = self.engine.cache.k if kind == 0 else self.engine.cache.v
        page = pool[layer][ex.page_ids[pidx]].view(torch.uint8)
        if ex.ready is None:
            arr = page.numpy().copy()
        else:
            arr = self._copy_to_host(page, ex.ready)
        view = memoryview(arr.reshape(-1))
        ex.seg_cache = (seg, arr, view)
        return view

    def _copy_to_host(self, page: torch.Tensor,
                      ready: "torch.cuda.Event") -> np.ndarray:
        """One page to the host on the side stream, after ``ready``: the
        blocking copy synchronises the side stream only."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=page.device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            return page.cpu().numpy()

    def end(self, handoff_id: str) -> bool:
        """Close an export and release its pin (the pages go back to
        parked-retained). Idempotent. Requires the engine lock."""
        with self._lock:
            ex = self._exports.pop(handoff_id, None)
        if ex is None:
            return False
        self.engine.cache.free(ex.pin_id)
        return True

    def abort_all(self) -> int:
        """Release every open export (shutdown path). Requires the
        engine lock."""
        with self._lock:
            exports = list(self._exports.values())
            self._exports.clear()
        for ex in exports:
            self.engine.cache.free(ex.pin_id)
            _handoff_aborts_total.inc()
        return len(exports)

    def sweep(self, now: Optional[float] = None) -> int:
        """Free exports older than ``RAYTPU_KV_HANDOFF_TTL_S`` — the
        decode peer died mid-pull and will never call ``end``. Runs on
        every ``begin`` (and may be called directly). Requires the
        engine lock."""
        ttl = tuning.KV_HANDOFF_TTL_S
        now = time.monotonic() if now is None else now
        expired: List[_Export] = []
        with self._lock:
            for hid in list(self._exports):
                if now - self._exports[hid].opened > ttl:
                    expired.append(self._exports.pop(hid))
        for ex in expired:
            self.engine.cache.free(ex.pin_id)
            _handoff_aborts_total.inc()
        return len(expired)

    def open_exports(self) -> int:
        with self._lock:
            return len(self._exports)


class KVHandoffSink:
    """Sink half of a KV handoff; one per pull.

    ``begin``/``seal``/``abort`` mutate engine bookkeeping and require
    the engine lock; ``write`` stages bytes host-side and is lock-free.
    """

    def __init__(self, engine):
        self.engine = engine
        self._pin_id: Optional[str] = None
        self._pages: List[int] = []
        self._hashes: List[bytes] = []
        self._meta: Dict[str, Any] = {}
        self._buf: Optional[np.ndarray] = None
        self._ranges: List[Tuple[int, int]] = []

    def begin(self, meta: dict, prompt: Sequence[int]) -> bool:
        """Reserve destination pages for the incoming stream. The chain
        hashes are recomputed locally from the prompt — the sink never
        trusts sender-supplied hashes. Requires the engine lock."""
        eng = self.engine
        cache = eng.cache
        if eng.prefix_cache is None:
            return False
        if (meta["page_size"] != eng.page_size
                or meta["num_layers"] != cache.num_layers
                or meta["kv_heads"] != cache.num_kv_heads
                or meta["head_dim"] != cache.head_dim
                or meta["dtype"] != _dtype_name(cache.dtype)):
            raise ValueError(
                "KV layout mismatch between replicas: got "
                f"{meta!r}, local page_size={eng.page_size} "
                f"layers={cache.num_layers} kv_heads={cache.num_kv_heads} "
                f"head_dim={cache.head_dim} "
                f"dtype={_dtype_name(cache.dtype)}")
        n = int(meta["num_pages"])
        if n <= 0:
            return False
        prompt = [int(t) for t in prompt]
        hashes = chain_hashes(prompt[:n * eng.page_size], eng.page_size)
        if len(hashes) != n:
            raise ValueError(
                f"prompt covers {len(hashes)} full pages, peer sent {n}")
        pin_id = f"kvgraft-{uuid.uuid4().hex[:12]}"
        if not cache.allocate(pin_id, n * eng.page_size):
            return False
        self._pin_id = pin_id
        self._pages = cache.block_table(pin_id)
        self._hashes = hashes
        self._meta = dict(meta)
        # Final-size host staging region: every chunk lands at its wire
        # offset, so out-of-order and duplicate delivery are both safe.
        self._buf = np.zeros(int(meta["total_bytes"]), dtype=np.uint8)
        self._ranges = []
        return True

    def write(self, offset: int, data) -> None:
        if self._buf is None:
            raise RuntimeError("sink not begun (or already sealed)")
        view = memoryview(data)
        offset = int(offset)
        end = offset + len(view)
        if offset < 0 or end > self._buf.shape[0]:
            raise ValueError(
                f"chunk [{offset}, {end}) outside staging region of "
                f"{self._buf.shape[0]} bytes")
        self._buf[offset:end] = np.frombuffer(view, dtype=np.uint8)
        self._note(offset, end)

    def _note(self, start: int, end: int) -> None:
        ranges = sorted(self._ranges + [(start, end)])
        merged = [ranges[0]]
        for a, b in ranges[1:]:
            if a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        self._ranges = merged

    def complete(self) -> bool:
        return (self._buf is not None and self._buf.shape[0] > 0
                and self._ranges == [(0, self._buf.shape[0])])

    def seal(self) -> int:
        """Scatter the staged pages into the pool, adopt their hashes,
        release the pin (pages park retained). Returns pages adopted.
        Requires the engine lock."""
        if self._pin_id is None or self._buf is None:
            raise RuntimeError("sink not begun (or already sealed)")
        if not self.complete():
            covered = sum(b - a for a, b in self._ranges)
            raise ValueError(
                f"incomplete KV stream: {covered}/{self._buf.shape[0]} "
                "bytes covered")
        eng = self.engine
        cache = eng.cache
        n = int(self._meta["num_pages"])
        # One copy of the whole stream to the pool's device, read there as
        # the pool's dtype: numpy has no bfloat16.
        staged = torch.from_numpy(self._buf).to(cache.device).view(
            cache.dtype).reshape(cache.num_layers, 2, n, eng.page_size,
                                 cache.num_kv_heads, cache.head_dim)
        idx = torch.tensor(self._pages, dtype=torch.long, device=cache.device)
        with torch.no_grad():
            for li in range(cache.num_layers):
                cache.k[li].index_copy_(0, idx, staged[li, 0])
                cache.v[li].index_copy_(0, idx, staged[li, 1])
        # Adopt BEFORE freeing the pin: retain() only parks registered
        # pages, so the order is what turns "free" into "park".
        adopted = eng.prefix_cache.adopt(self._pages, self._hashes)
        cache.free(self._pin_id)
        _handoff_pages_total.inc(adopted)
        _handoff_bytes_total.inc(int(self._meta["total_bytes"]))
        self._pin_id = None
        self._buf = None
        return adopted

    def abort(self) -> None:
        """Free the reserved pages (nothing was adopted, so the pin
        release returns them straight to the free list). Idempotent.
        Requires the engine lock."""
        if self._pin_id is not None:
            self.engine.cache.free(self._pin_id)
            self._pin_id = None
            _handoff_aborts_total.inc()
        self._buf = None


def pull_kv_prefix(engine, lock, peer, prompt: Sequence[int]) -> int:
    """Receiver-driven handoff: fetch ``peer``'s cached KV prefix for
    ``prompt`` into ``engine``'s pool and prefix cache.

    ``peer`` duck-types three methods — ``kv_export_begin(prompt,
    max_pages)``, ``kv_export_read(handoff_id, offset, length)``,
    ``kv_export_end(handoff_id)`` — so it can be a sibling deployment
    object in-process (of either package: the wire format is shared).

    Returns the number of prompt tokens grafted; 0 means "prefill
    locally" (peer had nothing cached, or the stream failed — the sink
    is aborted and its pages already freed). Never raises.
    """
    prompt = [int(t) for t in prompt]
    if engine.prefix_cache is None:
        return 0
    cap = (len(prompt) - 1) // engine.page_size
    if cap <= 0:
        return 0
    try:
        meta = peer.kv_export_begin(prompt, cap)
    except Exception:
        _handoff_fallbacks_total.inc()
        return 0
    if not meta:
        return 0
    hid = meta["handoff_id"]
    sink = KVHandoffSink(engine)
    try:
        with lock:
            if not sink.begin(meta, prompt):
                return 0
        window = transfer._window()
        chunk = max(1, int(tuning.KV_STREAM_CHUNK_BYTES))
        total = int(meta["total_bytes"])
        offset = 0
        while offset < total:
            n = min(chunk, total - offset)
            window.acquire(n)
            try:
                failpoint("disagg.pull_chunk")
                data = peer.kv_export_read(hid, offset, n)
                if len(memoryview(data)) != n:
                    raise IOError(
                        f"short KV chunk: {len(memoryview(data))} != {n}")
                sink.write(offset, data)
            finally:
                window.release(n)
            offset += n
        with lock:
            sink.seal()
        return int(meta["tokens_covered"])
    except Exception:
        with lock:
            sink.abort()
        _handoff_fallbacks_total.inc()
        return 0
    finally:
        # Best-effort unpin on the source; if the peer is dead its TTL
        # sweep frees the pinned pages instead.
        try:
            peer.kv_export_end(hid)
        except Exception:
            pass
