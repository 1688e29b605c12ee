"""InferenceEngine: continuous batching over a paged KV cache, the port
of ``raytpu/inference/engine.py``.

The JAX engine compiles one program per shape bucket; the port runs
eagerly but keeps the same buckets and padding rules, so both engines
hand the model the same shapes and produce the same tokens:

- **Prefill** pads a prompt to the smallest length bucket (powers of two
  up to ``max_model_len``) and runs one sequence at a time. A prompt
  longer than ``prefill_chunk``, or one whose prefix came from the
  prefix cache, goes through the paged chunk path one chunk per step.
- **Decode** pads the batch to the smallest batch bucket and trims the
  block tables to a bucketed page width. Dummy rows point at scratch
  page 0 with ``context_len=1``, so padding attends to one garbage slot
  and pollutes nothing.

The JAX engine's compile counters become call counts per bucket
(``stats()``). Sampling runs on the host with per-request RNGs (see
:mod:`raytpu_torch.inference.sampling`), so batched output equals solo
output.

Observability, as in the JAX engine: the ``raytpu_infer_*`` gauges,
token counters and TTFT histogram (process-wide, set every step and by
:meth:`InferenceEngine.note_idle`); the request events ``PREFILL_START``,
``PREFILL_END`` and ``FIRST_TOKEN`` (the scheduler emits the rest); the
spans ``infer.prefill``, ``infer.prefill_chunk`` and ``infer.decode``;
and, under ``profiling_enabled()``, the decode step profiler. Each site
costs one flag check when its flag is off. A span wraps a forward's
dispatch: on CUDA the forward returns before the card has run it, and
the host copy of the logits that waits for it comes after the span (the
JAX span around an asynchronous jit call reads the same). The step
profiler times a decode from before its forward to after that copy, so
its step time holds the device's work.

Not ported yet: tensor parallelism (``tp``/``mesh``; see ROADMAP.md).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence as SequenceT, Union

import numpy as np
import torch

from raytpu_torch import resolve_device
from raytpu_torch.inference.kv_cache import PagedKVCache
from raytpu_torch.inference.prefix_cache import PrefixCache
from raytpu_torch.inference.sampling import SamplingParams, sample_token
from raytpu_torch.inference.scheduler import Scheduler, Sequence
from raytpu_torch.models.common import write_kv
from raytpu_torch.models.gpt2 import (GPT2, gpt2_decode, gpt2_prefill,
                                      gpt2_prefill_chunk)
from raytpu_torch.models.llama import (Llama, llama_decode, llama_prefill,
                                       llama_prefill_chunk)
from raytpu_torch.util import task_events, tracing
from raytpu_torch.util.metrics import Counter, Gauge, Histogram
from raytpu_torch.util.profiler import profiling_enabled
from raytpu_torch.util.stepprof import decode_step_flops, step_profiler

_running_gauge = Gauge("raytpu_infer_running_requests",
                       "Sequences currently decoding")
_waiting_gauge = Gauge("raytpu_infer_waiting_requests",
                       "Requests queued for admission")
_kv_util_gauge = Gauge("raytpu_infer_kv_page_utilization",
                       "Fraction of KV pages in use")
_prefill_tps_gauge = Gauge("raytpu_infer_prefill_tokens_per_s",
                           "Prefill throughput of the last engine step")
_decode_tps_gauge = Gauge("raytpu_infer_decode_tokens_per_s",
                          "Decode throughput of the last engine step")
_prefill_tokens_total = Counter("raytpu_infer_prefill_tokens_total",
                                "Prompt tokens prefilled")
_decode_tokens_total = Counter("raytpu_infer_decode_tokens_total",
                               "Tokens decoded")
_ttft_hist = Histogram(
    "raytpu_infer_ttft_seconds",
    "Time from request admission to its first sampled token",
    boundaries=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))


@dataclasses.dataclass(frozen=True)
class StepOutput:
    """One newly sampled token for one request."""

    request_id: str
    token_id: int
    finished: bool = False
    finish_reason: Optional[str] = None


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


def _bucket_for(n: int, buckets: SequenceT[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


class InferenceEngine:
    """Continuous-batching decode loop over a paged KV cache.

    Drive it with :meth:`add_request` + :meth:`step` (one scheduler
    iteration per call), or use :meth:`generate` to run a closed batch
    to completion. ``model`` is a :class:`~raytpu_torch.models.llama.
    Llama` or a :class:`~raytpu_torch.models.gpt2.GPT2` on ``device``
    (``cuda`` unless ``"cpu"`` is asked for), the two families the JAX
    engine serves; its config's ``attn_impl`` / ``paged_attn`` pick the
    attention versions.
    """

    def __init__(self, model: Union[Llama, GPT2], *, page_size: int = 16,
                 num_pages: Optional[int] = None, max_num_seqs: int = 8,
                 max_model_len: Optional[int] = None,
                 prefill_buckets: Optional[SequenceT[int]] = None,
                 decode_buckets: Optional[SequenceT[int]] = None,
                 prefill_chunk: Optional[int] = None,
                 enable_prefix_cache: bool = True,
                 tp: int = 1, mesh=None, device=None):
        self.device = resolve_device(device)
        if tp != 1 or mesh is not None:
            raise NotImplementedError(
                "tensor parallelism is not ported yet (ROADMAP.md)")
        c = model.config
        # The weights a decode step multiplies by (for its analytic FLOP
        # count): every matrix but the embedding lookups, the LM head
        # included (GPT-2's is tied to ``wte``; ``wpe`` is a lookup).
        matrices = sum(p.numel() for p in model.parameters() if p.dim() == 2)
        # The forwards by model family, as the JAX engine picks them by
        # config type (a Mixtral is neither: the engine refuses it).
        if type(model) is Llama:
            self._prefill_fwd, self._decode_fwd = llama_prefill, llama_decode
            self._chunk_fwd = llama_prefill_chunk
            kv_heads, head_dim = c.n_kv_head, c.head_dim
            matrices -= model.embed_tokens.weight.numel()
        elif type(model) is GPT2:
            self._prefill_fwd, self._decode_fwd = gpt2_prefill, gpt2_decode
            self._chunk_fwd = gpt2_prefill_chunk
            kv_heads, head_dim = c.n_head, c.n_embd // c.n_head
            matrices -= model.wpe.weight.numel()
        else:
            raise TypeError(f"unsupported model: {type(model).__name__} "
                            f"(the engine serves Llama and GPT-2)")
        if model.device != self.device:
            raise ValueError(f"model weights are on {model.device}, the "
                             f"engine runs on {self.device}")
        self.model = model
        self._matmul_params = matrices
        self._attn_dims = (c.n_layer, c.n_head, head_dim)
        self.max_model_len = min(max_model_len or c.block_size, c.block_size)
        self.page_size = page_size
        self.max_pages_per_seq = -(-self.max_model_len // page_size)
        if num_pages is None:
            num_pages = max_num_seqs * self.max_pages_per_seq + 1
        self.cache = PagedKVCache(c.n_layer, num_pages, page_size,
                                  kv_heads, head_dim, dtype=c.dtype,
                                  device=self.device)
        self.prefix_cache = (PrefixCache(self.cache)
                             if enable_prefix_cache else None)
        self.scheduler = Scheduler(self.cache, max_num_seqs=max_num_seqs,
                                   max_model_len=self.max_model_len,
                                   prefix_cache=self.prefix_cache)
        # Chunked prefill: at most this many prompt tokens per engine
        # step per sequence. Default = max_model_len, i.e. one-shot
        # prefill (the chunk path still runs for prefix-hit tails).
        self.prefill_chunk = min(prefill_chunk or self.max_model_len,
                                 self.max_model_len)
        self.prefill_buckets = sorted(prefill_buckets or _pow2_buckets(
            min(16, self.max_model_len), self.max_model_len))
        self.chunk_buckets = _pow2_buckets(
            min(16, self.prefill_chunk), self.prefill_chunk)
        self.decode_buckets = sorted(decode_buckets or _pow2_buckets(
            1, max_num_seqs))
        # Block-table width buckets: decode/chunk pass tables trimmed to
        # the batch's actual max page count, bucketed.
        self.page_buckets = _pow2_buckets(1, self.max_pages_per_seq)
        self._prefill_calls: Dict[str, int] = collections.Counter()
        self._chunk_calls: Dict[str, int] = collections.Counter()
        self._decode_calls: Dict[str, int] = collections.Counter()
        self._decode_batch_hist: List[int] = []
        self._prefill_tokens = 0
        self._decode_tokens = 0
        self._prefill_seconds = 0.0
        self._decode_seconds = 0.0
        self._arrival_ts: Dict[str, float] = {}
        self._ttft_window = collections.deque(maxlen=256)
        # Request ids whose PREFILL_START was emitted but not yet paired
        # with PREFILL_END (chunked prefills span steps; preemption-
        # resume prefills are excluded — RESUMED covers them).
        self._prefill_announced: set = set()
        self._hbm_tick = 0

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # ---- request lifecycle ------------------------------------------

    def add_request(self, request_id: str, prompt: SequenceT[int],
                    sampling: Optional[SamplingParams] = None) -> Sequence:
        sampling = sampling or SamplingParams()
        prompt = list(prompt)
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) >= self.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_model_len "
                f"{self.max_model_len} leaves no room to generate")
        if self.cache.pages_for(len(prompt) + 1) > self.cache.total_pages:
            raise ValueError("prompt exceeds total KV-page capacity")
        seq = Sequence(request_id=request_id, prompt=prompt,
                       sampling=sampling)
        self._arrival_ts[request_id] = time.perf_counter()
        self.scheduler.add(seq)
        return seq

    def abort(self, request_id: str) -> bool:
        self._arrival_ts.pop(request_id, None)
        self._prefill_announced.discard(request_id)
        return self.scheduler.abort(request_id)

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    # ---- the iteration ----------------------------------------------

    def step(self) -> List[StepOutput]:
        """One scheduler iteration: run every admitted prefill (one
        chunk each), then one padded decode step over all running
        sequences; sample on host; retire finished sequences."""
        out: List[StepOutput] = []
        plan = self.scheduler.schedule()
        t0 = time.perf_counter()
        prefilled = decoded = 0
        with torch.no_grad():
            for seq in plan.prefills:
                prefilled += self._run_prefill(seq, out)
            t1 = time.perf_counter()
            if plan.decodes:
                decoded = self._run_decode(plan.decodes, out)
        t2 = time.perf_counter()
        # Each path ends by copying logits to the host, so these host
        # times cover the device work.
        self._prefill_seconds += t1 - t0
        self._decode_seconds += t2 - t1

        # Throughput gauges reflect THIS step — a step that moved no
        # tokens zeroes them, so autoscalers never read the last busy
        # step's value as live pressure.
        if prefilled:
            self._prefill_tokens += prefilled
            _prefill_tokens_total.inc(prefilled)
            _prefill_tps_gauge.set(prefilled / max(t1 - t0, 1e-9))
        else:
            _prefill_tps_gauge.set(0.0)
        if decoded:
            self._decode_tokens += decoded
            _decode_tokens_total.inc(decoded)
            _decode_tps_gauge.set(decoded / max(t2 - t1, 1e-9))
        else:
            _decode_tps_gauge.set(0.0)
        _running_gauge.set(len(self.scheduler.running))
        _waiting_gauge.set(len(self.scheduler.waiting))
        _kv_util_gauge.set(self.cache.utilization())
        return out

    def _run_prefill(self, seq: Sequence, out: List[StepOutput]) -> int:
        """Advance one sequence's prefill by (at most) one chunk. A
        sequence starting from zero whose prompt fits in one chunk takes
        the full-prefill path (flash attention); anything with cached
        context before it (a prefix-cache hit tail, or chunk 2..n of a
        long prompt) takes the paged chunk path. The FINAL chunk's last
        logit samples the first token."""
        plen = seq.prefill_len
        start = seq.cached_len
        if task_events.request_events_enabled() and not seq.generated \
                and seq.request_id not in self._prefill_announced:
            self._prefill_announced.add(seq.request_id)
            task_events.emit_request(
                seq.request_id,
                task_events.RequestTransition.PREFILL_START,
                deployment=seq.deployment, tenant=seq.tenant,
                data={"prompt_tokens": len(seq.prompt), "cached": start})
        if start == 0 and plen <= self.prefill_chunk:
            n = self._prefill_full(seq, plen, out)
        else:
            n = self._prefill_one_chunk(seq, start, plen, out)
        if task_events.request_events_enabled() \
                and seq.cached_len >= plen \
                and seq.request_id in self._prefill_announced:
            self._prefill_announced.discard(seq.request_id)
            task_events.emit_request(
                seq.request_id,
                task_events.RequestTransition.PREFILL_END,
                deployment=seq.deployment, tenant=seq.tenant)
        return n

    def _register_prefix(self, seq: Sequence) -> None:
        """Index every fully-written full PROMPT page for sharing. Must
        run before sampling: emitting can finish the sequence and drop
        its block table."""
        if self.prefix_cache is not None:
            self.prefix_cache.register(
                seq.request_id, seq.prompt,
                min(seq.cached_len, len(seq.prompt)))

    def _prefill_full(self, seq: Sequence, plen: int,
                      out: List[StepOutput]) -> int:
        bucket = _bucket_for(plen, self.prefill_buckets)
        tokens = np.zeros((1, bucket), dtype=np.int64)
        tokens[0, :plen] = seq.tokens[:plen]
        dests = self._put(self.cache.prefill_dests(
            seq.request_id, plen, bucket).astype(np.int64))
        with tracing.span("infer.prefill", {
                "request_id": seq.request_id, "len": plen,
                "bucket": bucket}):
            logits, ks, vs = self._prefill_fwd(self.model, self._put(tokens))
            for pool_k, pool_v, k, v in zip(self.cache.k, self.cache.v,
                                            ks, vs):
                write_kv(pool_k, dests, k[0])
                write_kv(pool_v, dests, v[0])
        last = logits[0, plen - 1].cpu().numpy()
        self._prefill_calls[str(bucket)] += 1
        seq.cached_len = plen
        self._register_prefix(seq)
        if not seq.generated:
            # Fresh prompt: its last logit samples the first new token.
            # A preemption-resume prefill must NOT resample — the tail
            # token was already emitted; the next decode rewrites its KV.
            self._emit(seq, sample_token(last, seq.sampling, seq.rng), out)
        return plen

    def _prefill_one_chunk(self, seq: Sequence, start: int, plen: int,
                           out: List[StepOutput]) -> int:
        take = min(self.prefill_chunk, plen - start)
        bucket = _bucket_for(take, self.chunk_buckets)
        tokens = np.zeros((1, bucket), dtype=np.int64)
        tokens[0, :take] = seq.tokens[start:start + take]
        # Padding rows keep position 0: GPT-2 looks ``wpe`` up at every
        # position, and torch, unlike JAX, does not clamp an index out of
        # range.
        positions = np.zeros(bucket, dtype=np.int32)
        positions[:take] = np.arange(start, start + take)
        dests = self.cache.chunk_dests(seq.request_id, start, take, bucket)
        p_used = _bucket_for(self.cache.num_seq_pages(seq.request_id),
                             self.page_buckets)
        tables = self.cache.table_array([seq.request_id], p_used)
        with tracing.span("infer.prefill_chunk", {
                "request_id": seq.request_id, "start": start,
                "take": take, "bucket": bucket}):
            logits = self._chunk_fwd(
                self.model, self._put(tokens), self._put(positions),
                self._put(dests.astype(np.int64)), self._put(tables),
                self.cache.k, self.cache.v)
        last = logits[0, take - 1].cpu().numpy()
        self._chunk_calls[f"{bucket}x{p_used}"] += 1
        seq.cached_len = start + take
        self._register_prefix(seq)
        if seq.cached_len >= plen and not seq.generated:
            # Final chunk of a fresh prompt: sample the first token from
            # the last REAL row (same no-resample rule as above).
            self._emit(seq, sample_token(last, seq.sampling, seq.rng), out)
        return take

    def _run_decode(self, seqs: List[Sequence],
                    out: List[StepOutput]) -> int:
        b = len(seqs)
        bucket = _bucket_for(b, self.decode_buckets)
        P = _bucket_for(max(self.cache.num_seq_pages(s.request_id)
                            for s in seqs), self.page_buckets)
        tokens = np.zeros(bucket, dtype=np.int64)
        positions = np.zeros(bucket, dtype=np.int32)  # padding: 0, as above
        dests = np.zeros(bucket, dtype=np.int64)  # page-0 slot 0 = scratch
        context_lens = np.ones(bucket, dtype=np.int32)
        for i, seq in enumerate(seqs):
            pos = seq.cached_len
            tokens[i] = seq.tokens[-1]
            positions[i] = pos
            dests[i] = self.cache.slot(seq.request_id, pos)
            context_lens[i] = pos + 1
        tables = self.cache.table_array(
            [s.request_id for s in seqs], P, batch=bucket)
        t_dec = time.perf_counter()
        with tracing.span("infer.decode", {"batch": b, "bucket": bucket}):
            logits = self._decode_fwd(
                self.model, self._put(tokens), self._put(positions),
                self._put(dests), self._put(tables),
                self._put(context_lens), self.cache.k, self.cache.v)
        logits_np = logits[:b].cpu().numpy()  # host sync: dt covers the step
        if profiling_enabled():
            prof = step_profiler("infer")
            # FLOPs counted once per (batch bucket x table width), as the
            # JAX engine asks XLA once per compiled program.
            flops = prof.ensure_flops(
                ("decode", bucket, P), lambda: self.decode_flops(bucket, P))
            prof.observe_step(time.perf_counter() - t_dec, flops=flops)
            self._hbm_tick += 1
            if self._hbm_tick % 32 == 1:
                prof.observe_hbm(self.device)
        self._decode_calls[f"{bucket}x{P}"] += 1
        for i, seq in enumerate(seqs):
            seq.cached_len += 1
            self._emit(seq, sample_token(logits_np[i], seq.sampling,
                                         seq.rng), out)
        self._decode_batch_hist.append(b)
        return b

    def _emit(self, seq: Sequence, token: int,
              out: List[StepOutput]) -> None:
        seq.generated.append(token)
        if len(seq.generated) == 1:
            t0 = self._arrival_ts.pop(seq.request_id, None)
            if t0 is not None:
                ttft = time.perf_counter() - t0
                _ttft_hist.observe(ttft)
                self._ttft_window.append(ttft)
            if task_events.request_events_enabled():
                task_events.emit_request(
                    seq.request_id,
                    task_events.RequestTransition.FIRST_TOKEN,
                    deployment=seq.deployment, tenant=seq.tenant)
        reason = None
        if token in seq.sampling.stop_token_ids:
            reason = "stop"
        elif len(seq.generated) >= seq.sampling.max_new_tokens:
            reason = "length"
        elif seq.num_tokens >= self.max_model_len:
            reason = "length"
        if reason is not None:
            self.scheduler.finish(seq, reason)
        out.append(StepOutput(request_id=seq.request_id, token_id=token,
                              finished=reason is not None,
                              finish_reason=reason))

    # ---- convenience + introspection --------------------------------

    def generate(self, prompts: SequenceT[SequenceT[int]],
                 sampling: Optional[SamplingParams] = None,
                 ) -> List[List[int]]:
        """Run a closed batch of prompts to completion; returns the
        generated token ids per prompt."""
        ids = [f"gen-{i}" for i in range(len(prompts))]
        for rid, prompt in zip(ids, prompts):
            self.add_request(rid, prompt, sampling)
        results: Dict[str, List[int]] = {rid: [] for rid in ids}
        while self.has_unfinished():
            for o in self.step():
                if o.request_id in results:
                    results[o.request_id].append(o.token_id)
        return [results[rid] for rid in ids]

    def note_idle(self) -> None:
        """Called by the stepping loop when there is no work: zero the
        throughput gauges so scrapes between bursts read true idle."""
        _prefill_tps_gauge.set(0.0)
        _decode_tps_gauge.set(0.0)
        _running_gauge.set(len(self.scheduler.running))
        _waiting_gauge.set(len(self.scheduler.waiting))
        _kv_util_gauge.set(self.cache.utilization())

    def decode_flops(self, batch_bucket: int, pages: int) -> float:
        """Analytic FLOPs of one decode step at a batch bucket and a
        block-table width (:func:`~raytpu_torch.util.stepprof.
        decode_step_flops`): what the step profiler divides by the step
        time for ``raytpu_infer_decode_mfu``."""
        return decode_step_flops(self._matmul_params, *self._attn_dims,
                                 batch_bucket, pages, self.page_size)

    def ttft_quantile(self, q: float) -> float:
        """Recent-window TTFT quantile in seconds (0.0 when empty)."""
        if not self._ttft_window:
            return 0.0
        xs = sorted(self._ttft_window)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def pressure(self) -> Dict[str, float]:
        """Load snapshot for engine-pressure autoscaling — plain floats
        so it crosses the serve wire untouched."""
        return {
            "waiting_requests": float(len(self.scheduler.waiting)),
            "running_requests": float(len(self.scheduler.running)),
            "kv_utilization": float(self.cache.utilization()),
            "ttft_p95_s": float(self.ttft_quantile(0.95)),
        }

    def stats(self) -> dict:
        return {
            "prefill_calls": dict(self._prefill_calls),
            "chunk_prefill_calls": dict(self._chunk_calls),
            "decode_calls": dict(self._decode_calls),
            "decode_batch_hist": list(self._decode_batch_hist),
            "num_preemptions": self.scheduler.num_preemptions,
            "running": len(self.scheduler.running),
            "waiting": len(self.scheduler.waiting),
            "kv_utilization": self.cache.utilization(),
            "prefill_tokens": self._prefill_tokens,
            "decode_tokens": self._decode_tokens,
            "prefill_seconds": self._prefill_seconds,
            "decode_seconds": self._decode_seconds,
            "ttft_p50_s": self.ttft_quantile(0.5),
            "ttft_p95_s": self.ttft_quantile(0.95),
            "prefix_cache": (self.prefix_cache.stats()
                             if self.prefix_cache else None),
        }
