"""LLMDeployment: the inference engine behind a serve replica; the port
of ``raytpu/inference/serving.py``.

This is the replica body: the class the serve fabric instantiates in
each replica process (``raytpu_torch.serve.LLMDeployment._target``, as
``serve.LLMDeployment._target`` in the JAX package). Through serve, a
client calls ``handle.generate.remote_streaming(prompt, ...)``: the
router picks a replica, the replica's ``handle_request_streaming`` drains
:meth:`LLMDeployment.generate` on its executor, and each token id crosses
back as its own message of the port's runtime while the sequence still
decodes. The class also stays a plain one that a caller builds and calls
in one process; a decode replica's prefill peer is then any object with
the ``kv_export_*`` trio (another ``LLMDeployment``, of either package).
Through serve, the peer is the prefill deployment's ``DeploymentHandle``
(or its bound node, which ``build_app`` turns into one): the decode
replica pulls through :class:`_HandlePeer`, each chunk a call on the one
prefill replica that pinned the pages.

The engine is pumped by a REPLICA-OWNED background stepping loop: one
daemon thread per replica steps the engine whenever any request is
unfinished and parks on a condition variable otherwise. Request threads
only drain their own buffers — a slow (or stalled) consumer never stalls
other streams, and tokens keep decoding while nobody is pulling.
Cancellation rides generator close: closing a stream (or dropping it;
through serve, the client's ``close()``, which the runtime carries to the
replica) delivers GeneratorExit to :meth:`LLMDeployment.generate`'s
frame, whose ``finally`` aborts the request — freeing its KV pages. :meth:`abort`
ends a stream from outside it.

As in the JAX package, an exception in the engine's step ends the loop's
thread (its traceback goes to ``threading.excepthook``) and the streams
then wait; callers that must see such a death check
``_step_thread.is_alive()``.

The loop also maintains a lock-free ``engine_pressure()`` snapshot
(waiting depth, KV-page occupancy, TTFT p95).

Disaggregated serving: a deployment may be built with ``role="prefill"``
(serves ``kv_export_*`` — prefills prompts on demand, pins the finished
pages, streams them out chunk by chunk) or ``role="decode"`` with
``prefill=<peer>`` (on each request, pulls the prompt's KV prefix from
the peer into the local prefix cache before admission, so the engine
grafts the pages and starts at ``cached_len`` without re-prefilling).
See :mod:`raytpu_torch.inference.disagg`.

The request context's deployment and tenant tags ride each request's
``Sequence`` (the stepping loop, on its own thread, emits the engine's
request events under them), and a decode replica's pull emits
``HANDOFF_START``/``HANDOFF_END`` and books a pull that fell back as
wasted prefill in the goodput ledger, as the JAX package's replica does.
"""

from __future__ import annotations

import dataclasses
import threading
import uuid
from collections import deque
from typing import Dict, Optional

import torch

from raytpu_torch import resolve_device
from raytpu_torch.cluster import constants as tuning
from raytpu_torch.inference import disagg
from raytpu_torch.inference.engine import InferenceEngine
from raytpu_torch.inference.sampling import SamplingParams
# The ambient per-request context: a hosting replica sets it per request
# ({"request_id", "deployment", "tenant"}); direct callers leave it empty.
from raytpu_torch.serve._private.replica import (_request_context,  # noqa: F401
                                                 get_request_context)
from raytpu_torch.util import serve_slo, task_events


class _HandlePeer:
    """``kv_export_*`` over a serve DeploymentHandle, sticky to ONE
    prefill replica — every chunk of a handoff must hit the replica
    that pinned the pages, so the power-of-two router is consulted
    once per peer, not once per chunk. Any failure drops the sticky
    pick (the next request re-chooses a live replica). Unlike the JAX
    package's, it remembers which replica opened each export, so a
    pull that failed still ends its export there (the pinned pages are
    freed at once, not by the TTL sweep) when that replica lives."""

    def __init__(self, handle):
        self._handle = handle
        self._replica = None
        self._exporters: Dict[str, object] = {}  # handoff id: replica

    def _actor(self):
        if self._replica is None:
            router = self._handle._get_router()
            self._replica = router._replica_set.choose()
        return self._replica

    def _call(self, replica, method: str, args: tuple):
        from raytpu_torch import runtime

        try:
            return runtime.get(replica.handle_request.remote(
                method, args, {}, {}))
        except Exception:
            self._replica = None
            raise

    def kv_export_begin(self, prompt, max_pages=None):
        replica = self._actor()
        meta = self._call(replica, "kv_export_begin", (prompt, max_pages))
        if meta:
            self._exporters[meta["handoff_id"]] = replica
        return meta

    def kv_export_read(self, handoff_id, offset, length):
        return self._call(self._exporters[handoff_id], "kv_export_read",
                          (handoff_id, offset, length))

    def kv_export_end(self, handoff_id):
        replica = self._exporters.pop(handoff_id, None)
        if replica is None:
            return False
        return self._call(replica, "kv_export_end", (handoff_id,))


class _HandoffLock:
    """A reentrant lock that, on its last release, hands itself to the
    thread that has waited longest instead of letting the releasing thread
    take it back first. The stepping loop releases the engine lock between
    steps and re-takes it a few bytecodes later, before a woken request
    thread can run; with a plain lock (the JAX package's: ``Condition()``
    over an ``RLock``) request threads can wait until the loop parks, so
    tokens may reach a stream only once every sequence has finished and
    an out-of-band abort land after the tokens it meant to stop. Handed
    over, a request thread waits at most for the step in flight.

    Provides what ``threading.Condition`` takes of its lock: ``acquire``
    (blocking), ``release``, the context protocol and the three private
    hooks a reentrant lock gives it."""

    def __init__(self):
        self._mutex = threading.Lock()
        self._owner: Optional[int] = None
        self._depth = 0
        self._queue: deque = deque()  # (thread id, its gate), oldest first

    def acquire(self, blocking: bool = True) -> bool:
        me = threading.get_ident()
        with self._mutex:
            if self._owner == me:
                self._depth += 1
                return True
            if self._owner is None:  # so nobody is queued either
                self._owner, self._depth = me, 1
                return True
            if not blocking:
                return False
            gate = threading.Lock()
            gate.acquire()
            self._queue.append((me, gate))
        gate.acquire()  # released by the thread that hands the lock over
        return True

    def release(self) -> None:
        with self._mutex:
            if self._owner != threading.get_ident():
                raise RuntimeError("cannot release un-acquired lock")
            self._depth -= 1
            if not self._depth:
                self._hand_over()

    def _hand_over(self) -> None:
        """Give the lock to the oldest waiter, or free it (under
        ``_mutex``)."""
        if self._queue:
            self._owner, gate = self._queue.popleft()
            self._depth = 1
            gate.release()
        else:
            self._owner, self._depth = None, 0

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self) -> int:
        with self._mutex:
            depth = self._depth
            self._hand_over()
        return depth

    def _acquire_restore(self, depth: int) -> None:
        self.acquire()
        self._depth = depth


def _model_family(model: str):
    """(config class, model class) of a family name."""
    if model == "llama":
        from raytpu_torch.models.llama import Llama, LlamaConfig

        return LlamaConfig, Llama
    if model == "gpt2":
        from raytpu_torch.models.gpt2 import GPT2, GPT2Config

        return GPT2Config, GPT2
    raise ValueError(f"unknown model family: {model!r}")


class LLMDeployment:
    """Serve a decoder LM with continuous batching + streaming tokens.

    Args:
        model: "llama" or "gpt2".
        model_config: a ``LlamaConfig``/``GPT2Config`` (or kwargs dict
            for one). Defaults to the family's ``tiny()`` config in fp32
            with the plain attention (and RMSNorm) versions, as the JAX
            package's default.
        engine_options: kwargs forwarded to :class:`InferenceEngine`
            (page_size, num_pages, max_num_seqs, prefill_chunk,
            enable_prefix_cache, ...).
        seed: parameter-init seed — two replicas with the same seed on
            the same device hold identical weights.
        role: None (serve everything, the default), "prefill" (KV
            factory: prefills + exports pages), or "decode" (pulls
            prompt KV from ``prefill`` before admission and decodes).
        prefill: the prefill peer for ``role="decode"`` — a
            DeploymentHandle (serve composition) or any object with the
            ``kv_export_*`` trio (a deployment built in this process).
        device: ``cuda`` unless ``"cpu"`` is asked for; raises without a
            card.
        state_dict: weights loaded into the model after it is built (a
            dict of CPU tensors, as ``models/convert.py`` makes from the
            JAX package's parameters); None keeps the seed's.
    """

    def __init__(self, model: str = "llama", model_config=None,
                 engine_options: Optional[dict] = None, seed: int = 0,
                 role: Optional[str] = None, prefill=None, device=None,
                 state_dict: Optional[dict] = None):
        self.device = resolve_device(device)
        cfg_cls, model_cls = _model_family(model)
        if model_config is None:
            tiny = cfg_cls.tiny()
            model_config = dataclasses.replace(
                tiny, dtype=torch.float32, remat=False,
                **{f: "reference" for f in ("attn_impl", "paged_attn",
                                            "norm_impl") if hasattr(tiny, f)})
        elif isinstance(model_config, dict):
            model_config = cfg_cls(**model_config)
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"unknown replica role: {role!r}")
        self._role = role
        self._prefill = prefill
        self._peer = None  # the prefill peer as pulled from, at first use
        net = model_cls(model_config, device=self.device, seed=seed)
        if state_dict is not None:
            net.load_state_dict(state_dict)
        self._engine = InferenceEngine(net, device=self.device,
                                       **(engine_options or {}))
        self._handoff_source = disagg.KVHandoffSource(self._engine)
        # One condition serializes engine mutation (add/abort/step) and
        # carries wakeups both ways: producers signal "new work" to the
        # loop, the loop signals "new tokens" to consumers. Its lock is
        # handed over on release, so the loop cannot starve them.
        self._cv = threading.Condition(_HandoffLock())
        self._buffers: Dict[str, deque] = {}
        self._finished: Dict[str, str] = {}
        # O(1) request-liveness: ids currently registered with the
        # engine, plus their serving attribution.
        self._live: set = set()
        self._req_info: Dict[str, dict] = {}
        self._closed = False
        # Lock-free pressure snapshot: the loop REPLACES the dict, so
        # readers never see a half-written one (GIL-atomic store).
        self._pressure = self._engine.pressure()
        self._step_thread = threading.Thread(
            target=self._step_loop, name="llm-step-loop", daemon=True)
        self._step_thread.start()

    # ---- the replica-owned stepping loop ----------------------------

    def _step_loop(self) -> None:
        """Pump the engine while any request is unfinished; park on the
        condition when idle. Runs on a daemon thread for the replica's
        whole life — consumers never step the engine themselves."""
        if self.device.type == "cuda":
            # The current device is per thread: launch on the engine's.
            torch.cuda.set_device(self.device)
        while True:
            with self._cv:
                while not self._closed and not self._engine.has_unfinished():
                    self._engine.note_idle()
                    self._pressure = self._engine.pressure()
                    self._cv.wait(timeout=0.5)
                if self._closed:
                    return
                outs = self._engine.step()
                for out in outs:
                    buf = self._buffers.get(out.request_id)
                    if buf is not None:
                        buf.append(out.token_id)
                    if out.finished:
                        self._finished[out.request_id] = out.finish_reason
                self._pressure = self._engine.pressure()
                if outs:
                    self._cv.notify_all()
            # The lock is dropped between iterations so request threads
            # can drain buffers / add / abort while the engine is busy:
            # handed to the oldest of them, it comes back after them.

    def shutdown(self) -> None:
        """Stop the stepping loop and wait for its thread (up to 5 s)."""
        with self._cv:
            self._handoff_source.abort_all()
            self._closed = True
            self._cv.notify_all()
        self._step_thread.join(timeout=5.0)

    # ---- request-facing API -----------------------------------------

    def generate(self, prompt, max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 stop_token_ids=()):
        """Sync generator of token ids for one request; safe to call
        from many requests concurrently — they share decode steps."""
        sampling = SamplingParams(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, seed=seed, stop_token_ids=tuple(stop_token_ids))
        prompt = [int(t) for t in prompt]
        # A hosting replica's request context carries the client's
        # request id, which the engine sequence keeps (direct callers get
        # a fresh id), and the deployment and tenant tags its events and
        # ledger entries book under.
        ctx = get_request_context()
        request_id = str(ctx.get("request_id") or uuid.uuid4().hex)
        deployment_name = str(ctx.get("deployment") or "")
        tenant = str(ctx.get("tenant") or "")
        if self._role == "decode" and self._prefill is not None:
            # Disaggregated prefill: graft the prompt's KV prefix from
            # the prefill peer before admission. Best-effort by design
            # — on any failure the request simply prefills here.
            self._maybe_pull_prefix(prompt, request_id=request_id,
                                    deployment=deployment_name,
                                    tenant=tenant)
        with self._cv:
            seq = self._engine.add_request(request_id, prompt, sampling)
            seq.deployment = deployment_name
            seq.tenant = tenant
            self._buffers[request_id] = deque()
            self._live.add(request_id)
            self._req_info[request_id] = {"deployment": deployment_name,
                                          "tenant": tenant}
            self._cv.notify_all()  # wake the stepping loop
        try:
            while True:
                token = self._next_token(request_id)
                if token is None:
                    return
                yield token
        finally:
            with self._cv:
                self._engine.abort(request_id)  # no-op if finished
                self._buffers.pop(request_id, None)
                self._finished.pop(request_id, None)
                self._live.discard(request_id)
                self._req_info.pop(request_id, None)
                self._cv.notify_all()

    def _next_token(self, request_id: str) -> Optional[int]:
        with self._cv:
            while True:
                buf = self._buffers.get(request_id)
                if buf is None:
                    return None
                if buf:
                    return buf.popleft()
                if request_id in self._finished or self._closed:
                    return None
                if request_id not in self._live:
                    # Out-of-band abort: the request left the engine
                    # without a finish marker — end the stream.
                    return None
                # Timed wait guards against a lost wakeup if the loop
                # notified between our buffer check and the wait.
                self._cv.wait(timeout=1.0)

    # ---- disaggregated prefill/decode (see inference/disagg.py) -----

    def _peer_obj(self):
        if self._peer is None:
            from raytpu_torch.serve.handle import DeploymentHandle

            peer = self._prefill
            # hasattr is useless on a DeploymentHandle (its __getattr__
            # manufactures a method wrapper for ANY name), so the wire
            # case is matched by type; everything else duck-types.
            self._peer = (_HandlePeer(peer)
                          if isinstance(peer, DeploymentHandle) else peer)
        return self._peer

    def _maybe_pull_prefix(self, prompt, request_id: str = "",
                           deployment: str = "", tenant: str = "") -> int:
        """Pull the prompt's full-page KV prefix from the prefill peer
        unless the local prefix cache already covers it. Returns tokens
        grafted (0 = nothing pulled; local prefill covers the rest)."""
        eng = self._engine
        if eng.prefix_cache is None:
            return 0
        cap = (len(prompt) - 1) // eng.page_size
        if cap <= 0:
            return 0
        with self._cv:
            local = len(eng.prefix_cache.match(prompt, max_pages=cap))
        if local >= cap:
            return 0
        if task_events.request_events_enabled() and request_id:
            task_events.emit_request(
                request_id, task_events.RequestTransition.HANDOFF_START,
                deployment=deployment, tenant=tenant,
                data={"pages_wanted": cap - local})
        pulled = disagg.pull_kv_prefix(eng, self._cv, self._peer_obj(),
                                       prompt)
        if pulled == 0:
            # Failed pull: the whole prompt goes back through local
            # prefill — book the recompute in the goodput ledger.
            serve_slo.wasted("handoff_fallback", len(prompt), deployment,
                             tenant)
        if task_events.request_events_enabled() and request_id:
            task_events.emit_request(
                request_id, task_events.RequestTransition.HANDOFF_END,
                deployment=deployment, tenant=tenant,
                data={"tokens_grafted": pulled,
                      "fallback": pulled == 0})
        return pulled

    def kv_export_begin(self, prompt, max_pages=None):
        """Open a KV export of ``prompt``'s full-page prefix, running a
        (chunked) prefill first when it isn't cached yet — the prefill
        replica's whole job. Returns the handoff meta dict, or None
        when there is nothing to export."""
        if self._role == "decode":
            raise RuntimeError("decode replicas do not export KV")
        eng = self._engine
        if eng.prefix_cache is None:
            return None
        prompt = [int(t) for t in prompt]
        cap = (len(prompt) - 1) // eng.page_size
        if max_pages is not None:
            cap = min(cap, int(max_pages))
        if cap <= 0:
            return None
        with self._cv:
            have = len(eng.prefix_cache.match(prompt, max_pages=cap))
        if have < cap:
            # Prefill through the normal request path (chunked per the
            # engine's prefill_chunk), which registers the prompt's
            # full pages as a side effect; one sampled-and-discarded
            # token is the price of reusing the engine seam unmodified.
            for _ in self.generate(prompt, max_new_tokens=1):
                pass
        with self._cv:
            return self._handoff_source.begin(prompt, max_pages=cap)

    def kv_export_read(self, handoff_id, offset, length):
        """Serve one chunk of an open export (lock-free: reads only
        pinned pages, so a slow puller never blocks the step loop)."""
        return self._handoff_source.read(handoff_id, offset, length)

    def kv_export_end(self, handoff_id) -> bool:
        with self._cv:
            return self._handoff_source.end(handoff_id)

    def prefix_summary(self) -> dict:
        """Compact routing summary for a prefix-aware router: registered
        page-chain digests plus the load signals."""
        eng = self._engine
        digests = []
        if eng.prefix_cache is not None:
            with self._cv:
                digests = eng.prefix_cache.summary(
                    tuning.PREFIX_SUMMARY_MAX)
        pressure = self.engine_pressure()
        return {
            "digests": digests,
            "page_size": eng.page_size,
            "role": self._role,
            "kv_utilization": pressure.get("kv_utilization", 0.0),
            "ttft_p95_s": pressure.get("ttft_p95_s", 0.0),
        }

    # ---- introspection ----------------------------------------------

    def engine_pressure(self) -> dict:
        """Latest engine-load snapshot, readable without the engine
        lock, even while a step is in flight."""
        return dict(self._pressure)

    def stats(self) -> dict:
        with self._cv:
            return self._engine.stats()

    def abort(self, request_id: str) -> bool:
        with self._cv:
            ok = self._engine.abort(request_id)
            if ok:
                # Out-of-band abort: drop liveness now so blocked
                # consumers end their streams on the next wakeup
                # (generate's finally re-discards harmlessly).
                self._live.discard(request_id)
                self._req_info.pop(request_id, None)
            self._cv.notify_all()
            return ok
