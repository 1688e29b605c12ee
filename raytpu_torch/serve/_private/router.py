"""Client-side request router with power-of-two-choices replica selection;
the port of :mod:`raytpu.serve._private.router`.

Reference analogue: ``python/ray/serve/_private/router.py`` and
``python/ray/serve/_private/replica_scheduler/pow_2_scheduler.py`` —
``PowerOfTwoChoicesReplicaScheduler.choose_replica_for_request``
(``:50,717``): sample two replicas, probe their queue lengths, send to the
shorter queue; if both are at ``max_ongoing_requests``, back off and
re-sample. The replica set is kept fresh by long-polling the controller
(O(changes), not O(requests)).

As in the JAX package, the router looks the controller up by name
(``SERVE_CONTROLLER``) and long-polls ``listen_for_change`` through calls
of the port's runtime; a probe is a call on a replica process. It works
alike in the driver and in a replica (a composed deployment's handle),
and never starts a controller.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from raytpu_torch import runtime
from raytpu_torch.cluster import constants as tuning
from raytpu_torch.serve._private import prefix_router
from raytpu_torch.serve._private.controller import get_controller
from raytpu_torch.util import task_events, tenancy

BACKOFF_S = 0.02
MAX_BACKOFF_S = 0.5
# Queue-length probe budget (RAYTPU_SERVE_PROBE_TIMEOUT_S). A replica
# that can't answer within this is scored worst-queue for the pick —
# NEVER assumed idle: a wedged replica that looks like a zero-length
# queue would attract every request the power-of-two pick routes.
PROBE_TIMEOUT_S = tuning.SERVE_PROBE_TIMEOUT_S


class ReplicaSet:
    """Thread-safe view of one deployment's healthy replicas, refreshed by a
    background long-poll thread."""

    def __init__(self, controller, full_name: str, max_ongoing: int):
        self._controller = controller
        self._full_name = full_name
        self._max_ongoing = max_ongoing
        self._lock = threading.Lock()
        self._replicas: List[Tuple[str, object]] = []
        self._version = -1
        # Controller-pushed prefix summaries (rid -> (recv_mono, summary)),
        # refreshed by the same long-poll thread; see pushed_summary().
        self._pushed_summaries: Dict[str, Tuple[float, dict]] = {}
        self._prefix_version = -1
        self._stopped = False
        self._have_replicas = threading.Event()
        self._thread = threading.Thread(
            target=self._poll_loop, daemon=True,
            name=f"serve-longpoll-{full_name}",
        )
        self._thread.start()

    def _poll_loop(self):
        key = f"replicas::{self._full_name}"
        prefix_key = f"prefix::{self._full_name}"
        while not self._stopped:
            try:
                updates = self._controller.call(
                    "listen_for_change",
                    {key: self._version, prefix_key: self._prefix_version})
            except Exception:  # a controller stopping or stopped
                if self._stopped:
                    return
                time.sleep(0.1)
                continue
            if prefix_key in updates:
                upd = updates[prefix_key]
                snap = upd.object_snapshot
                now = time.monotonic()
                with self._lock:
                    self._prefix_version = upd.snapshot_id
                    if isinstance(snap, dict):
                        self._pushed_summaries = {
                            rid: (now, s) for rid, s in snap.items()}
            if key in updates:
                upd = updates[key]
                snap = upd.object_snapshot
                if isinstance(snap, dict):
                    reps = list(snap["replicas"])
                    max_ongoing = int(snap.get("max_ongoing",
                                               self._max_ongoing))
                else:  # pre-dict snapshots (e.g. the delete-path empty list)
                    reps = list(snap)
                    max_ongoing = self._max_ongoing
                with self._lock:
                    self._replicas = reps
                    self._max_ongoing = max_ongoing
                    self._version = upd.snapshot_id
                if self._replicas:
                    self._have_replicas.set()
                else:
                    self._have_replicas.clear()

    def stop(self):
        self._stopped = True

    def pushed_summary(self, replica_id: str) -> Optional[dict]:
        """The controller-pushed prefix summary for one replica, or
        None when there isn't one fresh enough to trust. Staleness is
        bounded by ``RAYTPU_PREFIX_PUSH_MAX_AGE_S``: a partitioned or
        failed-over controller stops refreshing pushes, and routing on
        a frozen cache view is worse than paying the unicast probe."""
        with self._lock:
            entry = self._pushed_summaries.get(replica_id)
        if entry is None:
            return None
        ts, summary = entry
        if time.monotonic() - ts > tuning.PREFIX_PUSH_MAX_AGE_S:
            return None
        return summary

    def snapshot(self) -> List[Tuple[str, object]]:
        with self._lock:
            return list(self._replicas)

    def choose(self, timeout_s: float = 30.0) -> object:
        """Power-of-two-choices with queue-length probes."""
        deadline = time.monotonic() + timeout_s
        backoff = BACKOFF_S
        while True:
            replicas = self.snapshot()
            if not replicas:
                # Scale-from-zero signal: tell the controller a request is
                # waiting so the autoscaler can leave min_replicas=0.
                try:
                    self._controller.submit("record_handle_demand",
                                            self._full_name, 1.0)
                except Exception:  # a stopped controller: the wait times out
                    pass
                if not self._have_replicas.wait(timeout=min(
                    1.0, max(0.0, deadline - time.monotonic())
                )) and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"no running replicas for {self._full_name} after "
                        f"{timeout_s}s"
                    )
                continue
            if len(replicas) == 1:
                candidates = replicas
            else:
                candidates = random.sample(replicas, 2)
            probed = []
            for rid, handle in candidates:
                try:
                    qlen = runtime.get(handle.get_queue_len.remote(),
                                       timeout=PROBE_TIMEOUT_S)
                except Exception:
                    # Timed-out/dead probe: score worst-queue so this
                    # pick can never select it (inf >= max_ongoing);
                    # the long-poll/health-check path removes it.
                    qlen = float("inf")
                probed.append((qlen, rid, handle))
            probed.sort(key=lambda t: t[0])
            if probed and probed[0][0] < self._max_ongoing:
                return probed[0][2]
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"all replicas of {self._full_name} saturated for {timeout_s}s"
                )
            time.sleep(backoff)
            backoff = min(backoff * 2, MAX_BACKOFF_S)


_request_counter = None
_request_counter_tried = False


def _tick_request(deployment: str, tenant: str) -> None:
    """Per-tenant serve demand, visible on the cluster TSDB. Best-effort
    (metrics must never fail a request); the tenant tag rides the
    reserved headroom in the cardinality cap, so a busy deployment's
    free-form series cannot silently fold tenant evidence away."""
    global _request_counter, _request_counter_tried
    if _request_counter is None and not _request_counter_tried:
        _request_counter_tried = True
        try:
            from raytpu_torch.util.metrics import Counter

            _request_counter = Counter(
                "raytpu_serve_requests_total",
                "Serve requests routed, by deployment and tenant",
                tag_keys=("deployment", "tenant"))
        except Exception:
            _request_counter = None
    if _request_counter is not None:
        try:
            _request_counter.inc(1, {"deployment": deployment,
                                     "tenant": tenant or "default"})
        except Exception:
            pass


def _stamp_tenant(request_meta: Optional[dict]) -> dict:
    """The ambient tenant rides request metadata to the replica, where
    replica-side user code and the serving ledger read it."""
    meta = dict(request_meta or {})
    t = tenancy.current_tenant()
    if t and "tenant" not in meta:
        meta["tenant"] = t
    return meta


class Router:
    """One per DeploymentHandle; owns the replica set and assigns requests."""

    _sets: Dict[str, ReplicaSet] = {}
    _sets_lock = threading.Lock()

    def __init__(self, full_name: str, max_ongoing: int = 100):
        self._full_name = full_name
        self._controller = get_controller()
        with Router._sets_lock:
            rs = Router._sets.get(full_name)
            if rs is None or rs._stopped:
                rs = ReplicaSet(self._controller, full_name, max_ongoing)
                Router._sets[full_name] = rs
        self._replica_set = rs
        self._summaries = prefix_router.PrefixSummaryCache(
            self._fetch_summary)

    # -- prefix-cache-aware selection (RAYTPU_PREFIX_ROUTING) ---------

    def _fetch_summary(self, handle) -> Optional[dict]:
        return runtime.get(handle.get_prefix_summary.remote(),
                           timeout=PROBE_TIMEOUT_S)

    def _probe_qlen(self, handle) -> float:
        try:
            return runtime.get(handle.get_queue_len.remote(),
                               timeout=PROBE_TIMEOUT_S)
        except Exception:
            return float("inf")

    def _choose(self, args: tuple, kwargs: dict,
                timeout_s: float) -> object:
        """Replica pick for one request: prefix-aware when the flag is
        on AND the policy finds a cache match, blind power-of-two
        otherwise. With ``RAYTPU_PREFIX_ROUTING`` unset this method is
        a tail call into ``ReplicaSet.choose`` — no digests, no
        summary probes, no RNG draws — so decisions are identical to
        the pre-disaggregation router."""
        if tuning.PREFIX_ROUTING:
            replica = self._choose_by_prefix(args, kwargs)
            if replica is not None:
                return replica
        return self._replica_set.choose(timeout_s=timeout_s)

    def _choose_by_prefix(self, args: tuple, kwargs: dict):
        prompt = kwargs.get("prompt", args[0] if args else None)
        if prompt is None or not hasattr(prompt, "__len__"):
            return None
        try:
            prompt = [int(t) for t in prompt]
        except (TypeError, ValueError):
            return None
        replicas = self._replica_set.snapshot()
        if len(replicas) < 2:
            return None  # single replica: blind pick is already optimal
        summaries = []
        page_size = None
        for rid, handle in replicas:
            # Controller-pushed advertisement first (zero RPCs, refreshed
            # on health cadence); unicast TTL-cached probe as fallback.
            s = self._replica_set.pushed_summary(rid)
            if s is None:
                s = self._summaries.get(rid, handle)
            if page_size is None and s.get("page_size"):
                page_size = int(s["page_size"])
            summaries.append((rid, handle, s.get("digests", ())))
        if not page_size:
            return None
        try:
            digests = prefix_router.prompt_digests(prompt, page_size)
        except Exception:
            return None
        return prefix_router.select_replica(
            digests, summaries, self._probe_qlen,
            self._replica_set._max_ongoing, random)

    def assign_request(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        request_meta: Optional[dict] = None,
        timeout_s: float = 30.0,
    ):
        """Returns an ObjectRef for the replica's response."""
        replica = self._choose(args, kwargs, timeout_s)
        meta = _stamp_tenant(request_meta)
        _tick_request(self._full_name, meta.get("tenant", ""))
        return replica.handle_request.remote(
            method_name, args, kwargs, meta
        )

    def probe_asgi(self, timeout_s: float = 30.0) -> bool:
        """One-shot transport probe: does this deployment serve ASGI?"""
        replica = self._replica_set.choose(timeout_s=timeout_s)
        return bool(runtime.get(replica.is_asgi.remote(), timeout=10))

    def assign_request_asgi(self, scope: dict, body: bytes,
                            request_meta: Optional[dict] = None,
                            timeout_s: float = 30.0):
        replica = self._replica_set.choose(timeout_s=timeout_s)
        meta = _stamp_tenant(request_meta)
        _tick_request(self._full_name, meta.get("tenant", ""))
        return replica.handle_request_asgi.remote(scope, body, meta)

    def assign_request_streaming(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        request_meta: Optional[dict] = None,
        timeout_s: float = 30.0,
    ):
        """Returns an ObjectRefGenerator of the replica's response chunks."""
        meta = _stamp_tenant(request_meta)
        # Mint the request's identity HERE — the one id every process
        # (router, replica, engine scheduler, client-side generator)
        # stitches its timeline events under.
        rid = meta.setdefault("request_id", uuid.uuid4().hex)
        meta.setdefault("deployment", self._full_name)
        tenant = meta.get("tenant", "")
        if task_events.request_events_enabled():
            task_events.emit_request(
                rid, task_events.RequestTransition.RECEIVED,
                deployment=self._full_name, tenant=tenant,
                data={"method": method_name})
        replica = self._choose(args, kwargs, timeout_s)
        if task_events.request_events_enabled():
            task_events.emit_request(
                rid, task_events.RequestTransition.ROUTED,
                deployment=self._full_name, tenant=tenant)
        _tick_request(self._full_name, tenant)
        gen = replica.handle_request_streaming.options(
            num_returns="streaming"
        ).remote(method_name, args, kwargs, meta)
        # Client-side SLO accounting (TTFT/TPOT/goodput) reads this off
        # the stream object — see handle.DeploymentResponseGenerator.
        gen._raytpu_request_meta = {"request_id": rid,
                                    "deployment": self._full_name,
                                    "tenant": tenant}
        return gen

    @classmethod
    def reset_all(cls):
        with cls._sets_lock:
            for rs in cls._sets.values():
                rs.stop()
            cls._sets.clear()
