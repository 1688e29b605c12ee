"""Serve controller: declarative app state reconciled onto replica
processes; the port of :mod:`raytpu.serve._private.controller`.

Each reconcile tick: diff target vs running replicas, start/stop replica
processes (workers of the port's runtime), run health checks, feed queue
and engine metrics to the autoscaler, and publish routing tables through
the long-poll host.

As in the JAX package, the controller is a named detached actor,
:data:`CONTROLLER_NAME`, with ``max_concurrency=10_000``: a worker
process of the port's runtime that the driver starts at the first
``serve.run``, and that any process of the tree (the driver, a replica)
reaches with ``runtime.get_actor``. Its replicas are its children. Its
methods are coroutines on the worker's event loop, where the reconcile
loop, health checks, replacements and autoscaling run too; a call that
waits on a replica waits on one of its threads (``_WAITERS``). Routers
long-poll ``listen_for_change`` through calls. It never touches CUDA (no
context, no card memory): it only starts and calls replica processes.

What differs from the JAX package:

- a replica is published to routers once its constructor has returned
  (its first ``check_health`` answered); a replica that dies before that
  (its constructor raised, or its process could not start) marks its
  deployment ``DEPLOY_FAILED`` (with the error as ``message``) and stops
  the restarts until the next deploy, so ``serve.run`` raises before its
  timeout;
- ``_autoscale`` reads engine pressure from each replica's
  ``get_metrics`` only: the TSDB path needs the cluster's metrics
  shipping, which the port lacks (ROADMAP.md).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import functools
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from raytpu_torch import runtime
from raytpu_torch.serve._private.autoscaling_policy import (
    AutoscalingPolicyManager, EnginePressure)
from raytpu_torch.serve._private.long_poll import LongPollHost
from raytpu_torch.serve.config import ReplicaConfig

logger = logging.getLogger("raytpu_torch.serve")

CONTROLLER_NAME = "SERVE_CONTROLLER"
# The controller's calls at once: every router's long poll parks one.
CONTROLLER_MAX_CONCURRENCY = 10_000
RECONCILE_PERIOD_S = 0.1
# How many calls the controller may wait on at once (health checks,
# metrics, drains and one start-up probe a starting replica): each blocks
# one of its threads.
_WAITERS = 64
# A replica runs this many calls at once (the JAX controller's
# max_concurrency); max_ongoing_requests bounds its requests.
REPLICA_MAX_CONCURRENCY = 10_000


class ReplicaWrapper:
    """Controller-side record of one replica actor (reference:
    ``ActorReplicaWrapper``, deployment_state.py:219)."""

    def __init__(self, replica_id: str, handle, config: ReplicaConfig):
        self.replica_id = replica_id
        self.handle = handle
        self.config = config
        self.healthy = True
        # Published to routers once its constructor has returned.
        self.ready = False
        self.started_at = time.monotonic()
        self.start_s: Optional[float] = None  # spawn to ready
        self.last_health_check = time.monotonic()
        self.draining = False
        # Latest prefix-cache advertisement piggybacked on this
        # replica's health reply (None until it advertises one).
        self.prefix_summary = None


class DeploymentState:
    """Target state + running replicas for one deployment."""

    def __init__(self, app_name: str, name: str, replica_config: ReplicaConfig):
        self.app_name = app_name
        self.name = name
        self.replica_config = replica_config
        self.target_num_replicas = self._initial_target()
        self.replicas: Dict[str, ReplicaWrapper] = {}
        self._counter = 0
        self.deleting = False
        # Why a replica failed to start: no restarts until the next
        # deploy.
        self.failed: Optional[str] = None
        # Last prefix-summary snapshot pushed to long-poll subscribers
        # (change-only publication; None = never published).
        self.last_prefix_snapshot = None
        cfg = replica_config.deployment_config.autoscaling_config
        self.autoscaler = AutoscalingPolicyManager(cfg) if cfg else None

    def _initial_target(self) -> int:
        dc = self.replica_config.deployment_config
        if dc.autoscaling_config:
            ac = dc.autoscaling_config
            return ac.initial_replicas if ac.initial_replicas is not None \
                else ac.min_replicas
        return dc.num_replicas

    @property
    def full_name(self) -> str:
        return f"{self.app_name}#{self.name}"

    def next_replica_id(self) -> str:
        self._counter += 1
        return f"{self.full_name}#{self._counter}"


class ServeController(LongPollHost):
    """The serve controller. Its public methods are coroutines, run on the
    event loop of the worker process that hosts it."""

    def __init__(self):
        LongPollHost.__init__(self)
        self._waiters = concurrent.futures.ThreadPoolExecutor(
            max_workers=_WAITERS, thread_name_prefix="serve-controller")
        # app_name -> {deployment_name -> DeploymentState}
        self._apps: Dict[str, Dict[str, DeploymentState]] = {}
        self._app_meta: Dict[str, dict] = {}  # route_prefix, ingress name
        self._loop_task: Optional[asyncio.Task] = None
        self._shutdown = False
        # full_name -> [(ts, n)] requests reported waiting by handles with
        # no replicas to route to (the scale-from-zero signal; reference:
        # handles report queued metrics to the controller for autoscaling).
        self._pending_demand: Dict[str, list] = {}
        # In-flight replica stop tasks (concurrent drains; the reconcile
        # loop must not stall behind graceful_shutdown_timeout_s), and
        # start-up probes.
        self._stop_tasks: set = set()
        self._start_tasks: set = set()

    async def _get(self, ref, timeout: Optional[float] = None):
        """The value of a runtime ref, waited for on one of the
        controller's threads."""
        return await asyncio.get_running_loop().run_in_executor(
            self._waiters, functools.partial(runtime.get, ref,
                                             timeout=timeout))

    def _ensure_loop(self):
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.ensure_future(self._reconcile_loop())

    # -- API used by serve.run / handles ----------------------------------

    async def deploy_application(
        self,
        app_name: str,
        route_prefix: Optional[str],
        ingress_deployment: str,
        configs: List[ReplicaConfig],
    ) -> None:
        self._ensure_loop()
        states = self._apps.setdefault(app_name, {})
        new_names = set()
        for rc in configs:
            new_names.add(rc.deployment_name)
            existing = states.get(rc.deployment_name)
            if existing is None:
                states[rc.deployment_name] = DeploymentState(
                    app_name, rc.deployment_name, rc
                )
            else:
                existing.deleting = False  # re-added after a removal
                existing.failed = None  # a new deploy: restarts resume
                await self._update_deployment(existing, rc)
        # Deployments removed from the app: drain to 0, reconcile drops the
        # state once the last replica is gone (``deleting`` flag).
        for name in list(states):
            if name not in new_names:
                states[name].deleting = True
                states[name].target_num_replicas = 0
        self._app_meta[app_name] = {
            "route_prefix": route_prefix,
            "ingress": ingress_deployment,
        }
        self.notify_changed("route_table", self._route_table())
        await self._reconcile_once()

    async def _update_deployment(self, state: DeploymentState, rc: ReplicaConfig):
        old_dc = state.replica_config.deployment_config
        new_dc = rc.deployment_config
        code_changed = (
            rc.serialized_callable != state.replica_config.serialized_callable
            or _differ(rc.init_args, state.replica_config.init_args)
            or _differ(rc.init_kwargs, state.replica_config.init_kwargs)
        )
        state.replica_config = rc
        if new_dc.autoscaling_config and state.autoscaler is None:
            state.autoscaler = AutoscalingPolicyManager(new_dc.autoscaling_config)
        elif not new_dc.autoscaling_config:
            state.autoscaler = None
        if state.autoscaler is None:
            state.target_num_replicas = new_dc.num_replicas
        if code_changed:
            # Rolling replace: stop everything, reconcile restarts fresh.
            for rep in list(state.replicas.values()):
                self._stop_replica_background(state, rep)
        elif new_dc.user_config != old_dc.user_config and \
                new_dc.user_config is not None:
            for rep in state.replicas.values():
                try:
                    await self._get(rep.handle.reconfigure.remote(
                        new_dc.user_config))
                except Exception:  # a replica that cannot take it is replaced
                    rep.healthy = False

    async def delete_application(self, app_name: str) -> None:
        states = self._apps.get(app_name)
        if states is None:
            return
        for state in states.values():  # nothing new starts from here on
            state.deleting = True
            state.target_num_replicas = 0
        stops = [
            self._stop_replica_background(state, rep)
            for state in states.values()
            for rep in list(state.replicas.values())
        ]
        if stops:
            await asyncio.gather(*stops, return_exceptions=True)
        del self._apps[app_name]
        self._app_meta.pop(app_name, None)
        self.notify_changed("route_table", self._route_table())
        for state in states.values():
            self.notify_changed(f"replicas::{state.full_name}", [])

    async def get_deployment_targets(self, app_name: str) -> List[str]:
        return sorted(self._apps.get(app_name, {}))

    async def status(self) -> Dict[str, Any]:
        out = {}
        for app, states in self._apps.items():
            deps = {}
            for name, st in states.items():
                healthy = sum(1 for r in st.replicas.values()
                              if r.healthy and r.ready)
                if st.failed is not None:
                    status = "DEPLOY_FAILED"
                elif healthy >= st.target_num_replicas:
                    status = "RUNNING"
                elif st.replicas:
                    status = "UPDATING"
                else:
                    status = "DEPLOYING" if st.target_num_replicas else "RUNNING"
                deps[name] = {
                    "status": status,
                    "target_replicas": st.target_num_replicas,
                    "running_replicas": len(st.replicas),
                    "healthy_replicas": healthy,
                }
                if st.failed is not None:
                    deps[name]["message"] = st.failed
            out[app] = {
                "route_prefix": self._app_meta.get(app, {}).get("route_prefix"),
                "ingress": self._app_meta.get(app, {}).get("ingress"),
                "deployments": deps,
            }
        return out

    async def graceful_shutdown(self) -> None:
        self._shutdown = True
        if self._loop_task is not None:
            self._loop_task.cancel()
            self._loop_task = None
        for app in list(self._apps):
            await self.delete_application(app)
        if self._stop_tasks:
            await asyncio.gather(*self._stop_tasks, return_exceptions=True)
        for task in list(self._start_tasks):
            task.cancel()
        self._waiters.shutdown(wait=False, cancel_futures=True)

    # -- reconcile loop ----------------------------------------------------

    async def _reconcile_loop(self):
        while not self._shutdown:
            try:
                await self._reconcile_once()
            except Exception:
                logger.exception("serve controller reconcile failed")
            await asyncio.sleep(RECONCILE_PERIOD_S)

    async def _reconcile_once(self):
        for app_name, states in list(self._apps.items()):
            for name, state in list(states.items()):
                if not state.deleting:
                    await self._autoscale(state)
                if self._apps.get(app_name) is not states:
                    break  # deleted while this tick awaited
                await self._reconcile_deployment(state)
                await self._health_check(state)
                if state.deleting and not state.replicas:
                    states.pop(name, None)

    async def _reconcile_deployment(self, state: DeploymentState):
        # Remove dead/unhealthy replicas first so they get replaced.
        for rep in [r for r in state.replicas.values() if not r.healthy]:
            self._stop_replica_background(state, rep)
        delta = state.target_num_replicas - len(state.replicas)
        if delta > 0 and state.failed is None:
            for _ in range(delta):
                self._start_replica(state)
            self._publish_replicas(state)
        elif delta < 0:
            doomed = list(state.replicas.values())[delta:]
            for rep in doomed:
                self._stop_replica_background(state, rep)

    def _stop_replica_background(self, state: DeploymentState,
                                 rep: ReplicaWrapper) -> asyncio.Task:
        """Unpublish immediately; drain+kill concurrently so one slow drain
        (up to graceful_shutdown_timeout_s) can't freeze the reconcile loop
        for every other deployment."""
        state.replicas.pop(rep.replica_id, None)
        self._publish_replicas(state)
        task = asyncio.ensure_future(self._drain_and_kill(rep))
        self._stop_tasks.add(task)
        task.add_done_callback(self._stop_tasks.discard)
        return task

    def _start_replica(self, state: DeploymentState):
        from raytpu_torch.serve._private.replica import Replica

        rid = state.next_replica_id()
        opts = dict(state.replica_config.deployment_config.ray_actor_options)
        opts["max_concurrency"] = REPLICA_MAX_CONCURRENCY
        handle = runtime.remote(Replica).options(**opts).remote(
            rid, state.replica_config)
        rep = ReplicaWrapper(rid, handle, state.replica_config)
        state.replicas[rid] = rep
        task = asyncio.ensure_future(self._await_start(state, rep))
        self._start_tasks.add(task)
        task.add_done_callback(self._start_tasks.discard)

    async def _await_start(self, state: DeploymentState,
                           rep: ReplicaWrapper) -> None:
        """Publish a replica once its constructor has returned (its first
        health check answers then). A replica that dies first (its
        constructor raised, or its process could not start) fails the
        deployment: no restarts until the next deploy."""
        try:
            reply = await self._get(rep.handle.check_health.remote())
        except Exception as exc:  # a failed start: reported, not retried
            if state.replicas.get(rep.replica_id) is rep:
                state.failed = f"replica {rep.replica_id}: {exc}"
                logger.error("deployment %s failed to start: %s",
                             state.full_name, state.failed)
                self._stop_replica_background(state, rep)
            return
        if state.replicas.get(rep.replica_id) is not rep:
            return  # stopped meanwhile
        rep.ready = True
        rep.start_s = time.monotonic() - rep.started_at
        rep.last_health_check = time.monotonic()
        if isinstance(reply, dict):
            rep.prefix_summary = reply.get("prefix_summary")
        self._publish_replicas(state)

    async def _drain_and_kill(self, rep: ReplicaWrapper):
        dc = rep.config.deployment_config
        if rep.ready and rep.healthy:
            try:
                await self._get(rep.handle.prepare_for_shutdown.remote(
                    dc.graceful_shutdown_wait_loop_s,
                    dc.graceful_shutdown_timeout_s,
                ), timeout=dc.graceful_shutdown_timeout_s + 1.0)
            except Exception:  # a replica that cannot drain is killed now
                pass
        await asyncio.get_running_loop().run_in_executor(
            self._waiters, runtime.kill, rep.handle)

    async def _health_check(self, state: DeploymentState):
        now = time.monotonic()
        period = state.replica_config.deployment_config.health_check_period_s
        for rep in list(state.replicas.values()):
            if not rep.ready or now - rep.last_health_check < period:
                continue
            rep.last_health_check = now
            try:
                reply = await self._get(
                    rep.handle.check_health.remote(),
                    timeout=state.replica_config.deployment_config
                    .health_check_timeout_s,
                )
            except Exception:  # dead or wedged: replaced by the reconcile
                rep.healthy = False
                continue
            # Modern replicas piggyback their prefix-cache summary on
            # the health reply; legacy replicas return a bare bool.
            if isinstance(reply, dict):
                rep.prefix_summary = reply.get("prefix_summary")
        self._publish_prefix_summaries(state)

    def _publish_prefix_summaries(self, state: DeploymentState):
        """Change-only broadcast of the deployment's per-replica
        prefix-cache summaries to ``prefix::<full_name>`` long-poll
        subscribers. Unhealthy replicas and replicas that never
        advertised are excluded — routers unicast-probe those instead
        of trusting missing evidence. Steady state (no cache drift)
        publishes nothing, so idle clusters wake zero routers."""
        snap = {
            r.replica_id: r.prefix_summary
            for r in state.replicas.values()
            if r.healthy and r.prefix_summary is not None
        }
        if snap == state.last_prefix_snapshot:
            return
        state.last_prefix_snapshot = {
            rid: dict(s) if isinstance(s, dict) else s
            for rid, s in snap.items()}
        self.notify_changed(f"prefix::{state.full_name}", snap)

    async def record_handle_demand(self, full_name: str, n: float = 1.0):
        self._pending_demand.setdefault(full_name, []).append(
            (time.monotonic(), n))

    def _demand_level(self, full_name: str) -> float:
        """Requests reported waiting by handles within the last 2s. A level
        (not a counter): each waiting request re-reports ~1/s, so summing a
        2s window survives reconcile ticks that land between reports —
        required for upscale hysteresis to ever elapse at zero replicas."""
        entries = self._pending_demand.get(full_name)
        if not entries:
            return 0.0
        cutoff = time.monotonic() - 2.0
        fresh = [(t, n) for (t, n) in entries if t >= cutoff]
        if not fresh:
            self._pending_demand.pop(full_name, None)
            return 0.0
        self._pending_demand[full_name] = fresh
        # Each waiting request contributes ~2 reports per window; halve,
        # but any fresh report counts as at least one waiting request.
        return max(sum(n for _, n in fresh) / 2.0, 1.0)

    async def _autoscale(self, state: DeploymentState):
        if state.autoscaler is None:
            return
        total = self._demand_level(state.full_name)
        # Engine pressure aggregates: queue depths SUM (total unmet
        # demand), occupancy and latency take the WORST replica (one
        # saturated engine is a problem even if its peers are idle).
        waiting = kv_util = ttft = 0.0
        saw_pressure = False
        for rep in list(state.replicas.values()):
            if not rep.ready:
                continue
            try:
                m = await self._get(rep.handle.get_metrics.remote(),
                                    timeout=2.0)
                total += m["avg_ongoing"]
                if "engine_waiting_requests" in m:
                    saw_pressure = True
                    waiting += m["engine_waiting_requests"]
                    kv_util = max(kv_util,
                                  m.get("engine_kv_utilization", 0.0))
                    ttft = max(ttft, m.get("engine_ttft_p95_s", 0.0))
            except Exception:  # a replica that cannot answer adds nothing
                pass
        pressure = None
        if saw_pressure:
            pressure = EnginePressure(waiting_requests=waiting,
                                      kv_utilization=kv_util,
                                      ttft_p95_s=ttft)
        decision = state.autoscaler.get_decision_num_replicas(
            total, state.target_num_replicas, engine_pressure=pressure
        )
        if decision is not None and decision != state.target_num_replicas:
            logger.info(
                "autoscaling %s: %d -> %d (load=%.1f)",
                state.full_name, state.target_num_replicas, decision, total,
            )
            state.target_num_replicas = decision

    # -- routing state published to handles/proxies ------------------------

    def _publish_replicas(self, state: DeploymentState):
        snapshot = {
            "replicas": [
                (r.replica_id, r.handle)
                for r in state.replicas.values() if r.healthy and r.ready
            ],
            # Routers size their saturation threshold from the deployment's
            # actual config, not the handle-constructor default.
            "max_ongoing": state.replica_config.deployment_config
            .max_ongoing_requests,
            # Disaggregation topology: None / "prefill" / "decode".
            "role": state.replica_config.deployment_config.role,
        }
        self.notify_changed(f"replicas::{state.full_name}", snapshot)

    def _route_table(self) -> Dict[str, tuple]:
        table = {}
        for app, meta in self._app_meta.items():
            if meta.get("route_prefix"):
                table[meta["route_prefix"]] = (app, meta["ingress"])
        return table

    async def get_route_table(self) -> Dict[str, tuple]:
        return self._route_table()

    async def get_running_replicas(self, full_name: str) -> list:
        for states in self._apps.values():
            for state in states.values():
                if state.full_name == full_name:
                    return [
                        (r.replica_id, r.handle)
                        for r in state.replicas.values()
                        if r.healthy and r.ready
                    ]
        return []

    async def replica_starts(self, full_name: str) -> Dict[str, float]:
        """Seconds from spawn to ready of each ready replica of a
        deployment, by replica id."""
        for states in self._apps.values():
            for state in states.values():
                if state.full_name == full_name:
                    return {r.replica_id: r.start_s
                            for r in state.replicas.values() if r.ready}
        return {}


def _differ(a, b) -> bool:
    """Whether two init argument lists differ; values without a truth
    value for ``!=`` (tensors) differ unless they are the same objects."""
    try:
        return bool(a != b)
    except (RuntimeError, TypeError, ValueError):
        return True


class ControllerClient:
    """A process's way to the controller actor: ``call`` runs a
    controller method and waits for its value; ``submit`` runs one
    without waiting (its ref)."""

    def __init__(self, actor):
        self.actor = actor

    def submit(self, method: str, *args):
        return getattr(self.actor, method).remote(*args)

    def call(self, method: str, *args, timeout: Optional[float] = None):
        return runtime.get(self.submit(method, *args), timeout=timeout)


_start_lock = threading.Lock()


def get_or_create_controller() -> ControllerClient:
    """The controller, started (detached, named) at the first call."""
    with _start_lock:  # a name is taken before its worker is up
        try:
            return get_controller()
        except RuntimeError:
            pass
        return ControllerClient(runtime.remote(ServeController).options(
            name=CONTROLLER_NAME, lifetime="detached",
            max_concurrency=CONTROLLER_MAX_CONCURRENCY).remote())


def get_controller() -> ControllerClient:
    """The controller, from any process of the tree; raises when serve is
    not running (before ``serve.run``, or after ``serve.shutdown``). It
    never starts one."""
    try:
        return ControllerClient(runtime.get_actor(CONTROLLER_NAME))
    except ValueError:
        raise RuntimeError("serve is not running: serve.run(...) starts "
                           "it") from None


def stop_controller() -> None:
    """Shut the controller down gracefully (every replica drained and
    killed), then end its process."""
    try:
        ctl = get_controller()
    except RuntimeError:
        return
    try:
        ctl.call("graceful_shutdown", timeout=60.0)
    finally:
        runtime.kill(ctl.actor)
