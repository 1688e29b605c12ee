"""Streaming executor, the port of :mod:`raytpu.data.executor`:
pull-based pipelined block processing on the port's tasks and actors.

Operators process blocks as tasks of :mod:`raytpu_torch.runtime`; the
consuming loop keeps at most ``max_in_flight`` tasks outstanding and
yields output block refs as they complete, in block order (streaming:
downstream consumption overlaps upstream production; memory is bounded
by the in-flight count and the :class:`ResourceBudget`, not the
dataset's size). Blocks go from the task that made them to the task or
reader that takes them through the object store; the loop holds refs.

The JAX package defines its stage task and its ``_MapWorker`` actor
inside functions, which its ``cloudpickle`` carries; here both are
module-level definitions that take the UDF as an argument, by value
(:mod:`raytpu_torch.runtime.serialization`). They keep the in-flight
cap, the byte budget, stage fusion and the actor-pool cap from
``cluster_resources()``.
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Iterator, List, Optional

from raytpu_torch import runtime
from raytpu_torch.runtime import ObjectRef

# The JAX package's cfg.data_memory_budget_bytes (0: a quarter of
# cfg.object_store_memory_bytes).
DATA_MEMORY_BUDGET_BYTES = 0
OBJECT_STORE_MEMORY_BYTES = 2 * 1024 * 1024 * 1024


class ResourceBudget:
    """Object-store byte budget for one streaming execution.

    Reference analogue: ``_internal/execution/resource_manager.py`` — the
    reference bounds each execution's object-store footprint, not just
    its task count. Block sizes aren't known before a task runs, so the
    consumer feeds observed sizes back (:meth:`record_block`) and the
    admission check holds ``(in_flight + 1) * avg_block_bytes`` under the
    budget. Until the first observation the concurrency cap alone
    governs; at least one block is always admitted (no livelock).
    """

    def __init__(self, budget_bytes: Optional[int] = None):
        if not budget_bytes:
            budget_bytes = int(DATA_MEMORY_BUDGET_BYTES) or int(
                0.25 * float(OBJECT_STORE_MEMORY_BYTES))
        self.budget_bytes = int(budget_bytes)
        self.avg_block_bytes: Optional[float] = None
        self.peak_in_flight = 0
        # Peak admissions AFTER the first size observation — the
        # steady-state footprint (cold start is governed by the
        # concurrency cap alone, so peak_in_flight can reach the window).
        self.warm_peak_in_flight = 0
        self.throttle_events = 0

    def record_block(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        if self.avg_block_bytes is None:
            self.avg_block_bytes = float(nbytes)
        else:  # EMA: recent blocks dominate (sizes drift along a scan)
            self.avg_block_bytes += 0.3 * (nbytes - self.avg_block_bytes)

    def admit(self, in_flight: int) -> bool:
        if in_flight == 0 or self.avg_block_bytes is None:
            return True
        ok = (in_flight + 1) * self.avg_block_bytes <= self.budget_bytes
        if ok:
            self.warm_peak_in_flight = max(self.warm_peak_in_flight,
                                           in_flight + 1)
        else:
            self.throttle_events += 1
        return ok


class ActorPoolStrategy:
    """Run a map stage on a pool of long-lived actors instead of per-block
    tasks (reference: ``ActorPoolStrategy`` / the actor-pool MapOperator,
    ``execution/operators/map_operator.py:34``): a stage whose setup is
    expensive (load a model) amortizes it across every block the actor
    processes."""

    def __init__(self, size: int = 2):
        self.size = max(1, int(size))


class OpSpec:
    """One pipeline stage: a remote transform over blocks.

    fn(block) -> block. ``fn`` may also be a CLASS: it is instantiated
    once per pool actor (stateful UDF; requires ``compute``).
    """

    def __init__(self, name: str, fn: Callable, *, num_cpus: float = 1.0,
                 compute: "ActorPoolStrategy" = None):
        self.name = name
        self.fn = fn
        self.num_cpus = num_cpus
        self.compute = compute


def _composed(f: Callable, g: Callable, block):
    return g(f(block))


def fuse_ops(ops: List[OpSpec]) -> List[OpSpec]:
    """Logical-plan optimizer rule: consecutive task-based map stages fuse
    into ONE remote task so intermediate blocks never hit the object
    store (reference: ``OperatorFusionRule``,
    ``_internal/logical/rules/operator_fusion.py``). Actor-pool stages
    are fusion barriers (different execution substrate)."""
    fused: List[OpSpec] = []
    for op in ops:
        prev = fused[-1] if fused else None
        if (prev is not None and prev.compute is None
                and op.compute is None):
            fused[-1] = OpSpec(f"{prev.name}->{op.name}",
                               functools.partial(_composed, prev.fn, op.fn),
                               num_cpus=max(prev.num_cpus, op.num_cpus))
        else:
            fused.append(op)
    return fused


class _MapWorker:
    """An actor-pool stage's actor: the UDF (an instance of it, built
    once, where it is a class) applied to each block it is given."""

    def __init__(self, fn):
        self._fn = fn() if inspect.isclass(fn) else fn

    def apply(self, block):
        return self._fn(block)


def _stage(fn: Callable, block):
    """A task-based stage: one block through the (fused) UDF."""
    return fn(block)


class _PoolStage:
    """Actor-pool execution of one stage: blocks dispatch round-robin to
    ``size`` actors, each hosting the (possibly stateful) UDF."""

    def __init__(self, op: OpSpec):
        # Cap the pool at what the pool of CPUs can hold: actors beyond
        # it would oversubscribe the cores the stage's tasks share.
        size = op.compute.size
        total_cpus = float(runtime.cluster_resources().get("CPU", 1.0))
        size = min(size, max(1, int(total_cpus // max(op.num_cpus, 1e-9))))
        worker = runtime.remote(_MapWorker).options(num_cpus=op.num_cpus)
        self.actors = [worker.remote(op.fn) for _ in range(size)]
        self._next = 0

    def submit(self, ref: ObjectRef) -> ObjectRef:
        actor = self.actors[self._next % len(self.actors)]
        self._next += 1
        return actor.apply.remote(ref)

    def stop(self) -> None:
        for a in self.actors:
            runtime.kill(a)


def run_pipeline(source: Iterator, ops: List[OpSpec], *,
                 max_in_flight: int = 8,
                 budget: Optional[ResourceBudget] = None
                 ) -> Iterator[ObjectRef]:
    """Stream block refs from `source` through `ops`.

    `source` yields ObjectRefs of blocks. Returns an iterator of output
    block refs in order. Each stage runs as remote tasks (fused where
    adjacent) or on an actor pool, with a concurrency cap AND (when the
    consumer feeds a :class:`ResourceBudget`) an object-store byte
    budget; stages are chained per-block (pipeline, no barrier — block i
    can be in stage 2 while block j is in stage 0).
    """
    if not ops:
        yield from source
        return

    ops = fuse_ops(ops)
    stages = []
    pools: List[_PoolStage] = []
    try:
        for op in ops:
            if op.compute is not None:
                pool = _PoolStage(op)
                pools.append(pool)
                stages.append(pool.submit)
            else:
                stage = runtime.remote(num_cpus=op.num_cpus,
                                       name=f"data::{op.name}")(
                    functools.partial(_stage, op.fn))
                stages.append(stage.remote)

        def chain(ref: ObjectRef) -> ObjectRef:
            for submit in stages:
                ref = submit(ref)
            return ref

        pending: List[ObjectRef] = []  # ordered
        source_iter = iter(source)
        exhausted = False
        while pending or not exhausted:
            while not exhausted and len(pending) < max_in_flight and (
                    budget is None or budget.admit(len(pending))):
                try:
                    in_ref = next(source_iter)
                except StopIteration:
                    exhausted = True
                    break
                pending.append(chain(in_ref))
                if budget is not None:
                    budget.peak_in_flight = max(budget.peak_in_flight,
                                                len(pending))
            if pending:
                # Ordered streaming: wait on the head (completion order
                # within the window doesn't matter for memory; order does
                # for output).
                head = pending.pop(0)
                runtime.wait([head], num_returns=1)
                yield head
    finally:
        for pool in pools:
            pool.stop()


def materialize_refs(refs: Iterator[ObjectRef]) -> List[ObjectRef]:
    return list(refs)
