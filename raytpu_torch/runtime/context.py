"""The runtime context: the port of :mod:`raytpu.runtime.context`
(``get_runtime_context()``; reference ``python/ray/runtime_context.py``).

Where the JAX package keeps one context a thread (its tasks and actors
are threads of one process), each process of the port's tree is a task
worker, an actor or the driver: the process sets what it is at its
start (:func:`set_process`: the actor's id, its attempt, its group) and
a task worker the task it runs (:func:`set_task`). The job and the node
are the tree's: derived from its id, so every process names them alike
without a message. An actor method's context has no task id.

:func:`register_task_scope_reset` and :func:`reset_task_scope` are the
JAX package's: the task worker runs the registered resets when each task
ends (the JAX executor between tasks on a reused thread).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass, field
from typing import Optional

from raytpu_torch.core.ids import ActorID, JobID, NodeID, TaskID


@dataclass
class RuntimeContext:
    job_id: Optional[JobID] = None
    node_id: Optional[NodeID] = None
    task_id: Optional[TaskID] = None
    actor_id: Optional[ActorID] = None
    placement_group_id: Optional[str] = None
    attempt: int = 0
    extras: dict = field(default_factory=dict)

    def get_job_id(self):
        return self.job_id

    def get_node_id(self):
        return self.node_id

    def get_task_id(self):
        return self.task_id

    def get_actor_id(self):
        return self.actor_id

    def get_placement_group_id(self):
        return self.placement_group_id

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return self.attempt > 0


_PROCESS = {"actor_id": None, "attempt": 0, "placement_group_id": None,
            "capture": False, "task_id": None}


def _derived(cls, tag: str):
    from raytpu_torch.runtime import object_store

    key = f"{tag}/{object_store.tree()}".encode()
    return cls(hashlib.blake2b(key, digest_size=cls.SIZE).digest())


def set_process(actor_id: Optional[str] = None, attempt: int = 0,
                placement_group_id: Optional[str] = None,
                capture: bool = False) -> None:
    """What this process is, at its start: an actor's id (hex), the
    attempt (0 at its first start, n after n restarts), and the group it
    runs in (``capture``: its own tasks and actors default to it)."""
    _PROCESS.update(actor_id=actor_id, attempt=attempt,
                    placement_group_id=placement_group_id, capture=capture)


def set_task(task_id: Optional[str],
             placement_group_id: Optional[str] = None,
             capture: bool = False) -> None:
    """The task this task worker runs (None between tasks)."""
    _PROCESS.update(task_id=task_id, placement_group_id=placement_group_id,
                    capture=capture and task_id is not None)


# -- task-scope resets ---------------------------------------------------
# A task worker runs task after task in one process; modules that keep
# state for the task that runs (the collective groups it joined) register
# a reset here, which the worker runs when each task ends, so that one
# task's state never reaches the next task on the same worker.
_task_scope_resets: list = []


def register_task_scope_reset(fn) -> None:
    _task_scope_resets.append(fn)


def reset_task_scope() -> None:
    """Called by the task worker when a task ends."""
    set_task(None)
    for fn in _task_scope_resets:
        try:
            fn()
        except Exception:
            # A reset that failed quietly would let one task's state
            # reach the next: be loud.
            logging.getLogger("raytpu_torch").exception(
                "task-scope reset %r failed", fn)


def captured_group() -> Optional[str]:
    """The group a child of this process defaults to: this one's, where
    it was started with ``placement_group_capture_child_tasks``."""
    return _PROCESS["placement_group_id"] if _PROCESS["capture"] else None


def current() -> RuntimeContext:
    tid, aid = _PROCESS["task_id"], _PROCESS["actor_id"]
    return RuntimeContext(
        job_id=_derived(JobID, "job"), node_id=node_id(),
        task_id=None if tid is None else TaskID.from_hex(tid),
        actor_id=None if aid is None else ActorID.from_hex(aid),
        placement_group_id=_PROCESS["placement_group_id"],
        attempt=_PROCESS["attempt"])


def node_id() -> NodeID:
    """The tree's one node: the driver's host."""
    return _derived(NodeID, "node")
