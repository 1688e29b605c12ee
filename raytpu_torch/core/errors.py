"""The errors of the port's worker-process layer: the port's copies of the
names of :mod:`raytpu.core.errors` that :mod:`raytpu_torch.runtime`
raises.

- :class:`TaskError`: a method raised inside a worker; ``get`` re-raises
  it in the caller with the worker's formatted traceback in its message.
- :class:`ActorError` and :class:`ActorDiedError`: a worker process
  exited (killed, crashed, or its constructor raised).
- :class:`GetTimeoutError`: ``get`` ran out of its ``timeout``; it is a
  :class:`TimeoutError`.
- :class:`ObjectLostError` and :class:`OwnerDiedError`: a ref whose
  value was freed, or whose owner process exited.
- :class:`WorkerCrashedError`: a task's worker process died on its last
  try; :class:`TaskCancelledError`: the task was cancelled.
- :class:`ObjectStoreFullError`: ``/dev/shm`` has no room for a value.
- :class:`PlacementGroupError`: a placement group that cannot be
  reserved (it does not fit the ledger, or STRICT_SPREAD asks for more
  than the one host), or a request into a group that is gone.
- :class:`RuntimeEnvError` and :class:`ActorUnavailableError`: the JAX
  package's names; the port raises neither yet (``runtime_env`` is an
  option it refuses).
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class of the port's runtime errors."""


class TaskError(RayTpuError):
    """A method raised in a worker; re-raised at ``get`` of its result
    with the worker's traceback text (the cause itself stays behind: its
    traceback holds frames that do not pickle)."""

    def __init__(self, function_name: str, remote_traceback: str,
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{remote_traceback}")

    @classmethod
    def from_exception(cls, function_name: str,
                       exc: BaseException) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc,
                                                exc.__traceback__))
        return cls(function_name, tb, cause=exc)

    def __reduce__(self):
        return (TaskError, (self.function_name, self.remote_traceback))


class ActorError(RayTpuError):
    pass


class ActorUnavailableError(ActorError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id_hex: str, reason: str = ""):
        self.actor_id_hex = actor_id_hex
        self.reason = reason
        super().__init__(f"actor {actor_id_hex} died: {reason}")

    def __reduce__(self):
        return (type(self), (self.actor_id_hex, self.reason))


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_id_hex: str, reason: str = "owner or store lost"):
        self.object_id_hex = object_id_hex
        self.reason = reason
        super().__init__(f"object {object_id_hex} lost: {reason}")

    def __reduce__(self):
        return (type(self), (self.object_id_hex, self.reason))


class OwnerDiedError(ObjectLostError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class ObjectStoreFullError(RayTpuError):
    pass


class RuntimeEnvError(RayTpuError):
    pass


class PlacementGroupError(RayTpuError):
    pass
