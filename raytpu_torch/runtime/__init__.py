"""raytpu_torch.runtime: the port's worker-process layer (actors in
spawned processes on ``torch.multiprocessing``), with the shape of the
calls of :mod:`raytpu.runtime` that its libraries use. See
:mod:`raytpu_torch.runtime.api` for what it keeps and leaves out."""

from raytpu_torch.core.errors import (ActorDiedError, ActorError,
                                      GetTimeoutError, TaskError)
from raytpu_torch.runtime.api import (ActorHandle, ObjectRef, call, get, kill,
                                      put, remote, wait)

__all__ = ["ActorDiedError", "ActorError", "ActorHandle", "GetTimeoutError",
           "ObjectRef", "TaskError", "call", "get", "kill", "put", "remote",
           "wait"]
