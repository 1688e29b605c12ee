"""raytpu_torch.runtime: the port's worker-process layer (actors in
spawned processes on ``torch.multiprocessing``, concurrent calls,
streamed returns, handles that cross processes and named actors), with the shape of the calls of :mod:`raytpu.runtime`
that its libraries use. See :mod:`raytpu_torch.runtime.api` for what it
keeps and leaves out."""

from raytpu_torch.core.errors import (ActorDiedError, ActorError,
                                      GetTimeoutError, TaskError)
from raytpu_torch.runtime.api import (ActorHandle, ObjectRef, call, get,
                                      get_actor, kill, put, remote, wait)
from raytpu_torch.runtime.generator import ObjectRefGenerator

__all__ = ["ActorDiedError", "ActorError", "ActorHandle", "GetTimeoutError",
           "ObjectRef", "ObjectRefGenerator", "TaskError", "call", "get",
           "get_actor", "kill", "put", "remote", "wait"]
