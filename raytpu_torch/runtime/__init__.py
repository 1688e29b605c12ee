"""raytpu_torch.runtime: the port's worker-process layer (actors in
processes of their own on ``torch.multiprocessing``, forked from a
server that imported torch once, concurrent calls,
streamed returns, handles that cross processes and named actors; tasks
on one pool of worker processes for the whole tree; refs that cross
processes, borrow and are freed; an object store of sealed
shared-memory segments), with the shape of the calls of
:mod:`raytpu.runtime` that its libraries use. See
:mod:`raytpu_torch.runtime.api` for what it keeps and leaves out."""

from raytpu_torch.core.errors import (ActorDiedError, ActorError,
                                      GetTimeoutError, ObjectLostError,
                                      ObjectStoreFullError, OwnerDiedError,
                                      TaskCancelledError, TaskError,
                                      WorkerCrashedError)
from raytpu_torch.runtime.api import (ActorHandle, ObjectRef,
                                      available_resources, call, cancel,
                                      cluster_resources, get, get_actor,
                                      init, is_initialized, kill, put,
                                      remote, shutdown, wait)
from raytpu_torch.runtime.generator import ObjectRefGenerator

__all__ = ["ActorDiedError", "ActorError", "ActorHandle", "GetTimeoutError",
           "ObjectLostError", "ObjectRef", "ObjectRefGenerator",
           "ObjectStoreFullError", "OwnerDiedError", "TaskCancelledError",
           "TaskError", "WorkerCrashedError", "available_resources", "call",
           "cancel", "cluster_resources", "get", "get_actor", "init",
           "is_initialized", "kill", "put", "remote", "shutdown", "wait"]
