"""How the runtime starts its processes (actors and task workers): forked
from a ``multiprocessing`` forkserver that has imported numpy, torch and
the runtime once, instead of spawned interpreters that each spend seconds
importing torch.

A forked child's environment is its server's, fixed when the server
started, where a spawned child gets its parent's at its start (tracing,
failpoints, request events and a replica's settings travel in it). So a
process keeps one server for each environment it has had when it
started a child, and starts each child from the server of its
environment of the moment: a child sees what it would have seen
spawned. The first start in an environment pays the server's launch
(one interpreter importing numpy, torch and the runtime); the others a
fork and the import of the parent's main module, as spawn does.

The server never touches CUDA, so a child sets CUDA up afresh (a train
worker, a replica) as a spawned one does. Each server runs until the
last process that holds its alive pipe (its starter and the children it
forked) exits. Everything else is ``multiprocessing``'s: the child runs
``spawn``'s preparation (``sys.path``, the authkey, the parent's main
module imported as ``__mp_main__``), its arguments cross by
``multiprocessing``'s pickler, and the server reaps it and reports its
exit code.
"""

from __future__ import annotations

import io
import os
import threading
from multiprocessing import forkserver, popen_forkserver, process, spawn, util
from multiprocessing.context import reduction, set_spawning_popen
from typing import Dict

# What each server imports once, before it forks any child: the runtime
# and, through it, numpy, torch and the port's package.
PRELOAD = ["raytpu_torch.runtime.task_pool"]

_SERVERS: Dict[tuple, forkserver.ForkServer] = {}
_LOCK = threading.Lock()
# Variables that name the moment, not a setting: left out of a server's
# key (pytest rewrites this one at every phase of every test, which
# would launch a server a test).
_UNKEYED = ("PYTEST_CURRENT_TEST",)


def _server() -> forkserver.ForkServer:
    """The server of this process's environment of the moment."""
    key = tuple(sorted(kv for kv in os.environ.items()
                       if kv[0] not in _UNKEYED))
    with _LOCK:
        server = _SERVERS.get(key)
        if server is None:
            server = _SERVERS[key] = forkserver.ForkServer()
            server.set_forkserver_preload(PRELOAD)
    return server


def servers() -> int:
    """How many servers this process has started (one an environment)."""
    with _LOCK:
        return len(_SERVERS)


class _Popen(popen_forkserver.Popen):
    """``multiprocessing``'s forkserver start, through the server of the
    starter's environment."""

    def _launch(self, process_obj):
        prep_data = spawn.get_preparation_data(process_obj._name)
        buf = io.BytesIO()
        set_spawning_popen(self)
        try:
            reduction.dump(prep_data, buf)
            reduction.dump(process_obj, buf)
        finally:
            set_spawning_popen(None)
        self.sentinel, w = _server().connect_to_new_process(self._fds)
        # The data pipe's write end, kept as the child's sentinel of its
        # parent (as multiprocessing's own forkserver start keeps it).
        parent_w = os.dup(w)
        self.finalizer = util.Finalize(self, util.close_fds,
                                       (parent_w, self.sentinel))
        with open(w, "wb", closefd=True) as f:
            f.write(buf.getbuffer())
        self.pid = forkserver.read_signed(self.sentinel)


class Process(process.BaseProcess):
    """A ``multiprocessing`` process started by :func:`_server`'s fork."""

    _start_method = "forkserver"

    @staticmethod
    def _Popen(process_obj):
        return _Popen(process_obj)
