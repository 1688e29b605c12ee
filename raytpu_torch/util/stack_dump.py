"""In-process stack dumps, CPU profiles and memory profiles of the live
processes of the tree (and their span buffers, for
``tracing.cluster_timeline``); the port of ``raytpu/util/stack_dump.py``.

The JAX package fans a call out to every node daemon, which asks each
of its workers over its RPC loop (``worker_stacks``, ``worker_profile``,
``worker_memory_profile``, ``raytpu/cluster/node.py:2232-2380``). The
port has no nodes: every process of the tree (each actor, each task
worker, each process that joined with ``init(address=...)``) holds a
connection to the driver opened at its start, and answers the driver's
requests on it from a thread of its own (:func:`answer`), so a busy or
wedged task thread does not block its dump. The driver asks every
process at once and waits under one deadline
(:func:`raytpu_torch.runtime.api.ask_processes`); a process that died
or said nothing by then gets an ``error`` entry. The shape is the JAX
package's: ``{node id: {process id: {"pid", "stack" | "profile" |
"memory" | "error"}}}``, with the port's one host as the node and the
process's id in the driver's records (``records.identity()``) as the
worker's.

What this cannot snapshot: a process hard-hung in native code without
releasing the GIL (the JAX package's caveat, as py-spy's ptrace could).
"""

from __future__ import annotations

import os
import sys
import threading
import traceback

# A request's method -> the key its payload has in a process's entry.
PAYLOAD_KEYS = {"stack": "stack", "profile": "profile",
                "memory_profile": "memory", "trace": "trace"}


def answer(method: str, args: tuple):
    """This process's answer to one of the driver's requests: its stack
    dump (``stack``), a sampled CPU profile (``profile``: duration, hz,
    include_idle), an allocation profile (``memory_profile``: duration,
    traceback frames, top N, stop after) or its span buffer (``trace``,
    for :func:`raytpu_torch.runtime.api.trace_dumps`)."""
    if method == "trace":
        from raytpu_torch.util import tracing

        return tracing.dump()
    if method == "stack":
        from raytpu_torch.runtime import records

        return dump_all_threads(
            header=f"worker {records.identity()} pid={os.getpid()}")
    if method == "profile":
        from raytpu_torch.util.profiler import sample_for

        return sample_for(*args)
    if method == "memory_profile":
        from raytpu_torch.util.memprofile import memory_profile

        return memory_profile(*args)
    raise ValueError(f"no such request {method!r}")


def fanout_process_call(method: str, *args, worker=None, node_filter=None,
                        timeout: float = 30.0):
    """``method`` in every live process of the tree at once (a wedged
    process costs at most one ``timeout``, not one a process), from any
    process of it: asked by the driver. The asking process leaves itself
    out (never profile the profiler) unless it is the driver. Returns
    ``{node id: {process id: {"pid", key or "error"}}}``; ``{}`` when
    ``node_filter`` (an id prefix) does not match the host."""
    from raytpu_torch.runtime import api, records

    node = records.node_id()
    if node_filter and not node.startswith(node_filter):
        return {}
    exclude = () if api._REGISTRY is None else (records.identity(),)
    return {node: records.at_driver(
        api.ask_processes, method, tuple(args), PAYLOAD_KEYS[method],
        timeout, worker, exclude)}


def collect_cluster_stacks(worker=None, node_filter=None,
                           timeout: float = 30.0):
    """Every live process's ``stack`` (see :func:`fanout_process_call`)."""
    return fanout_process_call("stack", worker=worker,
                               node_filter=node_filter, timeout=timeout)


def dump_all_threads(header: str = "") -> str:
    """Format every thread's current stack, py-spy-dump style."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    parts = []
    if header:
        parts.append(header)
    for tid, frame in sorted(frames.items()):
        t = by_id.get(tid)
        name = t.name if t is not None else f"<unknown-{tid}>"
        flags = []
        if t is not None and t.daemon:
            flags.append("daemon")
        if t is threading.main_thread():
            flags.append("main")
        suffix = f" ({', '.join(flags)})" if flags else ""
        parts.append(
            f'Thread "{name}" tid={tid}{suffix}:\n'
            + "".join(traceback.format_stack(frame)).rstrip())
    return "\n\n".join(parts) + "\n"
