"""Host-plane collective communication between tasks and actors: the
port of :mod:`raytpu.collective.collective`, with its names and
semantics.

Reference analogue: ``ray.util.collective``
(``python/ray/util/collective/collective.py``). As in the JAX package,
this is the host plane only: numpy contributions for
orchestration-level exchange (rendezvous metadata, eval metrics,
parameter broadcast to env runners, ...); tensors on the card take the
device plane, :mod:`raytpu_torch.collective.mesh_ops`.

Ranks meet at a named, detached coordinator actor per group (a process
of the port's runtime, ``num_cpus=0``); each collective op is a
sequenced slot on it, ranks post their contributions and poll for the
completed result; an op-order mismatch poisons the slot, so every rank
raises. There is no ``shard_map`` here to stand in for: the ranks are
the runtime's tasks and actors. A group's membership is per thread and
is reset when a task ends (:func:`raytpu_torch.runtime.context.
register_task_scope_reset`), so a task that reuses a worker process sees
no group of an earlier task.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from raytpu_torch.runtime import context


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: lambda arrs: np.sum(arrs, axis=0),
    ReduceOp.PRODUCT: lambda arrs: np.prod(arrs, axis=0),
    ReduceOp.MIN: lambda arrs: np.min(arrs, axis=0),
    ReduceOp.MAX: lambda arrs: np.max(arrs, axis=0),
}


class _CollectiveError:
    """Poison-pill slot result: delivered to every polling rank."""

    def __init__(self, message: str):
        self.message = message


class _Coordinator:
    """Named per-group rendezvous + collective slots.

    Runs as an actor of the port's runtime. Methods never block, so the
    default sequential actor queue cannot deadlock; ranks poll (reference
    gloo groups spin on a store too, just below the user API).
    """

    def __init__(self, world_size: int):
        self.world_size = world_size
        # op slots: seq -> {"parts": {rank: payload}, "result": Any}
        self._slots: Dict[int, dict] = {}
        # point-to-point mailboxes: (src, dst, seq) -> payload
        self._mail: Dict[tuple, Any] = {}
        self._joined: set = set()

    def join(self, rank: int) -> int:
        self._joined.add(rank)
        return self.world_size

    def joined_count(self) -> int:
        return len(self._joined)

    def post(self, seq: int, rank: int, op: str, payload):
        slot = self._slots.setdefault(seq, {"parts": {}, "op": op,
                                            "result": None, "taken": set()})
        if slot["op"] != op:
            # Poison the slot so every rank (including ones already
            # polling) observes the mismatch instead of hanging.
            slot["result"] = _CollectiveError(
                f"collective op mismatch at seq {seq}: rank {rank} called "
                f"{op!r} but group is in {slot['op']!r} — collective calls "
                "must be issued in the same order on every rank")
            raise ValueError(slot["result"].message)
        slot["parts"][rank] = payload
        if len(slot["parts"]) == self.world_size:
            slot["result"] = self._complete(slot)

    def poll(self, seq: int, rank: int):
        """Returns (done, result). Frees the slot once every rank took it."""
        slot = self._slots.get(seq)
        if slot is None or slot["result"] is None:
            return False, None
        result = slot["result"]
        out = result[rank] if isinstance(result, dict) else result
        slot["taken"].add(rank)
        if len(slot["taken"]) == self.world_size:
            del self._slots[seq]
        return True, out

    def p2p_send(self, src: int, dst: int, seq: int, payload):
        self._mail[(src, dst, seq)] = payload

    def p2p_recv(self, src: int, dst: int, seq: int):
        key = (src, dst, seq)
        if key in self._mail:
            return True, self._mail.pop(key)
        return False, None

    def _complete(self, slot: dict):
        op = slot["op"]
        parts = slot["parts"]
        ordered = [parts[r] for r in range(self.world_size)]
        if op.startswith("allreduce:"):
            return _REDUCERS[op.split(":", 1)[1]](np.stack(ordered))
        if op == "allgather":
            return list(ordered)
        if op.startswith("reducescatter:"):
            red = _REDUCERS[op.split(":", 1)[1]](np.stack(ordered))
            chunks = np.array_split(red, self.world_size, axis=0)
            return {r: chunks[r] for r in range(self.world_size)}
        if op.startswith("broadcast:"):
            src = int(op.split(":", 1)[1])
            return parts[src]
        if op == "barrier":
            return True
        raise ValueError(f"unknown collective op {op!r}")


class _GroupState:
    def __init__(self, name: str, world_size: int, rank: int, handle):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.handle = handle
        self.seq = 0
        self.p2p_seq: Dict[tuple, int] = {}


_local = threading.local()


def _reset_thread_groups() -> None:
    """Task-scope reset: worker processes are reused across tasks; a
    group one task joined must not look initialized to the next task on
    the same worker (stale rank/coordinator -> wrong reductions)."""
    if hasattr(_local, "groups"):
        del _local.groups


context.register_task_scope_reset(_reset_thread_groups)


def _groups() -> Dict[str, _GroupState]:
    if not hasattr(_local, "groups"):
        _local.groups = {}
    return _local.groups


def _coordinator_name(group_name: str) -> str:
    return f"raytpu_torch::collective::{group_name}"


# How long a rank that lost the race to start a group's coordinator waits
# for the winner's to be registered under its name.
COORDINATOR_WAIT_S = 60.0


def _find_coordinator(name: str):
    """The coordinator another rank is starting: the registry holds its
    name from the start of the actor's process to its first answer, and
    the lookup finds it only after that."""
    import raytpu_torch as rt

    deadline = time.monotonic() + COORDINATOR_WAIT_S
    while True:
        try:
            return rt.get_actor(name)
        except ValueError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default") -> None:
    """Join (creating if first) the collective group ``group_name``.

    Must be called by every participating task/actor with a distinct
    ``rank`` in ``[0, world_size)``. Reference:
    ``python/ray/util/collective/collective.py:120``.

    ``backend``: ``"host"`` (or its alias ``"gloo"``) only. Device-plane
    collectives run over a mesh's ``torch.distributed`` groups
    (:mod:`raytpu_torch.collective.mesh_ops`) and need no group here.
    """
    import raytpu_torch as rt

    if backend not in ("host", "gloo"):
        raise ValueError(
            f"backend {backend!r} unsupported; host-plane collectives use "
            "'host' — tensors on the card should use the mesh's "
            "collectives (raytpu_torch.collective.mesh_ops)")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    name = _coordinator_name(group_name)
    coord_cls = rt.remote(_Coordinator)
    try:
        handle = coord_cls.options(
            name=name, lifetime="detached", num_cpus=0,
        ).remote(world_size)
    except ValueError:  # the name is taken: another rank started it
        handle = _find_coordinator(name)
    ws = rt.get(handle.join.remote(rank))
    if ws != world_size:
        raise ValueError(
            f"group {group_name!r} exists with world_size={ws}, "
            f"got {world_size}")
    _groups()[group_name] = _GroupState(group_name, world_size, rank, handle)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups()


def get_rank(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return -1 if g is None else g.rank


def get_collective_group_size(group_name: str = "default") -> int:
    g = _groups().get(group_name)
    return -1 if g is None else g.world_size


def destroy_collective_group(group_name: str = "default") -> None:
    _groups().pop(group_name, None)


def _group(group_name: str) -> _GroupState:
    g = _groups().get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} not initialized on this "
            "worker; call init_collective_group() first")
    return g


def _run_collective(g: _GroupState, op: str, payload,
                    timeout: Optional[float] = None):
    import raytpu_torch as rt

    seq = g.seq
    g.seq += 1
    rt.get(g.handle.post.remote(seq, g.rank, op, payload))
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        done, result = rt.get(g.handle.poll.remote(seq, g.rank))
        if done:
            if isinstance(result, _CollectiveError):
                raise RuntimeError(result.message)
            return result
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"collective {op} seq={seq} timed out")
        time.sleep(0.002)


def _as_numpy(tensor) -> np.ndarray:
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def allreduce(tensor, group_name: str = "default",
              op: str = ReduceOp.SUM) -> np.ndarray:
    """All-reduce ``tensor`` across the group; returns the reduced array.

    Reference mutates in place (``collective.py:258``); we return the value
    (as the JAX package does) and copy into ``tensor`` when it is a
    writable ndarray for drop-in parity.
    """
    g = _group(group_name)
    result = _run_collective(g, f"allreduce:{op}", _as_numpy(tensor))
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, result)
    return result


def allgather(tensor, group_name: str = "default") -> List[np.ndarray]:
    g = _group(group_name)
    return _run_collective(g, "allgather", _as_numpy(tensor))


def reducescatter(tensor, group_name: str = "default",
                  op: str = ReduceOp.SUM) -> np.ndarray:
    """Reduce across ranks, then scatter row-chunks: rank r gets chunk r
    of axis 0 (reference: ``collective.py:472``)."""
    g = _group(group_name)
    return _run_collective(g, f"reducescatter:{op}", _as_numpy(tensor))


def broadcast(tensor, src_rank: int = 0,
              group_name: str = "default") -> np.ndarray:
    g = _group(group_name)
    result = _run_collective(g, f"broadcast:{src_rank}", _as_numpy(tensor))
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable:
        np.copyto(tensor, result)
    return result


def barrier(group_name: str = "default",
            timeout: Optional[float] = None) -> None:
    g = _group(group_name)
    _run_collective(g, "barrier", None, timeout=timeout)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    import raytpu_torch as rt

    g = _group(group_name)
    key = (g.rank, dst_rank)
    seq = g.p2p_seq.get(key, 0)
    g.p2p_seq[key] = seq + 1
    rt.get(g.handle.p2p_send.remote(g.rank, dst_rank, seq,
                                        _as_numpy(tensor)))


def recv(src_rank: int, group_name: str = "default",
         timeout: Optional[float] = None) -> np.ndarray:
    import raytpu_torch as rt

    g = _group(group_name)
    key = (src_rank, g.rank)
    seq = g.p2p_seq.get(key, 0)
    g.p2p_seq[key] = seq + 1
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        ok, payload = rt.get(
            g.handle.p2p_recv.remote(src_rank, g.rank, seq))
        if ok:
            return payload
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(f"recv from rank {src_rank} timed out")
        time.sleep(0.002)
