"""Binary entity IDs: the port's copy of :mod:`raytpu.core.ids`.

Reference analogue: ``src/ray/common/id.h`` — JobID/TaskID/ActorID/ObjectID/
NodeID with deterministic derivation (object ids are derived from the
producing task id + return index, so any party can name a task's outputs
without communication). We keep the same derivation property but use a
simpler uniform 16-byte layout.
"""

from __future__ import annotations

import hashlib
import os
import threading

_ID_SIZE = 16


class BaseID:
    """A fixed-size binary id with value semantics."""

    __slots__ = ("_bytes",)
    SIZE = _ID_SIZE

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {binary!r}"
            )
        self._bytes = binary

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._bytes))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class ActorID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class TaskID(BaseID):
    """Task ids embed nothing; object ids are derived from them (below)."""

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        return cls(_derive(b"actor_creation", actor_id.binary()))


class ObjectID(BaseID):
    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Deterministic: anyone holding the task id can name its returns.

        Reference: ``src/ray/common/id.h`` ``ObjectID::FromIndex``.
        """
        return cls(_derive(b"return", task_id.binary() + index.to_bytes(4, "little")))

    @classmethod
    def for_put(cls, worker_id: WorkerID, put_index: int) -> "ObjectID":
        return cls(_derive(b"put", worker_id.binary() + put_index.to_bytes(8, "little")))


def _derive(tag: bytes, payload: bytes) -> bytes:
    return hashlib.blake2b(tag + payload, digest_size=_ID_SIZE).digest()


class _Counter:
    """Thread-safe monotonically increasing counter (for put indices etc.)."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
