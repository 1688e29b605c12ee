"""The port's object store, the role of :mod:`raytpu.runtime.object_store`
and :mod:`raytpu.runtime.shm_store` in Python (the C++ arena is not
needed): a value is **sealed** once, by the process that makes it, into a
descriptor and, when it holds large buffers, one shared-memory segment;
any process of the tree **unseals** the descriptor by mapping the
segment, without a copy.

- **Sealing** pickles the value with
  :mod:`raytpu_torch.runtime.serialization`. Every CPU tensor, and every
  other pickle-5 buffer of :data:`OUT_OF_BAND_BYTES` or more (numpy
  arrays, arrow buffers), is copied once into one new segment, each at a
  64-byte boundary; the pickle stream stays in the descriptor, or goes
  into the segment too when it is over :data:`INLINE_BYTES`. A value
  with no such buffer is its descriptor alone. So a descriptor is small,
  and a block never rides in a connection's pickle stream.
- **Segments** are files under ``/dev/shm`` named
  ``rtt-<tree>-<owner pid>-<n>``: the tree is the driver's pid, the owner
  the process whose refcount frees the value. Readers map them shared
  and writable (``torch.from_file``): a write is seen by every holder, as
  ``put``'s buffer was. Freeing unlinks the file; mappings that readers
  hold stay valid until they drop them. A process that starts another
  unlinks what the child owned once it has reaped it
  (:func:`sweep_owner`), and the driver unlinks every segment of its
  tree at its exit.
- **Counters.** :func:`stats` gives this process's owned objects and
  their bytes (live and peak), the segments it created and unlinked, and
  the bytes its runtime connections carried; :func:`segments` lists the
  tree's segment files, from any process.

Sealing refuses (``ObjectStoreFullError``) a segment that ``/dev/shm``
has no room for, rather than letting a write fault later.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import pickle
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from raytpu_torch.core.errors import ObjectStoreFullError
from raytpu_torch.runtime import serialization, transport

SEGMENT_DIR = "/dev/shm"
PREFIX = "rtt-"
# Buffers at least this large go into the segment (tensors always do).
OUT_OF_BAND_BYTES = 64 * 1024
# A pickle stream longer than this goes into the segment with the buffers.
INLINE_BYTES = 1 << 20
_ALIGN = 64
_TREE_ENV = "RAYTPU_TORCH_TREE"

_LOCK = threading.Lock()
_NAMES = itertools.count()
_STATS = {"objects": 0, "bytes": 0, "peak_objects": 0, "peak_bytes": 0,
          "segments_created": 0, "segment_bytes_created": 0,
          "segments_unlinked": 0}


_TREE: Optional[str] = None


def tree() -> str:
    """This process tree's id: the driver's pid, which the runtime's
    children inherit through the environment (set before the first
    child). A process that ``multiprocessing`` did not start is a driver
    of its own tree, whatever its environment says (a subprocess of a
    process of another tree)."""
    global _TREE
    if _TREE is None:
        if mp.parent_process() is None:
            os.environ[_TREE_ENV] = str(os.getpid())
        _TREE = os.environ.setdefault(_TREE_ENV, str(os.getpid()))
    return _TREE


def set_tree(tree_id: str) -> None:
    """Adopt the tree of the driver this process joined (before its
    first segment; its children inherit it)."""
    global _TREE
    _TREE = os.environ[_TREE_ENV] = str(tree_id)


def _path(name: str) -> str:
    return os.path.join(SEGMENT_DIR, name)


def _create(nbytes: int, owner_pid: int) -> Tuple[str, torch.Tensor]:
    free = os.statvfs(SEGMENT_DIR)
    if free.f_bavail * free.f_frsize < nbytes:
        raise ObjectStoreFullError(
            f"{SEGMENT_DIR} has {free.f_bavail * free.f_frsize} bytes free; "
            f"a segment of {nbytes} bytes does not fit")
    name = f"{PREFIX}{tree()}-{owner_pid}-{os.getpid()}.{next(_NAMES)}"
    seg = torch.from_file(_path(name), shared=True, size=nbytes,
                          dtype=torch.uint8)
    with _LOCK:
        _STATS["segments_created"] += 1
        _STATS["segment_bytes_created"] += nbytes
    return name, seg


def _open(name: str, nbytes: int) -> torch.Tensor:
    return torch.from_file(_path(name), shared=True, size=nbytes,
                           dtype=torch.uint8)


def unlink(name: str) -> None:
    try:
        os.unlink(_path(name))
    except FileNotFoundError:
        return
    with _LOCK:
        _STATS["segments_unlinked"] += 1


def _always_out_of_band(pb: pickle.PickleBuffer) -> bool:
    return isinstance(memoryview(pb).obj, serialization._TensorBytes)


class Sealed:
    """A sealed value's descriptor: ``meta`` (the pickle stream, or None
    when it lies in the segment at ``meta_at``), the segment (``name``,
    ``nbytes``) and where each out-of-band buffer lies in it, and the
    borrow tokens of the refs the value holds (``contained``), which the
    owner drops when it frees the value."""

    __slots__ = ("meta", "name", "nbytes", "spans", "meta_at",
                 "contained")

    def __init__(self, meta, name=None, nbytes=0, spans=(), meta_at=None,
                 contained=()):
        self.meta = meta
        self.name = name
        self.nbytes = nbytes
        self.spans = spans
        self.meta_at = meta_at
        self.contained = contained

    def __reduce__(self):
        return (Sealed, (self.meta, self.name, self.nbytes, self.spans,
                         self.meta_at, self.contained))

    def size(self) -> int:
        return self.nbytes + (len(self.meta) if self.meta else 0)

    def free(self) -> None:
        """Unlink the segment (the owner's part of freeing the value)."""
        if self.name is not None:
            unlink(self.name)


def seal(value, owner_pid: int) -> Sealed:
    """``value`` as a descriptor and, for its large buffers, a new segment
    owned (unlinked at free) by ``owner_pid``."""
    from raytpu_torch.runtime import refcount

    buffers: List[pickle.PickleBuffer] = []
    inline = [0]

    def place(pb) -> bool:
        n = memoryview(pb).nbytes
        if (n >= OUT_OF_BAND_BYTES or _always_out_of_band(pb)
                or inline[0] + n > INLINE_BYTES):
            buffers.append(pb)
            return False
        inline[0] += n
        return True

    with refcount.collecting_tokens() as contained:
        meta = serialization.dumps(value, buffer_callback=place)
    if not buffers and len(meta) <= INLINE_BYTES:
        return Sealed(meta, contained=tuple(contained))
    spans, at = [], 0
    for pb in buffers:
        n = memoryview(pb).nbytes
        spans.append((at, n))
        at += -(-n // _ALIGN) * _ALIGN
    meta_at = None
    if len(meta) > INLINE_BYTES:
        meta_at, at = at, at + len(meta)
    name, seg = _create(max(at, 1), owner_pid)
    flat = seg.numpy()
    for pb, (offset, n) in zip(buffers, spans):
        flat[offset:offset + n] = np.frombuffer(pb.raw(), np.uint8)
    if meta_at is not None:
        flat[meta_at:meta_at + len(meta)] = np.frombuffer(meta, np.uint8)
        meta = None
    return Sealed(meta, name, max(at, 1), tuple(spans), meta_at,
                  tuple(contained))


def unseal(sealed: Sealed):
    """The value of a descriptor: its buffers are views of the mapped
    segment (no copy)."""
    if sealed.name is None:
        return serialization.loads(sealed.meta)
    seg = _open(sealed.name, sealed.nbytes)
    flat = seg.numpy()
    views = [memoryview(flat[o:o + n]) for o, n in sealed.spans]
    meta = sealed.meta
    if meta is None:
        meta = flat[sealed.meta_at:sealed.nbytes].tobytes()
    serialization._UNSEALING.segment = (seg, seg.data_ptr())
    try:
        return serialization.loads(meta, buffers=views)
    finally:
        serialization._UNSEALING.segment = None


def count(delta_objects: int, delta_bytes: int) -> None:
    """The owner's ledger of what it holds (called by the refcount)."""
    with _LOCK:
        _STATS["objects"] += delta_objects
        _STATS["bytes"] += delta_bytes
        _STATS["peak_objects"] = max(_STATS["peak_objects"],
                                     _STATS["objects"])
        _STATS["peak_bytes"] = max(_STATS["peak_bytes"], _STATS["bytes"])


def stats() -> dict:
    """This process's store counters and the bytes its runtime
    connections carried."""
    with _LOCK:
        out = dict(_STATS)
    wire = transport.wire_bytes()
    out["wire_bytes_sent"] = wire["sent"]
    out["wire_bytes_received"] = wire["received"]
    return out


def segments(owner_pid: Optional[int] = None) -> List[Tuple[str, int]]:
    """(name, bytes) of this tree's segment files, or of one owner's."""
    head = f"{PREFIX}{tree()}-"
    if owner_pid is not None:
        head += f"{owner_pid}-"
    out = []
    for name in sorted(os.listdir(SEGMENT_DIR)):
        if name.startswith(head):
            try:
                out.append((name, os.path.getsize(_path(name))))
            except FileNotFoundError:
                pass  # unlinked meanwhile
    return out


def sweep_owner(pid: Optional[int] = None) -> int:
    """Unlink the segments that ``pid`` owned (every segment of the tree
    when None): called once that process is gone. Returns how many."""
    names = [name for name, _ in segments(pid)]
    for name in names:
        unlink(name)
    return len(names)
