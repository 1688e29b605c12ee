"""Single-writer multi-reader versioned channels across processes, the
port of :mod:`raytpu.runtime.channel`.

The JAX channel's semantics, kept: a ring of ``capacity`` versions, a
fixed ``num_readers``, each reader's cursor claimed once by
:meth:`Channel.reader_id` (it sees only later writes), broadcast (every
reader sees every version once, in order), backpressure (the writer
blocks while ``capacity`` versions are unread by the slowest reader),
``TimeoutError`` on a ``read``/``write`` timeout, and :meth:`close`
waking every blocked reader and writer, which then raise
:class:`ChannelClosed`.

What the port changes: its actors are processes, not threads of one
process, so the ring lives in shared memory.

- **The ring.** One file under ``/dev/shm`` that the creating process
  owns, named as the object store names its segments
  (``rtt-<tree>-<owner pid>-...``): a header (the sizes, the closed flag,
  the newest version, two wake-up words), the readers' cursors and
  ``capacity`` slots of :data:`SLOT_BYTES` each. Pickling a channel gives its
  name; unpickling it in any process of the tree (the driver, an actor,
  a task worker, a process joined by ``init(address=...)``) maps the
  same file, so the same cursors: a reader id claimed in the driver is
  valid in the reader's process. Within one process the same name gives
  the same :class:`Channel` object.
- **Mutual exclusion.** ``flock`` on the file (an open file description
  a process's channel object) and a thread lock of the object. Both are
  held only to read or move the header and the cursors, and while the
  writer copies a slot in.
- **Waiting.** A blocked reader or writer sleeps in the kernel on a
  futex word of the mapping (``FUTEX_WAIT``, shared, not private),
  through ``ctypes``' ``syscall``: readers on the word every write
  bumps, writers on the word every read bumps; ``close`` bumps both.
  A waiter reads its word under the lock and sleeps only while it still
  holds that value, so no wake-up is lost. Why a futex: Python has no
  process-shared condition variable, ``multiprocessing``'s semaphores
  cannot be handed to a forkserver child after it has started, and a
  wake-up fd would have to travel over each worker's socket for every
  channel; a futex needs nothing but the mapping every process already
  has. So an idle compiled graph holds no core.
- **Values.** A value whose pickled bytes (its CPU tensors in band) fit
  a slot is copied into the slot; a reader copies it out and unpickles
  it. A larger one is sealed into the object store
  (:func:`raytpu_torch.runtime.object_store.seal`, its buffers out of
  band in a segment the writer owns) and only the descriptor goes into
  the slot; readers map that segment, and the reader whose read is the
  last of that version unlinks it. A CUDA tensor crosses by CUDA IPC
  (:mod:`raytpu_torch.runtime.serialization`): the writer's channel
  object keeps every value it wrote alive until the slowest reader has
  read its version.
- **Cleanup.** :meth:`close` unlinks the ring and the segments of the
  versions not yet read by all (a reader's mapping stays valid until it
  drops it). A process unlinks the rings it created and left open at its
  exit; a ring or a sealed value whose owner dies is unlinked by the
  owner's starter (:func:`object_store.sweep_owner`), and the driver
  unlinks every segment of its tree at its exit.

TPU relevance in the JAX package, GPU here: the host-side feeding
primitive (a data-loader actor writing each step's inputs into a
channel the training actor reads) and the wire of compiled graphs
(:mod:`raytpu_torch.dag.compiled`).
"""

from __future__ import annotations

import atexit
import ctypes
import errno
import fcntl
import itertools
import mmap
import os
import platform
import struct
import threading
import time
import weakref
from collections import deque
from typing import Any, Optional

from raytpu_torch.runtime import object_store, serialization

# A slot's payload bytes: a value whose pickle is longer goes through the
# object store (a GPT-2 batch of 8 x 1024 int64 tokens, 64 KiB, fits).
SLOT_BYTES = 1 << 20

_MAGIC = 0x48435452  # "RTCH"
# Header: magic, num_readers, capacity, slot_bytes, closed, wseq, rseq,
# next_reader (u32 each), then the newest version (u64).
_HEADER = struct.Struct("<8IQ")
_CLOSED, _WSEQ, _RSEQ = 16, 20, 24
_NEXT_READER, _VERSION = 28, 32
_CURSORS = 64  # one i64 a reader: -1 unclaimed, else its last version read
_SLOT_HEAD = struct.Struct("<QII")  # version, payload bytes, kind
_INLINE, _SEALED = 0, 1
_ALIGN = 64

_FUTEX_WAIT, _FUTEX_WAKE = 0, 1
_SYS_FUTEX = {"x86_64": 202, "aarch64": 98}.get(platform.machine())
_LIBC = ctypes.CDLL(None, use_errno=True)
_INT_MAX = 0x7FFFFFFF


class ChannelClosed(Exception):
    pass


class _Timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


def _futex(address: int, op: int, value: int,
           timeout: Optional[float] = None) -> int:
    """One futex call on a word of a shared mapping; the errno on
    failure (EAGAIN: the word had moved; ETIMEDOUT), else 0."""
    if _SYS_FUTEX is None:
        raise OSError(errno.ENOSYS, f"no futex syscall number for "
                      f"{platform.machine()}")
    ts = None
    if timeout is not None:
        sec = int(timeout)
        ts = ctypes.byref(_Timespec(sec, int((timeout - sec) * 1e9)))
    rc = _LIBC.syscall(ctypes.c_long(_SYS_FUTEX), ctypes.c_void_p(address),
                       ctypes.c_int(op), ctypes.c_uint32(value), ts, None,
                       ctypes.c_int(0))
    if rc == -1:
        err = ctypes.get_errno()
        if err in (errno.ENOSYS, errno.EPERM, errno.EFAULT, errno.EINVAL):
            raise OSError(err, f"futex: {os.strerror(err)}")
        return err
    return 0


class _TooLarge(Exception):
    """Raised from the pickler's buffer callback: the value's buffers
    alone outgrow a slot."""


# This process's channel objects by name: unpickling a name that is
# already mapped here gives the same object.
_LIVE: "weakref.WeakValueDictionary[str, Channel]" = \
    weakref.WeakValueDictionary()
_LIVE_LOCK = threading.Lock()
_NAMES = itertools.count()
# The rings this process created and has not closed: unlinked at its exit
# (a process that started no runtime child has no sweep of its own).
_CREATED: set = set()


@atexit.register
def _unlink_created() -> None:
    for name in list(_CREATED):
        object_store.unlink(name)


# A forked child owns none of its parent's rings.
os.register_at_fork(after_in_child=_CREATED.clear)


def _layout(num_readers: int, capacity: int, slot_bytes: int):
    slots_at = -(-(_CURSORS + 8 * num_readers) // _ALIGN) * _ALIGN
    stride = -(-(_SLOT_HEAD.size + slot_bytes) // _ALIGN) * _ALIGN
    return slots_at, stride, slots_at + stride * capacity


class Channel:
    """Versioned ring of ``capacity`` slots in shared memory.
    ``num_readers`` fixed at creation; every reader sees every version
    exactly once (broadcast)."""

    def __init__(self, num_readers: int = 1, capacity: int = 1, *,
                 _attach: str = None):
        if _attach is not None:
            self._map(_attach)
            return
        if num_readers < 1:
            raise ValueError("num_readers must be >= 1")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        name = (f"{object_store.PREFIX}{object_store.tree()}-{os.getpid()}-"
                f"{os.getpid()}.chan{next(_NAMES)}")
        size = _layout(num_readers, capacity, SLOT_BYTES)[2]
        path = os.path.join(object_store.SEGMENT_DIR, name)
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
        except BaseException:
            os.close(fd)
            os.unlink(path)
            raise
        _HEADER.pack_into(mm, 0, _MAGIC, num_readers, capacity, SLOT_BYTES,
                          0, 0, 0, 0, 0)
        for rid in range(num_readers):
            struct.pack_into("<q", mm, _CURSORS + 8 * rid, -1)
        self._setup(name, fd, mm)
        with _LIVE_LOCK:
            _LIVE[name] = self
            _CREATED.add(name)

    # -- mapping -------------------------------------------------------------

    def _map(self, name: str) -> None:
        path = os.path.join(object_store.SEGMENT_DIR, name)
        try:
            fd = os.open(path, os.O_RDWR)
        except FileNotFoundError:
            raise ChannelClosed(f"channel {name} no longer exists") from None
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size)
        except BaseException:
            os.close(fd)
            raise
        if struct.unpack_from("<I", mm, 0)[0] != _MAGIC:
            os.close(fd)
            raise ValueError(f"{name} is not a channel")
        self._setup(name, fd, mm)

    def _setup(self, name: str, fd: int, mm: mmap.mmap) -> None:
        self._name = name
        self._fd = fd
        self._mm = mm
        (_, self._num_readers, self._capacity, self._slot_bytes,
         *_rest) = _HEADER.unpack_from(mm, 0)
        self._slots_at, self._stride, _ = _layout(
            self._num_readers, self._capacity, self._slot_bytes)
        # The futex words' addresses (the ctypes views pin the mapping).
        self._words = {off: ctypes.c_uint32.from_buffer(mm, off)
                       for off in (_WSEQ, _RSEQ)}
        self._addr = {off: ctypes.addressof(w)
                      for off, w in self._words.items()}
        self._tlock = threading.Lock()
        # The writer's values, held until every reader has read them
        # (a CUDA tensor's memory must outlive its readers' opens).
        self._held: deque = deque()
        self._finalizer = weakref.finalize(self, os.close, fd)

    @property
    def name(self) -> str:
        return self._name

    def _lock(self):
        return _Locked(self)

    def _u32(self, off: int) -> int:
        return struct.unpack_from("<I", self._mm, off)[0]

    def _bump(self, off: int) -> None:
        struct.pack_into("<I", self._mm, off, (self._u32(off) + 1)
                         & 0xFFFFFFFF)

    def _version(self) -> int:
        return struct.unpack_from("<Q", self._mm, _VERSION)[0]

    def _cursor(self, rid: int) -> int:
        return struct.unpack_from("<q", self._mm, _CURSORS + 8 * rid)[0]

    def _slowest(self) -> int:
        claimed = [c for c in (self._cursor(r)
                               for r in range(self._num_readers)) if c >= 0]
        return min(claimed) if claimed else self._version()

    @property
    def closed(self) -> bool:
        return bool(self._u32(_CLOSED))

    def _wait(self, off: int, seen: int, deadline: Optional[float],
              what: str) -> None:
        """Sleep on a wake-up word while it still reads ``seen``."""
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"channel {what} timed out")
        err = _futex(self._addr[off], _FUTEX_WAIT, seen, remaining)
        if err == errno.ETIMEDOUT:
            raise TimeoutError(f"channel {what} timed out")

    def _wake(self, off: int) -> None:
        _futex(self._addr[off], _FUTEX_WAKE, _INT_MAX)

    # -- reader registration ---------------------------------------------

    def reader_id(self) -> int:
        """Claim one of the num_readers read cursors."""
        with self._lock():
            rid = self._u32(_NEXT_READER)
            if rid >= self._num_readers:
                raise ValueError(
                    f"channel has {self._num_readers} readers; all claimed")
            struct.pack_into("<I", self._mm, _NEXT_READER, rid + 1)
            # Sees only future writes.
            struct.pack_into("<q", self._mm, _CURSORS + 8 * rid,
                             self._version())
            return rid

    # -- data plane --------------------------------------------------------

    def _encode(self, value: Any):
        """(kind, payload bytes, the segment sealed for it or None)."""
        room = [self._slot_bytes]

        def in_band(pb) -> bool:
            room[0] -= memoryview(pb).nbytes
            if room[0] < 0:
                raise _TooLarge()
            return True

        try:
            data = serialization.dumps(value, buffer_callback=in_band)
            if len(data) <= self._slot_bytes:
                return _INLINE, data, None
        except _TooLarge:
            pass
        sealed = object_store.seal(value, os.getpid())
        data = serialization.dumps(sealed)
        if len(data) > self._slot_bytes:
            sealed.free()
            raise ValueError(f"a value's descriptor of {len(data)} bytes "
                             f"outgrows the channel's {self._slot_bytes}-byte "
                             f"slots")
        return _SEALED, data, sealed

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        """Block while ``capacity`` versions are pending for some reader."""
        deadline = None if timeout is None else time.monotonic() + timeout
        kind, data, sealed = self._encode(value)
        try:
            self._publish(kind, data, value, deadline)
        except BaseException:
            if sealed is not None:
                sealed.free()
            raise

    def _publish(self, kind: int, data: bytes, value, deadline) -> None:
        while True:
            with self._lock():
                if self.closed:
                    raise ChannelClosed()
                version, slowest = self._version(), self._slowest()
                self._release_held(slowest)
                if version - slowest < self._capacity:
                    version += 1
                    at = self._slots_at + self._stride * (
                        version % self._capacity)
                    _SLOT_HEAD.pack_into(self._mm, at, version, len(data),
                                         kind)
                    self._mm[at + _SLOT_HEAD.size:
                             at + _SLOT_HEAD.size + len(data)] = data
                    struct.pack_into("<Q", self._mm, _VERSION, version)
                    self._bump(_WSEQ)
                    self._held.append((version, value))
                    break
                seen = self._u32(_RSEQ)
            self._wait(_RSEQ, seen, deadline, "write")
        self._wake(_WSEQ)

    def _release_held(self, slowest: int) -> None:
        while self._held and self._held[0][0] <= slowest:
            self._held.popleft()

    def read(self, reader_id: int, timeout: Optional[float] = None) -> Any:
        """Block until a version newer than this reader's cursor appears."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not 0 <= reader_id < self._num_readers or \
                self._cursor(reader_id) < 0:
            raise ValueError(f"unknown reader {reader_id}")
        while True:
            with self._lock():
                want = self._cursor(reader_id) + 1
                if want <= self._version():
                    break
                if self.closed:
                    raise ChannelClosed()
                seen = self._u32(_WSEQ)
            self._wait(_WSEQ, seen, deadline, "read")
        # The slot holds ``want`` until this reader's cursor passes it.
        at = self._slots_at + self._stride * (want % self._capacity)
        _, n, kind = _SLOT_HEAD.unpack_from(self._mm, at)
        data = self._mm[at + _SLOT_HEAD.size: at + _SLOT_HEAD.size + n]
        sealed = None
        try:
            if kind == _SEALED:
                sealed = serialization.loads(data)
                try:
                    value = object_store.unseal(sealed)
                except (FileNotFoundError, RuntimeError) as exc:
                    raise ChannelClosed(f"version {want}'s value was freed "
                                        f"at close ({exc})") from None
            else:
                value = serialization.loads(data)
        finally:
            with self._lock():
                before = self._slowest()
                struct.pack_into("<q", self._mm, _CURSORS + 8 * reader_id,
                                 want)
                last = before < want <= self._slowest()
                self._bump(_RSEQ)
            self._wake(_RSEQ)  # a parked writer
        if last and sealed is not None:
            sealed.free()  # every reader has mapped it
        return value

    def close(self) -> None:
        """Wake every blocked reader and writer (they raise
        :class:`ChannelClosed`), unlink the ring and the segments of the
        versions not yet read by all."""
        with self._lock():
            struct.pack_into("<I", self._mm, _CLOSED, 1)
            self._bump(_WSEQ)
            self._bump(_RSEQ)
            pending = []
            for version in range(self._slowest() + 1, self._version() + 1):
                at = self._slots_at + self._stride * (
                    version % self._capacity)
                _, n, kind = _SLOT_HEAD.unpack_from(self._mm, at)
                if kind == _SEALED:
                    pending.append(bytes(self._mm[
                        at + _SLOT_HEAD.size: at + _SLOT_HEAD.size + n]))
            self._held.clear()
        self._wake(_WSEQ)
        self._wake(_RSEQ)
        for data in pending:
            serialization.loads(data).free()
        object_store.unlink(self._name)
        with _LIVE_LOCK:
            _CREATED.discard(self._name)
            if _LIVE.get(self._name) is self:
                del _LIVE[self._name]

    # -- serialization: the name maps the same ring ------------------------

    def __reduce__(self):
        return (_resolve_channel, (self._name,))

    def __repr__(self):
        return (f"Channel({self._name}, readers={self._num_readers}, "
                f"capacity={self._capacity})")


class _Locked:
    """The channel's thread lock, then its file lock."""

    __slots__ = ("ch",)

    def __init__(self, ch: Channel):
        self.ch = ch

    def __enter__(self):
        self.ch._tlock.acquire()
        try:
            fcntl.flock(self.ch._fd, fcntl.LOCK_EX)
        except BaseException:
            self.ch._tlock.release()
            raise

    def __exit__(self, *exc):
        try:
            fcntl.flock(self.ch._fd, fcntl.LOCK_UN)
        finally:
            self.ch._tlock.release()
        return False


def _resolve_channel(name: str) -> Channel:
    """The channel of ``name`` in this process: the object already mapped
    here, else a new mapping of the same ring."""
    with _LIVE_LOCK:
        ch = _LIVE.get(name)
        if ch is None:
            ch = Channel(_attach=name)
            _LIVE[name] = ch
    return ch


def segments() -> list:
    """(name, bytes) of this tree's channel rings in ``/dev/shm``."""
    return [(n, b) for n, b in object_store.segments() if ".chan" in n]
