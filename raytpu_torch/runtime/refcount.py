"""Reference counting across processes, the port of
:mod:`raytpu.runtime.refcount` (its ``Reference``, ``ReferenceCounter``
and borrower protocol, ``refcount.py:53-115``).

Every process keeps two tables, under one condition (:data:`READY`) on
which ``get`` and ``wait`` sleep:

- **owned** (:class:`Entry`): the objects this process owns: what it
  ``put``, and the results of the calls and tasks it submitted, pending
  until the producer's descriptor (or error) arrives. An entry counts
  its **local** refs (live :class:`~raytpu_torch.runtime.object_ref.ObjectRef`
  instances in this process: a call's or task's submission holds those
  of its arguments until it ends, the submitted-task refs), its
  **tokens** (refs serialized somewhere and not yet claimed) and its
  **borrowers** (the pids of the processes that hold one). Once all are
  gone the entry is freed: its segment is unlinked, the tokens of the
  refs its value held are dropped, and a result still pending is thrown
  away when it lands.
- **borrowed** (:class:`Borrow`): refs of other owners held here, one
  entry per object however many instances. The first instance claims a
  borrow at the owner; the last one's death releases it. A borrower
  that exits releases all its borrows (its connection to the owner
  closes).

The protocol: serializing a ref mints a token, which the owner records
before the bytes leave (at once where the serializer is the owner, by a
round trip otherwise). Unpickling claims it synchronously in the
receiving process (or drops it where that process already borrows, or
is the owner). A token nobody claims is dropped by whoever made the
bytes: a submission at its end, a value's owner when it frees the value.
So an object outlives every ref to it, in any process, and no longer.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Callable, Dict, List, Optional

from raytpu_torch.runtime import object_store
from raytpu_torch.util import task_events

# Every completion lands under this condition; get and wait sleep on it.
READY = threading.Condition(threading.RLock())

PENDING, DONE, FAILED = 0, 1, 2
_NOVALUE = object()


class Entry:
    """One object this process owns."""

    __slots__ = ("oid", "state", "sealed", "error", "value", "local",
                 "tokens", "borrowers", "waiters", "caller", "call_id",
                 "task", "counted")

    def __init__(self, oid: str):
        self.oid = oid
        self.state = PENDING
        self.sealed = None
        self.error = None
        self.value = _NOVALUE
        self.local = 0
        self.tokens: set = set()
        self.borrowers: set = set()
        self.waiters: List[Callable[["Entry"], None]] = []
        self.caller = None      # the actor caller of a pending call
        self.call_id = 0
        self.task = None        # the task id of a pending task's return
        self.counted = 0        # bytes this entry adds to the store's ledger


class Borrow:
    """Another owner's object, held here."""

    __slots__ = ("owner", "live", "claimed", "requested", "sealed",
                 "error", "value")

    def __init__(self, owner: str):
        self.owner = owner
        self.live = 0
        self.claimed = False
        self.requested = False
        self.sealed = None
        self.error = None
        self.value = _NOVALUE


OWNED: Dict[str, Entry] = {}
BORROWED: Dict[str, Borrow] = {}


def _reset_after_fork() -> None:
    """A forked child owns and borrows nothing of its parent's."""
    OWNED.clear()
    BORROWED.clear()


os.register_at_fork(after_in_child=_reset_after_fork)


# ---- tokens --------------------------------------------------------------

_SINK = threading.local()


@contextlib.contextmanager
def collecting_tokens():
    """Record the borrow tokens minted while the block serializes."""
    outer = getattr(_SINK, "tokens", None)
    _SINK.tokens = tokens = []
    try:
        yield tokens
    finally:
        _SINK.tokens = outer
        if outer is not None:
            outer.extend(tokens)


def minted(oid: str, owner: str, token: str) -> None:
    sink = getattr(_SINK, "tokens", None)
    if sink is not None:
        sink.append((oid, owner, token))


# ---- the owner's table --------------------------------------------------


def new_entry(oid: str, **fields) -> Entry:
    entry = Entry(oid)
    for key, value in fields.items():
        setattr(entry, key, value)
    with READY:
        OWNED[oid] = entry
    return entry


def _set_done(entry: Entry, sealed) -> None:
    entry.state = DONE
    entry.sealed = sealed
    entry.counted = sealed.size()
    object_store.count(1, entry.counted)


def complete(oid: str, sealed=None, value=_NOVALUE) -> None:
    """A pending object's value arrived (a descriptor, or a value in hand
    that is sealed only if another process asks for it)."""
    with READY:
        entry = OWNED.get(oid)
        if entry is None or entry.state != PENDING:
            discard(sealed)  # nobody holds a ref any more
            return
        if sealed is not None:
            _set_done(entry, sealed)
        else:
            entry.state = DONE
        entry.value = value
        waiters, entry.waiters = entry.waiters, []
        _finish(entry)
        READY.notify_all()
    if task_events.enabled():
        # The object is in its owner's table: the JAX node store's PUT.
        task_events.emit("object", oid, task_events.TaskTransition.PUT)
    for waiter in waiters:
        waiter(entry)


def fail(oid: str, error: BaseException) -> None:
    with READY:
        entry = OWNED.get(oid)
        if entry is None or entry.state != PENDING:
            return
        entry.state = FAILED
        entry.error = error
        waiters, entry.waiters = entry.waiters, []
        _finish(entry)
        READY.notify_all()
    for waiter in waiters:
        waiter(entry)


def _finish(entry: Entry) -> None:
    entry.caller = None
    entry.task = None


def sealed_of(entry: Entry):
    """The descriptor of a done entry, sealing a value in hand at the
    first request from another process."""
    if entry.sealed is None and entry.value is not _NOVALUE:
        sealed = object_store.seal(entry.value, os.getpid())
        with READY:
            if entry.sealed is None and OWNED.get(entry.oid) is entry:
                _set_done(entry, sealed)
                sealed = None
        if sealed is not None:  # freed, or sealed by another thread
            discard(sealed)
    return entry.sealed


def when_done(oid: str, reply: Callable[[Optional[Entry]], None]) -> None:
    """Call ``reply`` with the entry once it is done or failed (None if
    it is not owned here: freed)."""
    with READY:
        entry = OWNED.get(oid)
        if entry is not None and entry.state == PENDING:
            entry.waiters.append(reply)
            return
    reply(entry)


def add_local(oid: str) -> bool:
    with READY:
        entry = OWNED.get(oid)
        if entry is None:
            return False
        entry.local += 1
        return True


def remove_local(oid: str) -> None:
    with READY:
        entry = OWNED.get(oid)
        if entry is not None:
            entry.local -= 1
            _maybe_free(entry)


def add_token(oid: str, token: str) -> bool:
    with READY:
        entry = OWNED.get(oid)
        if entry is None:
            return False
        entry.tokens.add(token)
        return True


def claim(oid: str, token: Optional[str], pid: int) -> bool:
    with READY:
        entry = OWNED.get(oid)
        if entry is None:
            return False
        entry.tokens.discard(token)
        entry.borrowers.add(pid)
        return True


def drop_token(oid: str, token: str) -> None:
    with READY:
        entry = OWNED.get(oid)
        if entry is not None:
            entry.tokens.discard(token)
            _maybe_free(entry)


def release(oid: str, pid: int) -> None:
    with READY:
        entry = OWNED.get(oid)
        if entry is not None:
            entry.borrowers.discard(pid)
            _maybe_free(entry)


def release_pid(pid: int) -> None:
    """A borrower process is gone: every borrow it held ends."""
    with READY:
        for entry in list(OWNED.values()):
            if pid in entry.borrowers:
                entry.borrowers.discard(pid)
                _maybe_free(entry)


def _maybe_free(entry: Entry) -> None:
    if entry.local > 0 or entry.tokens or entry.borrowers:
        return
    if OWNED.get(entry.oid) is entry:
        del OWNED[entry.oid]
    if entry.caller is not None:
        entry.caller.forget(entry.call_id)
    if entry.counted:
        object_store.count(-1, -entry.counted)
        entry.counted = 0
    if entry.state == DONE:
        discard(entry.sealed)
    entry.value = _NOVALUE


class Submission:
    """What a call or task keeps until it ends: the refs of its arguments
    (the submitted-task refs), its sealed arguments (whose segment and
    tokens go at the end) and, for a call, the entry its reply completes
    (None once no ref waits for it)."""

    __slots__ = ("oid", "keep", "sealed")

    def __init__(self, oid, keep, sealed):
        self.oid = oid
        self.keep = keep
        self.sealed = sealed

    def finish(self) -> None:
        sealed, self.sealed, self.keep = self.sealed, None, None
        discard(sealed)


def discard(sealed) -> None:
    """Free a descriptor nobody owns: its segment and its tokens."""
    if sealed is None:
        return
    sealed.free()
    drop_tokens(sealed.contained)


def drop_tokens(tokens) -> None:
    """Drop unclaimed tokens (a no-op for those already claimed)."""
    if not tokens:
        return
    from raytpu_torch.runtime import object_ref

    for oid, owner, token in tokens:
        object_ref.drop(oid, owner, token)


def owned_stats() -> Dict[str, Any]:
    """The owned table by state, for tests and the card's checks."""
    with READY:
        entries = list(OWNED.values())
    return {"owned": len(entries),
            "pending": sum(e.state == PENDING for e in entries),
            "borrowed": len(BORROWED)}
