"""Refs that cross processes, the port of :mod:`raytpu.runtime.object_ref`.

An :class:`ObjectRef` is an object id and its owner's address: the
abstract Unix socket on which the owner's object server listens (opened
when the first of its refs leaves the process). It pickles to the two,
and a borrow token (:mod:`raytpu_torch.runtime.refcount`); any process
of the tree that unpickles it resolves it through the owner: one request
gives the value's descriptor once it is done, and the reader maps the
value's segment itself (:mod:`raytpu_torch.runtime.object_store`). So a
value's bytes go from the process that made it to the process that reads
it, never through the owner or the submitter.

Each process keeps one connection to each owner it talks to
(:class:`_Peer`), whose first message names its pid: when it closes, the
owner ends that process's borrows. Releases and token drops go out from
a sender thread, never from a finalizer. A ref whose owner has exited
raises :class:`OwnerDiedError` at ``get``; one whose value was freed
:class:`ObjectLostError`.

A call's top-level ref argument crosses as a :class:`TopArg` (no token:
the submitter holds the ref until the call ends) and is resolved where
the call runs, before it starts.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import uuid
from typing import Callable, Dict, Optional

from raytpu_torch.core.errors import (ObjectLostError, OwnerDiedError,
                                      TaskError)
from raytpu_torch.runtime import object_store, refcount, transport


def _fresh_identity() -> None:
    global _ME, _SERVING, _PEERS, _OUTBOX_THREAD
    _ME = transport.new_address("obj-")
    _SERVING = None
    _PEERS = {}
    _OUTBOX.clear()
    _OUTBOX_THREAD = None


_ME = ""
_SERVING = None
_SERVER_LOCK = threading.Lock()
_PEERS: Dict[str, "_Peer"] = {}
_PEERS_LOCK = threading.Lock()
_OUTBOX: collections.deque = collections.deque()
_OUTBOX_EVENT = threading.Event()
_OUTBOX_THREAD: Optional[threading.Thread] = None
_TOKENS = itertools.count()
_fresh_identity()
# A forked child is a process of its own: its own address and peers.
os.register_at_fork(after_in_child=_fresh_identity)


def me() -> str:
    return _ME


def new_id() -> str:
    return uuid.uuid4().hex


class ObjectRef:
    """A future of one value, owned by the process that ``put`` it or
    submitted the call that makes it. Equal and hashed by id."""

    __slots__ = ("_id", "_owner", "_mine", "__weakref__")

    def __init__(self, oid: str, owner: Optional[str] = None):
        self._id = oid
        self._owner = owner or _ME
        self._mine = self._owner == _ME

    @classmethod
    def owned(cls, oid: str) -> "ObjectRef":
        """A new local ref to an entry of this process."""
        ref = cls(oid)
        refcount.add_local(oid)
        return ref

    def hex(self) -> str:
        return self._id

    def __del__(self):
        try:
            if self._mine:
                refcount.remove_local(self._id)
            else:
                _borrow_dec(self._id)
        except (AttributeError, TypeError):  # the interpreter's teardown
            pass

    def __reduce__(self):
        token = f"{os.getpid()}.{next(_TOKENS)}"
        if self._mine:
            ensure_serving()
            refcount.add_token(self._id, token)
        elif not peer(self._owner).call("add", self._id, token)[0]:
            token = None  # freed or its owner gone: the receiver sees it
        if token is not None:
            refcount.minted(self._id, self._owner, token)
        return (_rebuild_ref, (self._id, self._owner, token))

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id[:16]})"


def _rebuild_ref(oid: str, owner: str, token: Optional[str]) -> ObjectRef:
    ref = ObjectRef(oid, owner)
    if ref._mine:
        refcount.add_local(oid)
        if token is not None:
            refcount.drop_token(oid, token)
    else:
        _borrow_inc(oid, owner, token)
    return ref


class TopArg:
    """A call's top-level ref argument, as it crosses: resolved where the
    call runs. The submitter holds the ref until the call ends."""

    __slots__ = ("oid", "owner")

    def __init__(self, oid: str, owner: str):
        self.oid = oid
        self.owner = owner

    def __reduce__(self):
        return (TopArg, (self.oid, self.owner))

    def ref(self) -> ObjectRef:
        """A ref to the argument in this process (no borrow claimed)."""
        ref = ObjectRef(self.oid, self.owner)
        if ref._mine:
            refcount.add_local(self.oid)
        else:
            _borrow_inc(self.oid, self.owner, None)
        return ref


def top_arg(ref: ObjectRef) -> TopArg:
    if ref._mine:
        ensure_serving()
    return TopArg(ref._id, ref._owner)


# ---- borrows -------------------------------------------------------------


def _borrow_inc(oid: str, owner: str, token: Optional[str]) -> None:
    _ensure_outbox()
    with refcount.READY:
        b = refcount.BORROWED.get(oid)
        if b is None:
            b = refcount.BORROWED[oid] = refcount.Borrow(owner)
        b.live += 1
        claim = token is not None and not b.claimed
        if claim:
            b.claimed = True
    if token is None:
        return
    if not claim:
        _post(owner, "drop", oid, token)
        return
    ok, error = peer(owner).call("claim", oid, token, os.getpid())
    if not ok:
        with refcount.READY:
            b.error = error or ObjectLostError(oid, "freed by its owner")
            refcount.READY.notify_all()


def _borrow_dec(oid: str) -> None:
    with refcount.READY:
        b = refcount.BORROWED.get(oid)
        if b is None:
            return
        b.live -= 1
        if b.live > 0:
            return
        del refcount.BORROWED[oid]
    if b.claimed:
        _post(b.owner, "release", oid, os.getpid())


def drop(oid: str, owner: str, token: str) -> None:
    """Drop an unclaimed token (a no-op at the owner if it was claimed)."""
    if owner == _ME:
        refcount.drop_token(oid, token)
    else:
        _post(owner, "drop", oid, token)


def _post(owner: str, kind: str, *args) -> None:
    _OUTBOX.append((owner, kind, args))
    _OUTBOX_EVENT.set()


def _ensure_outbox() -> None:
    global _OUTBOX_THREAD
    if _OUTBOX_THREAD is None:
        with _SERVER_LOCK:
            if _OUTBOX_THREAD is None:
                _OUTBOX_THREAD = threading.Thread(
                    target=_send_outbox, name="raytpu-torch-releases",
                    daemon=True)
                _OUTBOX_THREAD.start()


def _send_outbox() -> None:
    while True:
        _OUTBOX_EVENT.wait()
        _OUTBOX_EVENT.clear()
        while _OUTBOX:
            owner, kind, args = _OUTBOX.popleft()
            peer(owner).send(kind, *args)


# ---- the owner's server --------------------------------------------------


def ensure_serving() -> None:
    """Listen on this process's address (once), before a ref leaves."""
    global _SERVING
    if _SERVING is not None:
        return
    with _SERVER_LOCK:
        if _SERVING is None:
            sock = transport.listen(_ME)
            threading.Thread(target=transport.serve_socket,
                             args=(sock, _serve, "raytpu-torch-objects"),
                             name="raytpu-torch-objects",
                             daemon=True).start()
            _SERVING = sock


def _serve(conn) -> None:
    """One process's requests: get (answered once done), claim and add
    (answered at once), drop and release; at its close, its borrows
    end."""
    lock = threading.Lock()
    pid = None

    def reply(rid: int, ok: bool, payload) -> None:
        with lock:
            try:
                transport.send(conn, (rid, ok, payload))
            except OSError:
                pass  # the asker is gone

    while True:
        try:
            rid, kind, args = transport.recv(conn)
        except (EOFError, OSError):
            break
        if kind == "hello":
            pid = args[0]
        elif kind == "get":
            refcount.when_done(args[0], lambda e, rid=rid, oid=args[0]:
                               _answer_get(reply, rid, oid, e))
        elif kind == "claim":
            reply(rid, refcount.claim(*args), None)
        elif kind == "add":
            reply(rid, refcount.add_token(*args), None)
        elif kind == "drop":
            refcount.drop_token(*args)
        elif kind == "release":
            refcount.release(*args)
    if pid is not None:
        refcount.release_pid(pid)


def _answer_get(reply, rid: int, oid: str, entry) -> None:
    if entry is None:
        reply(rid, False, ObjectLostError(oid, "freed by its owner"))
    elif entry.state == refcount.FAILED:
        reply(rid, False, entry.error)
    else:
        try:
            reply(rid, True, refcount.sealed_of(entry))
        except Exception as exc:  # the value does not pickle: say so
            reply(rid, False, TaskError.from_exception(f"sealing {oid}",
                                                       exc))


# ---- a process's side of an owner ---------------------------------------


class _Peer:
    """This process's connection to one owner: requests with an id, whose
    replies a reader thread hands to their callbacks; the owner's exit
    fails every request, now and later."""

    def __init__(self, address: str):
        self.address = address
        self.lock = threading.Lock()
        self.conn = None
        self.dead: Optional[str] = None
        self.ids = itertools.count(1)
        self.waiting: Dict[int, Callable] = {}

    def _open(self) -> None:
        if self.conn is not None or self.dead is not None:
            return
        try:
            conn = transport.connect(self.address)
            transport.send(conn, (0, "hello", (os.getpid(),)))
        except Exception as exc:  # its owner has exited
            self.dead = f"its owner is gone ({exc!r})"
            return
        self.conn = conn
        threading.Thread(target=self._read, name="raytpu-torch-peer",
                         daemon=True).start()

    def send(self, kind: str, *args, callback=None) -> None:
        with self.lock:
            self._open()
            if self.dead is None:
                rid = 0
                if callback is not None:
                    rid = next(self.ids)
                    self.waiting[rid] = callback
                try:
                    transport.send(self.conn, (rid, kind, args))
                    return
                except OSError:
                    self.waiting.pop(rid, None)  # the reader sees the EOF
        if callback is not None:
            callback(False, None)

    def call(self, kind: str, *args):
        """(ok, payload) of one request, waited for."""
        box = []

        def done(ok, payload):
            with refcount.READY:
                box.append((ok, payload))
                refcount.READY.notify_all()

        self.send(kind, *args, callback=done)
        with refcount.READY:
            while not box:
                refcount.READY.wait(0.05)
        return box[0]

    def _read(self) -> None:
        while True:
            try:
                rid, ok, payload = transport.recv(self.conn)
            except (EOFError, OSError):
                break
            with self.lock:
                callback = self.waiting.pop(rid, None)
            if callback is not None:
                callback(ok, payload)
        with self.lock:
            self.dead = self.dead or "its owner's connection closed"
            waiting, self.waiting = self.waiting, {}
        for callback in waiting.values():
            callback(False, None)


def peer(address: str) -> _Peer:
    with _PEERS_LOCK:
        p = _PEERS.get(address)
        if p is None:
            p = _PEERS[address] = _Peer(address)
    return p


# ---- readiness and values ------------------------------------------------


def is_ready(ref: ObjectRef) -> bool:
    """Whether ``get`` of ``ref`` returns (or raises) at once; asks a
    borrowed ref's owner for it the first time. Under READY."""
    if ref._mine:
        entry = refcount.OWNED.get(ref._id)
        return entry is None or entry.state != refcount.PENDING
    b = refcount.BORROWED.get(ref._id)
    if b is None or b.sealed is not None or b.error is not None:
        return True
    if not b.requested:
        b.requested = True
        oid = ref._id

        def got(ok, payload, b=b, oid=oid):
            with refcount.READY:
                if ok:
                    b.sealed = payload
                else:
                    b.error = payload or OwnerDiedError(
                        oid, f"its owner {b.owner[1:]!r} exited")
                refcount.READY.notify_all()

        peer(b.owner).send("get", oid, callback=got)
    return False


def pending_caller(ref: ObjectRef):
    """The actor caller whose reply ``ref`` waits on, if any (its exit is
    polled while a get waits). Under READY."""
    if ref._mine:
        entry = refcount.OWNED.get(ref._id)
        if entry is not None and entry.state == refcount.PENDING:
            return entry.caller
    return None


def value_of(ref: ObjectRef):
    """The value of a ready ref (mapped once, then cached while a ref to
    it lives here), or its error raised."""
    with refcount.READY:
        if ref._mine:
            holder = refcount.OWNED.get(ref._id)
            if holder is None:
                raise ObjectLostError(ref._id, "freed by its owner")
            if holder.state == refcount.FAILED:
                raise holder.error
        else:
            holder = refcount.BORROWED.get(ref._id)
            if holder is None:
                raise ObjectLostError(ref._id, "no longer borrowed here")
            if holder.error is not None:
                raise holder.error
        if holder.value is not refcount._NOVALUE:
            return holder.value
        sealed = holder.sealed
    value = object_store.unseal(sealed)
    with refcount.READY:
        if holder.value is refcount._NOVALUE:
            holder.value = value
        return holder.value
