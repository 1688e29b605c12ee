"""The runtime's sockets and messages: abstract Unix sockets that only
processes of one tree reach, and one send and one receive that every
connection of the runtime goes through, so that a process can count the
bytes its connections carried (:func:`wire_bytes`).

A process tree shares the ``multiprocessing`` authkey: the runtime's
children inherit it, and a connection proves it both ways before it carries
anything. Messages are pickled with :mod:`raytpu_torch.runtime.serialization`
(functions and classes that cannot be found by name go by value); what
is large (a block, a tensor) never rides in a message but in a sealed
shared-memory segment (:mod:`raytpu_torch.runtime.object_store`), whose
descriptor does.
"""

from __future__ import annotations

import socket
import threading
import uuid
from multiprocessing import connection as mpc
from typing import Callable

import torch.multiprocessing as mp

from raytpu_torch.runtime import serialization

# Connections a listening socket holds before they are accepted.
BACKLOG = 128

_COUNT_LOCK = threading.Lock()
_WIRE = {"sent": 0, "received": 0}


def wire_bytes() -> dict:
    """Bytes this process's runtime connections sent and received, since
    it started."""
    with _COUNT_LOCK:
        return dict(_WIRE)


def send(conn, message) -> None:
    data = serialization.dumps(message)
    conn.send_bytes(data)
    with _COUNT_LOCK:
        _WIRE["sent"] += len(data)


def recv(conn):
    data = conn.recv_bytes()
    with _COUNT_LOCK:
        _WIRE["received"] += len(data)
    return serialization.loads(data)


def new_address(kind: str = "") -> str:
    """An abstract Unix socket address: no file, gone with its socket."""
    return f"\0raytpu_torch-{kind}{uuid.uuid4().hex}"


def listen(address: str) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.bind(address)
    sock.listen(BACKLOG)
    return sock


def accepted(sock: socket.socket) -> mpc.Connection:
    """An accepted socket as a connection, once the peer has proved it
    holds this tree's authkey (and this side has proved it too)."""
    conn = mpc.Connection(sock.detach())
    authkey = mp.current_process().authkey
    try:
        mpc.deliver_challenge(conn, authkey)
        mpc.answer_challenge(conn, authkey)
    except BaseException:
        conn.close()
        raise
    return conn


def connect(address: str) -> mpc.Connection:
    return mpc.Client(address, family="AF_UNIX",
                      authkey=mp.current_process().authkey)


def serve_socket(sock: socket.socket,
                 handle: Callable[[mpc.Connection], None],
                 name: str) -> None:
    """Accept connections on ``sock`` until it closes; each on a daemon
    thread of its own that authenticates it and runs ``handle``."""

    def one(client: socket.socket) -> None:
        try:
            conn = accepted(client)
        except Exception:  # a process of another tree, or one that left
            return
        with conn:
            handle(conn)

    while True:
        try:
            client, _ = sock.accept()
        except OSError:
            return
        client.setblocking(True)
        threading.Thread(target=one, args=(client,), name=f"{name}-conn",
                         daemon=True).start()
