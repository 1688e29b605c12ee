"""Handles that cross processes and named actors in the port's runtime
(raytpu_torch/runtime), on the CPU. First the JAX package's own cases,
run through both packages (the JAX side under ``raytpu.init`` in local
mode, as tests/test_api.py runs them): a named actor
(tests/test_api.py:292) and a handle passed into another worker that
calls it (:311, an actor in place of the task), with the JAX package's
errors for an unknown and a taken name. Then the port's own behaviour
over a handle that is not the owner's: a stream and its close, CPU
tensors between two sibling workers, ``runtime.call``, ``ActorDiedError``
within 10 s of a kill, ``kill`` from a holder that is not the owner, a
dropped copy that ends nothing, ``get_actor`` in a worker and in a
worker's worker, a detached actor that outlives its creator, and no
process left behind (tests/test_torch_runtime_lifetimes.py: nor after
the driver).

Workers import this module by name to rebuild its classes, so it imports
nothing of JAX or of the JAX package at its top level. Every get has a
timeout; overlap is held by events in the workers, never by timings."""

import gc
import multiprocessing
import os
import threading
import time

import pytest
import torch

from raytpu_torch import runtime
from raytpu_torch.core.errors import ActorDiedError, TaskError

T = 60.0  # any get here; a worker starts in a few seconds


class Counter:
    def __init__(self):
        self.v = 0
        self.closed = []
        self.sleeping = threading.Event()

    def inc(self):
        self.v += 1
        return self.v

    def count(self, n):
        yield from range(n)

    def forever(self, tag):
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            self.closed.append(tag)

    def closed_streams(self):
        return list(self.closed)

    def double(self, t):
        return t * 2, t.is_shared()

    def sleep(self, s):
        self.sleeping.set()
        time.sleep(s)
        return s

    def is_sleeping(self):
        return self.sleeping.is_set()

    def pid(self):
        return os.getpid()


class Registry:
    """tests/test_api.py:292's actor."""

    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v

    def get(self, k):
        return self.d.get(k)


def read_v(instance):
    """Run inside a Counter's worker (``runtime.call``)."""
    return instance.v


class Relay:
    """A worker that calls the handles it is given."""

    def __init__(self):
        self.held = None
        self.child = None

    def bump(self, counter):
        return runtime.get(counter.inc.remote(), timeout=T)

    def stream(self, counter, n):
        return [runtime.get(r, timeout=T) for r in
                counter.count.options(num_returns="streaming").remote(n)]

    def take_and_close(self, counter, k):
        gen = counter.forever.options(num_returns="streaming").remote(
            "relay")
        got = [runtime.get(next(gen), timeout=T) for _ in range(k)]
        gen.close()
        return got

    def double(self, counter, t):
        out, shared = runtime.get(counter.double.remote(t), timeout=T)
        return out, shared, t.is_shared()

    def made_here(self, counter):
        t = torch.arange(6, dtype=torch.float32)
        out, shared = runtime.get(counter.double.remote(t), timeout=T)
        return out, shared

    def via_call(self, counter):
        return runtime.get(runtime.call(counter, read_v), timeout=T)

    def wait_on(self, counter):
        """A long call on ``counter``: its error, and when it came."""
        try:
            runtime.get(counter.sleep.remote(3600.0), timeout=T)
        except Exception as exc:
            return type(exc).__name__, str(exc), time.time()
        return None, "", time.time()

    def kill(self, counter):
        runtime.kill(counter)
        return True

    def hold(self, counter):
        self.held = counter
        return runtime.get(counter.inc.remote(), timeout=T)

    def drop(self):
        self.held = None
        gc.collect()
        return True

    def lookup(self, name, namespace="default"):
        h = runtime.get_actor(name, namespace)
        return runtime.get(h.inc.remote(), timeout=T)

    def lookup_error(self, name):
        try:
            runtime.get_actor(name)
        except ValueError as exc:
            return str(exc)
        return None

    def start_named(self, name, lifetime=None):
        opts = {"name": name}
        if lifetime:
            opts["lifetime"] = lifetime
        self.held = runtime.remote(Counter).options(**opts).remote()
        return self.held.pid

    def start_taken(self, name):
        try:
            runtime.remote(Counter).options(name=name).remote()
        except ValueError as exc:
            return str(exc)
        return None

    def start_child(self):
        self.child = runtime.remote(Relay).remote()
        return self.child.pid

    def child_lookup(self, name):
        return runtime.get(self.child.lookup.remote(name), timeout=T)

    def child_pid(self):
        return self.child.pid


def alive(pid: int) -> bool:
    """Whether a process runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def wait_gone(pids, deadline_s: float = T) -> list:
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        left = [p for p in pids if alive(p)]
        if not left:
            return []
        time.sleep(0.05)
    return [p for p in pids if alive(p)]


@pytest.fixture(scope="module")
def relays():
    """Two relays and a counter the tests share; no process is left."""
    before = {p.pid for p in multiprocessing.active_children()}
    counter = runtime.remote(Counter).options(max_concurrency=4).remote()
    a, b = (runtime.remote(Relay).remote() for _ in range(2))
    yield counter, a, b
    for h in (counter, a, b):
        runtime.kill(h)
    assert [p.pid for p in multiprocessing.active_children()
            if p.pid not in before] == []


# ---- the JAX package's cases, through both ---------------------------


def test_a_named_actor_as_in_the_jax_package(raytpu_local):
    raytpu = raytpu_local
    got = {}
    for tag, rt in (("jax", raytpu), ("port", runtime)):
        cls = rt.remote(Registry)
        h0 = cls.options(name="reg", lifetime="detached").remote()
        h = rt.get_actor("reg")
        rt.get(h.set.remote("k", 42), timeout=T)
        with pytest.raises(ValueError) as unknown:
            rt.get_actor("no-such-actor")
        with pytest.raises(ValueError) as taken:
            cls.options(name="reg").remote()
        errors = [str(unknown.value), str(taken.value)]
        got[tag] = (rt.get(h.get.remote("k"), timeout=T), errors)
        rt.kill(h0)
    assert got["jax"] == got["port"]
    assert got["port"][0] == 42
    with pytest.raises(ValueError, match="no actor named 'reg'"):
        runtime.get_actor("reg")  # a killed actor's name is free


def test_a_handle_passed_into_another_worker_calls_it(raytpu_local, relays):
    raytpu = raytpu_local
    _, relay, _ = relays

    class JaxBumper:  # the task of tests/test_api.py:311, as an actor
        def bump(self, counter):
            import raytpu as r

            return r.get(counter.inc.remote())

    jax_counter = raytpu.remote(Counter).remote()
    jax_bumper = raytpu.remote(JaxBumper).remote()
    raytpu.get(jax_bumper.bump.remote(jax_counter))
    jax = raytpu.get(jax_bumper.bump.remote(jax_counter))
    counter = runtime.remote(Counter).remote()
    runtime.get(relay.bump.remote(counter), timeout=T)
    port = runtime.get(relay.bump.remote(counter), timeout=T)
    assert jax == port == 2
    # The owner sees the passed handle's calls; a copy made here is the
    # owner's own handle.
    assert runtime.get(counter.inc.remote(), timeout=T) == 3
    import pickle

    assert pickle.loads(pickle.dumps(counter)) is counter
    runtime.kill(counter)


# ---- the port's own behaviour over a passed handle -------------------


def test_a_stream_a_tensor_and_call_over_a_passed_handle(relays):
    counter, relay, _ = relays
    assert runtime.get(relay.stream.remote(counter, 5), timeout=T) == \
        [0, 1, 2, 3, 4]
    # close() from the holder closes the generator in the worker.
    assert runtime.get(relay.take_and_close.remote(counter, 3),
                       timeout=T) == [0, 1, 2]
    end = time.monotonic() + T
    while "relay" not in runtime.get(counter.closed_streams.remote(),
                                     timeout=T):
        assert time.monotonic() < end, "the stream's generator never closed"
        time.sleep(0.05)
    # A CPU tensor from the driver, passed on by one worker to its
    # sibling, and one made in a worker: shared memory both ways.
    t = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    out, shared_there, shared_relay = runtime.get(
        relay.double.remote(counter, t), timeout=T)
    assert torch.equal(out, t * 2) and shared_there and shared_relay
    out, shared_there = runtime.get(relay.made_here.remote(counter),
                                    timeout=T)
    assert torch.equal(out, torch.arange(6, dtype=torch.float32) * 2)
    assert shared_there
    v = runtime.get(counter.inc.remote(), timeout=T)
    assert runtime.get(relay.via_call.remote(counter), timeout=T) == v


def test_a_caller_that_is_not_the_owner_sees_actor_died_error(relays):
    _, relay, other = relays
    victim = runtime.remote(Counter).options(max_concurrency=2).remote()
    ref = relay.wait_on.remote(victim)
    end = time.monotonic() + T
    while not runtime.get(victim.is_sleeping.remote(), timeout=T):
        assert time.monotonic() < end, "the relay's call never arrived"
        time.sleep(0.05)
    t_kill = time.time()
    runtime.kill(victim)
    kind, text, when = runtime.get(ref, timeout=T)
    assert kind == "ActorDiedError" and "connection closed" in text
    assert when - t_kill < 10.0
    # A later call from the holder raises too, and so does a new one.
    with pytest.raises(TaskError, match="ActorDiedError"):
        runtime.get(relay.bump.remote(victim), timeout=T)
    with pytest.raises(TaskError, match="ActorDiedError"):
        runtime.get(other.bump.remote(victim), timeout=T)
    # kill() from a holder that is not the owner: the owner sees it.
    second = runtime.remote(Counter).remote()
    assert runtime.get(second.inc.remote(), timeout=T) == 1
    assert runtime.get(relay.kill.remote(second), timeout=T)
    with pytest.raises(ActorDiedError):
        runtime.get(second.inc.remote(), timeout=T)
    assert wait_gone([second.pid, victim.pid]) == []


def test_dropping_a_passed_copy_leaves_the_worker_alive(relays):
    _, relay, _ = relays
    counter = runtime.remote(Counter).remote()
    assert runtime.get(relay.hold.remote(counter), timeout=T) == 1
    assert runtime.get(relay.drop.remote(), timeout=T)
    assert runtime.get(counter.inc.remote(), timeout=T) == 2
    # Even the holder's whole process ending ends nothing.
    holder = runtime.remote(Relay).remote()
    assert runtime.get(holder.hold.remote(counter), timeout=T) == 3
    runtime.kill(holder)
    assert runtime.get(counter.inc.remote(), timeout=T) == 4
    runtime.kill(counter)


def test_get_actor_in_the_driver_a_worker_and_a_worker_s_worker(relays):
    _, relay, other = relays
    named = runtime.remote(Counter).options(name="shared",
                                            namespace="ns").remote()
    assert runtime.get_actor("shared", "ns") is named
    assert runtime.get(relay.lookup.remote("shared", "ns"),
                       timeout=T) == 1
    grandchild = runtime.get(relay.start_child.remote(), timeout=T)
    assert alive(grandchild)
    # A name registered in a worker, seen by the driver, by a sibling and
    # by the registering worker's own child.
    runtime.get(relay.start_named.remote("from-worker"), timeout=T)
    assert runtime.get(runtime.get_actor("from-worker").inc.remote(),
                       timeout=T) == 1
    assert runtime.get(other.lookup.remote("from-worker"), timeout=T) == 2
    assert runtime.get(relay.child_lookup.remote("from-worker"),
                       timeout=T) == 3
    # The JAX package's errors, raised in a worker.
    assert runtime.get(other.lookup_error.remote("nobody"), timeout=T) == \
        "no actor named 'nobody' in 'default'"
    assert runtime.get(other.start_taken.remote("from-worker"),
                       timeout=T) == "actor name 'from-worker' already taken"
    runtime.kill(named)
    with pytest.raises(ValueError, match="no actor named 'shared' in 'ns'"):
        runtime.get_actor("shared", "ns")


def test_a_detached_actor_outlives_its_creator_and_none_outlives_kill():
    creator = runtime.remote(Relay).remote()
    pid = runtime.get(creator.start_named.remote("kept", "detached"),
                      timeout=T)
    child = runtime.get(creator.start_child.remote(), timeout=T)
    runtime.kill(creator)
    # The creator's child reads its pipe's EOF and exits; the detached
    # actor, which the driver started, lives on.
    assert wait_gone([child]) == []
    kept = runtime.get_actor("kept")
    assert kept.pid == pid and alive(pid)
    assert runtime.get(kept.inc.remote(), timeout=T) == 1
    runtime.kill(kept)
    assert wait_gone([pid]) == []
    with pytest.raises(ValueError, match="no actor named 'kept'"):
        runtime.get_actor("kept")
    with pytest.raises(ValueError, match="lifetime"):
        runtime.remote(Counter).options(lifetime="forever")

