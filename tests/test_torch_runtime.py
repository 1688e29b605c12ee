"""The port's worker-process layer (raytpu_torch/runtime) on the CPU:
calls on one handle in order, ``wait`` and ``get`` with their timeouts,
a method that raises (TaskError with the worker's traceback, the worker
still serving), a worker that dies (ActorDiedError, never a hang), a
constructor that raises, tensors through shared memory, no process left
after ``kill``, and no JAX in a worker. Every get and wait has a timeout:
a hang fails the test instead of running the suite into its limit.

The workers import this module by name to rebuild ``Probe``, so it
imports nothing of JAX or of the JAX package."""

import multiprocessing
import os
import signal
import sys
import threading
import time

import pytest
import torch

from raytpu_torch import runtime
from raytpu_torch.core.errors import (ActorDiedError, GetTimeoutError,
                                      TaskError)

# Seconds any get/wait here may block: a worker starts (imports torch) in
# about 2-5 s on this machine; anything past this is a hang.
T = 60.0


class Probe:
    def __init__(self, tag="probe"):
        self.tag = tag
        self.seen = []

    def append(self, x):
        self.seen.append(x)
        return len(self.seen)

    def history(self):
        return list(self.seen)

    def echo(self, x):
        return x

    def sleep(self, s):
        time.sleep(s)
        return s

    def boom(self, what):
        raise ValueError(f"boom: {what}")

    def total(self, tensors):
        return {k: float(v.sum()) for k, v in tensors.items()}

    def shared(self, tensors):
        return {k: v.is_shared() for k, v in tensors.items()}

    def write(self, tensors, key, value):
        tensors[key].fill_(value)
        return True

    def read(self, tensors, key):
        return tensors[key].clone()

    def exit(self, code):
        os._exit(code)


class Broken:
    def __init__(self):
        raise RuntimeError("constructor failed on purpose")

    def ping(self):
        return True


def threads(instance):
    return torch.get_num_threads()


def forbidden_modules(instance):
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "raytpu"))


@pytest.fixture(scope="module")
def pair():
    """Two workers shared by the cases that leave them serving."""
    cls = runtime.remote(Probe)
    a = cls.options(num_cpus=1).remote("a")
    b = cls.options(num_cpus=2).remote("b")
    yield a, b
    runtime.kill(a)
    runtime.kill(b)


def test_calls_on_one_handle_run_in_submission_order(pair):
    a, _ = pair
    start = runtime.get(a.history.remote(), timeout=T)
    refs = [a.append.remote(i) for i in range(40)]
    counts = runtime.get(refs, timeout=T)
    assert counts == list(range(len(start) + 1, len(start) + 41))
    assert runtime.get(a.history.remote(), timeout=T)[len(start):] == \
        list(range(40))


def test_wait_returns_the_first_ref_that_is_ready(pair):
    a, b = pair
    slow, fast = a.sleep.remote(3.0), b.sleep.remote(0.05)
    ready, rest = runtime.wait([slow, fast], num_returns=1, timeout=T)
    assert ready == [fast] and rest == [slow]
    assert runtime.get(fast, timeout=T) == 0.05
    # Ready refs come back in the order given, and wait can time out.
    ready, rest = runtime.wait([slow, fast], num_returns=2, timeout=0.01)
    assert ready == [fast] and rest == [slow]
    assert runtime.get(slow, timeout=T) == 3.0
    with pytest.raises(ValueError):
        runtime.wait([fast], num_returns=2, timeout=T)


def test_get_timeout_raises(pair):
    a, _ = pair
    ref = a.sleep.remote(1.0)
    t0 = time.monotonic()
    with pytest.raises(GetTimeoutError, match="timed out") as info:
        runtime.get(ref, timeout=0.1)
    assert isinstance(info.value, TimeoutError)
    assert time.monotonic() - t0 < 0.9
    assert runtime.get(ref, timeout=T) == 1.0  # the ref is still good


def test_a_method_that_raises_gives_task_error_and_the_worker_serves_on(
        pair):
    a, _ = pair
    with pytest.raises(TaskError) as info:
        runtime.get(a.boom.remote("on purpose"), timeout=T)
    text = str(info.value)
    assert "boom: on purpose" in text and "ValueError" in text
    assert "Traceback" in text and "in boom" in text  # the child's frames
    assert runtime.get(a.echo.remote(7), timeout=T) == 7


def test_num_cpus_sets_the_worker_s_threads_and_other_options_raise(pair):
    a, b = pair
    assert runtime.get([runtime.call(a, threads), runtime.call(b, threads)],
                       timeout=T) == [1, 2]
    with pytest.raises(ValueError, match="runtime_env"):
        runtime.remote(Probe).options(runtime_env={"env_vars": {}})
    with pytest.raises(ValueError, match="num_cpus"):
        runtime.remote(Probe).options(num_cpus=-1)
    # num_cpus=0 (the JAX _SplitCoordinator's) starts with one thread.
    idle = runtime.remote(Probe).options(num_cpus=0).remote("idle")
    try:
        assert runtime.get(runtime.call(idle, threads), timeout=T) == 1
    finally:
        runtime.kill(idle)
    # A function gives a remote function, not a worker.
    from raytpu_torch.runtime.remote_function import RemoteFunction

    assert isinstance(runtime.remote(threads), RemoteFunction)
    with pytest.raises(AttributeError):
        a.no_such_method


def test_a_shared_tensor_arrives_equal_and_maps_the_same_pages(pair):
    a, b = pair
    rng = torch.Generator().manual_seed(0)
    weights = {"w": torch.randn(64, 32, generator=rng),
               "b": torch.randn(32, generator=rng)}
    ref = runtime.put(weights)
    want = {k: float(v.sum()) for k, v in weights.items()}
    assert runtime.get([a.total.remote(ref), b.total.remote(ref)],
                       timeout=T) == [want, want]
    assert runtime.get(a.shared.remote(ref), timeout=T) == {"w": True,
                                                           "b": True}
    got = runtime.get(a.read.remote(ref, "w"), timeout=T)
    assert torch.equal(got, weights["w"])
    # put took a snapshot: the caller's tensors are its own ...
    weights["w"].zero_()
    assert runtime.get(a.total.remote(ref), timeout=T) == want
    # ... and one copy, which a write by one worker shows to the other.
    assert runtime.get(a.write.remote(ref, "b", 3.0), timeout=T)
    assert runtime.get(b.total.remote(ref), timeout=T)["b"] == 3.0 * 32


def test_no_jax_and_nothing_of_raytpu_in_a_worker(pair):
    a, _ = pair
    assert runtime.get(runtime.call(a, forbidden_modules), timeout=T) == []


def test_a_killed_worker_gives_actor_died_error_not_a_hang():
    cls = runtime.remote(Probe)
    victim, killed, exits = cls.remote(), cls.remote(), cls.remote()
    assert runtime.get([h.echo.remote(1) for h in (victim, killed, exits)],
                       timeout=T) == [1, 1, 1]
    pids = {victim.pid, killed.pid, exits.pid}
    in_flight = victim.sleep.remote(60.0)
    queued = victim.echo.remote(2)
    os.kill(victim.pid, signal.SIGKILL)
    t0 = time.monotonic()
    ready, _ = runtime.wait([in_flight], num_returns=1, timeout=T)
    assert ready == [in_flight]  # a call on a dead worker is ready
    for ref in (in_flight, queued, victim.echo.remote(3)):
        with pytest.raises(ActorDiedError, match="exited with code -9"):
            runtime.get(ref, timeout=T)
    assert time.monotonic() - t0 < 10.0
    # A worker that exits of its own accord.
    with pytest.raises(ActorDiedError, match="exited with code 3"):
        runtime.get(exits.exit.remote(3), timeout=T)
    # kill() with a call in flight.
    in_flight = killed.sleep.remote(60.0)
    runtime.kill(killed)
    with pytest.raises(ActorDiedError, match="kill"):
        runtime.get(in_flight, timeout=T)
    runtime.kill(victim)
    runtime.kill(exits)
    assert not pids & {p.pid for p in multiprocessing.active_children()}
    for pid in pids:
        with pytest.raises(ProcessLookupError):  # reaped, not a zombie
            os.kill(pid, 0)


def test_a_constructor_that_raises_gives_actor_died_error():
    broken = runtime.remote(Broken).remote()
    with pytest.raises(ActorDiedError, match="constructor failed on purpose"):
        runtime.get(broken.ping.remote(), timeout=T)
    assert broken.pid not in {p.pid for p in
                              multiprocessing.active_children()}


def test_no_worker_outlives_kill():
    cls = runtime.remote(Probe)
    handles = [cls.remote(str(i)) for i in range(2)]
    assert runtime.get([h.echo.remote(i) for i, h in enumerate(handles)],
                       timeout=T) == [0, 1]
    pids = {h.pid for h in handles}
    assert pids <= {p.pid for p in multiprocessing.active_children()}
    for h in handles:
        runtime.kill(h)
        runtime.kill(h)  # a second kill is harmless
    assert not pids & {p.pid for p in multiprocessing.active_children()}


def test_many_threads_share_two_workers(pair):
    """More submitting threads than cores, with a short switch interval:
    every thread gets its own replies, in its own order."""
    a, b = pair
    errors, done = [], []

    def client(k):
        try:
            h = (a, b)[k % 2]
            refs = [h.echo.remote((k, i)) for i in range(25)]
            got = runtime.get(refs, timeout=T)
            if got != [(k, i) for i in range(25)]:
                errors.append((k, got))
            done.append(k)
        except Exception as exc:  # reported below, not lost in the thread
            errors.append((k, repr(exc)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(2 * (os.cpu_count() or 1))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=T)
    finally:
        sys.setswitchinterval(interval)
    assert not any(c.is_alive() for c in clients)
    assert errors == [] and sorted(done) == list(range(len(clients)))
