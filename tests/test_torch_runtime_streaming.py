"""The port's runtime (raytpu_torch/runtime) on the CPU: concurrent calls
on one actor (``max_concurrency``), async methods and async generators,
and streamed returns (``num_returns="streaming"``): values arrive while
the generator still runs, ``close()`` runs the worker generator's
``finally``, a generator's error ends its stream, and a worker killed
mid-stream ends the iteration with ActorDiedError. Overlap is shown by
events, never by timings; every get, wait and poll has a deadline.

The workers import this module by name to rebuild ``Streamer``, so it
imports nothing of JAX or of the JAX package."""

import asyncio
import multiprocessing
import os
import signal
import threading
import time

import pytest

from raytpu_torch import runtime
from raytpu_torch.core.errors import (ActorDiedError, GetTimeoutError,
                                      TaskError)
from raytpu_torch.runtime import ObjectRefGenerator

T = 60.0  # seconds any get/wait here may block before it counts as a hang


class Streamer:
    def __init__(self):
        self.events = {}
        self.lock = threading.Lock()
        self.log = []
        self.running = 0
        self.most_running = 0
        self.closed = []

    def _event(self, name):
        with self.lock:
            return self.events.setdefault(name, threading.Event())

    def release(self, name):
        self._event(name).set()
        return name

    def rendezvous(self, barrier_name, parties):
        """Returns once ``parties`` calls are inside it at once: only
        calls that overlap can pass."""
        with self.lock:
            b = self.events.setdefault(barrier_name,
                                       threading.Barrier(parties))
        return b.wait(timeout=T)

    def step(self, i):
        with self.lock:
            self.running += 1
            self.most_running = max(self.most_running, self.running)
        time.sleep(0.002)
        with self.lock:
            self.log.append(i)
            self.running -= 1
        return i

    def history(self):
        return {"log": list(self.log), "most_running": self.most_running}

    async def add(self, a, b):
        await asyncio.sleep(0)
        return a + b

    def count(self, n, gate=None, tag="sync"):
        """Yields 0..n-1; after the first value waits for ``gate``."""
        try:
            for i in range(n):
                yield i
                if i == 0 and gate is not None:
                    if not self._event(gate).wait(timeout=T):
                        raise TimeoutError(f"gate {gate} never opened")
        finally:
            self.closed.append(tag)

    async def acount(self, n, gate=None, tag="async"):
        try:
            for i in range(n):
                yield i
                if i == 0 and gate is not None:
                    ev = self._event(gate)
                    while not ev.is_set():
                        await asyncio.sleep(0.005)
        finally:
            self.closed.append(tag)

    def fails_after(self, n):
        for i in range(n):
            yield i
        raise ValueError(f"stream failed after {n}")

    def closed_streams(self):
        return list(self.closed)

    def not_a_generator(self):
        return 1


@pytest.fixture(scope="module")
def workers():
    """One worker that runs four calls at once, one at the default."""
    wide = runtime.remote(Streamer).options(max_concurrency=4).remote()
    narrow = runtime.remote(Streamer).remote()
    yield wide, narrow
    runtime.kill(wide)
    runtime.kill(narrow)


def poll(fn, what):
    end = time.monotonic() + T
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def values(gen):
    return [runtime.get(ref, timeout=T) for ref in gen]


def test_max_concurrency_lets_calls_overlap(workers):
    wide, _ = workers
    # Four calls that can only return once all four are inside at once.
    refs = [wide.rendezvous.remote("four", 4) for _ in range(4)]
    assert sorted(runtime.get(refs, timeout=T)) == [0, 1, 2, 3]
    # A call that waits for another's event finishes once that one runs.
    gen = wide.count.options(num_returns="streaming").remote(
        3, gate="overlap")
    assert runtime.get(next(gen), timeout=T) == 0
    assert runtime.get(wide.release.remote("overlap"), timeout=T)
    assert values(gen) == [1, 2]


def test_the_default_runs_one_call_at_a_time_in_order(workers):
    _, narrow = workers
    refs = [narrow.step.remote(i) for i in range(30)]
    assert runtime.get(refs, timeout=T) == list(range(30))
    h = runtime.get(narrow.history.remote(), timeout=T)
    assert h["log"][-30:] == list(range(30))
    assert h["most_running"] == 1
    with pytest.raises(ValueError, match="max_concurrency"):
        runtime.remote(Streamer).options(max_concurrency=0)
    with pytest.raises(ValueError, match="num_returns"):
        narrow.count.options(num_returns=2)
    with pytest.raises(ValueError, match="backpressure"):
        narrow.count.options(generator_backpressure_num_objects=4)


def test_async_methods_and_async_generators(workers):
    for h in workers:
        assert runtime.get(h.add.remote(2, 3), timeout=T) == 5
        gen = h.acount.options(num_returns="streaming").remote(5)
        assert isinstance(gen, ObjectRefGenerator)
        assert values(gen) == list(range(5))
        assert gen.completed()
        with pytest.raises(StopIteration):
            next(gen)


@pytest.mark.parametrize("method", ["count", "acount"])
def test_values_arrive_before_the_generator_ends(workers, method):
    wide, _ = workers
    gen = getattr(wide, method).options(num_returns="streaming").remote(
        4, gate=f"arrive-{method}")
    # The first value is in hand while the generator waits for its gate.
    assert runtime.get(next(gen), timeout=T) == 0
    with pytest.raises(GetTimeoutError):
        gen.next_ready(timeout=0.05)
    runtime.get(wide.release.remote(f"arrive-{method}"), timeout=T)
    assert values(gen) == [1, 2, 3]


@pytest.mark.parametrize("method", ["count", "acount"])
def test_close_runs_the_worker_generator_s_finally(workers, method):
    wide, _ = workers
    tag = f"closed-{method}"
    gen = getattr(wide, method).options(num_returns="streaming").remote(
        1000, gate=f"never-{method}", tag=tag)
    assert runtime.get(next(gen), timeout=T) == 0
    gen.close()
    gen.close()  # a second close is harmless
    with pytest.raises(StopIteration):
        next(gen)
    if method == "count":
        # A sync generator waits inside next() for its gate: it is closed
        # when that next() returns.
        runtime.get(wide.release.remote(f"never-{method}"), timeout=T)
    poll(lambda: tag in runtime.get(wide.closed_streams.remote(),
                                    timeout=T), f"{tag}'s finally")
    assert runtime.get(wide.add.remote(1, 1), timeout=T) == 2


def test_a_generator_s_error_ends_its_stream(workers):
    _, narrow = workers
    gen = narrow.fails_after.options(num_returns="streaming").remote(2)
    assert [runtime.get(next(gen), timeout=T) for _ in range(2)] == [0, 1]
    with pytest.raises(TaskError, match="stream failed after 2"):
        next(gen)
    with pytest.raises(StopIteration):
        next(gen)
    gen = narrow.not_a_generator.options(num_returns="streaming").remote()
    with pytest.raises(TaskError, match="TypeError"):
        next(gen)
    assert runtime.get(narrow.add.remote(1, 2), timeout=T) == 3


def test_a_worker_killed_mid_stream_ends_it_with_actor_died_error():
    victim = runtime.remote(Streamer).options(max_concurrency=2).remote()
    gen = victim.count.options(num_returns="streaming").remote(
        10, gate="never")
    assert runtime.get(next(gen), timeout=T) == 0
    pid = victim.pid
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(ActorDiedError, match="exited with code -9"):
        gen.next_ready(timeout=T)
    with pytest.raises(StopIteration):
        next(gen)
    runtime.kill(victim)
    assert pid not in {p.pid for p in multiprocessing.active_children()}
