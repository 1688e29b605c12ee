"""The port's tasks, refs and object store (raytpu_torch/runtime) on the
CPU: remote functions against the JAX package's on the same seeded
inputs (``num_returns`` of 1 and 3, and ``"streaming"``), a ref chained
through three tasks whose bytes never cross the driver, borrows that
keep a value alive past its owner's last ref and free it after, ``get``
resolving one level, retries after a worker's death (and none after a
raise), lambdas, closures and local classes by value, unknown options,
cancel, many submitting threads, and no ``cloudpickle`` anywhere. One
task pool for the module; every get carries a timeout.

This module imports nothing of JAX at its top: the task workers import
it by name to find its module-level helpers.
"""

import gc
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from raytpu_torch import runtime
from raytpu_torch.core.errors import (TaskCancelledError, TaskError,
                                      WorkerCrashedError)
from raytpu_torch.runtime import object_store, refcount

T = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pools():
    """The JAX package's local fabric and the port's task pool, four CPUs
    each."""
    import raytpu

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    runtime.shutdown()
    runtime.init(num_cpus=4)
    yield raytpu
    raytpu.shutdown()
    runtime.shutdown()


def segment_of(ref):
    """The name of the segment that holds ``ref``'s value (owned here)."""
    with refcount.READY:
        return refcount.OWNED[ref.hex()].sealed.name


def segment_exists(name) -> bool:
    return name in {n for n, _ in object_store.segments()}


def settle(predicate, timeout: float = T) -> None:
    """Wait (collecting garbage) until ``predicate()`` holds."""
    end = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < end, "never settled"
        gc.collect()
        time.sleep(0.05)


def moments(x, k):
    return x.sum(), (x ** 2).sum(), np.sort(x)[:k]


def stats3(x):
    return float(x.mean()), float(x.std()), float(x.max())


def chunks(x, n):
    for part in np.array_split(x, n):
        yield {"sum": part.sum(), "n": len(part)}


def test_tasks_give_the_jax_package_s_results(pools):
    raytpu = pools
    x = np.random.default_rng(0).standard_normal(4096)
    for fn, opts, args in ((moments, {}, (x, 5)),
                           (stats3, {"num_returns": 3}, (x,))):
        want = raytpu.get(raytpu.remote(**opts)(fn).remote(*args)
                          if opts else raytpu.remote(fn).remote(*args))
        rf = runtime.remote(**opts)(fn) if opts else runtime.remote(fn)
        got = runtime.get(rf.remote(*args), timeout=T)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    want = [raytpu.get(r) for r in raytpu.remote(
        num_returns="streaming")(chunks).remote(x, 7)]
    gen = runtime.remote(num_returns="streaming")(chunks).remote(x, 7)
    got = [runtime.get(r, timeout=T) for r in gen]
    assert [g["n"] for g in got] == [w["n"] for w in want]
    np.testing.assert_array_equal([g["sum"] for g in got],
                                  [w["sum"] for w in want])


def test_a_chained_ref_never_crosses_the_driver(pools):
    make = runtime.remote(lambda n: np.arange(n, dtype=np.float64))
    double = runtime.remote(lambda a: a * 2)
    total = runtime.remote(lambda a: float(a.sum()))
    n = 1 << 21  # 16 MiB of float64 a hop
    runtime.get(total.remote(double.remote(make.remote(8))), timeout=T)
    held = set(object_store.segments(os.getpid()))
    before = object_store.stats()
    out = runtime.get(total.remote(double.remote(make.remote(n))),
                      timeout=T)
    after = object_store.stats()
    assert out == float(n * (n - 1))
    carried = (after["wire_bytes_sent"] - before["wire_bytes_sent"]
               + after["wire_bytes_received"]
               - before["wire_bytes_received"])
    assert carried < 64 * 1024, carried  # descriptors, not the 16 MiB
    assert after["segments_created"] == before["segments_created"]
    # The hops' segments (owned here) are gone with their refs.
    settle(lambda: set(object_store.segments(os.getpid())) <= held)


class Holder:
    """An actor that keeps the refs it is given (nested, so borrowed) and
    makes refs of its own."""

    def __init__(self):
        self.held = []

    def hold(self, refs):
        self.held.extend(refs)
        return len(self.held)

    def total(self):
        return float(sum(runtime.get(r, timeout=T).sum()
                         for r in self.held))

    def drop(self):
        self.held.clear()
        gc.collect()
        return True

    def make(self, n):
        return [runtime.put(np.full(n, 3.0))]

    def ref_of(self, n):
        return runtime.put(np.full(n, 2.0))


def test_a_borrowed_ref_outlives_its_owner_s_last_ref_then_is_freed(pools):
    holder = runtime.remote(Holder).remote()
    try:
        gc.collect()
        base = object_store.stats()["objects"]
        ref = runtime.put(np.ones(100_000))
        oid, segment = ref.hex(), segment_of(ref)
        assert runtime.get(holder.hold.remote([ref]), timeout=T) == 1
        del ref
        gc.collect()
        # The worker's borrow keeps the value here, in its owner.
        assert oid in refcount.OWNED and segment_exists(segment)
        assert runtime.get(holder.total.remote(), timeout=T) == 100_000.0
        assert runtime.get(holder.drop.remote(), timeout=T)
        settle(lambda: oid not in refcount.OWNED)
        assert not segment_exists(segment)
        settle(lambda: object_store.stats()["objects"] <= base)
        # A ref the worker owns, borrowed here: its value lives there.
        [theirs] = runtime.get(holder.make.remote(100_000), timeout=T)
        assert runtime.get(theirs, timeout=T).sum() == 300_000.0
        assert theirs.hex() in refcount.BORROWED
        assert object_store.segments(holder.pid)
        oid = theirs.hex()
        del theirs
        settle(lambda: oid not in refcount.BORROWED)
        settle(lambda: not object_store.segments(holder.pid))
    finally:
        runtime.kill(holder)


def test_get_resolves_one_level(pools):
    holder = runtime.remote(Holder).remote()
    try:
        got = runtime.get(holder.ref_of.remote(10), timeout=T)
        np.testing.assert_array_equal(got, np.full(10, 2.0))
        nested = runtime.put(runtime.put(5))
        assert isinstance(runtime.get(runtime.put([nested]),
                                      timeout=T)[0], runtime.ObjectRef)
        assert runtime.get(nested, timeout=T) == 5  # one level, not two
    finally:
        runtime.kill(holder)


def die_once(marker):
    """Kill this worker on the first try; succeed on the next."""
    if not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(17)
    return os.getpid()


def write_and_exit(log):
    with open(log, "a") as f:
        f.write("x")
    os._exit(3)


def raise_and_count(log):
    with open(log, "a") as f:
        f.write("x")
    raise ValueError("on purpose")


def test_a_killed_worker_s_task_retries_and_a_raise_does_not(pools, tmp_path):
    marker = str(tmp_path / "died")
    pid = runtime.get(runtime.remote(die_once).remote(marker), timeout=T)
    assert os.path.exists(marker) and pid in runtime.api.pool_workers()
    crash = str(tmp_path / "always")
    always = runtime.remote(max_retries=1)(write_and_exit)
    with pytest.raises(WorkerCrashedError, match="exited with code 3"):
        runtime.get(always.remote(crash), timeout=T)
    assert open(crash).read() == "xx"  # the try and one retry
    log = str(tmp_path / "raises")
    with pytest.raises(TaskError, match="on purpose"):
        runtime.get(runtime.remote(raise_and_count).remote(log), timeout=T)
    assert open(log).read() == "x"  # not retried
    log2 = str(tmp_path / "retried")
    with pytest.raises(TaskError, match="on purpose"):
        runtime.get(runtime.remote(raise_and_count).options(
            retry_exceptions=[ValueError], max_retries=2).remote(log2),
            timeout=T)
    assert open(log2).read() == "xxx"
    settle(lambda: len(runtime.api.pool_workers()) == 4)


def test_lambdas_closures_and_local_classes_cross_by_value(pools):
    scale = 3.0

    class Affine:
        def __init__(self, a):
            self.a = a

        def __call__(self, x):
            return self.a * x + scale

        def apply(self, x):
            return self(x)

    def make_counter():
        count = [0]

        def bump(k):
            count[0] += k
            return count[0]
        return bump

    fact = None

    def factorial(n):  # recursive, through its own cell
        return 1 if n <= 1 else n * fact(n - 1)

    fact = factorial
    assert runtime.get(runtime.remote(lambda x: x + scale).remote(1.0),
                       timeout=T) == 4.0
    assert runtime.get(runtime.remote(
        lambda f, x: f(x)).remote(Affine(2.0), 5.0), timeout=T) == 13.0
    assert runtime.get(runtime.remote(make_counter()).remote(4),
                       timeout=T) == 4
    assert runtime.get(runtime.remote(factorial).remote(6),
                       timeout=T) == 720
    local = runtime.remote(Affine).remote(10.0)
    try:
        assert runtime.get(local.apply.remote(1.0), timeout=T) == 13.0
    finally:
        runtime.kill(local)


def test_unknown_options_raise(pools):
    f = runtime.remote(lambda: 1)
    for bad in ({"runtime_env": {"env_vars": {}}}, {"memory": 1},
                {"concurrency_groups": {"io": 1}}):
        with pytest.raises(ValueError, match=next(iter(bad))):
            f.options(**bad)
        with pytest.raises(ValueError, match=next(iter(bad))):
            runtime.remote(**bad)(lambda: 1)
    with pytest.raises(ValueError, match="num_returns"):
        f.options(num_returns=0)
    with pytest.raises(TaskError, match="can never fit"):
        runtime.get(f.options(num_cpus=64).remote(), timeout=T)
    with pytest.raises(TypeError, match="cannot be called directly"):
        f()


def test_cancel_a_queued_task(pools):
    sleep = runtime.remote(lambda s: time.sleep(s) or s)
    busy = [sleep.remote(1.0) for _ in range(4)]  # every worker
    queued = sleep.remote(0.0)
    runtime.cancel(queued)
    with pytest.raises(TaskCancelledError):
        runtime.get(queued, timeout=T)
    assert runtime.get(busy, timeout=T) == [1.0] * 4
    assert runtime.cluster_resources() == {"CPU": 4.0}
    assert runtime.available_resources() == {"CPU": 4.0}


def test_many_threads_submit_and_get(pools):
    square = runtime.remote(lambda k, i: (k, i * i))
    errors = []

    def client(k):
        try:
            got = runtime.get([square.remote(k, i) for i in range(20)],
                              timeout=T)
            if got != [(k, i * i) for i in range(20)]:
                errors.append((k, got))
        except Exception as exc:  # reported below, not lost in the thread
            errors.append((k, repr(exc)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(2 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=T)
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in threads if t.is_alive()]
    assert errors == []


def test_a_ref_pickles_and_resolves_in_another_process(pools):
    ref = runtime.put({"w": np.arange(6)})
    read = runtime.remote(lambda blob: runtime.get(
        pickle.loads(blob), timeout=T)["w"].sum())
    assert runtime.get(read.remote(pickle.dumps(ref)), timeout=T) == 15


_NO_CLOUDPICKLE = """
import sys
from raytpu_torch import runtime

def main():
    runtime.init(num_cpus=2)
    where = runtime.remote(lambda: "cloudpickle" in sys.modules)
    print(json.dumps(["cloudpickle" in sys.modules,
                      runtime.get(where.remote(), timeout=60)]))
    runtime.shutdown()

import json
main()
"""


def test_the_runtime_never_loads_cloudpickle():
    out = subprocess.run([sys.executable, "-c", _NO_CLOUDPICKLE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [False, False]


def test_perf_run_all_gives_the_jax_suite_s_names(pools):
    from raytpu import perf as jax_perf

    from raytpu_torch import perf

    want = [r["name"] for r in jax_perf.run_all(duration_s=0.05)]
    got = perf.run_all(duration_s=0.05)
    assert [r["name"] for r in got] == want
    assert all(r["ops_per_s"] > 0 for r in got)
