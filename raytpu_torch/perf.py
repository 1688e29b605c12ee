"""Core-ops microbenchmark suite of the port's runtime, the port of
:mod:`raytpu.perf`: the same benchmark names, through
:mod:`raytpu_torch.runtime` (tasks on the task pool, an actor process,
``put``/``get`` through the object store).

Reference analogue: ``python/ray/_private/ray_perf.py:120-241`` — the
timeit-style ops/s suite: task submission+get, actor calls (sync and
batched), put/get throughput. Run with ``python -m raytpu_torch.perf``
or call :func:`run_all` for a list of dicts. It times host work only
(no card): every number is the host's.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List

import numpy as np


def timeit(name: str, fn: Callable[[], None], multiplier: int = 1,
           warmup: int = 2, duration_s: float = 1.0) -> Dict[str, float]:
    for _ in range(warmup):
        fn()
    start = time.perf_counter()
    count = 0
    while time.perf_counter() - start < duration_s:
        fn()
        count += 1
    elapsed = time.perf_counter() - start
    ops = count * multiplier / elapsed
    return {"name": name, "ops_per_s": round(ops, 1)}


def run_all(duration_s: float = 1.0) -> List[Dict[str, float]]:
    from raytpu_torch import runtime

    results: List[Dict[str, float]] = []
    runtime.shutdown()
    runtime.init(num_cpus=4)

    @runtime.remote
    def tiny():
        return b"ok"

    @runtime.remote
    class Ping:
        def ping(self):
            return b"ok"

        def batch(self, n):
            return n

    # 1. single task submit+get roundtrip
    results.append(timeit(
        "single client task sync",
        lambda: runtime.get(tiny.remote()), duration_s=duration_s))

    # 2. batched task throughput
    def batch_tasks():
        runtime.get([tiny.remote() for _ in range(100)])

    results.append(timeit("client tasks batch=100", batch_tasks,
                          multiplier=100, duration_s=duration_s))

    # 3. actor call roundtrip
    actor = Ping.remote()
    runtime.get(actor.ping.remote())
    results.append(timeit(
        "single client actor call sync",
        lambda: runtime.get(actor.ping.remote()), duration_s=duration_s))

    # 4. batched actor calls
    def batch_actor():
        runtime.get([actor.ping.remote() for _ in range(100)])

    results.append(timeit("client actor calls batch=100", batch_actor,
                          multiplier=100, duration_s=duration_s))

    # 5. put/get small
    results.append(timeit(
        "put small (1KiB)",
        lambda: runtime.put(b"x" * 1024), duration_s=duration_s))

    # 6. put/get large numpy (zero-copy path)
    big = np.zeros((1024, 1024), dtype=np.float32)  # 4 MiB

    def put_get_big():
        runtime.get(runtime.put(big))

    results.append(timeit("put+get 4MiB ndarray", put_get_big,
                          duration_s=duration_s))

    runtime.kill(actor)
    runtime.shutdown()
    return results


def main() -> None:
    for r in run_all():
        print(json.dumps(r))


if __name__ == "__main__":
    main()
