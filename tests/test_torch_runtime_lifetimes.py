"""No process of the port's runtime outlives its driver
(raytpu_torch/runtime), on the CPU: a driver that started a worker, a
detached actor, a worker's worker and a detached actor asked for by a
worker (which the driver starts) exits, or is killed with SIGKILL, and
every one of those processes ends. The driver is a fresh interpreter
that imports the classes of tests/test_torch_runtime_handles.py."""

import os
import select
import signal
import subprocess
import sys

import pytest

from test_torch_runtime_handles import T, alive, wait_gone

# A driver that starts a worker, a detached actor, and (through the
# worker) a worker's worker and a detached actor the driver starts for
# it; it prints their pids, then exits once its input has a line (or is
# killed first).
DRIVER = """
import sys
sys.path.insert(0, {tests!r})
from raytpu_torch import runtime
from test_torch_runtime_handles import Counter, Relay, T
relay = runtime.remote(Relay).remote()
kept = runtime.remote(Counter).options(name="kept",
                                       lifetime="detached").remote()
child = runtime.get(relay.start_child.remote(), timeout=T)
named = runtime.get(relay.start_named.remote("x", "detached"), timeout=T)
print(relay.pid, kept.pid, child, named, flush=True)
sys.stdin.readline()
"""


@pytest.mark.parametrize("end", ["exit", "sigkill"])
def test_no_process_outlives_the_driver(end):
    code = DRIVER.format(tests=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 2 * T)
        assert ready, "the driver printed nothing"
        pids = [int(p) for p in proc.stdout.readline().split()]
        assert len(pids) == 4 and all(alive(p) for p in pids)
        if end == "sigkill":
            os.kill(proc.pid, signal.SIGKILL)
        else:
            proc.stdin.write("\n")
            proc.stdin.flush()
        assert proc.wait(timeout=T) == (-9 if end == "sigkill" else 0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=T)
    assert wait_gone(pids) == []
