"""The port's command line (raytpu_torch/scripts/cli.py, ``python -m
raytpu_torch``) held to the JAX package's (raytpu/scripts/cli.py) on the
CPU.

One scenario (a named actor, a task, a ``put``, two serve requests'
events, a structured event) runs in the port's runtime and in the JAX
package's local mode, and each package's CLI reads it in process (the
port's with ``--address`` of this driver, which is its own tree): the
``state``, ``serve``, ``memory``, ``events``, ``timeline`` and ``trace``
outputs are shaped as the JAX CLI's (the same lines where the data is
the same, the same columns and JSON keys where it differs), ``metrics
export-config`` writes files byte-identical to the JAX package's, and
``stack``, ``profile`` and ``memprofile`` print the JAX CLI's lines for
each process of the tree. From a fresh interpreter, ``python -m
raytpu_torch`` reads this driver through its address, and exits 1
naming an address that no driver answers.
"""

import json
import os
import re
import subprocess
import sys

import pytest

import raytpu
from raytpu.scripts import cli as jax_cli
from raytpu.util import events as jax_events
from raytpu.util import task_events as jax_task_events

from raytpu_torch import runtime
from raytpu_torch.runtime import api, records
from raytpu_torch.scripts import cli
from raytpu_torch.util import events, task_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60.0
REQUESTS = {"cli-r1": ("RECEIVED", "ROUTED", "FINISHED"),
            "cli-r2": ("RECEIVED", "FAILED")}


def cli_cube(x):
    return x ** 3


class CliCounter:
    def bump(self):
        return os.getpid()


def scenario(rt, remote, recorder, structured):
    counter = remote(CliCounter).options(name="cli-counter").remote()
    rt.get(counter.bump.remote(), timeout=T)
    assert rt.get(remote(cli_cube).remote(2), timeout=T) == 8
    ref = rt.put(b"x" * 1000)
    for rid, transitions in REQUESTS.items():
        for t in transitions:
            recorder.emit_request(rid, t, deployment="cli#Dep",
                                  tenant="acme",
                                  error="boom" if t == "FAILED" else None)
    structured.record_event("WARNING", "cli-test", "hello from the test")
    return counter, ref


@pytest.fixture(scope="module")
def trees():
    """The scenario in both packages; this driver's address."""
    env = (task_events.ENV_VAR, task_events.REQUEST_ENV_VAR)
    saved = {k: os.environ.get(k) for k in env}
    task_events.enable_task_events(env=True)
    task_events.enable_request_events(env=True)
    jax_flags = (jax_task_events.enabled(),
                 jax_task_events.request_events_enabled())
    jax_task_events.enable_task_events()
    jax_task_events.enable_request_events()
    task_events.clear()
    jax_task_events.clear()
    events.reset()
    jax_events.reset()
    records.reset()
    runtime.shutdown()
    runtime.init(num_cpus=1)
    raytpu.init(num_cpus=2, ignore_reinit_error=True)
    keep = [scenario(runtime, runtime.remote, task_events, events),
            scenario(raytpu, raytpu.remote, jax_task_events, jax_events)]
    try:
        yield api.driver_address(), keep[0][0]
    finally:
        del keep
        runtime.shutdown()
        raytpu.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
        if saved[task_events.ENV_VAR] is None:
            task_events.disable_task_events()
        if saved[task_events.REQUEST_ENV_VAR] is None:
            task_events.disable_request_events()
        if not jax_flags[0]:
            jax_task_events.disable_task_events()
        if not jax_flags[1]:
            jax_task_events.disable_request_events()
        for recorder in (task_events, jax_task_events):
            recorder.clear()
        events.reset()
        jax_events.reset()
        records.reset()


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def both(trees, capsys, *argv):
    """(port's, JAX's) (rc, stdout, stderr) of one command."""
    address, _ = trees
    return (run(cli.main, [*argv, "--address", address], capsys),
            run(jax_cli.main, list(argv), capsys))


def test_serve_listing_is_the_jax_cli_s(trees, capsys):
    got, want = both(trees, capsys, "serve")
    assert got == want
    assert [line.split()[:2] for line in got[1].splitlines()] == \
        [["cli-r2", "FAILED"], ["cli-r1", "FINISHED"]]
    got, want = both(trees, capsys, "serve", "--json", "--state", "FINISHED")
    rows = [json.loads(got[1]), json.loads(want[1])]
    assert [sorted(r[0]) for r in rows] == [sorted(rows[1][0])] * 2
    assert rows[0][0]["id"] == rows[1][0]["id"] == "cli-r1"


def test_serve_detail_is_the_jax_cli_s(trees, capsys):
    def plain(text):  # the waterfall's offsets are each run's own
        return re.sub(r"\+ *\d+\.\d{4}s", "+T", text)

    got, want = both(trees, capsys, "serve", "--detail", "cli-r2")
    assert got[0] == want[0] == 0 and plain(got[1]) == plain(want[1])
    assert got[1].splitlines()[0] == ("request cli-r2  deployment=cli#Dep  "
                                      "tenant=acme  state=FAILED")
    got, want = both(trees, capsys, "serve", "--detail", "nope")
    assert got == want and got[0] == 1


def test_state_list_and_summary_are_the_jax_cli_s(trees, capsys):
    got, want = both(trees, capsys, "state", "list", "actors")
    for rc, out, _ in (got, want):
        assert rc == 0
        lines = out.splitlines()
        assert all(re.fullmatch(r"[0-9a-f]{1,16} {0,15} \S+ +.*", line)
                   and line[39] == " " for line in lines), lines
        assert any(line[17:].split() == ["ALIVE", "cli-counter"]
                   for line in lines)
    got, want = both(trees, capsys, "state", "list", "tasks", "--detail")
    rows = [json.loads(got[1]), json.loads(want[1])]
    assert {r["name"] for r in rows[0]} >= {"cli_cube", "CliCounter.bump"}
    common = {"task_id", "name", "state", "node_id", "attempt", "events",
              "num_events", "first_ts", "last_ts"}
    assert all(common <= set(r) for rows_ in rows for r in rows_)
    got, want = both(trees, capsys, "state", "summary", "tasks")
    assert sorted(json.loads(got[1])) == sorted(json.loads(want[1]))


def test_state_timeline_is_the_jax_cli_s(trees, capsys):
    address, _ = trees
    [task] = json.loads(run(cli.main, ["state", "list", "tasks", "--name",
                                       "cli_cube", "--detail", "--address",
                                       address], capsys)[1])
    rc, out, _ = run(cli.main, ["state", "timeline", task["task_id"][:10],
                                "--address", address], capsys)
    rec = json.loads(out)
    assert rc == 0 and rec["id"] == task["task_id"]
    [jtask] = json.loads(run(jax_cli.main, ["state", "list", "tasks",
                                            "--name", "cli_cube",
                                            "--detail"], capsys)[1])
    jrec = json.loads(run(jax_cli.main, ["state", "timeline",
                                         jtask["task_id"]], capsys)[1])
    assert sorted(rec) == sorted(jrec)
    got, want = both(trees, capsys, "state", "timeline", "nope")
    assert got == want and got[0] == 1


def test_memory_events_timeline_and_trace_are_the_jax_cli_s(
        trees, capsys, tmp_path):
    got, want = both(trees, capsys, "memory")
    for rc, out, _ in (got, want):
        assert rc == 0 and re.fullmatch(r"objects: \d+  bytes: \d+\n", out)
    got, want = both(trees, capsys, "events")
    assert got[0] == want[0] == 0
    assert re.sub(r"^\d\d:\d\d:\d\d ", "", got[1]) == \
        re.sub(r"^\d\d:\d\d:\d\d ", "", want[1]) == \
        "WARNING cli-test           hello from the test\n"
    for command in ("timeline", "trace"):
        out = []
        for main, extra in ((cli.main, ["--address", trees[0]]),
                            (jax_cli.main, [])):
            path = tmp_path / f"{command}-{len(out)}.json"
            rc, text, _ = run(main, [command, "--output", str(path),
                                     *extra], capsys)
            assert rc == 0 and isinstance(json.loads(path.read_text()),
                                          list)
            out.append(re.sub(r"\d+ events to \S+", "N events to P", text))
        assert out[0] == out[1] == "wrote N events to P\n"


def test_stack_profile_and_memprofile_print_each_process(trees, capsys):
    address, counter = trees
    members = {p["uid"]: p["pid"] for p in api.tree_processes()}
    rc, out, _ = run(cli.main, ["stack", "--address", address], capsys)
    heads = re.findall(r"^== node ([0-9a-f]{12}) worker ([0-9a-f]{12}) "
                       r"pid=(\d+)$", out, re.M)
    assert rc == 0 and {(n, u, int(p)) for n, u, p in heads} == {
        (records.node_id()[:12], u, pid) for u, pid in members.items()}
    assert f"worker {records.identity()} pid={os.getpid()}" in out
    rc, out, _ = run(cli.main, ["stack", "--address", address, "daemon"],
                     capsys)
    assert rc == 0 and len(re.findall(r"^== node ", out, re.M)) == 1
    rc, out, err = run(cli.main, ["profile", "--address", address,
                                  "--duration", "0.3", "--out", "-"],
                       capsys)
    assert rc == 0 and all(re.fullmatch(r".+ \d+", line)
                           for line in out.splitlines())
    assert len(re.findall(r"^node [0-9a-f]{12} [0-9a-f]{12} pid=\d+: "
                          r"\d+ samples$", err, re.M)) == len(members)
    rc, out, err = run(cli.main, ["memprofile", "--address", address,
                                  "--duration", "0.2", "--stop", "--out",
                                  "-"], capsys)
    assert rc == 0 and out.count("pid ") == len(members)
    assert f"pid={counter.pid}: " in err
    rc, _, err = run(cli.main, ["profile", "--address", address,
                                "--continuous", "--out", "-"], capsys)
    assert rc == 1 and "profile store is empty" in err


def test_metrics_export_config_writes_the_jax_files(tmp_path, capsys):
    targets = "10.0.0.1:8090,10.0.0.2:9100"
    written = []
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = tmp_path / name
        rc, text, _ = run(main, ["metrics", "export-config", "--out",
                                 str(out), "--targets", targets], capsys)
        assert rc == 0
        written.append({os.path.basename(p): open(p, "rb").read()
                        for p in text.split()})
    assert written[0] == written[1] and len(written[0]) == 2


def test_a_fresh_interpreter_reads_this_driver_and_names_a_dead_address(
        trees):
    address, _ = trees
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop(api.ADDRESS_ENV, None)
    out = subprocess.run([sys.executable, "-m", "raytpu_torch", "state",
                          "list", "actors", "--name", "cli-counter",
                          "--address", address], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert [line[17:].split() for line in out.stdout.splitlines()] == \
        [["ALIVE", "cli-counter"]]
    dead = "raytpu-torch://raytpu_torch-nobody#00"
    out = subprocess.run([sys.executable, "-m", "raytpu_torch", "state",
                          "list", "actors", "--address", dead], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1 and out.stdout == ""
    assert f"cannot reach a driver at {dead}" in out.stderr


def test_no_address_is_an_error_not_a_runtime(capsys, monkeypatch):
    monkeypatch.delenv(api.ADDRESS_ENV, raising=False)
    rc, out, err = run(cli.main, ["memory"], capsys)
    assert (rc, out) == (1, "") and api.ADDRESS_ENV in err
