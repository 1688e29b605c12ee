"""Job submission in the port (raytpu_torch/job/) held to the JAX
package's (raytpu/job/) on the CPU.

- tests/test_ops_tooling.py's ``TestJobSubmission`` cases and its CLI
  round trip, each one test parametrised over both packages (each
  package's server, SDK and CLI); a client of one package against the
  server of the other gives the same results (the REST surface is
  shared);
- a job that joins the driver's tree: its script calls
  ``runtime.init(address=$RAYTPU_TORCH_ADDRESS)`` (the manager sets it to
  this process's address), runs a task on the driver's pool (its
  ``__main__`` function goes by value) and calls an actor of its own,
  and its task events (armed through ``env_vars``: the job's records;
  the pool's are the driver's, unarmed here) reach the driver's store
  under its process's id; the driver's table drops the job once it has
  exited.
"""

import importlib
import json
import os
import sys
import time

import pytest

from raytpu_torch import runtime, state
from raytpu_torch.runtime import api, records

PACKAGES = ("raytpu", "raytpu_torch")
T = 60.0


def _job(package: str):
    return importlib.import_module(f"{package}.job")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """Both packages' job servers: package -> (address, manager)."""
    out = {}
    for package in PACKAGES:
        job = _job(package)
        manager = job.JobManager(log_dir=str(tmp_path_factory.mktemp(
            f"{package}_job_logs")))
        server = job.JobServer(manager)
        out[package] = (server.start(), manager, server)
    yield out
    for _, _, server in out.values():
        server.stop()
    runtime.shutdown()


@pytest.fixture(params=PACKAGES)
def client(request, servers):
    """One package's client of its own package's server."""
    address, _, _ = servers[request.param]
    return _job(request.param).JobSubmissionClient(address)


def test_submit_and_succeed(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'print(40 + 2)'")
    assert client.wait_until_finished(job_id, timeout=T) == "SUCCEEDED"
    assert "42" in client.get_job_logs(job_id)
    info = client.get_job_info(job_id)
    assert info["return_code"] == 0


def test_failed_job(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'raise SystemExit(3)'")
    assert client.wait_until_finished(job_id, timeout=T) == "FAILED"
    assert client.get_job_info(job_id)["return_code"] == 3


def test_stop_job(client):
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(60)'")
    deadline = time.monotonic() + 30
    while client.get_job_status(job_id) == "PENDING" and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert client.stop_job(job_id) is True
    assert client.wait_until_finished(job_id, timeout=30) == "STOPPED"


def test_env_vars_runtime_env(client, tmp_path):
    job_id = client.submit_job(
        entrypoint=(f"{sys.executable} -c "
                    "'import os; print(os.environ[\"MY_FLAG\"], "
                    "os.getcwd())'"),
        runtime_env={"env_vars": {"MY_FLAG": "xyzzy"},
                     "working_dir": str(tmp_path)})
    client.wait_until_finished(job_id, timeout=T)
    assert f"xyzzy {tmp_path}" in client.get_job_logs(job_id)


def test_list_and_404(client):
    assert isinstance(client.list_jobs(), list)
    with pytest.raises(KeyError):
        client.get_job_status("nope")
    with pytest.raises(KeyError):
        client.get_job_logs("nope")
    with pytest.raises(KeyError):
        client.stop_job("nope")


def test_a_duplicate_submission_id_is_refused(client):
    job_id = client.submit_job(entrypoint="true",
                               submission_id=f"dup-{id(client)}",
                               metadata={"k": "v"})
    assert client.get_job_info(job_id)["metadata"] == {"k": "v"}
    with pytest.raises(RuntimeError, match="400"):
        client.submit_job(entrypoint="true", submission_id=job_id)
    client.wait_until_finished(job_id, timeout=T)


@pytest.mark.parametrize("package", PACKAGES)
def test_job_cli_roundtrip(servers, package, capsys):
    cli = importlib.import_module(f"{package}.scripts.cli")
    address, _, _ = servers[package]
    rc = cli.main(["job", "--api", address, "submit", "--wait",
                   sys.executable, "-c", "print('cli-ok')"])
    assert rc == 0
    job_id, status = capsys.readouterr().out.split()
    assert status == "SUCCEEDED"
    assert cli.main(["job", "--api", address, "logs", job_id]) == 0
    assert capsys.readouterr().out == "cli-ok\n"
    assert cli.main(["job", "--api", address, "status", job_id]) == 0
    assert capsys.readouterr().out == "SUCCEEDED\n"
    assert cli.main(["job", "--api", address, "list"]) == 0
    rows = [line.split("\t") for line in
            capsys.readouterr().out.splitlines()]
    assert [job_id, "SUCCEEDED"] in [r[:2] for r in rows]


@pytest.mark.parametrize("client_package,server_package",
                         [("raytpu", "raytpu_torch"),
                          ("raytpu_torch", "raytpu")])
def test_clients_and_servers_of_the_two_packages_agree(
        servers, client_package, server_package):
    address, _, _ = servers[server_package]
    c = _job(client_package).JobSubmissionClient(address)
    job_id = c.submit_job(entrypoint=f"{sys.executable} -c 'print(7)'",
                          metadata={"from": client_package})
    assert c.wait_until_finished(job_id, timeout=T) == "SUCCEEDED"
    info = c.get_job_info(job_id)
    assert set(info) == {"job_id", "entrypoint", "status",
                         "submission_time", "start_time", "end_time",
                         "return_code", "metadata", "log_path", "message"}
    assert info["metadata"] == {"from": client_package}
    assert c.get_job_logs(job_id) == "7\n"
    assert c.stop_job(job_id) is False


JOINING_JOB = """
import json, os
from raytpu_torch import runtime
from raytpu_torch.runtime import api, records


def job_cube(x):
    return x ** 3


class JobCounter:
    def bump(self):
        return os.getpid()


if __name__ == "__main__":  # its actor's process imports this file
    runtime.init(address=os.environ[api.ADDRESS_ENV])
    counter = runtime.remote(JobCounter).remote()
    out = {"uid": records.identity(), "pid": os.getpid(),
           "task": runtime.get(runtime.remote(job_cube).remote(3),
                               timeout=60),
           "actor_pid": runtime.get(counter.bump.remote(), timeout=60),
           "members": [p["uid"] for p in api.tree_processes()]}
    print("JOINED " + json.dumps(out), flush=True)
"""


def test_a_job_joins_the_driver_s_tree_and_its_records_reach_it(
        servers, tmp_path):
    _, manager, _ = servers["raytpu_torch"]
    assert manager.cluster_address == api.driver_address()
    (tmp_path / "joining_job.py").write_text(JOINING_JOB)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job_id = manager.submit_job(
        f"{sys.executable} joining_job.py",
        runtime_env={"working_dir": str(tmp_path), "env_vars": {
            "RAYTPU_TASK_EVENTS": "1", "PYTHONPATH": repo}})
    assert manager.wait_until_finished(job_id, timeout=120) == \
        "SUCCEEDED", manager.get_job_logs(job_id)
    [line] = [ln for ln in manager.get_job_logs(job_id).splitlines()
              if ln.startswith("JOINED ")]
    out = json.loads(line[len("JOINED "):])
    assert out["task"] == 27 and out["actor_pid"] != out["pid"]
    assert out["uid"] in out["members"]
    assert records.identity() in out["members"]  # the driver's, first
    # The job's actor call, recorded in the job, reached this driver.
    end = time.monotonic() + T
    while True:
        calls = state.list_tasks(name="JobCounter.bump", detail=True)
        if calls and calls[0]["state"] == "FINISHED":
            break
        assert time.monotonic() < end, calls
        time.sleep(0.1)
    [call] = calls
    assert {e["worker_id"] for e in call["events"]} == {out["uid"]}
    # Its exit closed its connection: gone from the driver's table.
    while out["uid"] in {p["uid"] for p in api.tree_processes()}:
        assert time.monotonic() < end
        time.sleep(0.05)
