"""The port's state API (raytpu_torch/state) over the driver's records
(raytpu_torch/runtime/records.py), on the CPU, against the JAX package.

- One scenario through the port's runtime and through the JAX package's
  local mode (tasks that succeed, a task retried on
  ``retry_exceptions``, a terminal failure, an actor created, called and
  killed, a ``put``) gives each entity the same transition sequence and
  attempts, ids mapped by name. JAX local mode also records an actor's
  construction as a task of its own; the port's actors are processes
  whose owner records CREATED at the constructor's reply, so that
  record has no counterpart. JAX local mode records no PUT (only its
  node store does); the port records one where a value enters its
  owner's table.
- Port-only cases: a task worker SIGKILLed mid-task (SUBMITTED, the dead
  attempt's FAILED at attempt 0, RETRIED at attempt 1, FINISHED, as
  tests/test_task_events.py asserts of the JAX cluster; the dead
  worker's RUNNING never reached the driver), a tiny Llama served
  through serve whose request timelines are stitched at the driver from
  the router's and the replica's processes in the JAX order (the JAX
  engine's own order for the same prompt), the state API asked from
  another process, and the submit path's one flag check.

One task pool for the module, armed through the environment before it
starts; every flag and variable is put back at the end. This module
imports nothing of JAX at its top: workers import it by name.
"""

import os
import signal
import time

import pytest

from raytpu_torch import runtime, serve, state
from raytpu_torch.runtime import records
from raytpu_torch.util import metrics, task_events

T = 60.0
ENGINE_OPTIONS = {"page_size": 8, "max_num_seqs": 4, "max_model_len": 64}
NEW_TOKENS = 6
# The request transitions the serve router and replica emit before the
# engine's, in both packages (raytpu/serve/_private/router.py, replica.py).
FRONT = ["RECEIVED", "ROUTED", "QUEUED"]


class Flaky(Exception):
    pass


def st_ok(x):
    return x + 1


def st_flaky(path):
    """Raises on its first run (the marker file is not there yet)."""
    if not os.path.exists(path):
        open(path, "w").close()
        raise Flaky("first run")
    return 7


def st_bad():
    raise ValueError("always")


def st_die_once(path):
    """SIGKILLs its own worker on its first run."""
    if not os.path.exists(path):
        open(path, "w").close()
        os.kill(os.getpid(), signal.SIGKILL)
    return "lived"


def st_hog(seconds):
    time.sleep(seconds)
    return "hog"


class StCounter:
    def __init__(self):
        self.n = 0

    def bump(self):
        self.n += 1
        return self.n


class Asker:
    """Asks the state API from its own process."""

    def ask(self):
        from raytpu_torch import state as st

        return {"tasks": len(st.list_tasks(limit=0)),
                "nodes": st.list_nodes(),
                "summary": st.summary_tasks()["total"],
                "actors": len(st.list_actors()["actors"])}


_ENV = (task_events.ENV_VAR, task_events.REQUEST_ENV_VAR, metrics.ENV_SHIP)


@pytest.fixture(scope="module")
def armed():
    """Task events, request events and metrics shipping armed through the
    environment before the module's pool starts; the driver's store and
    ring empty. Everything back as it was at the end."""
    saved = {k: os.environ.get(k) for k in _ENV}
    flags = (task_events.enabled(), task_events.request_events_enabled(),
             metrics.enabled())
    task_events.enable_task_events(env=True)
    task_events.enable_request_events(env=True)
    metrics.enable_metrics_ship(env=True)
    task_events.clear()
    records.reset()
    runtime.shutdown()
    runtime.init(num_cpus=2)
    yield
    runtime.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    for was, off in zip(flags, (task_events.disable_task_events,
                                task_events.disable_request_events,
                                metrics.disable_metrics_ship)):
        if not was:
            off()
    task_events.clear()
    records.reset()


def steps(rec) -> list:
    return [(e["transition"], e["attempt"]) for e in rec["events"]]


def run_scenario(rt, tmp_path, tag: str):
    """The shared scenario through ``rt`` (``raytpu`` or
    ``raytpu_torch.runtime``): the refs and handles it made."""
    assert rt.get(rt.remote(st_ok).remote(1), timeout=T) == 2
    flaky = rt.remote(st_flaky).options(retry_exceptions=[Flaky],
                                        max_retries=2)
    assert rt.get(flaky.remote(str(tmp_path / f"{tag}-flaky")),
                  timeout=T) == 7
    with pytest.raises(Exception, match="always"):
        rt.get(rt.remote(st_bad).options(max_retries=1).remote(), timeout=T)
    put = rt.put(41)
    counter = rt.remote(StCounter).options(name=f"st-counter-{tag}").remote()
    assert rt.get(counter.bump.remote(), timeout=T) == 1
    assert rt.get(counter.bump.remote(), timeout=T) == 2
    rt.kill(counter)
    return put


def sequences(api, actor_name: str) -> dict:
    """Each entity's (transition, attempt) sequence, keyed by what maps
    it across packages: a task function's name, ``bump`` for the actor
    calls (in submission order), the actor's name."""
    out = {"bump": []}
    tasks = sorted(api.list_tasks(detail=True, limit=0),
                   key=lambda t: t["first_ts"] or 0.0)
    for t in tasks:
        name = t["name"] or ""
        if name in ("st_ok", "st_flaky", "st_bad"):
            out[name] = steps(t)
        elif name.endswith(".bump"):
            out["bump"].append(steps(t))
    [actor] = api._recorder_list("actor", name=actor_name, limit=0,
                                 detail=True)
    out["actor"] = steps(actor)
    return out


def test_the_scenario_gives_the_jax_package_s_transitions(armed, tmp_path):
    import raytpu
    from raytpu.state import api as jax_state
    from raytpu.util import task_events as jax_task_events

    was = jax_task_events.enabled()
    jax_task_events.clear()
    jax_task_events.enable_task_events()
    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    try:
        run_scenario(raytpu, tmp_path, "jax")
        time.sleep(0.2)  # the killed actor's DEAD
        want = sequences(jax_state, "st-counter-jax")
        jax_objects = jax_state.list_objects(detail=True)
        jax_creation = [t for t in jax_state.list_tasks(detail=True)
                        if t["name"] == "st-counter-jax"]
    finally:
        raytpu.shutdown()
        if not was:
            jax_task_events.disable_task_events()
        jax_task_events.clear()
    records.reset()
    put = run_scenario(runtime, tmp_path, "port")
    got = sequences(state.api, "st-counter-port")
    assert got == want
    assert got["st_flaky"] == [("SUBMITTED", 0), ("RUNNING", 0),
                               ("FAILED", 0), ("RETRIED", 1),
                               ("RUNNING", 1), ("FINISHED", 1)]
    assert got["actor"] == [("CREATED", 0), ("DEAD", 0)]
    # What has no counterpart: the JAX actor's construction task, and the
    # port's PUT (JAX local mode records none).
    assert [steps(t) for t in jax_creation] == [
        [("SUBMITTED", 0), ("RUNNING", 0), ("FINISHED", 0)]]
    assert not any(o.get("events") for o in jax_objects)
    assert steps(state.get_timeline(put.hex(), kind="object")) == [
        ("PUT", 0)]


def test_a_killed_worker_leaves_the_whole_flight_record(armed, tmp_path):
    ref = runtime.remote(st_die_once).remote(str(tmp_path / "died"))
    assert runtime.get(ref, timeout=T) == "lived"
    [row] = [t for t in state.list_tasks(name="st_die_once", detail=True)]
    assert row["state"] == "FINISHED" and row["attempt"] == 1
    assert steps(row) == [("SUBMITTED", 0), ("FAILED", 0), ("RETRIED", 1),
                          ("RUNNING", 1), ("FINISHED", 1)]
    failed = row["events"][1]
    assert failed["error"].startswith("WorkerCrashedError")
    assert state.get_timeline(row["task_id"][:12])["id"] == row["task_id"]


def test_listings_have_the_jax_shapes(armed):
    import raytpu.state as jax_state_pkg

    import raytpu_torch.state as port_state_pkg

    assert port_state_pkg.__all__ == jax_state_pkg.__all__
    counter = runtime.remote(StCounter).options(name="st-alive").remote()
    runtime.get(counter.bump.remote(), timeout=T)
    ref = runtime.put(b"x" * 1000)
    try:
        res = state.list_actors(name="st-alive", detail=True)
        assert set(res) == {"actors", "partial", "errors"}
        assert res["partial"] is False and res["errors"] == []
        [a] = res["actors"]
        assert a["state"] == "ALIVE" and a["pid"] == counter.pid
        assert [e["transition"] for e in a["events"]] == ["CREATED"]
        [node] = state.list_nodes()
        assert node["alive"] and node["resources"]["CPU"] == 2.0
        assert state.list_placement_groups() == []
        objects = {o["object_id"]: o for o in state.list_objects()}
        assert objects[ref.hex()]["size_bytes"] > 1000
        summary = state.object_summary()
        assert summary["count"] == len(objects)
        assert summary["total_bytes"] >= objects[ref.hex()]["size_bytes"]
        counts = state.summarize_tasks()
        assert counts.get("FINISHED", 0) >= 1
        s = state.summary_tasks()
        assert s["kind"] == "task" and s["total"] == sum(counts.values())
        assert s["queue_to_run_latency_s"]["count"] >= 1
        assert state.summary_actors()["by_state"]["CREATED"]["st-alive"] == 1
        assert state.list_events(limit=0) == []
        assert state.api.rpc_stage_summary() == {}
    finally:
        runtime.kill(counter)


def test_another_process_reads_the_driver_s_records(armed):
    asker = runtime.remote(Asker).remote()
    try:
        got = runtime.get(asker.ask.remote(), timeout=T)
        assert got["nodes"] == state.list_nodes()
        assert got["tasks"] > 0 and got["summary"] > 0
        assert got["actors"] >= 1  # itself, recorded by its owner here
    finally:
        runtime.kill(asker)


def test_the_submit_path_checks_the_flag_once(armed, monkeypatch):
    """With the pool's two CPUs held by a hog, a submission runs the
    submit path alone: one ``enabled()`` check in this process."""
    hog = runtime.remote(st_hog).options(num_cpus=2).remote(1.0)
    end = time.monotonic() + T
    while not any(t["state"] == "RUNNING" and t["name"] == "st_hog"
                  for t in runtime.api._POOL.live()):
        assert time.monotonic() < end, "the hog never ran"
        time.sleep(0.01)
    calls = []
    real = task_events.enabled
    monkeypatch.setattr(task_events, "enabled",
                        lambda: (calls.append(1), real())[1])
    ref = runtime.remote(st_ok).options(num_cpus=2).remote(1)
    assert len(calls) == 1
    monkeypatch.undo()
    assert runtime.get([hog, ref], timeout=T) == ["hog", 2]


def jax_engine_order(prompt, n: int) -> list:
    """The JAX engine's request transitions for ``prompt`` (tiny Llama,
    fp32, seed 0), greedy ``n`` tokens."""
    import dataclasses

    import jax.numpy as jnp

    from raytpu.inference import InferenceEngine, SamplingParams
    from raytpu.models.llama import Llama, LlamaConfig, init_params
    from raytpu.util import task_events as jax_task_events

    cfg = dataclasses.replace(LlamaConfig.tiny(), dtype=jnp.float32,
                              attn_impl="reference", paged_attn="reference",
                              remat=False)
    params = init_params(Llama(cfg), cfg, seed=0, batch=1)
    eng = InferenceEngine(cfg, params, **ENGINE_OPTIONS)
    was = jax_task_events.request_events_enabled()
    jax_task_events.enable_request_events()
    jax_task_events.clear()
    try:
        eng.add_request("r", prompt, SamplingParams(max_new_tokens=n))
        while eng.has_unfinished():
            eng.step()
        return [e["transition"] for e in jax_task_events.get_events()
                if e["kind"] == "request" and e["id"] == "r"]
    finally:
        if not was:
            jax_task_events.disable_request_events()
        jax_task_events.clear()


def test_serve_request_timelines_are_stitched_in_the_jax_order(armed):
    prompt = [1, 2, 3, 4, 5, 6, 7]
    handle = serve.run(serve.LLMDeployment.options(name="st-llm").bind(
        model="llama", engine_options=ENGINE_OPTIONS, seed=0, device="cpu"),
        name="st", route_prefix=None)
    try:
        full = [handle.generate.remote_streaming(prompt,
                                                 max_new_tokens=NEW_TOKENS)
                for _ in range(2)]
        ids = [g.request_id for g in full]
        assert [len(list(g)) for g in full] == [NEW_TOKENS] * 2
        closed = handle.generate.remote_streaming([5, 6, 7],
                                                  max_new_tokens=40)
        next(closed)
        next(closed)
        closed.close()
        overlong = handle.generate.remote_streaming(
            [1] * (ENGINE_OPTIONS["max_model_len"] + 8), max_new_tokens=4)
        with pytest.raises(Exception):
            list(overlong)
        ids += [closed.request_id, overlong.request_id]
        terminal = ("FINISHED", "ABORTED", "FAILED")
        end = time.monotonic() + T
        while True:  # the replica's events arrive on its ship timer
            recs = [state.get_request_timeline(rid) for rid in ids]
            if all(r is not None and r["state"] in terminal for r in recs):
                break
            assert time.monotonic() < end, recs
            time.sleep(0.1)
    finally:
        serve.shutdown()
    order = FRONT + jax_engine_order(prompt, NEW_TOKENS)
    assert order[-1] == "FINISHED"
    for rec in recs[:2]:
        assert [e["transition"] for e in rec["events"]] == order
        assert rec["deployment"] == "st#st-llm"
    aborted = [e["transition"] for e in recs[2]["events"]]
    assert aborted == order[:-1] + ["ABORTED"]
    assert [e["transition"] for e in recs[3]["events"]] == FRONT + [
        "FAILED"]
    # Stitched across processes: the router's events here, the replica's
    # in its own process, every one stamped with its emitter.
    here = records.identity()
    for rec in recs:
        by = {e["transition"]: e["worker_id"] for e in rec["events"]}
        assert by["RECEIVED"] == by["ROUTED"] == here
        assert by["QUEUED"] not in ("", here)
    assert {r["id"] for r in state.list_serve_requests(
        deployment="st#st-llm", limit=0)} >= set(ids)
    stats = records.ship_stats()
    assert stats["ships"] > 0 and stats["events"] > 0
    assert stats["lag_s"]["max"] >= stats["lag_s"]["p50"] >= 0.0
