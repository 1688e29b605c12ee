"""Durable workflows of the port (raytpu_torch/workflow/) held to the JAX
package's (raytpu/workflow/).

- Every case of tests/test_workflow.py against the port: a DAG of the
  port's remote functions (``.bind()``) run, resumed, listed, deleted,
  its steps checkpointed through the port's serializer, and the durable
  events.
- Parity: the diamond and a resumed DAG with a named ``wait_for_event``
  step and a step renamed by ``.options(name=...)``, run through the
  JAX local backend's workflow and through the port's, give the same
  step ids, the same step names and outputs, and run the same steps.
- A tiny GPT-2 workflow: prepare, train two AdamW steps, evaluate on a
  held-out batch; the evaluation fails once, the resume runs only it;
  the result equals the same steps called directly in the port to the
  bit, and agrees with the JAX package's train step.

One port runtime for the module (four task workers: a pending event
wait holds one). This module imports nothing of JAX at its top: the
port's task workers import it by name.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import raytpu_torch as rt
from raytpu_torch import workflow
from raytpu_torch.workflow.storage import WorkflowStorage

T = 60.0
# GPT-2 training parity's bound (tests/test_torch_gpt2.py's TOL): fp32
# results through several matmuls.
TOL = 1e-4
LR, WD = 3e-4, 0.1  # optax.adamw(3e-4, weight_decay=0.1), as bench.py


@pytest.fixture(scope="module")
def port():
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


@pytest.fixture
def wf(tmp_path, port):
    workflow.init(str(tmp_path))
    yield workflow


def add(a, b):
    return a + b


def double(x):
    return 2 * x


wf_add = rt.remote(add)
wf_double = rt.remote(double)


class TestWorkflowRun:
    def test_linear_dag(self, wf):
        dag = wf_double.bind(wf_add.bind(1, 2))
        assert wf.run(dag, workflow_id="lin") == 6
        assert wf.get_status("lin") == "SUCCESSFUL"
        assert wf.get_output("lin") == 6

    def test_diamond_dag_step_count(self, wf):
        a = wf_add.bind(1, 1)          # 2
        left = wf_double.bind(a)       # 4
        right = wf_double.bind(a)      # 4
        dag = wf_add.bind(left, right)  # 8
        assert wf.run(dag, workflow_id="dia") == 8
        steps = wf.list_steps("dia")
        assert len(steps) == 4  # shared node `a` ran once (memoized)

    def test_rerun_completed_returns_cached(self, wf, tmp_path):
        log = str(tmp_path / "effect_log")

        def effect():
            with open(log, "a") as f:
                f.write("ran\n")
            return "done"

        dag = rt.remote(effect).bind()
        assert wf.run(dag, workflow_id="cache") == "done"
        assert wf.run(dag, workflow_id="cache") == "done"
        # The second run loaded the stored output; no re-execution.
        assert wf.get_status("cache") == "SUCCESSFUL"
        assert open(log).read().splitlines() == ["ran"]

    def test_list_and_delete(self, wf):
        wf.run(wf_add.bind(1, 2), workflow_id="tolist")
        ids = [w["workflow_id"] for w in wf.list_all()]
        assert "tolist" in ids
        wf.delete("tolist")
        ids = [w["workflow_id"] for w in wf.list_all()]
        assert "tolist" not in ids

    def test_run_async_and_get_output(self, wf):
        def slow():
            time.sleep(0.3)
            return 99

        wid = wf.run_async(rt.remote(slow).bind())
        assert wf.get_output(wid, timeout=T) == 99


class TestWorkflowResume:
    def test_failure_then_resume_skips_completed_steps(self, wf, tmp_path):
        marker = str(tmp_path / "fail_once")
        log = str(tmp_path / "exec_log")
        open(marker, "w").write("arm")

        def step_a():
            with open(log, "a") as f:
                f.write("a\n")
            return 10

        def flaky(x):
            with open(log, "a") as f:
                f.write("flaky\n")
            if os.path.exists(marker):
                os.unlink(marker)
                raise RuntimeError("transient")
            return x + 5

        dag = rt.remote(flaky).bind(rt.remote(step_a).bind())
        with pytest.raises(rt.TaskError, match="transient"):
            wf.run(dag, workflow_id="resume-me")
        assert wf.get_status("resume-me") == "FAILED"
        assert open(log).read().splitlines() == ["a", "flaky"]
        # step_a checkpointed; resume re-runs only flaky.
        assert wf.resume("resume-me") == 15
        assert open(log).read().splitlines() == ["a", "flaky", "flaky"]
        assert wf.get_status("resume-me") == "SUCCESSFUL"

    def test_resume_all(self, wf, tmp_path):
        marker = str(tmp_path / "fail_always")
        open(marker, "w").write("arm")

        def fail_once_global(x):
            if os.path.exists(marker):
                os.unlink(marker)
                raise RuntimeError("boom")
            return x

        with pytest.raises(rt.TaskError):
            wf.run(rt.remote(fail_once_global).bind(7), workflow_id="ra")
        resumed = wf.resume_all()
        assert "ra" in resumed
        assert wf.get_output("ra") == 7

    def test_actor_nodes_rejected(self, wf):
        class A:
            def m(self):
                return 1

        a = rt.remote(A).remote()
        with pytest.raises(Exception, match="durable|actor"):
            wf.run(a.m.bind(), workflow_id="bad")


class TestStorage:
    def test_atomic_step_roundtrip(self, tmp_path):
        st = WorkflowStorage(str(tmp_path))
        st.create_workflow("w", b"blob")
        st.save_step("w", "s1", "mystep", {"x": (1, 2)})
        assert st.has_step("w", "s1")
        assert st.load_step("w", "s1") == {"x": (1, 2)}
        assert st.load_dag("w") == b"blob"
        st.save_output("w", [1, 2, 3])
        assert st.load_output("w") == [1, 2, 3]
        # No temporary file is left beside what the renames put in place.
        names = sorted(os.listdir(tmp_path / "w")) + sorted(
            os.listdir(tmp_path / "w" / "steps"))
        assert names == ["dag.pkl", "input.pkl", "output.pkl",
                         "status.json", "steps", "s1.meta.json", "s1.pkl"]


def identity(x):
    return x


def upper_status(payload):
    return payload["status"].upper()


def plus_one(x):
    return x + 1


def times_ten(payload):
    return payload * 10


class TestWorkflowEvents:
    def test_wait_unblocks_on_post(self, wf):
        def poster():
            time.sleep(0.5)
            wf.post_event("shipment", {"status": "arrived"})

        threading.Thread(target=poster, daemon=True).start()
        ev = wf.wait_for_event("shipment")
        assert wf.run(rt.remote(upper_status).bind(ev)) == "ARRIVED"

    def test_posted_event_is_durable_for_late_waiters(self, wf):
        wf.post_event("already", 42)
        assert wf.event_exists("already")
        p1 = rt.remote(plus_one)
        assert wf.run(p1.bind(wf.wait_for_event("already"))) == 43
        # And a SECOND workflow sees it too (events persist).
        assert wf.run(p1.bind(wf.wait_for_event("already"))) == 43

    def test_wait_timeout_fails_workflow(self, wf):
        with pytest.raises(Exception, match="not posted"):
            wf.run(rt.remote(identity).bind(
                wf.wait_for_event("never", timeout_s=0.5)))

    def test_resume_reenters_pending_wait(self, wf):
        """A workflow interrupted while waiting resumes into the wait and
        completes when the event lands: the durable record is created
        without ever executing, then resume() drives it into the wait."""
        from raytpu_torch.runtime import serialization
        from raytpu_torch.workflow.api import _get_storage

        wid = "wf-event-resume"
        dag = rt.remote(times_ten).bind(wf.wait_for_event("later"))
        _get_storage().create_workflow(wid, serialization.dumps(dag), None)
        assert wf.get_status(wid) == "RUNNING"
        box = {}

        def do_resume():
            box["out"] = wf.resume(wid)

        t = threading.Thread(target=do_resume, daemon=True)
        t.start()
        time.sleep(0.8)
        assert "out" not in box  # resumed INTO the wait, still pending
        wf.post_event("later", 7)
        t.join(timeout=T)
        assert box.get("out") == 70
        assert wf.get_status(wid) == "SUCCESSFUL"

    def test_reserved_workflow_id_rejected(self, wf):
        with pytest.raises(ValueError, match="reserved"):
            wf.run(rt.remote(identity).bind(1), workflow_id=".events")

    def test_slash_vs_underscore_events_distinct(self, wf):
        wf.post_event("a/b", 1)
        wf.post_event("a_b", 2)
        assert wf.event_exists("a/b") and wf.event_exists("a_b")
        ident = rt.remote(identity)
        assert wf.run(ident.bind(wf.wait_for_event("a/b"))) == 1
        assert wf.run(ident.bind(wf.wait_for_event("a_b"))) == 2


# ---- parity with the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def jax_wf(port):
    import raytpu
    from raytpu import workflow as jwf

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    yield raytpu, jwf
    raytpu.shutdown()


def step_a(log):
    with open(log, "a") as f:
        f.write("a\n")
    return 10


def flaky(x, payload, marker, log, base):
    with open(log, "a") as f:
        f.write("flaky\n")
    if os.path.exists(marker):
        os.unlink(marker)
        raise RuntimeError("transient")
    return x + payload + base


def _steps(wfmod, wid):
    return sorted((s["step_id"], s["name"]) for s in wfmod.list_steps(wid))


def _run_both(jax_wf, tmp_path, build, wid, resume_after=None):
    """Run the DAG ``build(remote, wfmod, where)`` makes through each
    package's workflow, each with a storage root of its own; with
    ``resume_after``, expect a failure first, call it, then resume.
    Returns, by package: the output, the step ids and names, and the
    step values."""
    raytpu, jwf = jax_wf
    out = {}
    for name, remote, wfmod in (("raytpu", raytpu.remote, jwf),
                                ("raytpu_torch", rt.remote, workflow)):
        where = tmp_path / name
        where.mkdir()
        wfmod.init(str(where / "store"))
        dag = build(remote, wfmod, where)
        if resume_after is not None:
            with pytest.raises(Exception, match="transient"):
                wfmod.run(dag, workflow_id=wid)
            assert wfmod.get_status(wid) == "FAILED"
            resume_after(wfmod, where)
            result = wfmod.resume(wid)
        else:
            result = wfmod.run(dag, workflow_id=wid)
        storage = WorkflowStorage(str(where / "store")) \
            if name == "raytpu_torch" else None
        values = {}
        for sid, _ in _steps(wfmod, wid):
            if storage is not None:
                values[sid] = storage.load_step(wid, sid)
            else:
                from raytpu.workflow.storage import WorkflowStorage as J

                values[sid] = J(str(where / "store")).load_step(wid, sid)
        out[name] = (result, _steps(wfmod, wid), values, where)
    return out


def test_diamond_step_ids_and_outputs_equal_the_jax_package(jax_wf,
                                                            tmp_path):
    def build(remote, wfmod, where):
        a = remote(add).bind(1, 1)
        return remote(add).bind(remote(double).bind(a),
                                remote(double).bind(a))

    out = _run_both(jax_wf, tmp_path, build, "dia")
    (jr, js, jv, _), (pr, ps, pv, _) = out["raytpu"], out["raytpu_torch"]
    assert pr == jr == 8
    assert ps == js and len(ps) == 4
    assert pv == jv


def test_resumed_dag_with_a_named_wait_equals_the_jax_package(jax_wf,
                                                              tmp_path):
    """The step id rule: the port's ``_name`` takes ``.options(name=)``
    first, the JAX package's is always the function's qualified name;
    both packages' step ids and names read the qualified name."""

    def build(remote, wfmod, where):
        marker, log = str(where / "marker"), str(where / "log")
        open(marker, "w").write("arm")
        wfmod.post_event("go", 5)
        a = remote(step_a).options(name="the-first-step").bind(log)
        return remote(flaky).bind(remote(double).bind(a),
                                  wfmod.wait_for_event("go"), marker, log, a)

    out = _run_both(jax_wf, tmp_path, build, "resumed",
                    resume_after=lambda wfmod, where: None)
    (jr, js, jv, jwhere), (pr, ps, pv, pwhere) = (out["raytpu"],
                                                  out["raytpu_torch"])
    assert pr == jr == 35  # 2 * 10 + 5 + 10
    assert ps == js
    # The shared step_a is reached first through double in the first run,
    # through flaky's last argument in the resume (double's checkpoint
    # stands in for its subtree): another path, another id, so it runs
    # again there, in both packages.
    assert sorted(n for _, n in ps) == [
        "double", "flaky", "step_a", "step_a",
        "wait_for_event.<locals>._wait_event"]
    assert pv == jv
    for where in (jwhere, pwhere):  # the resume: flaky and step_a again
        assert open(where / "log").read().splitlines() == [
            "a", "flaky", "a", "flaky"]


# ---- a tiny GPT-2 workflow: prepare, train, evaluate ----------------------

GPT2_STEPS = 2
SEQ = 32


def _tiny():
    from raytpu_torch.models.gpt2 import GPT2Config

    return dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32,
                               remat=False)


def gpt2_prepare(seed: int) -> dict:
    """The training batches and a held-out batch, from a numpy seed."""
    rng = np.random.default_rng(seed)
    vocab = _tiny().vocab_size
    return {"batches": [rng.integers(0, vocab, (2, SEQ))
                        for _ in range(GPT2_STEPS)],
            "heldout": rng.integers(0, vocab, (2, SEQ))}


def gpt2_train(data: dict, state: dict, count: str) -> dict:
    """GPT2_STEPS AdamW steps from ``state``; the losses and the trained
    state as CPU tensors. Each run appends a line to ``count``."""
    from raytpu_torch.models.gpt2 import GPT2, make_train_step

    with open(count, "a") as f:
        f.write("train\n")
    model = GPT2(_tiny(), device="cpu")
    model.load_state_dict(state)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=WD)
    step = make_train_step(model, opt)
    losses = [step(torch.from_numpy(b)).item() for b in data["batches"]]
    return {"losses": losses,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()}}


def gpt2_evaluate(trained: dict, data: dict, marker: str) -> dict:
    """The held-out loss of the trained state; raises once while
    ``marker`` exists."""
    from raytpu_torch.models.gpt2 import GPT2, gpt2_loss_fn

    if os.path.exists(marker):
        os.unlink(marker)
        raise RuntimeError("evaluation interrupted")
    model = GPT2(_tiny(), device="cpu")
    model.load_state_dict(trained["state"])
    with torch.no_grad():
        loss = gpt2_loss_fn(model, torch.from_numpy(data["heldout"]))
    return {"losses": trained["losses"], "heldout": loss.item()}


def test_gpt2_workflow_resumes_only_the_evaluation(wf, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax
    from raytpu.models.gpt2 import GPT2 as JaxGPT2
    from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from raytpu.models.gpt2 import gpt2_loss_fn as jax_loss
    from raytpu.models.gpt2 import init_params
    from raytpu.models.gpt2 import make_train_step as jax_make_train_step

    from raytpu_torch.models.convert import gpt2_state_from_jax

    jcfg = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32,
                               attn_impl="reference", remat=False)
    params = init_params(JaxGPT2(jcfg), jcfg, seed=0, batch=1)
    state = gpt2_state_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                _tiny())
    count, marker = str(tmp_path / "count"), str(tmp_path / "marker")
    open(marker, "w").write("arm")
    data = rt.remote(gpt2_prepare).bind(7)
    trained = rt.remote(gpt2_train).bind(data, state, count)
    dag = rt.remote(gpt2_evaluate).bind(trained, data, marker)
    with pytest.raises(rt.TaskError, match="evaluation interrupted"):
        wf.run(dag, workflow_id="gpt2")
    assert wf.get_status("gpt2") == "FAILED"
    got = wf.resume("gpt2")
    assert wf.get_status("gpt2") == "SUCCESSFUL"
    assert open(count).read().splitlines() == ["train"]  # trained once
    # The JAX executor's rule, copied: a step's id is its path from the
    # root, and a shared step is reached first through the checkpointed
    # train step in the first run but through evaluate's second argument
    # in the resume, so prepare (cheap) runs again under another id.
    names = sorted(s["name"] for s in wf.list_steps("gpt2"))
    assert names == ["gpt2_evaluate", "gpt2_prepare", "gpt2_prepare",
                     "gpt2_train"]

    # The same steps called directly in this process, on one thread as
    # a task worker with one CPU runs them: equal to the bit.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = gpt2_prepare(7)
        want = gpt2_evaluate(gpt2_train(d, state, str(tmp_path / "c2")), d,
                             str(tmp_path / "no-marker"))
    finally:
        torch.set_num_threads(threads)
    assert got == want

    # JAX's train step on the same batches, and its held-out loss.
    step = jax.jit(jax_make_train_step(JaxGPT2(jcfg),
                                       optax.adamw(LR, weight_decay=WD)))
    opt_state, jp, losses = optax.adamw(LR, weight_decay=WD).init(
        params), params, []
    for b in d["batches"]:
        jp, opt_state, loss = step(jp, opt_state, jnp.asarray(b))
        losses.append(float(loss))
    heldout = float(jax_loss(JaxGPT2(jcfg), jp, jnp.asarray(d["heldout"])))
    np.testing.assert_allclose(got["losses"] + [got["heldout"]],
                               losses + [heldout], rtol=TOL, atol=TOL)
    assert json.loads(json.dumps(got)) == got
