"""The port's Tune library on the CPU, second part: the counterparts of
tests/test_tune.py's tuner tests over a ``DataParallelTrainer`` (one
worker, inline in the trial; a gloo gang of two with datasets, started
from the trial's process), crash retries from a checkpoint and
exhausted retries, and ``Tuner.restore`` after the tuner's process is
killed mid-run (SIGKILL), which must reach the uninterrupted run's
results. Each trial is a worker process at ``TuneConfig(device="cpu")``
(or the trainer's ``ScalingConfig(device="cpu")``).

Trial processes import this module by name to load the trainables, so
it imports nothing of JAX or of the JAX package at module level."""

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import pytest

import raytpu_torch.tune as tune
from raytpu_torch import train
from raytpu_torch.train import (Checkpoint, FailureConfig, RunConfig,
                                ScalingConfig)
from raytpu_torch.train import session as port_session

FIT_TIMEOUT_S = 180.0
# The experiment killed mid-run: its trials sleep this long a step.
SLOW_STEP_S = 0.25


def children() -> set:
    return {p.pid for p in multiprocessing.active_children()}


def fit(tuner, timeout: float = FIT_TIMEOUT_S):
    """``tuner.fit()`` under a time limit."""
    out = {}

    def run():
        try:
            out["grid"] = tuner.fit()
        except BaseException as e:  # noqa: BLE001  re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"fit() did not end within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["grid"]


# ---- the loops and trainables (module level: they cross by pickle) -----


def report(metrics, checkpoint=None):
    """Report through the session the loop runs in: the port's in a
    worker process, the JAX package's in its own trial."""
    if port_session._get_session() is not None:
        port_session.report(metrics, checkpoint=checkpoint)
    else:
        import raytpu.tune as jtune

        jtune.report(metrics, checkpoint=checkpoint)


def loop_lr_distance(config):
    report({"loss": abs(config["lr"] - 0.01)})


def loop_rows(config):
    ctx = train.get_context()
    n = 0
    for batch in train.get_dataset_shard("train").iter_batches(batch_size=4):
        n += len(next(iter(batch.values())))
    train.report({"rows": n, "world": ctx.get_world_size(),
                  "lr": config["lr"], "pid": os.getpid()})


class Shard:
    """One worker's rows of :class:`Rows`."""

    def __init__(self, ids):
        self.ids = list(ids)

    def iter_batches(self, batch_size: int):
        for i in range(0, len(self.ids), batch_size):
            yield {"id": self.ids[i:i + batch_size]}


class Rows:
    """A dataset of ``n`` ids with the ``streaming_split`` Train reads
    (the port has no data library yet: ROADMAP.md)."""

    def __init__(self, n: int):
        self.n = n

    def streaming_split(self, k: int):
        return [Shard(range(i, self.n, k)) for i in range(k)]


def _report_with_state(metrics: dict, i: int) -> None:
    """Report ``metrics`` with a checkpoint holding ``i`` (report()
    copies the directory before it returns)."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "state.json"), "w") as f:
            json.dump({"i": i}, f)
        train.report(metrics, checkpoint=Checkpoint(d))


def _resume_from(name: str) -> int:
    ckpt = train.get_checkpoint()
    if ckpt is None:
        return 0
    with open(os.path.join(ckpt.path, name)) as f:
        return json.load(f)["i"] + 1


def objective_crashes_once(config):
    """Crashes once, after its checkpoint at i = 3 (the marker file says
    whether it has)."""
    for i in range(_resume_from("state.json"), 6):
        _report_with_state({"i": i, "score": i, "pid": os.getpid()}, i)
        if i == 3 and not os.path.exists(config["marker"]):
            with open(config["marker"], "w") as f:
                f.write("x")
            raise RuntimeError("transient crash")


def always_crash(config):
    raise RuntimeError("permanent")


def slow_objective(config):
    """Resumes from its checkpoint like a real trainable; the restore
    test's tuner process is killed while these run."""
    for i in range(_resume_from("s.json"), 10):
        time.sleep(SLOW_STEP_S)
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "s.json"), "w") as f:
                json.dump({"i": i}, f)
            tune.report({"score": config["x"] * (i + 1), "iter": i},
                        checkpoint=Checkpoint(d))


# ---- the tests -----------------------------------------------------------


def test_tune_over_a_one_worker_trainer(tmp_path):
    import raytpu
    import raytpu.tune as jtune
    from raytpu.train import JaxTrainer, ScalingConfig as JaxScaling
    from raytpu.train.config import RunConfig as JaxRunConfig

    trainer = train.DataParallelTrainer(
        loop_lr_distance, train_loop_config={"lr": 0.1},
        scaling_config=ScalingConfig(num_workers=1, device="cpu"))
    grid = fit(tune.Tuner(
        trainer, param_space={"lr": tune.grid_search([0.1, 0.01, 0.001])},
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(storage_path=str(tmp_path / "port"))))
    best = grid.get_best_result()
    assert best.metrics["loss"] == 0.0
    # The trials ran on the trainer's device, inline: one report each.
    assert [len(r.metrics_history) for r in grid] == [1, 1, 1]

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    try:
        want = jtune.Tuner(
            JaxTrainer(loop_lr_distance, train_loop_config={"lr": 0.1},
                       scaling_config=JaxScaling(num_workers=1)),
            param_space={"lr": jtune.grid_search([0.1, 0.01, 0.001])},
            tune_config=jtune.TuneConfig(metric="loss", mode="min"),
            run_config=JaxRunConfig(storage_path=str(tmp_path / "jax")),
        ).fit().get_best_result()
    finally:
        raytpu.shutdown()
    assert (want.config, want.metrics["loss"]) == \
        (best.config, best.metrics["loss"])


def test_tuner_runs_trainer_gang_and_datasets(tmp_path):
    """A trainer of two gloo workers with datasets: each trial starts its
    gang from its own process, and nothing outlives fit."""
    before = children()
    trainer = train.DataParallelTrainer(
        loop_rows, train_loop_config={"lr": 0.0},
        datasets={"train": Rows(32)},
        scaling_config=ScalingConfig(num_workers=2, device="cpu"),
        run_config=RunConfig(name="gang"))
    grid = fit(tune.Tuner(
        trainer, param_space={"lr": tune.grid_search([0.1, 0.2])},
        tune_config=tune.TuneConfig(metric="rows", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path))))
    assert len(grid) == 2 and not grid.errors
    best = grid.get_best_result()
    assert best.metrics["world"] == 2
    assert best.metrics["rows"] == 16  # half of 32 on rank 0
    assert sorted(r.metrics["lr"] for r in grid) == [0.1, 0.2]
    assert children() <= before
    # Each nested run's tree was removed; its result came back as a
    # report of the trial.
    assert not [d for d in os.listdir(tmp_path) if d.startswith("gang-")]


def test_a_trainer_on_the_card_needs_the_card(tmp_path):
    trainer = train.DataParallelTrainer(
        loop_lr_distance, scaling_config=ScalingConfig(num_workers=1))
    with pytest.raises(ValueError, match="ScalingConfig.device is 'cuda'"):
        tune.Tuner(trainer, tune_config=tune.TuneConfig(device="cpu"),
                   run_config=RunConfig(storage_path=str(tmp_path))).fit()


def test_trial_retries_from_checkpoint(tmp_path):
    from raytpu_torch.util import events

    marker = tmp_path / "crashed_once"
    grid = fit(tune.Tuner(
        objective_crashes_once, param_space={"marker": str(marker)},
        tune_config=tune.TuneConfig(num_samples=1, metric="score",
                                    mode="max", device="cpu"),
        run_config=RunConfig(
            name="retry-test", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=2))))
    assert not grid.errors, grid.errors
    best = grid.get_best_result()
    assert best.metrics["score"] == 5
    assert marker.exists()
    trial = grid._trials[0]
    assert trial.failures == 1
    # Rolled back to the checkpoint at i = 3, then i = 4 and 5 from a new
    # process: no report counted twice.
    assert [m["i"] for m in trial.history] == [0, 1, 2, 3, 4, 5]
    assert trial.history[3]["pid"] != trial.history[4]["pid"]
    retries = [e for e in events.recent_events(label="TRIAL_RETRY")
               if e.get("trial_id") == trial.trial_id]
    assert len(retries) == 1 and retries[0]["severity"] == "WARNING"
    assert "from checkpoint" in retries[0]["message"]


def test_exhausted_retries_error_out(tmp_path):
    before = children()
    grid = fit(tune.Tuner(
        always_crash, param_space={},
        tune_config=tune.TuneConfig(num_samples=1, device="cpu"),
        run_config=RunConfig(
            name="retry-exhaust", storage_path=str(tmp_path),
            failure_config=FailureConfig(max_failures=1))))
    assert len(grid.errors) == 1
    assert "permanent" in str(grid.errors[0])
    assert grid._trials[0].failures == 1
    assert children() <= before


def test_kill_mid_run_then_restore_converges(tmp_path):
    """Kill the tuner's process (SIGKILL) once some trial has a
    registered checkpoint; ``Tuner.restore`` finishes the experiment from
    the saved state and the trials' checkpoints and reaches the results
    of an uninterrupted run: every trial TERMINATED at ten iterations,
    score x * 10."""
    run_dir = str(tmp_path / "exp")
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(tests_dir)
    script = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{repo!r}, {tests_dir!r}]
        import raytpu_torch.tune as tune
        from raytpu_torch.train import RunConfig
        from test_torch_tune_trainer import slow_objective

        if __name__ == "__main__":
            tune.Tuner(
                slow_objective,
                param_space={{"x": tune.grid_search([0, 1, 2, 3])}},
                tune_config=tune.TuneConfig(metric="score", mode="max",
                                            max_concurrent_trials=2,
                                            device="cpu"),
                run_config=RunConfig(name="exp",
                                     storage_path={str(tmp_path)!r}),
            ).fit()
    """)
    path = tmp_path / "run_tuner.py"
    path.write_text(script)
    proc = subprocess.Popen([sys.executable, str(path)], cwd=repo)
    try:
        # Mid-run: the state exists and a trial's checkpoint at its third
        # iteration or later is registered (none can have finished).
        deadline = time.monotonic() + 120
        ckpt = None
        while time.monotonic() < deadline and proc.poll() is None:
            found = sorted(
                os.path.join(root, d) for root, dirs, _ in os.walk(run_dir)
                for d in dirs if d.startswith("checkpoint_"))
            if os.path.exists(os.path.join(run_dir, "tuner_state.pkl")) \
                    and any(d.endswith(("_000003", "_000004"))
                            for d in found):
                ckpt = found
                break
            time.sleep(0.05)
        assert ckpt, "the tuner never registered a third checkpoint"
    finally:
        proc.kill()
        proc.wait(timeout=10)

    restored = tune.Tuner.restore(run_dir)
    grid = fit(restored)
    best = grid.get_best_result()
    assert best.metrics["score"] == 30  # x=3, 10 iterations
    states = {t.trial_id: t.state for t in grid._trials}
    assert len(states) == 4, states
    assert all(s == "TERMINATED" for s in states.values()), states
    # The uninterrupted run's results: each trial's ten reports, in order
    # and none twice, ending at score x * 10.
    for t in grid._trials:
        assert [m["iter"] for m in t.history] == list(range(10)), t.history
        assert t.last_result["score"] == t.config["x"] * 10
