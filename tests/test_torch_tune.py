"""The port's Tune library (raytpu_torch/tune) end to end on the CPU, at
``TuneConfig(device="cpu")``: the counterparts of tests/test_tune.py's
tuner tests over plain functions (grid best, ``num_samples``, an isolated
trial error, ASHA stopping, HyperBand, the dataframe, released trial
processes, consistent searcher ids, ``num_to_keep``, the ask/tell and
Optuna adapters). Each trial is a worker process; where the trainable
is deterministic, the JAX package's tuner runs the same experiment and
the best config and metric must agree. The trainer, retry and restore
tests are in tests/test_torch_tune_trainer.py.

Trial processes import this module by name to load the trainables, so
it imports nothing of JAX or of the JAX package at module level. No test
relies on timing: where ASHA must see strong results first, the weak
trials wait until the controller has registered them, and every trial
waits for the controller to take each result before the next."""

import glob
import json
import multiprocessing
import os
import sys
import tempfile
import threading
import time
import types

import pytest

import raytpu_torch.tune as tune
from raytpu_torch.train import Checkpoint, CheckpointConfig, RunConfig
from raytpu_torch.train import session as port_session
from raytpu_torch.tune.search import Searcher

# Seconds a fit may take here: trial processes start (import torch) in
# a few seconds each, a wave at once; anything past this is a hang.
FIT_TIMEOUT_S = 180.0
# How long a weak ASHA trial waits for the strong results it must follow.
WAIT_S = 60.0


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


def cpu(**kw) -> tune.TuneConfig:
    return tune.TuneConfig(device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_fabric():
    """The JAX package's local fabric, once for the module."""
    import raytpu

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    yield raytpu
    raytpu.shutdown()


def jax_fit(trainable, param_space, tmp, **tc):
    """The same experiment through the JAX package's tuner."""
    import raytpu.tune as jtune
    from raytpu.train.config import RunConfig as JaxRunConfig

    return jtune.Tuner(
        trainable, param_space=param_space,
        tune_config=jtune.TuneConfig(**tc),
        run_config=JaxRunConfig(storage_path=str(tmp))).fit()


# ---- the trainables (module level: they cross to the trials by pickle) --


def report(metrics, checkpoint=None):
    """Report through the session the trainable runs in: the port's in
    a trial process, the JAX package's in its tuner's trial."""
    if port_session._get_session() is not None:
        port_session.report(metrics, checkpoint=checkpoint)
    else:
        import raytpu.tune as jtune

        jtune.report(metrics, checkpoint=checkpoint)


def objective_quadratic(config):
    report({"score": -(config["x"] - 3) ** 2})


def objective_lr(config):
    report({"v": config["lr"]})


def objective_fails_at_1(config):
    if config["x"] == 1:
        raise RuntimeError("bad trial")
    report({"score": config["x"]})


def objective_x(config):
    report({"score": config["x"]})


def objective_v(config):
    report({"v": config["x"]})


def registered(run_dir: str, strong: bool, at_least: int, q=None) -> bool:
    """Whether the controller has registered a checkpoint of a strong
    trial (q >= 1), or of the trial with this ``q``, at iteration
    ``at_least`` or later (it writes ``_metrics.json`` into the trial's
    managed checkpoint when it takes the report)."""
    for path in glob.glob(os.path.join(run_dir, "trial_*", "checkpoint_*",
                                       "_metrics.json")):
        try:
            with open(path) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue  # being written
        if (m["q"] >= 1.0 if strong else m["q"] == q) \
                and m["training_iteration"] >= at_least:
            return True
    return False


def wait_for(run_dir: str, *args) -> None:
    deadline = time.monotonic() + WAIT_S
    while not registered(run_dir, *args):
        assert time.monotonic() < deadline, f"not registered: {args}"
        time.sleep(0.02)


def objective_asha(config):
    """tests/test_tune.py's ASHA trainable, in lockstep with the
    controller instead of paced by sleeps: each result waits until the
    controller has taken the one before it (so the trial is still running
    when it is judged), and a weak trial (q < 1) reports a step only once
    a strong trial's result at that step is registered, so it reaches
    each rung after a strong peer."""
    run_dir = port_session.get_context().storage_path
    q = config["q"]
    for step in range(1, 20):
        if q < 1.0:
            wait_for(run_dir, True, step)
        with tempfile.TemporaryDirectory() as d:  # report() copies it
            report({"acc": q * step, "q": q, "training_iteration": step},
                   checkpoint=Checkpoint(d))
        wait_for(run_dir, False, step, q)


def objective_hyperband(config):
    for i in range(1, 10):
        report({"score": config["quality"] * i, "iter": i})


def objective_keep(config):
    for step in range(5):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "w.txt"), "w") as f:
                f.write(str(step))
            report({"v": step, "training_iteration": step + 1},
                   checkpoint=Checkpoint(d))


def objective_distance_to_1(config):
    assert config.get("const", 7) == 7
    report({"loss": (config["x"] - 1.0) ** 2})


def objective_distance_to_2(config):
    assert config["const"] == 7
    report({"loss": (config["x"] - 2.0) ** 2})


class RecordingSearcher(Searcher):
    def __init__(self):
        self.suggested = []
        self.completed = []
        self._n = 0

    def suggest(self, trial_id):
        if self._n >= 3:
            return None
        self._n += 1
        self.suggested.append(trial_id)
        return {"x": self._n}

    def on_trial_complete(self, trial_id, result):
        self.completed.append(trial_id)


# ---- the tests -----------------------------------------------------------


def test_grid_finds_best(tmp_path, jax_fabric):
    space = {"x": tune.grid_search([0, 1, 2, 3, 4, 5])}
    grid = fit(tune.Tuner(
        objective_quadratic, param_space=space,
        tune_config=cpu(metric="score", mode="max", max_concurrent_trials=3),
        run_config=RunConfig(storage_path=str(tmp_path / "port"))))
    best = grid.get_best_result()
    assert best.metrics["score"] == 0
    import raytpu.tune as jtune

    want = jax_fit(objective_quadratic,
                   {"x": jtune.grid_search([0, 1, 2, 3, 4, 5])},
                   tmp_path / "jax", metric="score", mode="max",
                   max_concurrent_trials=3).get_best_result()
    assert (best.config, best.metrics["score"]) == \
        (want.config, want.metrics["score"])
    assert sorted(r.metrics["score"] for r in grid) == [-9, -4, -4, -1, -1, 0]


def test_num_samples_random(tmp_path):
    grid = fit(tune.Tuner(
        objective_lr, param_space={"lr": tune.loguniform(1e-5, 1e-1)},
        tune_config=cpu(metric="v", mode="max", num_samples=5,
                        max_concurrent_trials=3),
        run_config=RunConfig(storage_path=str(tmp_path))))
    assert len(grid) == 5
    assert not grid.errors
    assert all(1e-5 <= r.metrics["v"] <= 1e-1 for r in grid)


def test_trial_error_isolated(tmp_path, jax_fabric):
    grid = fit(tune.Tuner(
        objective_fails_at_1, param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=cpu(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path / "port"))))
    assert len(grid.errors) == 1
    assert "bad trial" in str(grid.errors[0])
    assert grid.get_best_result().metrics["score"] == 2
    import raytpu.tune as jtune

    want = jax_fit(objective_fails_at_1, {"x": jtune.grid_search([0, 1, 2])},
                   tmp_path / "jax", metric="score", mode="max")
    assert len(want.errors) == 1
    assert want.get_best_result().config == grid.get_best_result().config


def test_asha_stops_bad_trials(tmp_path):
    grid = fit(tune.Tuner(
        objective_asha, param_space={"q": tune.grid_search(
            [0.1, 0.2, 1.0, 2.0])},
        tune_config=cpu(
            metric="acc", mode="max", max_concurrent_trials=4,
            scheduler=tune.ASHAScheduler(
                metric="acc", grace_period=2, reduction_factor=2,
                max_t=19)),
        run_config=RunConfig(storage_path=str(tmp_path))))
    stopped = {t.config["q"] for t in grid._trials if t.state == "STOPPED"}
    # Each weak trial reaches rung 2 after a strong peer: stopped there.
    assert {0.1, 0.2} <= stopped, stopped
    assert grid.get_best_result().metrics["acc"] > 1.0
    assert not grid.errors


def test_hyperband_integration_finds_best(tmp_path, jax_fabric):
    grid = fit(tune.Tuner(
        objective_hyperband,
        param_space={"quality": tune.grid_search([0.1, 0.5, 1.0, 5.0])},
        tune_config=cpu(
            metric="score", mode="max", max_concurrent_trials=4,
            scheduler=tune.HyperBandScheduler(
                metric="score", max_t=9, reduction_factor=3)),
        run_config=RunConfig(storage_path=str(tmp_path / "port"))))
    best = grid.get_best_result()
    assert best.metrics["score"] == pytest.approx(5.0 * 9)
    import raytpu.tune as jtune

    want = jax_fit(
        objective_hyperband,
        {"quality": jtune.grid_search([0.1, 0.5, 1.0, 5.0])},
        tmp_path / "jax", metric="score", mode="max",
        max_concurrent_trials=4,
        scheduler=jtune.HyperBandScheduler(metric="score", max_t=9,
                                           reduction_factor=3))
    assert want.get_best_result().config == best.config


def test_dataframe(tmp_path):
    grid = fit(tune.Tuner(
        objective_x, param_space={"x": tune.grid_search([1, 2])},
        tune_config=cpu(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path))))
    df = grid.get_dataframe()
    assert len(df) == 2
    assert "config/x" in df.columns
    assert sorted(df["score"]) == [1, 2]


def test_completed_trials_release_their_processes(tmp_path):
    """Each trial process ends when its trial completes, so a backfilled
    trial takes its place (the JAX test reads the freed CPU
    reservations; the port's runtime has none, so it reads the
    processes)."""
    before = children()
    grid = fit(tune.Tuner(
        objective_v, param_space={"x": tune.grid_search(list(range(6)))},
        tune_config=cpu(metric="v", mode="max", max_concurrent_trials=2,
                        resources_per_trial={"CPU": 2}),
        run_config=RunConfig(storage_path=str(tmp_path))))
    assert len(grid) == 6
    assert grid.get_best_result().metrics["v"] == 5
    assert children() <= before


def test_searcher_sees_consistent_ids(tmp_path):
    searcher = RecordingSearcher()
    fit(tune.Tuner(
        objective_v,
        tune_config=cpu(metric="v", mode="max", num_samples=3,
                        search_alg=searcher),
        run_config=RunConfig(storage_path=str(tmp_path))))
    assert len(searcher.suggested) == 3
    assert sorted(searcher.completed) == sorted(searcher.suggested)


def test_checkpoint_num_to_keep_honored(tmp_path):
    run_config = RunConfig(
        storage_path=str(tmp_path / "keep"),
        checkpoint_config=CheckpointConfig(num_to_keep=2))
    grid = fit(tune.Tuner(
        objective_keep, param_space={"x": tune.grid_search([1])},
        tune_config=cpu(metric="v", mode="max"), run_config=run_config))
    trial = grid._trials[0]
    trial_dir = None
    for root, dirs, _ in os.walk(str(tmp_path / "keep")):
        if trial.trial_id in dirs:
            trial_dir = os.path.join(root, trial.trial_id)
    assert trial_dir is not None
    kept = [d for d in os.listdir(trial_dir) if d.startswith("checkpoint")]
    assert len(kept) == 2, kept
    # The registered snapshots were moved, the rest swept.
    staged = os.path.join(os.path.dirname(trial_dir), ".staged_ckpts")
    assert not os.listdir(staged) if os.path.isdir(staged) else True


def test_ask_tell_adapter_drives_tuner(tmp_path, jax_fabric):
    proposals = [{"x": 5.0}, {"x": 2.0}, {"x": 0.5}, {"x": 1.0}]

    def run(pkg, path):
        told, state = [], {"i": 0}

        def ask():
            cfg = proposals[state["i"] % len(proposals)]
            state["i"] += 1
            return state["i"], cfg

        searcher = pkg.AskTellSearcher(ask, lambda t, s: told.append((t, s)),
                                       metric="loss", mode="min")
        kw = {"device": "cpu"} if pkg is tune else {}
        grid = pkg.Tuner(
            objective_distance_to_1,
            tune_config=pkg.TuneConfig(
                metric="loss", mode="min", num_samples=4,
                max_concurrent_trials=4, search_alg=searcher, **kw),
            run_config=(RunConfig if pkg is tune else jax_run_config)(
                storage_path=str(path))).fit()
        return grid, dict(told)

    from raytpu.train.config import RunConfig as jax_run_config

    import raytpu.tune as jtune

    grid, by_token = run(tune, tmp_path / "port")
    assert grid.get_best_result().config["x"] == 1.0
    assert len(by_token) == 4
    # min mode: the adapter hands larger-is-better scores to tell
    assert by_token[4] == 0.0  # x=1 -> loss 0 -> score -0.0
    assert by_token[1] == -16.0  # x=5 -> loss 16 -> score -16
    want, want_tokens = run(jtune, tmp_path / "jax")
    assert want_tokens == by_token
    assert want.get_best_result().config == grid.get_best_result().config


def test_optuna_searcher_with_mocked_optuna(tmp_path, monkeypatch):
    """OptunaSearcher drives a Tuner run against a faked optuna module
    (the real package is on neither machine). The fake study does not
    pickle, so the experiment state is written without the searcher."""

    class FakeDist:
        def __init__(self, *a, **k):
            self.args = a
            self.kwargs = k

    class FakeTrial:
        def __init__(self, number, params):
            self.number = number
            self.params = params

    class FakeStudy:
        def __init__(self):
            self.n = 0
            self.told = []

        def ask(self, distributions):
            params = {}
            for name, d in distributions.items():
                lo, hi = d.args[0], d.args[1]
                params[name] = lo + (hi - lo) * (self.n % 5) / 4.0
            t = FakeTrial(self.n, params)
            self.n += 1
            return t

        def tell(self, trial, value):
            self.told.append((trial.number, value))

    fake = types.ModuleType("optuna")
    fake.distributions = types.SimpleNamespace(
        CategoricalDistribution=FakeDist, FloatDistribution=FakeDist,
        IntDistribution=FakeDist)
    fake.samplers = types.SimpleNamespace(TPESampler=lambda seed=None: None)
    fake.create_study = lambda direction=None, sampler=None: FakeStudy()
    monkeypatch.setitem(sys.modules, "optuna", fake)

    space = {"x": tune.uniform(0.0, 4.0), "const": 7}
    searcher = tune.OptunaSearcher(space, metric="loss", mode="min")
    grid = fit(tune.Tuner(
        objective_distance_to_2,
        tune_config=cpu(metric="loss", mode="min", num_samples=5,
                        max_concurrent_trials=5, search_alg=searcher),
        run_config=RunConfig(name="optuna", storage_path=str(tmp_path))))
    best = grid.get_best_result()
    assert best.metrics["loss"] == 0.0 and best.config["x"] == 2.0
    assert len(searcher._study.told) == 5
    assert min(v for _, v in searcher._study.told) == 0.0
    with pytest.raises(ValueError, match="did not pickle"):
        tune.Tuner.restore(str(tmp_path / "optuna"))


def test_guards_raise(tmp_path, monkeypatch):
    """A trainable that does not pickle, an unknown resource and an
    unknown device are refused at fit, and start no process."""
    before = children()

    def closure(config):
        report({"v": 1})

    for tuner, match in (
            (tune.Tuner(closure, tune_config=cpu()), "does not pickle"),
            (tune.Tuner(objective_v, tune_config=cpu(
                resources_per_trial={"CPU": 1, "TPU": 1})), "'TPU'"),
            (tune.Tuner(objective_v, tune_config=tune.TuneConfig(
                device="tpu")), "device='tpu'")):
        tuner.run_config = RunConfig(storage_path=str(tmp_path))
        with pytest.raises(ValueError, match=match):
            tuner.fit()
    assert children() <= before
