"""The port's searchers and schedulers (raytpu_torch/tune) held to the JAX
package's at object level, with no process: the same seeds and the same
scripted result streams through both packages give the same configs
(grid x samples, TPE, BOHB fed intermediate results), the same
CONTINUE/STOP decisions and rung statistics (ASHA, HyperBand) and the
same PBT exploits and perturbations; each round-trips through the
standard ``pickle`` and goes on as before. The experiments that
tests/test_tune.py runs with 20-40 trials are held here, where a trial
costs nothing: the port's tuner tests (tests/test_torch_tune*.py) start
a process a trial."""

import pickle
import random

import numpy as np
import pytest

import raytpu_torch.tune as ptune
from raytpu_torch.tune.schedulers import CONTINUE, STOP


class T:
    """What a scheduler reads of a trial."""

    def __init__(self, tid, config=None):
        self.trial_id = tid
        self.config = dict(config or {})
        self.last_result = {}
        self.checkpoint = "c"


def spaces(tune):
    """One space of every kind, built through a package's own API."""
    return {"a": tune.grid_search([1, 2, 3]), "b": 7,
            "c": tune.choice(["x", "y", "z"]), "d": tune.uniform(-2, 5),
            "e": tune.loguniform(1e-5, 1e-1), "f": tune.randint(3, 40),
            "g": tune.qrandint(0, 100, 7)}


def double_bump(rng):
    """A custom domain's sampler (module level: it pickles by name)."""
    return 2 * rng.random()


def quadratic(cfg):
    return (cfg["x"] - 2.0) ** 2 + (cfg["y"] + 1.0) ** 2


def tpe_configs(tune, seed=0, n=40):
    """tests/test_tune.py's TPE experiment (40 suggestions on the
    quadratic, one trial at a time) with its results fed in turn."""
    s = tune.TPESearcher({"x": tune.uniform(-10, 10),
                          "y": tune.uniform(-10, 10)},
                         metric="loss", mode="min", n_startup=8, seed=seed)
    cfgs = []
    for i in range(n):
        cfg = s.suggest(f"t{i}")
        cfgs.append(cfg)
        s.on_trial_complete(f"t{i}", {"loss": quadratic(cfg)})
    return cfgs, s


def bohb_run(tune, schedulers_mod, seed=0, n=20):
    """tests/test_tune.py's BOHB experiment at object level, one trial at
    a time: HyperBand (max_t 8, factor 2) judges each result, BOHB sees
    every intermediate result and each completion."""
    space = {"x": tune.uniform(0.0, 1.0)}
    s = tune.BOHBSearcher(space, metric="score", mode="max", n_startup=6,
                          min_points_per_rung=4, seed=seed)
    hb = tune.HyperBandScheduler(metric="score", mode="max", max_t=8,
                                 reduction_factor=2)
    log = []
    for n_trial in range(n):
        tid = f"t{n_trial}"
        trial = T(tid, s.suggest(tid))
        last = {}
        for i in range(8):
            score = 1.0 - (trial.config["x"] - 0.7) ** 2 + 0.01 * i
            last = {"score": score, "training_iteration": i + 1}
            s.on_trial_result(tid, last)
            d = hb.on_result(trial, last)
            log.append((tid, i + 1, d))
            if d == schedulers_mod.STOP:
                break
        s.on_trial_complete(tid, last)
        hb.on_trial_remove(trial)
        log.append((tid, "config", trial.config))
    return log, s, hb


def event_stream(seed, n_trials=12, max_iter=20):
    """Interleaved results of ``n_trials`` trials, each reporting every
    1-3 iterations (so some skip rung values), in a seeded order."""
    rng = np.random.default_rng(seed)
    quality = rng.uniform(0.1, 2.0, n_trials)
    clocks = [0] * n_trials
    events = []
    while True:
        live = [i for i in range(n_trials) if clocks[i] < max_iter]
        if not live:
            return events
        i = int(rng.choice(live))
        clocks[i] += int(rng.integers(1, 4))
        events.append((f"t{i}", clocks[i],
                       float(quality[i] * clocks[i]
                             + rng.normal(0, 0.3))))


def judge(sched, events, stop_mod):
    """Feed a scheduler a stream; stopped trials report no more. The
    decisions in order."""
    trials, stopped, out = {}, set(), []
    for tid, it, value in events:
        if tid in stopped:
            continue
        trial = trials.setdefault(tid, T(tid))
        d = sched.on_result(trial, {"m": value, "training_iteration": it})
        out.append((tid, it, d))
        if d == stop_mod.STOP:
            stopped.add(tid)
            sched.on_trial_remove(trial)
    return out


# ---- the sample space --------------------------------------------------


def test_grid_expansion():
    gen = ptune.BasicVariantGenerator(
        {"a": ptune.grid_search([1, 2, 3]), "b": 7}, num_samples=2)
    cfgs = [gen.suggest(str(i)) for i in range(6)]
    assert all(c is not None for c in cfgs)
    assert gen.suggest("x") is None
    assert sorted(c["a"] for c in cfgs) == [1, 1, 2, 2, 3, 3]
    assert all(c["b"] == 7 for c in cfgs)


def test_samplers():
    rng = random.Random(0)
    assert ptune.choice([1, 2]).sample(rng) in (1, 2)
    assert 0.0 <= ptune.uniform(0, 1).sample(rng) <= 1.0
    v = ptune.loguniform(1e-4, 1e-1).sample(rng)
    assert 1e-4 <= v <= 1e-1
    assert 5 <= ptune.randint(5, 9).sample(rng) < 9


def test_every_domain_draws_the_jax_package_s_numbers():
    from raytpu.tune import search as jsearch

    import raytpu.tune as jtune

    for seed in (0, 1, 17):
        got, want = spaces(ptune), spaces(jtune)
        got["h"] = ptune.search.Domain(double_bump)
        want["h"] = jsearch.Domain(double_bump)
        r_got, r_want = random.Random(seed), random.Random(seed)
        for _ in range(25):
            assert ptune.search.sample_config(got, r_got) == \
                jsearch.sample_config(want, r_want)
        assert r_got.getstate() == r_want.getstate()


@pytest.mark.parametrize("num_samples,seed", [(1, 3), (3, 0), (4, 11)])
def test_basic_variant_generator_matches_the_jax_package(num_samples, seed):
    import raytpu.tune as jtune

    got = ptune.BasicVariantGenerator(spaces(ptune), num_samples, seed)
    want = jtune.BasicVariantGenerator(spaces(jtune), num_samples, seed)
    assert got.total() == want.total() == 3 * num_samples
    g = [got.suggest(str(i)) for i in range(got.total() + 1)]
    w = [want.suggest(str(i)) for i in range(want.total() + 1)]
    assert g == w and g[-1] is None


def test_tpe_matches_the_jax_package_and_steers():
    import raytpu.tune as jtune

    got, _ = tpe_configs(ptune)
    want, _ = tpe_configs(jtune)
    assert got == want
    losses = [quadratic(c) for c in got]
    # tests/test_tune.py's bounds on the same 40 suggestions.
    assert min(losses) < 2.0, min(losses)
    assert np.mean(losses[20:]) < np.mean(losses[:20])


def test_searcher_abc_surface():
    s = ptune.TPESearcher({"x": ptune.uniform(0, 1)}, metric="m")
    assert isinstance(s, ptune.Searcher)
    cfg = s.suggest("t1")
    assert 0 <= cfg["x"] <= 1
    s.on_trial_complete("t1", {"m": 1.0})


def test_bohb_matches_the_jax_package_and_converges():
    import raytpu.tune as jtune
    from raytpu.tune import schedulers as jsched

    from raytpu_torch.tune import schedulers as psched

    got, s, hb = bohb_run(ptune, psched)
    want, js, jhb = bohb_run(jtune, jsched)
    assert got == want
    assert dict(hb.rung_results) == dict(jhb.rung_results)
    configs = [e[2] for e in got if e[1] == "config"]
    best = max(configs, key=lambda c: 1.0 - (c["x"] - 0.7) ** 2)
    assert abs(best["x"] - 0.7) < 0.25, best
    assert s._rung_obs, "no rung observations recorded"


def test_bohb_uses_highest_rung():
    s = ptune.BOHBSearcher({"x": ptune.uniform(0, 1)}, metric="m",
                           min_points_per_rung=2, n_startup=100, seed=0)
    for i, tid in enumerate(["a", "b", "c"]):
        s.suggest(tid)
        s.on_trial_result(tid, {"training_iteration": 1, "m": i})
        if tid != "c":
            s.on_trial_result(tid, {"training_iteration": 4, "m": 10 * i})
    good, bad = s._split()
    scores = sorted([g[1] for g in good] + [b[1] for b in bad])
    assert scores == [0.0, 10.0]
    assert s._model_ready()


# ---- the schedulers ----------------------------------------------------


def test_asha_rung_geq_not_equality():
    """A trial reporting every 2 iterations must still hit odd rungs."""
    sched = ptune.ASHAScheduler(metric="m", grace_period=1,
                                reduction_factor=3, max_t=100)
    strong, weak = T("strong"), T("weak")
    for it in (2, 4, 10):
        assert sched.on_result(strong, {"m": 100.0,
                                        "training_iteration": it}) \
            == CONTINUE
    assert sched.on_result(weak, {"m": 0.1, "training_iteration": 2}) \
        == STOP


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    {"grace_period": 1, "reduction_factor": 3, "max_t": 20},
    {"grace_period": 2, "reduction_factor": 2, "max_t": 19},
    {"grace_period": 2, "reduction_factor": 2, "max_t": 6, "mode": "min"},
])
def test_asha_matches_the_jax_package(kw, seed):
    import raytpu.tune as jtune
    from raytpu.tune import schedulers as jsched

    from raytpu_torch.tune import schedulers as psched

    events = event_stream(seed)
    got = ptune.ASHAScheduler(metric="m", **kw)
    want = jtune.ASHAScheduler(metric="m", **kw)
    assert got.rungs == want.rungs
    assert judge(got, events, psched) == judge(want, events, jsched)
    assert dict(got.rung_results) == dict(want.rung_results)


def test_hyperband_bracket_ladders():
    hb = ptune.HyperBandScheduler(metric="m", max_t=27, reduction_factor=3)
    assert hb.brackets == [[1, 3, 9], [3, 9], [9], []]
    # Integer arithmetic: log(243)/log(3) truncates to 4 in floats.
    assert len(ptune.HyperBandScheduler(metric="m", max_t=243).brackets) \
        == 6


def test_hyperband_within_bracket_halving_decisions():
    hb = ptune.HyperBandScheduler(metric="m", max_t=9, reduction_factor=3)
    t1, t2, t3, t4 = T("a"), T("b"), T("c"), T("d")
    assert hb.on_result(t1, {"training_iteration": 1, "m": 1.0}) == CONTINUE
    assert hb.on_result(t2, {"training_iteration": 1, "m": 0.5}) == CONTINUE
    assert hb.on_result(t3, {"training_iteration": 1, "m": 0.5}) == CONTINUE
    assert hb.on_result(t4, {"training_iteration": 1, "m": 0.1}) == STOP
    assert hb.on_result(t1, {"training_iteration": 9, "m": 9.0}) == STOP


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("max_t,eta", [(9, 3), (20, 2), (27, 3)])
def test_hyperband_matches_the_jax_package(max_t, eta, seed):
    import raytpu.tune as jtune
    from raytpu.tune import schedulers as jsched

    from raytpu_torch.tune import schedulers as psched

    events = event_stream(seed, max_iter=max_t)
    got = ptune.HyperBandScheduler(metric="m", max_t=max_t,
                                   reduction_factor=eta)
    want = jtune.HyperBandScheduler(metric="m", max_t=max_t,
                                    reduction_factor=eta)
    assert got.brackets == want.brackets
    assert judge(got, events, psched) == judge(want, events, jsched)
    assert dict(got.rung_results) == dict(want.rung_results)


def test_pbt_ranks_live_trials_only():
    sched = ptune.PopulationBasedTraining(
        metric="m", perturbation_interval=1, quantile_fraction=0.5, seed=0)
    dead1, dead2 = T("dead1", {"lr": 1.0}), T("dead2", {"lr": 1.0})
    top, low = T("top", {"lr": 1.0}), T("low", {"lr": 1.0})
    for t, v in ((dead1, -10.0), (dead2, -9.0), (top, 5.0), (low, 1.0)):
        t.last_result = {"m": v, "training_iteration": 1}
        sched.on_result(t, t.last_result)
    sched.on_trial_remove(dead1)
    sched.on_trial_remove(dead2)
    assert sched.exploit_target(low) is top


def halve(x=None):
    """A PBT mutation given as a function (module level)."""
    return 0.5


def pbt_run(tune, seed):
    """A population of eight reporting for twelve iterations; every
    trial asks for an exploit target after each result, and each target
    found is perturbed. The targets and new configs in order."""
    sched = tune.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=3, seed=seed,
        quantile_fraction=0.25,
        hyperparam_mutations={"lr": [1e-3, 1e-2, 1e-1],
                              "wd": tune.uniform(0.0, 0.3),
                              "mom": halve, "width": None})
    rng = np.random.default_rng(seed)
    pop = [T(f"t{i}", {"lr": 1e-2, "wd": 0.1, "mom": 0.9,
                       "width": 64 + i}) for i in range(8)]
    out = []
    for it in range(1, 13):
        for trial in pop:
            trial.last_result = {"m": float(rng.normal()),
                                 "training_iteration": it}
            sched.on_result(trial, trial.last_result)
            target = sched.exploit_target(trial)
            if target is not None:
                out.append((trial.trial_id, it, target.trial_id,
                            sched.perturb(target.config)))
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_pbt_exploits_and_perturbs_as_the_jax_package(seed):
    import raytpu.tune as jtune

    got, want = pbt_run(ptune, seed), pbt_run(jtune, seed)
    assert got == want
    assert got, "no exploit in twelve iterations"


# ---- pickling ----------------------------------------------------------


def test_searchers_and_schedulers_go_on_after_a_pickle_round_trip():
    _, tpe = tpe_configs(ptune, n=12)
    bvg = ptune.BasicVariantGenerator(spaces(ptune), 2, seed=3)
    bvg.suggest("first")
    _, bohb, hb = bohb_run(ptune, ptune.schedulers, n=6)
    asha = ptune.ASHAScheduler(metric="m", grace_period=1,
                               reduction_factor=2, max_t=16)
    events = event_stream(4)
    judge(asha, events[:40], ptune.schedulers)
    pbt = ptune.PopulationBasedTraining(
        metric="m", seed=1, hyperparam_mutations={"wd": ptune.uniform(0, 1)})
    for obj in (tpe, bvg, bohb):
        copy = pickle.loads(pickle.dumps(obj))
        assert [copy.suggest(f"n{i}") for i in range(3)] == \
            [obj.suggest(f"n{i}") for i in range(3)]
    for obj in (hb, asha):
        copy = pickle.loads(pickle.dumps(obj))
        assert judge(copy, events[40:], ptune.schedulers) == \
            judge(obj, events[40:], ptune.schedulers)
    copy = pickle.loads(pickle.dumps(pbt))
    assert copy.perturb({"wd": 0.5}) == pbt.perturb({"wd": 0.5})


# ---- external searchers ------------------------------------------------


def test_failed_trial_reported_to_external_optimizer():
    failed = []
    s = ptune.AskTellSearcher(lambda: ("tok", {"x": 1.0}), lambda t, v: None,
                              metric="loss", mode="min",
                              tell_failure=failed.append)
    assert s.suggest("t1") == {"x": 1.0}
    s.on_trial_complete("t1", {})  # no metric: trial errored
    assert failed == ["tok"]
    assert s._tokens == {}


def test_optuna_searcher_raises_without_optuna(monkeypatch):
    import sys

    import raytpu.tune as jtune

    monkeypatch.setitem(sys.modules, "optuna", None)  # import fails
    for tune in (ptune, jtune):
        with pytest.raises(ImportError, match="requires the 'optuna'"):
            tune.OptunaSearcher({"x": tune.uniform(0, 1)}, metric="m")
