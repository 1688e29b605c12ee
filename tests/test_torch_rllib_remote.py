"""The port's remote env runners and IMPALA/APPO's asynchronous path
(raytpu_torch/rllib over raytpu_torch/runtime) on the CPU, held to the
JAX package: greedy evaluation through two runner processes equal to the
JAX group's; a remote runner's fragment equal to a local one's to the
bit; PPO, IMPALA, APPO and DQN training with runner processes; the
fragments IMPALA and APPO consumed, replayed through the JAX learners
from the same weights, ending at the same weights; an env whose creator
does not pickle refused at build; a runner that raises, or dies, named
at ``train()``.

Runner processes import this module by name (to rebuild the env
creators and the functions run in them below), so it imports JAX and the
JAX package only inside the tests."""

import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from raytpu_torch import runtime
from raytpu_torch.core.errors import ActorDiedError, TaskError
from raytpu_torch.rllib import (APPOConfig, CartPoleEnv, DQNConfig,
                                IMPALAConfig, PPOConfig, register_env)
from raytpu_torch.rllib.convert import params_from_jax
from raytpu_torch.rllib.env.env_runner import (EnvRunnerGroup,
                                               SingleAgentEnvRunner)

# Seconds a blocking call of the tests themselves may take.
T = 60.0
# The module test's bound on the logits (relative to their scale).
LOGIT_TOL = 1e-5
# fp32 parameters after a replayed run, relative norm a tensor (the bound
# the JAX package holds fp32 gradients to, tests/test_ops.py).
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as each runner process has (num_cpus=1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _children() -> set:
    return {p.pid for p in multiprocessing.active_children()}


def _pids(algo) -> set:
    return {r.pid for r in algo.env_runner_group.remote_runners}


def _stop(algo) -> None:
    pids = _pids(algo)
    algo.stop()
    assert not pids & _children()


# ---- run inside the runner processes ----------------------------------


def record_logits(runner):
    """Record every logits tensor the runner's module computes."""
    forward = runner.module.forward_train
    runner.seen_logits = []

    def recording(params, obs):
        logits, vf = forward(params, obs)
        runner.seen_logits.append(logits.detach())
        return logits, vf

    runner.module.forward_train = recording
    return True


def logit_margin(runner):
    """(forwards, smallest top-two margin, largest |logit|)."""
    logits = torch.cat(runner.seen_logits)
    top2 = logits.topk(2, dim=-1).values
    return (len(runner.seen_logits), float((top2[:, 0] - top2[:, 1]).min()),
            float(logits.abs().max()))


def make_cartpole(config):
    """A module-level creator: it pickles, so runner processes can use
    it."""
    return CartPoleEnv(config)


class FailingCartPole(CartPoleEnv):
    def step(self, action):
        raise RuntimeError("the env failed on purpose")


register_env("remote-test-cartpole", make_cartpole)
register_env("remote-test-failing", FailingCartPole)


# ---- the cases ---------------------------------------------------------


def _cartpole(cls, runners=2, **training):
    return (cls().environment("CartPole-v1")
            .env_runners(num_env_runners=runners, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(**training).debugging(seed=0))


def test_greedy_remote_evaluate_equals_the_jax_package_s(raytpu_local):
    from raytpu.rllib import PPOConfig as JaxPPOConfig

    def config(cls):
        return (cls().environment("CartPole-v1")
                .env_runners(num_env_runners=2)
                .evaluation(evaluation_num_episodes=4).debugging(seed=0))

    jax_algo = config(JaxPPOConfig).build()
    weights = jax_algo.learner.get_weights()
    # pi_out scaled up, in both packages, so logits are O(1) and their
    # top-two margins far above the arithmetic's differences.
    weights["pi_out"] = {k: v * 100 for k, v in weights["pi_out"].items()}
    jax_algo.learner.set_weights(weights)
    jax_algo.env_runner_group.sync_weights(weights)
    algo = config(PPOConfig).resources(device="cpu").build()
    algo.learner.set_weights(params_from_jax(weights))
    algo.env_runner_group.sync_weights(algo.learner.get_weights())
    runners = algo.env_runner_group.remote_runners
    assert runtime.get([runtime.call(r, record_logits) for r in runners],
                       timeout=T) == [True, True]

    got, want = algo.evaluate(), jax_algo.evaluate()
    assert got == want and got["num_episodes"] == 4
    for n, margin, scale in runtime.get(
            [runtime.call(r, logit_margin) for r in runners], timeout=T):
        assert n >= 2 * 5
        assert margin > 10 * LOGIT_TOL * scale, margin
    _stop(algo)
    jax_algo.stop()


def test_remote_fragment_equals_the_local_runner_s_to_the_bit():
    spec = PPOConfig().environment("CartPole-v1").rl_module_spec()
    config = {"env": "CartPole-v1", "env_config": {}, "module_spec": spec,
              "rollout_fragment_length": 16, "num_envs_per_env_runner": 3,
              "seed": 4, "gamma": 0.99, "env_to_module_connectors": [],
              "module_to_env_connectors": [], "device": "cpu"}
    group = EnvRunnerGroup(config, 1)
    local = SingleAgentEnvRunner({**config, "worker_index": 1})
    weights = {k: torch.randn(v.shape, generator=torch.Generator()
                              .manual_seed(i))
               for i, (k, v) in enumerate(local.get_weights().items())}
    local.set_weights(weights)
    group.sync_weights(weights)
    for _ in range(2):  # the runners' state carries across fragments
        [remote] = group.sample()
        mine = local.sample()
        assert set(remote) == set(mine)
        for k, v in mine.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == remote[k].dtype, k
                assert np.array_equal(v, remote[k]), k
            else:
                assert v == remote[k], k
    pids = {r.pid for r in group.remote_runners}
    group.stop()
    assert not pids & _children()


def test_ppo_remote_runners_and_eval():
    algo = (_cartpole(PPOConfig, lr=3e-4, num_epochs=4, minibatch_size=64)
            .evaluation(evaluation_interval=2, evaluation_num_episodes=2)
            .resources(device="cpu")).build()
    assert len(algo.env_runner_group.remote_runners) == 2
    assert len(algo.env_runner_group.startup_s) == 2
    r1 = algo.train()
    r2 = algo.train()
    assert "evaluation" in r2 and "evaluation" not in r1
    assert r2["evaluation"]["episode_return_mean"] > 0
    assert r2["evaluation"]["num_episodes"] == 2
    assert r1["timesteps_total"] == 2 * 2 * 32
    assert r2["timesteps_total"] == 2 * 2 * 2 * 32
    assert np.isfinite(r2["total_loss"])
    _stop(algo)


ASYNC = {"IMPALA": IMPALAConfig, "APPO": APPOConfig}
ASYNC_TRAINING = {"lr": 5e-4, "entropy_coeff": 0.01,
                  "num_fragments_per_step": 4}


@pytest.fixture(scope="module", params=sorted(ASYNC))
def async_run(request):
    """Ten iterations of IMPALA or APPO with two runner processes (2 envs
    x 32 steps each, 4 fragments a step) from the JAX learner's initial
    weights: the returns, the learner's calls in order (each update's
    batch, each target sync), and the JAX algorithm to replay them on."""
    from raytpu.rllib import APPOConfig as JaxAPPOConfig
    from raytpu.rllib import IMPALAConfig as JaxIMPALAConfig

    name = request.param
    jax_cls = {"IMPALA": JaxIMPALAConfig, "APPO": JaxAPPOConfig}[name]
    jax_algo = _cartpole(jax_cls, runners=0, **ASYNC_TRAINING).build()
    start = jax_algo.learner.get_weights()
    algo = _cartpole(ASYNC[name], **ASYNC_TRAINING).resources(
        device="cpu").build()
    algo.learner.set_weights(params_from_jax(start))
    if name == "APPO":
        algo.learner.sync_target()
    algo.env_runner_group.sync_weights(algo.learner.get_weights())
    calls = []
    update, learner = algo.learner.update, algo.learner

    def recording_update(batch):
        calls.append(("update", {k: v.copy() for k, v in batch.items()}))
        return update(batch)

    learner.update = recording_update
    if name == "APPO":
        sync = learner.sync_target

        def recording_sync():
            calls.append(("sync_target", None))
            sync()

        learner.sync_target = recording_sync
    results = [algo.train() for _ in range(10)]
    weights = algo.learner.get_weights()
    _stop(algo)
    yield {"name": name, "results": results, "calls": calls,
           "weights": weights, "jax_algo": jax_algo, "start": start,
           "jax_cls": jax_cls}
    jax_algo.stop()


def test_async_returns_rise(async_run):
    returns = [r["episode_return_mean"] for r in async_run["results"]]
    assert returns[-1] > returns[0], returns
    assert [r["timesteps_total"] for r in async_run["results"]] == \
        [4 * 64 * (i + 1) for i in range(10)]


def test_async_step_replayed_through_the_jax_learner(async_run):
    calls = async_run["calls"]
    updates = [c for c in calls if c[0] == "update"]
    assert len(updates) == 10 * 4
    syncs = [i for i, c in enumerate(calls) if c[0] == "sync_target"]
    if async_run["name"] == "APPO":
        # target_network_update_freq=2 against the iterations done before
        # the step (0, 2, 4, ...): after the four updates of the 1st,
        # 3rd, ..., 9th train() call.
        assert syncs == [4 * k + (k - 1) // 2 for k in (1, 3, 5, 7, 9)], \
            syncs
    else:
        assert syncs == []
    jl = async_run["jax_algo"].learner
    for kind, batch in calls:
        if kind == "update":
            jl.update(batch)
        else:
            jl.sync_target()
    want = params_from_jax(jl.get_weights())
    got = async_run["weights"]
    assert set(got) == set(want)
    for k in want:
        rel = float((got[k] - want[k]).norm() / want[k].norm())
        assert rel <= TOL, (k, rel)


def test_async_step_replayed_update_by_update(async_run):
    """The replay above one update at a time, through a fresh port
    learner beside a fresh JAX learner from the same weights. The fresh
    port learner ends at the live one's weights to the bit, so the gap is
    all in the update's arithmetic and none in the asynchronous path.
    After every update each tensor is within TOL of the JAX one relative
    to its scale, the largest norm it has had in the replay: the policy's
    output bias (two values) passes near zero (to 4.1e-6), where its
    relative gap reads up to 2.75e-3 from an absolute one of 2.4e-8
    (ROADMAP.md, Queue 3)."""
    name = async_run["name"]
    start = async_run["start"]
    jax_algo = _cartpole(async_run["jax_cls"], runners=0,
                         **ASYNC_TRAINING).build()
    algo = _cartpole(ASYNC[name], runners=0, **ASYNC_TRAINING).resources(
        device="cpu").build()
    try:
        jl, pl = jax_algo.learner, algo.learner
        jl.set_weights(start)
        pl.set_weights(params_from_jax(start))
        if name == "APPO":
            jl.sync_target()
            pl.sync_target()
        scale: dict = {}
        worst = (0.0, None, None)
        for i, (kind, batch) in enumerate(async_run["calls"]):
            if kind == "update":
                jl.update(batch)
                pl.update(batch)
            else:
                jl.sync_target()
                pl.sync_target()
            want = params_from_jax(jl.get_weights())
            got = pl.get_weights()
            for k in want:
                scale[k] = max(scale.get(k, 0.0), float(want[k].norm()))
                gap = float((got[k] - want[k]).norm()) / scale[k]
                worst = max(worst, (gap, i, k))
        assert worst[0] <= TOL, worst
        live = async_run["weights"]
        assert all(torch.equal(got[k], live[k]) for k in live)
    finally:
        algo.stop()
        jax_algo.stop()


def test_dqn_with_remote_runners_trains():
    algo = (_cartpole(DQNConfig, num_steps_sampled_before_learning_starts=64,
                      train_batch_size=32)
            .resources(device="cpu")).build()
    r = algo.train()
    assert r["timesteps_total"] == 2 * 2 * 32
    assert r["replay_size"] > 0 and np.isfinite(r["qf_loss"])
    assert 0.0 < r["epsilon"] < 1.0
    _stop(algo)


def test_an_env_whose_creator_does_not_pickle_is_refused_at_build():
    register_env("remote-test-lambda", lambda cfg: CartPoleEnv(cfg))

    def closure_env():
        def create(cfg):
            return CartPoleEnv(cfg)
        return create

    register_env("remote-test-closure", closure_env())
    before = _children()
    for name in ("remote-test-lambda", "remote-test-closure"):
        with pytest.raises(ValueError, match=name):
            (PPOConfig().environment(name).env_runners(num_env_runners=2)
             .resources(device="cpu")).build()
    assert _children() <= before  # refused before any process started
    # A module-level creator, registered in this process only, reaches
    # the runner process.
    algo = (PPOConfig().environment("remote-test-cartpole")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .training(minibatch_size=16, num_epochs=1)
            .debugging(seed=0).resources(device="cpu")).build()
    assert algo.train()["timesteps_total"] == 32
    _stop(algo)


def test_a_runner_that_raises_surfaces_in_train_with_its_traceback():
    algo = (PPOConfig().environment("remote-test-failing")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                         rollout_fragment_length=16)
            .debugging(seed=0).resources(device="cpu")).build()
    with pytest.raises(TaskError) as info:
        algo.train()
    text = str(info.value)
    assert "the env failed on purpose" in text
    assert "Traceback" in text and "in _sample" in text  # the child's frames
    _stop(algo)


def test_a_runner_killed_mid_step_raises_actor_died_error():
    algo = (_cartpole(IMPALAConfig, num_fragments_per_step=4)
            .resources(device="cpu")).build()
    algo.train()  # each runner now has a fragment in flight
    victim = algo.env_runner_group.remote_runners[0]
    os.kill(victim.pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError, match=str(victim.pid)):
        for _ in range(3):
            algo.train()
    assert time.monotonic() - t0 < 10.0
    _stop(algo)
