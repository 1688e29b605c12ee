"""The port's algorithms (raytpu_torch/rllib) end to end on the CPU,
through the JAX package's entry points (``PPOConfig()...build()``,
``train``, ``evaluate``, ``save``, ``restore``, ``stop``): greedy
evaluation equal to the JAX package's on the same weights and env seeds,
and a few iterations of every other algorithm; and what the port does not
have (remote runners) raises. PPO learning CartPole is
tests/test_torch_rllib_learning.py."""

import numpy as np
import pytest
import torch

import raytpu.data as rd
from raytpu.rllib import FrameStack as JaxFrameStack
from raytpu.rllib import PPOConfig as JaxPPOConfig
from raytpu_torch.rllib import (APPOConfig, BCConfig, CartPoleEnv, CQLConfig,
                                DQNConfig, FrameStack, IMPALAConfig,
                                MARWILConfig, PendulumEnv, PPOConfig,
                                SACConfig)
from raytpu_torch.rllib.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the nets here are tiny, and the test runner's
    parallel workers would otherwise each start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# The module test's bound on the logits (relative to their scale).
LOGIT_TOL = 1e-5


def _finite(result, *keys):
    for k in keys:
        assert np.isfinite(result[k]), (k, result)


@pytest.mark.parametrize("env,connector", [("CartPole-v1", None),
                                           ("Catch-v0", 2)])
def test_greedy_evaluate_equals_the_jax_package_s(env, connector,
                                                 raytpu_local):
    def config(cls, stack):
        c = (cls().environment(env).env_runners(num_env_runners=0)
             .evaluation(evaluation_num_episodes=3).debugging(seed=0))
        return c.connectors(env_to_module=[stack(connector)]) \
            if connector else c

    jax_algo = config(JaxPPOConfig, JaxFrameStack).build()
    weights = jax_algo.learner.get_weights()
    # pi_out scaled up, in both packages, so logits are O(1) and their
    # top-two margins far above the arithmetic's differences.
    weights["pi_out"] = {k: v * 100 for k, v in weights["pi_out"].items()}
    jax_algo.learner.set_weights(weights)
    jax_algo.env_runner_group.sync_weights(weights)
    algo = config(PPOConfig, FrameStack).resources(device="cpu").build()
    algo.learner.set_weights(params_from_jax(weights))
    algo.env_runner_group.sync_weights(algo.learner.get_weights())

    module = algo.env_runner_group.local_runner.module
    seen = []
    forward = module.forward_train

    def recording(params, obs):
        logits, vf = forward(params, obs)
        seen.append(logits.detach())
        return logits, vf

    module.forward_train = recording
    assert algo.evaluate() == jax_algo.evaluate()
    logits = torch.cat(seen)
    top2 = logits.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    assert len(seen) >= 3 * 5
    assert margin > 10 * LOGIT_TOL * float(logits.abs().max()), margin
    algo.stop()
    jax_algo.stop()


def test_ppo_on_pixels_save_restore_and_entry_points(tmp_path):
    config = (PPOConfig().environment("Catch-v0")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                           rollout_fragment_length=10)
              .connectors(env_to_module=[FrameStack(2)])
              .training(lr=1e-3, num_epochs=2, minibatch_size=20)
              .evaluation(evaluation_interval=2, evaluation_num_episodes=2)
              .debugging(seed=0).resources(device="cpu"))
    algo = config.build()
    assert algo.module.observation_shape == (10, 5, 2)
    assert type(algo.module).__name__ == "ConvPolicyModule"
    algo.train()
    r = algo.train()
    _finite(r, "total_loss", "grad_norm", "policy_loss", "vf_loss")
    assert "evaluation" in r
    path = algo.save(str(tmp_path / "ckpt"))
    twin = config.build()
    twin.restore(path)
    assert twin.iteration == 2 and twin._timesteps_total == 80
    for k, v in algo.learner.get_weights().items():
        torch.testing.assert_close(twin.learner.get_weights()[k], v,
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            twin.env_runner_group.local_runner.get_weights()[k], v,
            rtol=0, atol=0)
    batch = algo._concat_time_major(algo.env_runner_group.sample())
    perms = algo.learner.permutations(40)
    assert algo.learner.update(batch, perms) == \
        twin.learner.update(batch, perms)
    algo.stop()
    twin.stop()


def _cartpole(cls, **training):
    return (cls().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(**training).debugging(seed=0)
            .resources(device="cpu"))


def test_impala_and_appo_train():
    for cls in (IMPALAConfig, APPOConfig):
        algo = _cartpole(cls, lr=5e-4, num_fragments_per_step=2).build()
        for _ in range(3):
            r = algo.train()
        _finite(r, "total_loss", "grad_norm", "policy_loss", "vf_loss",
                "entropy")
        assert r["timesteps_total"] == 3 * 2 * 64
        algo.stop()


def test_dqn_trains_and_syncs_its_target():
    algo = _cartpole(DQNConfig, lr=1e-3, train_batch_size=32,
                     updates_per_step=2,
                     num_steps_sampled_before_learning_starts=64,
                     target_network_update_freq=64,
                     epsilon_timesteps=500).build()
    for _ in range(3):
        r = algo.train()
    _finite(r, "qf_loss", "q_mean", "grad_norm")
    assert r["replay_size"] == 192 and r["epsilon"] < 1.0
    learner = algo.learner
    for k, v in learner.get_weights().items():  # synced this iteration
        torch.testing.assert_close(learner.target_params[k], v)
    algo.stop()


def test_sac_trains_on_pendulum():
    algo = (SACConfig().environment("Pendulum-v1")
            .env_runners(num_env_runners=0, rollout_fragment_length=50)
            .training(train_batch_size=32,
                      num_steps_sampled_before_learning_starts=100,
                      updates_per_step=3, model={"fcnet_hiddens": (32, 32)})
            .debugging(seed=0).resources(device="cpu")).build()
    for _ in range(3):
        r = algo.train()
    _finite(r, "qf_loss", "actor_loss", "alpha_loss", "q_mean")
    assert 0.0 < r["alpha"] < 1.0
    assert np.isfinite(algo.evaluate()["episode_return_mean"])
    with pytest.raises(ValueError, match="continuous"):
        SACConfig().environment("CartPole-v1").resources(
            device="cpu").build()
    algo.stop()


def _expert_dataset(n_episodes, with_returns=False):
    """tests/test_rllib.py's hand controller (pole angle + angular
    velocity), as a raytpu.data dataset."""
    rows = []
    env = CartPoleEnv({"seed": 0})
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=ep)
        ep_rows, done = [], False
        while not done:
            a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            ep_rows.append({"obs": obs.astype(np.float32),
                            "actions": np.int32(a)})
            obs, r, term, trunc, _ = env.step(a)
            done = term or trunc
        g = 0.0
        for row in reversed(ep_rows):
            g = 1.0 + 0.99 * g
            if with_returns:
                row["returns"] = np.float32(g)
        rows.extend(ep_rows)
    return rd.from_items(rows, blocks=2)


def test_bc_and_marwil_clone_the_expert(raytpu_local):
    # raytpu_local: raytpu.data starts the JAX package's runtime, and the
    # fixture shuts it down after.
    for cls, with_returns in ((BCConfig, False), (MARWILConfig, True)):
        algo = (cls().environment("CartPole-v1")
                .offline(dataset=_expert_dataset(10, with_returns))
                .training(lr=1e-3, train_batch_size=256)
                .debugging(seed=0).resources(device="cpu")).build()
        first = algo.train()
        for _ in range(30):
            last = algo.train()
        _finite(last, "bc_loss", "grad_norm")
        assert last["bc_loss"] < first["bc_loss"]
        assert algo.evaluate()["episode_return_mean"] > 80
        algo.stop()
    algo = (MARWILConfig().offline(dataset=_expert_dataset(1),
                                   observation_dim=4, action_dim=2)
            .training(train_batch_size=64)
            .debugging(seed=0).resources(device="cpu")).build()
    with pytest.raises(ValueError, match="returns"):
        algo.train()
    with pytest.raises(ValueError, match="evaluation"):
        algo.evaluate()


def test_cql_trains_offline(raytpu_local):
    rng = np.random.default_rng(0)
    rows = []
    env = PendulumEnv({"seed": 0, "max_episode_steps": 50})
    for ep in range(4):
        obs, _ = env.reset(seed=ep)
        for _ in range(50):
            a = np.clip(-2.0 * obs[1] - 0.5 * obs[2] + rng.normal() * 0.5,
                        -2, 2)
            nobs, r, term, trunc, _ = env.step(np.array([a]))
            rows.append({"obs": obs.astype(np.float32),
                         "actions": np.float32([a]),
                         "rewards": np.float32(r),
                         "next_obs": nobs.astype(np.float32),
                         "terminateds": False})
            obs = nobs
    algo = (CQLConfig().environment("Pendulum-v1")
            .offline(dataset=rd.from_items(rows, blocks=2))
            .training(train_batch_size=64, updates_per_iteration=4,
                      model={"fcnet_hiddens": (32, 32)})
            .debugging(seed=0).resources(device="cpu")).build()
    for _ in range(2):
        r = algo.train()
    _finite(r, "qf_loss", "bellman_loss", "actor_loss", "q_mean")
    assert r["cql_penalty"] > 0.0
    assert np.isfinite(algo.evaluate()["episode_return_mean"])
    algo.stop()


def test_what_the_port_does_not_have_raises():
    with pytest.raises(NotImplementedError, match="remote env runners"):
        (PPOConfig().environment("CartPole-v1")
         .env_runners(num_env_runners=2).resources(device="cpu")).build()
    with pytest.raises(NotImplementedError, match="NCCL"):
        (PPOConfig().environment("CartPole-v1").learners(num_learners=2)
         .resources(device="cpu")).build()
