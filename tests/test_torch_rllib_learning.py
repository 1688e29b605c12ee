"""PPO learning CartPole in the port (raytpu_torch/rllib) and in the JAX
package, on the CPU, at tests/test_rllib.py's config and threshold (after
15 iterations the episode return is above 60 and above 1.5 times the
first iteration's), at seeds 0-4 in both."""

import numpy as np
import pytest
import torch

from raytpu.rllib import PPOConfig as JaxPPOConfig
from raytpu_torch.rllib import PPOConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the nets here are tiny, and the test runner's
    parallel workers would otherwise each start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEEDS = range(5)


def _learn(config, seed):
    """tests/test_rllib.py:112-129's run: (the first iteration's return,
    the fifteenth's)."""
    algo = (config.environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=128)
            .training(lr=3e-4, num_epochs=6, minibatch_size=128,
                      entropy_coeff=0.01)
            .debugging(seed=seed)).build()
    first = algo.train()
    for _ in range(14):
        last = algo.train()
    assert last["timesteps_total"] == 15 * 128 * 4
    algo.stop()
    return first["episode_return_mean"], last["episode_return_mean"]


def test_ppo_learns_cartpole():
    # Torch's draws are not JAX's, so the two packages' runs at one seed
    # are not the same run: each seed is one sample of a package's
    # learning curve. At this config the JAX package's own seeds fall on
    # both sides of the threshold (its seed 4 ends near 52, the port's
    # seed 0 near 52). So the rule holds the median over seeds 0-4, every
    # seed must still learn (1.5 times its first return), and the port's
    # mean final return must be at least 0.9 times the JAX package's at
    # the same seeds. The update itself is held to the JAX package's,
    # whole, by tests/test_torch_rllib_learners.py.
    port = [_learn(PPOConfig().resources(device="cpu"), s) for s in SEEDS]
    ref = [_learn(JaxPPOConfig(), s) for s in SEEDS]
    for seed, (first, last) in zip(SEEDS, port):
        assert last > 1.5 * first, (seed, port)
    first, last = np.median(port, axis=0)
    assert last > max(60, first * 1.5), port
    port_mean, ref_mean = (np.mean([last for _, last in runs])
                           for runs in (port, ref))
    assert port_mean >= 0.9 * ref_mean, (port, ref)
