"""The port's RL modules, estimators, envs and replay buffer
(raytpu_torch/rllib) against the JAX package's (raytpu/rllib), on the CPU
in fp32: every module class's forwards, logp and entropy with the JAX
weights carried across by raytpu_torch/rllib/convert.py (the conv net at
non-square inputs, where a wrong SAME padding or flatten order shows),
GAE and v-trace, and the numpy envs, connectors and replay buffer at the
same seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.rllib import connectors as jax_connectors
from raytpu.rllib.core import learner as jax_learner
from raytpu.rllib.core import rl_module as jax_rl
from raytpu.rllib.env import envs as jax_envs
from raytpu.rllib.utils.replay_buffer import ReplayBuffer as JaxReplayBuffer
from raytpu_torch.rllib import connectors
from raytpu_torch.rllib.convert import params_from_jax
from raytpu_torch.rllib.core import learner
from raytpu_torch.rllib.core import rl_module as rl
from raytpu_torch.rllib.env import envs
from raytpu_torch.rllib.utils.replay_buffer import ReplayBuffer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the nets here are tiny, and the test runner's
    parallel workers would otherwise each start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# fp32 on both sides through two or three small layers: the libraries
# sum in different orders, so outputs agree to about 1e-6 relative;
# 1e-5 is the bound the JAX package's own fp32 attention tests hold.
TOL = 1e-5
HIDDEN = {"fcnet_hiddens": (32, 24)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _pair(name, obs_dim, act_dim, **kw):
    """(JAX module, its params, port module, the converted params)."""
    jm = getattr(jax_rl, name)(obs_dim, act_dim, dict(HIDDEN), **kw)
    pm = getattr(rl, name)(obs_dim, act_dim, dict(HIDDEN), **kw)
    jp = jm.init_params(jax.random.PRNGKey(3))
    return jm, jp, pm, params_from_jax(_np(jp))


def _obs(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# -- categorical and Q modules ---------------------------------------------

@pytest.mark.parametrize("name", ["DiscretePolicyModule", "QModule"])
def test_categorical_module_forwards_match_jax(name):
    jm, jp, pm, pp = _pair(name, 6, 3)
    obs = _obs((16, 6))
    jl, jv = jm.forward_train(jp, jnp.asarray(obs))
    pl, pv = pm.forward_train(pp, _t(obs))
    _close(pl, jl)
    if name == "QModule":
        assert jv is None and pv is None
        _close(pm.q_values(pp, _t(obs)), jm.q_values(jp, jnp.asarray(obs)))
    else:
        _close(pv, jv)
    np.testing.assert_array_equal(
        pm.forward_inference(pp, _t(obs)).numpy(),
        np.asarray(jm.forward_inference(jp, jnp.asarray(obs))))
    actions = np.random.default_rng(1).integers(0, 3, 16).astype(np.int32)
    jlp, jent, _ = jm.logp_entropy(jp, jnp.asarray(obs), jnp.asarray(actions))
    plp, pent, _ = pm.logp_entropy(pp, _t(obs), _t(actions))
    _close(plp, jlp)
    _close(pent, jent)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_conv_module_matches_jax_at_non_square_inputs(scale):
    # Catch with FrameStack(2) is (10, 5, 2): SAME pads H (0, 1) and W
    # (1, 1) at the first conv; (7, 12, 3) pads the other way round.
    for shape in [(10, 5, 2), (7, 12, 3)]:
        jm, jp, pm, pp = _pair("ConvPolicyModule", int(np.prod(shape)), 3,
                               observation_shape=shape)
        obs = _obs((8,) + shape, scale=scale)
        jl, jv = jm.forward_train(jp, jnp.asarray(obs))
        pl, pv = pm.forward_train(pp, _t(obs))
        _close(pl, jl)
        _close(pv, jv)
        actions = np.arange(8, dtype=np.int32) % 3
        jlp, jent, _ = jm.logp_entropy(jp, jnp.asarray(obs),
                                       jnp.asarray(actions))
        plp, pent, _ = pm.logp_entropy(pp, _t(obs), _t(actions))
        _close(plp, jlp)
        _close(pent, jent)


def test_conv_module_takes_time_major_leading_dims():
    shape = (10, 5, 2)
    _, _, pm, pp = _pair("ConvPolicyModule", 100, 3, observation_shape=shape)
    obs = _t(_obs((4, 3) + shape))
    logits, vf = pm.forward_train(pp, obs)
    flat, vflat = pm.forward_train(pp, obs.reshape(12, *shape))
    torch.testing.assert_close(logits.reshape(12, 3), flat)
    torch.testing.assert_close(vf.reshape(12), vflat)


def test_same_padding_is_xla_s():
    assert rl._same_padding(10) == (0, 1)
    assert rl._same_padding(5) == (1, 1)
    assert rl._same_padding(3) == (1, 1)
    assert rl._same_padding(4) == (0, 1)
    assert rl._same_padding(1) == (1, 1)


# -- Gaussian and SAC modules ----------------------------------------------

BOUNDS = {"action_low": [-2.0, -1.0], "action_high": [2.0, 3.0]}


@pytest.mark.parametrize("scale", [1.0, 40.0])  # 40: log_std hits its clip
def test_gaussian_module_matches_jax_with_jax_noise(scale):
    jm, jp, pm, pp = _pair("GaussianPolicyModule", 5, 2, **BOUNDS)
    obs = _obs((16, 5), scale=scale)
    jmean, jls = jm.forward_train(jp, jnp.asarray(obs))
    pmean, pls = pm.forward_train(pp, _t(obs))
    _close(pmean, jmean)
    _close(pls, jls)
    assert float(pls.min()) >= -20.0 and float(pls.max()) <= 2.0
    key = jax.random.PRNGKey(11)
    ja, jlogp = jm.sample(jp, jnp.asarray(obs), key)
    noise = np.asarray(jax.random.normal(key, (16, 2)))
    pa, plogp = pm.sample(pp, _t(obs), noise=_t(noise))
    _close(pa, ja)
    _close(plogp, jlogp)
    lo, hi = np.array(BOUNDS["action_low"]), np.array(BOUNDS["action_high"])
    assert np.all(pa.numpy() >= lo) and np.all(pa.numpy() <= hi)
    _close(pm.forward_inference(pp, _t(obs)),
           jm.forward_inference(jp, jnp.asarray(obs)))


def test_sac_module_matches_jax():
    jm, jp, pm, pp = _pair("SACModule", 3, 1, action_low=-2.0,
                           action_high=2.0)
    assert set(pp) == {"pi", "q1", "q2"}
    obs = _obs((12, 3))
    act = _obs((12, 1), seed=1)
    for got, want in zip(pm.q_values(pp, _t(obs), _t(act)),
                         jm.q_values(jp, jnp.asarray(obs), jnp.asarray(act))):
        _close(got, want)
    key = jax.random.PRNGKey(2)
    ja, jlogp = jm.sample(jp, jnp.asarray(obs), key)
    noise = np.asarray(jax.random.normal(key, (12, 1)))
    pa, plogp = pm.sample(pp, _t(obs), noise=_t(noise))
    _close(pa, ja)
    _close(plogp, jlogp)
    _close(pm.forward_inference(pp, _t(obs)),
           jm.forward_inference(jp, jnp.asarray(obs)))


# -- exploration, init and conversion --------------------------------------

def test_exploration_draws_from_the_generator():
    pm = rl.DiscretePolicyModule(4, 3, dict(HIDDEN))
    params = pm.init_params(0)
    obs = _t(_obs((64, 4)))
    draws = [pm.forward_exploration(params, obs,
                                    torch.Generator().manual_seed(5))
             for _ in range(2)]
    torch.testing.assert_close(draws[0][0], draws[1][0])
    actions, logp, vf = draws[0]
    lp, _, v = pm.logp_entropy(params, obs, actions)
    torch.testing.assert_close(logp, lp)
    torch.testing.assert_close(vf, v)
    # orthogonal(0.01) head: a nearly uniform initial policy.
    assert torch.allclose(logp, torch.full_like(logp, -np.log(3)),
                          atol=0.05)
    q = rl.QModule(4, 3, dict(HIDDEN))
    qp = q.init_params(0)
    g = torch.Generator().manual_seed(0)
    greedy = q.forward_inference(qp, obs)
    a, _, _ = q.forward_exploration(qp, obs, g, epsilon=0.0)
    torch.testing.assert_close(a, greedy)
    a, _, _ = q.forward_exploration(qp, obs, g, epsilon=1.0)
    assert (a != greedy).any() and a.min() >= 0 and a.max() < 3


def test_init_follows_flax_initialisers():
    pm = rl.DiscretePolicyModule(64, 4, {"fcnet_hiddens": (256,)})
    params = pm.init_params(7)
    again = pm.init_params(7)
    for k in params:
        torch.testing.assert_close(params[k], again[k], rtol=0, atol=0)
        if k.endswith(".bias"):
            assert not params[k].any()
    w = params["pi_out.weight"]  # [4, 256]: orthonormal rows, gain 0.01
    torch.testing.assert_close(w @ w.T, 1e-4 * torch.eye(4), rtol=0,
                               atol=1e-9)
    w = params["pi_0.weight"]  # lecun normal: variance 1 / fan-in
    assert abs(float(w.std()) - 64 ** -0.5) < 0.05 * 64 ** -0.5
    assert float(w.abs().max()) <= 2 * 64 ** -0.5 / 0.8796256610342398 + 1e-6
    conv = rl.ConvPolicyModule(100, 3, {}, observation_shape=(10, 5, 2))
    k = conv.init_params(0)["torso.conv_0.weight"]  # fan-in 3 * 3 * 2
    assert abs(float(k.std()) - 18 ** -0.5) < 0.15 * 18 ** -0.5


@pytest.mark.parametrize("name,kw", [
    ("DiscretePolicyModule", {}), ("QModule", {}),
    ("ConvPolicyModule", {"observation_shape": (10, 5, 2)}),
    ("GaussianPolicyModule", {}), ("SACModule", {})])
def test_converted_params_are_the_nets_parameters(name, kw):
    jm, _, pm, pp = _pair(name, 100 if kw else 4, 3, **kw)
    mine = pm.init_params(0)
    if name == "SACModule":
        assert set(pp) == set(mine)
        pp, mine = pp["q1"], mine["q1"]
    assert {k: tuple(v.shape) for k, v in pp.items()} == \
        {k: tuple(v.shape) for k, v in mine.items()}


# -- estimators ------------------------------------------------------------

def _trajectory(seed, T=9, B=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dones = rng.random((T, B)) < 0.2
    return f(T, B), f(T, B), dones, f(B), f(T, B) * 0.5, f(T, B) * 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_gae_matches_jax(seed):
    rewards, values, dones, boot, _, _ = _trajectory(seed)
    want = jax_learner.compute_gae(rewards, values, dones, boot, 0.97, 0.9)
    got = learner.compute_gae(_t(rewards), _t(values), _t(dones), _t(boot),
                              0.97, 0.9)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.8, 1.2)])
def test_vtrace_matches_jax(clip):
    rewards, values, dones, boot, blogp, tlogp = _trajectory(2)
    want = jax_learner.vtrace(blogp, tlogp, rewards, values, dones, boot,
                              0.99, *clip)
    got = learner.vtrace(_t(blogp), _t(tlogp), _t(rewards), _t(values),
                         _t(dones), _t(boot), 0.99, *clip)
    for g, w in zip(got, want):
        _close(g, w)


# -- numpy copies: envs, connectors, replay buffer --------------------------

def _rollout(mod, name, actions, config):
    env = mod.make_env(name, dict(config))
    out = [env.reset(seed=4)[0]]
    for a in actions:
        step = (env.step_batch(a) if getattr(env, "is_vector_env", False)
                else env.step(a))
        out += [step[0], np.float64(np.mean(step[1])), step[2], step[3]]
        if not getattr(env, "is_vector_env", False) and (step[2] or step[3]):
            out.append(env.reset()[0])
    return out


@pytest.mark.parametrize("name,actions", [
    ("CartPole-v1", [i % 2 for i in range(60)]),
    ("CartPole-v0", [1] * 30),
    ("Pendulum-v1", [np.array([np.sin(i)]) for i in range(30)]),
    ("Catch-v0", [i % 3 for i in range(30)]),
    ("CartPole-v1-vec", [np.arange(8) % 2] * 40),
])
def test_envs_match_the_jax_package_at_a_seed(name, actions):
    cfg = {"seed": 9, "num_envs": 8}
    got = _rollout(envs, name, actions, cfg)
    want = _rollout(jax_envs, name, actions, cfg)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_replay_buffer_samples_as_the_jax_package_s():
    ours, theirs = ReplayBuffer(50, seed=3), JaxReplayBuffer(50, seed=3)
    rng = np.random.default_rng(0)
    for _ in range(4):
        batch = {"obs": rng.normal(size=(20, 4)).astype(np.float32),
                 "actions": rng.integers(0, 2, 20)}
        ours.add(batch)
        theirs.add(batch)
        assert len(ours) == len(theirs)
        a, b = ours.sample(16), theirs.sample(16)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_connectors_match_the_jax_package():
    rng = np.random.default_rng(0)
    obs = [rng.random((3, 4, 5, 1)).astype(np.float32) for _ in range(4)]
    pipes = [m.ConnectorPipeline([m.ObsScaler(0.5), m.FrameStack(3)])
             for m in (connectors, jax_connectors)]
    for i, o in enumerate(obs):
        outs = [p(o) for p in pipes]
        np.testing.assert_array_equal(*outs)
        np.testing.assert_array_equal(*[p.peek(o) for p in pipes])
        if i == 1:
            for p in pipes:
                p.on_episode_done(1)
    assert pipes[0].transform_obs_shape((4, 5, 1)) == (4, 5, 3)
    flat = [m.FlattenObs()(obs[0]) for m in (connectors, jax_connectors)]
    np.testing.assert_array_equal(*flat)
    clip = [m.ClipActions(-1, 1)(obs[0] * 4 - 2)
            for m in (connectors, jax_connectors)]
    np.testing.assert_array_equal(*clip)
