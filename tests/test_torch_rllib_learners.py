"""The port's learners (raytpu_torch/rllib) against the JAX package's
(raytpu/rllib), on the CPU in fp32, from the same weights
(raytpu_torch/rllib/convert.py) and the same batches: each loss and its
gradients (PPO, IMPALA, APPO, DQN, BC, MARWIL); one whole PPO rollout
update with the JAX learner's permutations; one SAC step and one CQL
step with the JAX step's noise; and the parameters afterwards."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.rllib.algorithms import appo as jax_appo
from raytpu.rllib.algorithms import bc as jax_bc
from raytpu.rllib.algorithms import cql as jax_cql
from raytpu.rllib.algorithms import dqn as jax_dqn
from raytpu.rllib.algorithms import impala as jax_impala
from raytpu.rllib.algorithms import ppo as jax_ppo
from raytpu.rllib.algorithms import sac as jax_sac
from raytpu.rllib.core import rl_module as jax_rl
from raytpu_torch.rllib.algorithms import appo, bc, cql, dqn, impala, ppo, sac
from raytpu_torch.rllib.convert import params_from_jax
from raytpu_torch.rllib.core import learner as port_learner
from raytpu_torch.rllib.core import rl_module as rl


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the nets here are tiny, and the test runner's
    parallel workers would otherwise each start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# fp32 losses and gradients through a few small layers: the libraries sum
# in different orders (about 1e-6 relative); 1e-4 is the bound the JAX
# package holds fp32 gradients to (tests/test_ops.py), here in relative
# norm a tensor.
TOL = 1e-4
HIDDEN = {"fcnet_hiddens": (32, 24)}
CPU = {"device": "cpu"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _assert_tree(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], tol)
        else:
            assert _rel(got[k], want[k]) <= tol, (k, _rel(got[k], want[k]))


def _assert_metrics(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k in want:
        assert _rel(got[k], want[k]) <= tol or \
            abs(float(got[k]) - float(want[k])) <= 1e-6, (k, got[k], want[k])


def _pair(jax_cls, port_cls, module_name, config, obs_dim=4, act_dim=3,
          **kw):
    """(JAX learner, port learner with the JAX weights)."""
    jm = getattr(jax_rl, module_name)(obs_dim, act_dim, dict(HIDDEN), **kw)
    pm = getattr(rl, module_name)(obs_dim, act_dim, dict(HIDDEN), **kw)
    jl = jax_cls(jm, dict(config))
    pl = port_cls(pm, {**config, **CPU})
    pl.set_weights(params_from_jax(_np(jl.params)))
    return jl, pl


def _loss_and_grads(jl, pl, batch, jax_batch=None):
    (jloss, jmet), jgrads = jax.value_and_grad(
        jl.compute_loss, has_aux=True)(jl.params, jax_batch or batch,
                                       jax.random.PRNGKey(0))
    tb = port_learner.to_device(batch, pl.device)
    ploss, pmet = pl.compute_loss(pl.params, tb)
    pgrads = torch.autograd.grad(ploss, list(pl.params.values()),
                                 materialize_grads=True)
    assert _rel(ploss, jloss) <= TOL
    _assert_metrics(port_learner.to_host(pmet),
                    {k: float(v) for k, v in jmet.items()})
    _assert_tree(dict(zip(pl.params, pgrads)), params_from_jax(_np(jgrads)))


def _flat_batch(rng, n=48, obs_dim=4, act_dim=3):
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, act_dim, n).astype(np.int32),
            "action_logp": (rng.normal(size=n) * 0.3 - 1.1).astype(
                np.float32),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32)}


def _rollout(rng, T=16, B=8, obs_dim=4, act_dim=3):
    return {"obs": rng.normal(size=(T, B, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, act_dim, (T, B)).astype(np.int32),
            "rewards": rng.normal(size=(T, B)).astype(np.float32),
            "terminateds": rng.random((T, B)) < 0.1,
            "action_logp": (rng.normal(size=(T, B)) * 0.3 - 1.1).astype(
                np.float32),
            "vf_preds": rng.normal(size=(T, B)).astype(np.float32),
            "bootstrap_obs": rng.normal(size=(B, obs_dim)).astype(
                np.float32)}


PPO_CFG = {"gamma": 0.99, "lambda_": 0.95, "clip_param": 0.2,
           "vf_clip_param": 1.0, "vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
           "num_epochs": 3, "minibatch_size": 32, "lr": 3e-3, "seed": 0}


def test_ppo_loss_and_gradients_match_jax():
    jl, pl = _pair(jax_ppo.PPOLearner, ppo.PPOLearner,
                   "DiscretePolicyModule", PPO_CFG)
    _loss_and_grads(jl, pl, _flat_batch(np.random.default_rng(0)))


IMPALA_CFG = {"gamma": 0.97, "vf_loss_coeff": 0.5, "entropy_coeff": 0.01,
              "clip_rho_threshold": 1.0, "clip_c_threshold": 0.9, "seed": 0}


def test_impala_loss_and_gradients_match_jax():
    jl, pl = _pair(jax_impala.IMPALALearner, impala.IMPALALearner,
                   "DiscretePolicyModule", IMPALA_CFG)
    _loss_and_grads(jl, pl, _rollout(np.random.default_rng(1)))


@pytest.mark.parametrize("use_kl_loss", [False, True])
def test_appo_loss_and_gradients_match_jax(use_kl_loss):
    cfg = {**IMPALA_CFG, "clip_param": 0.2, "use_kl_loss": use_kl_loss,
           "kl_coeff": 0.3}
    jl, pl = _pair(jax_appo.APPOLearner, appo.APPOLearner,
                   "DiscretePolicyModule", cfg)
    # A target network that differs from the online one.
    target = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.sin(jnp.arange(p.size).reshape(p.shape)),
        jl.params)
    pl.target_params = params_from_jax(_np(target))
    batch = _rollout(np.random.default_rng(2))
    _loss_and_grads(jl, pl, batch, {**batch, "target_params": target})


def _replay_batch(rng, n=40, obs_dim=4, act_dim=3):
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, act_dim, n).astype(np.int32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "terminateds": rng.random(n) < 0.2,
            "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32)}


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_loss_and_gradients_match_jax(double_q):
    jl, pl = _pair(jax_dqn.DQNLearner, dqn.DQNLearner, "QModule",
                   {"gamma": 0.99, "double_q": double_q, "seed": 0})
    target = jax.tree_util.tree_map(lambda p: p * 1.1 + 0.01, jl.params)
    pl.target_params = params_from_jax(_np(target))
    batch = _replay_batch(np.random.default_rng(3))
    # Rewards large enough that some errors pass the Huber knee at 1.
    batch["rewards"] *= 3
    _loss_and_grads(jl, pl, batch, {**batch, "target_params": target})


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_bc_and_marwil_loss_and_gradients_match_jax(beta):
    jl, pl = _pair(jax_bc.BCLearner, bc.BCLearner, "DiscretePolicyModule",
                   {"beta": beta, "vf_coeff": 0.7, "seed": 0})
    rng = np.random.default_rng(4)
    batch = {"obs": rng.normal(size=(40, 4)).astype(np.float32),
             "actions": rng.integers(0, 3, 40).astype(np.int32),
             "returns": (rng.normal(size=40) * 5).astype(np.float32),
             "adv_norm": np.float32(2.5)}
    _loss_and_grads(jl, pl, batch)


# -- whole updates ----------------------------------------------------------

@pytest.mark.parametrize("grad_clip", [40.0, 0.05])  # 0.05: every step clips
def test_ppo_rollout_update_with_jax_permutations(grad_clip):
    cfg = {**PPO_CFG, "grad_clip": grad_clip}
    jl, pl = _pair(jax_ppo.PPOLearner, ppo.PPOLearner,
                   "DiscretePolicyModule", cfg)
    batch = _rollout(np.random.default_rng(5))
    n = 16 * 8
    num_mb, mb = pl.minibatch_shape(n)
    assert (num_mb, mb) == (4, 32)
    # The permutations the JAX update draws: its learner's key, split
    # once by update() and once a epoch by _rollout_update.
    _, key = jax.random.split(jl._rng)
    perms = np.stack([np.asarray(jax.random.permutation(k, n))[: num_mb * mb]
                      for k in jax.random.split(key, cfg["num_epochs"])])
    jmet = jl.update(batch)
    pmet = pl.update(batch, perms=torch.from_numpy(
        perms.reshape(-1, num_mb, mb).astype(np.int64)))
    _assert_metrics(pmet, jmet)
    if grad_clip < 1:
        assert pmet["grad_norm"] > grad_clip
    _assert_tree(pl.get_weights(), params_from_jax(jl.get_weights()))
    # The same seed draws the same permutations again.
    twin = ppo.PPOLearner(pl.module, {**cfg, **CPU})
    torch.testing.assert_close(twin.permutations(n),
                               ppo.PPOLearner(pl.module, {**cfg, **CPU})
                               .permutations(n))


SAC_CFG = {"gamma": 0.99, "tau": 0.05, "initial_alpha": 0.7,
           "target_entropy": None, "lr": 1e-3, "seed": 0}
SAC_BOUNDS = {"action_low": [-2.0, -1.0], "action_high": [2.0, 1.5]}


def _sac_pair(jax_cls, port_cls, cfg):
    jl, pl = _pair(jax_cls, port_cls, "SACModule", cfg, obs_dim=3, act_dim=2,
                   **SAC_BOUNDS)
    # Target critics that differ from the online ones.
    jl.target_q = jax.tree_util.tree_map(lambda p: p * 0.9, jl.target_q)
    port_learner.load_params_(pl.target_q, params_from_jax(_np(jl.target_q)))
    return jl, pl


def _sac_batch(rng, n=32):
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.uniform([-2, -1], [2, 1.5], (n, 2)).astype(
                np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "terminateds": rng.random(n) < 0.1,
            "next_obs": rng.normal(size=(n, 3)).astype(np.float32)}


def _check_sac_step(jl, pl, batch, key, noise):
    out = jl._step_fn(jl.params, jl.target_q, jl.log_alpha, jl.opt_state,
                      {k: jnp.asarray(v) for k, v in batch.items()}, key)
    params, target_q, log_alpha, _, jmet = out
    pmet = pl.update(batch, noise={k: np.asarray(v)
                                   for k, v in noise.items()})
    _assert_metrics(pmet, {k: float(v) for k, v in jmet.items()})
    _assert_tree(pl.get_weights(), params_from_jax(_np(params)))
    _assert_tree(port_learner.host_copy(pl.target_q),
                 params_from_jax(_np(target_q)))
    assert _rel(pl.log_alpha, log_alpha) <= TOL
    # The actor's loss left nothing in the critics (or anywhere).
    assert all(p.grad is None for p in pl._q_params() + pl._pi_params())


def test_sac_step_matches_jax_with_its_noise():
    jl, pl = _sac_pair(jax_sac.SACLearner, sac.SACLearner, SAC_CFG)
    key = jax.random.PRNGKey(21)
    r_next, r_pi = jax.random.split(key)
    noise = {"next": jax.random.normal(r_next, (32, 2)),
             "pi": jax.random.normal(r_pi, (32, 2))}
    _check_sac_step(jl, pl, _sac_batch(np.random.default_rng(6)), key, noise)


def test_cql_step_matches_jax_with_its_noise():
    cfg = {**SAC_CFG, "min_q_weight": 5.0, "num_cql_actions": 3}
    jl, pl = _sac_pair(jax_cql.CQLLearner, cql.CQLLearner, cfg)
    key = jax.random.PRNGKey(22)
    r_next, r_pi, r_rand, r_cur = jax.random.split(key, 4)
    lo, hi = (jnp.asarray(SAC_BOUNDS["action_low"]),
              jnp.asarray(SAC_BOUNDS["action_high"]))
    noise = {"next": jax.random.normal(r_next, (32, 2)),
             "pi": jax.random.normal(r_pi, (32, 2)),
             "rand": jax.random.uniform(r_rand, (3, 32, 2), minval=lo,
                                        maxval=hi),
             "cur": jax.random.normal(r_cur, (32, 2))}
    _check_sac_step(jl, pl, _sac_batch(np.random.default_rng(7)), key, noise)


def test_sac_draws_noise_of_the_step_s_shapes():
    pl = _sac_pair(jax_cql.CQLLearner, cql.CQLLearner,
                   {**SAC_CFG, "num_cql_actions": 3})[1]
    noise = pl.draw_noise(5)
    assert noise["next"].shape == noise["pi"].shape == noise["cur"].shape \
        == (5, 2)
    rand = noise["rand"]
    assert rand.shape == (3, 5, 2)
    assert (rand >= torch.tensor([-2.0, -1.0])).all()
    assert (rand <= torch.tensor([2.0, 1.5])).all()
    metrics = pl.update(_sac_batch(np.random.default_rng(8), 5))
    assert set(metrics) == {"qf_loss", "bellman_loss", "cql_penalty",
                            "actor_loss", "alpha", "q_mean"}
    assert all(np.isfinite(v) for v in metrics.values())


# -- the learner's own rules -------------------------------------------------

def test_clip_by_global_norm_is_optax_s_rule():
    import optax

    grads = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]  # norm 13
    norm = port_learner.global_norm(grads)
    assert float(norm) == 13.0
    for max_norm in (20.0, 13.0, 6.5):
        got = port_learner.clip_by_global_norm(grads, norm, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g.numpy()) for g in grads], None)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_adam_steps_as_optax_adam():
    import optax

    p0 = np.array([0.5, -1.0, 2.0], np.float32)
    grads = [np.array([0.1, -0.3, 2.0], np.float32),
             np.array([-0.2, 0.0, 1.0], np.float32),
             np.array([1e-3, 0.4, -5.0], np.float32)]
    p = torch.tensor(p0, requires_grad=True)
    opt = torch.optim.Adam([p], lr=1e-2)  # as the learners build it
    tx = optax.adam(1e-2)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    for g in grads:
        port_learner.apply_grads(opt, [p], [torch.from_numpy(g)])
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6)


def test_targets_are_copies_not_aliases():
    for cls, name in ((dqn.DQNLearner, "QModule"),
                      (appo.APPOLearner, "DiscretePolicyModule")):
        pl = cls(getattr(rl, name)(4, 3, dict(HIDDEN)),
                 {"gamma": 0.99, **IMPALA_CFG, "clip_param": 0.2, **CPU})
        before = port_learner.host_copy(pl.target_params)
        batch = (_replay_batch(np.random.default_rng(9)) if name == "QModule"
                 else _rollout(np.random.default_rng(9)))
        pl.update(batch)
        _assert_tree(port_learner.host_copy(pl.target_params), before, 0.0)
        assert _rel(pl.params["pi_0.weight"], before["pi_0.weight"]) > 0
        pl.sync_target()
        _assert_tree(port_learner.host_copy(pl.target_params),
                     pl.get_weights(), 0.0)
    pl = sac.SACLearner(rl.SACModule(3, 2, dict(HIDDEN)), {**SAC_CFG, **CPU})
    before = port_learner.host_copy(pl.target_q)
    pl.update(_sac_batch(np.random.default_rng(10)))
    after = port_learner.host_copy(pl.target_q)
    online = pl.get_weights()
    for q in ("q1", "q2"):  # the polyak move: (1 - tau) target + tau online
        for k in before[q]:
            torch.testing.assert_close(
                after[q][k], 0.95 * before[q][k] + 0.05 * online[q][k])


def test_several_learners_raise():
    with pytest.raises(NotImplementedError, match="NCCL"):
        ppo.PPOLearner(rl.DiscretePolicyModule(4, 2, dict(HIDDEN)),
                       {**PPO_CFG, "num_learners": 2, **CPU})


def test_learner_state_round_trips_on_the_cpu():
    cfg = {**PPO_CFG, **CPU}
    pl = ppo.PPOLearner(rl.DiscretePolicyModule(4, 3, dict(HIDDEN)), cfg)
    pl.update(_rollout(np.random.default_rng(11)))
    state = pl.get_state()
    assert all(v.device.type == "cpu" for v in state["params"].values())
    twin = ppo.PPOLearner(rl.DiscretePolicyModule(4, 3, dict(HIDDEN)),
                          {**cfg, "seed": 5})
    twin.set_state(state)
    batch = _rollout(np.random.default_rng(12))
    perms = pl.permutations(128)
    a, b = pl.update(batch, perms=perms), twin.update(batch, perms=perms)
    assert a == b
    _assert_tree(twin.get_weights(), pl.get_weights(), 0.0)


def test_set_state_leaves_the_caller_s_state_as_it_was():
    # Two CPU learners set from one state and stepped alike end alike:
    # neither steps the state's optimizer moments in place.
    cfg = {**PPO_CFG, **CPU}
    pl = ppo.PPOLearner(rl.DiscretePolicyModule(4, 3, dict(HIDDEN)), cfg)
    pl.update(_rollout(np.random.default_rng(13)))
    state = pl.get_state()
    moments = copy.deepcopy(state["opt_state"]["state"])
    batch = _rollout(np.random.default_rng(14))
    perms = pl.permutations(128)
    twins = [ppo.PPOLearner(rl.DiscretePolicyModule(4, 3, dict(HIDDEN)), cfg)
             for _ in range(2)]
    for twin in twins:
        twin.set_state(state)
        twin.update(batch, perms=perms)
    _assert_tree(twins[1].get_weights(), twins[0].get_weights(), 0.0)
    for i, m in moments.items():
        for k, v in m.items():
            assert torch.equal(state["opt_state"]["state"][i][k], v), (i, k)
