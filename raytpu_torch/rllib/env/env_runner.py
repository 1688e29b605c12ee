"""EnvRunner — the sampling plane: the port of
:mod:`raytpu.rllib.env.env_runner`.

Env stepping is host-side numpy; the policy forward runs on the
algorithm's device (the card unless the config asks for the CPU), as the
JAX runner runs its jitted forwards on the default device. Each step
sends the observations to the device once and brings actions, logp and
values back in one copy. Batches come back time-major (T, B, ...) so
GAE/v-trace run directly over them.

``EnvRunnerGroup(num_env_runners=0)`` samples in process; with
``num_env_runners > 0`` each runner is a spawned worker process of the
port's runtime (:mod:`raytpu_torch.runtime`), which resolves the config's
device itself and gets the config's env handed over
(:func:`~raytpu_torch.rllib.env.envs.env_registration`).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from raytpu_torch import resolve_device, runtime
from raytpu_torch.core.errors import GetTimeoutError
from raytpu_torch.rllib.connectors import ConnectorPipeline
from raytpu_torch.rllib.core.learner import host_copy, load_params_
from raytpu_torch.rllib.core.rl_module import ieee_fp32
from raytpu_torch.rllib.env.envs import (env_registration, make_env,
                                         register_env)

# How long a group waits for its runner processes to start (import torch,
# reach the card, build the envs and the module).
START_TIMEOUT_S = 300.0


def _build_pipelines(config: Dict[str, Any]):
    """Fresh (env→module, module→env) connector pipelines from the config's
    prototypes — deep-copied so stateful connectors never share state
    between consumers (sampling vs eval vs other runners)."""
    return (
        ConnectorPipeline([copy.deepcopy(c) for c in
                           config.get("env_to_module_connectors") or []]),
        ConnectorPipeline([copy.deepcopy(c) for c in
                           config.get("module_to_env_connectors") or []]),
    )


class SingleAgentEnvRunner:
    """Steps ``num_envs`` copies of one env with the current policy.

    Config keys (subset of the reference's AlgorithmConfig surface):
    ``env``, ``env_config``, ``module_spec``, ``rollout_fragment_length``,
    ``num_envs_per_env_runner``, ``seed``, ``worker_index``, ``device``;
    and ``env_registration``, a ``(name, creator)`` pair to register
    before the env is made (how a runner in a process of its own gets a
    registered env).
    """

    def __init__(self, config: Dict[str, Any]):
        self.config = config
        if config.get("env_registration"):
            register_env(*config["env_registration"])
        self.device = resolve_device(config.get("device"))
        self.worker_index = int(config.get("worker_index", 0))
        seed = config.get("seed")
        self._seed = (None if seed is None
                      else int(seed) + 1000 * self.worker_index)
        self.num_envs = int(config.get("num_envs_per_env_runner", 1))
        self.fragment_len = int(config.get("rollout_fragment_length", 64))
        env_config = dict(config.get("env_config") or {})
        if self._seed is not None:
            env_config.setdefault("seed", self._seed)
        # Vectorized envs (is_vector_env) batch all copies into one numpy
        # step; per-env Python stepping is the fallback for arbitrary
        # user envs.
        probe = make_env(config["env"],
                         {**env_config, "num_envs": self.num_envs})
        if getattr(probe, "is_vector_env", False):
            self._vec = probe
            self.num_envs = probe.num_envs
            self.envs = []
        else:
            self._vec = None
            self.envs = [probe] + [make_env(config["env"], env_config)
                                   for _ in range(self.num_envs - 1)]
        self.module = config["module_spec"].build()
        self._env_to_module, self._module_to_env = _build_pipelines(config)
        self._act_shape = tuple(getattr(self.module, "action_shape", ()))
        self._act_dtype = getattr(self.module, "action_dtype", np.int32)
        self._continuous = bool(getattr(self.module, "is_continuous", False))
        self._has_value_head = bool(
            getattr(self.module, "has_value_head", True))
        self.params = self.module.init_params(self._seed or 0, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            (self._seed or 0) + 1)
        # Persistent episode state across sample() calls.
        if self._vec is not None:
            self._obs = self._vec.reset()[0]
        else:
            self._obs = np.stack([e.reset()[0] for e in self.envs])
        self._ep_return = np.zeros(self.num_envs)
        self._ep_len = np.zeros(self.num_envs, dtype=np.int64)
        self._completed: List[dict] = []
        self._total_steps = 0

    # -- weight sync (reference: EnvRunnerGroup.sync_weights) -----------------

    def set_weights(self, weights) -> None:
        load_params_(self.params, weights)

    def get_weights(self):
        return host_copy(self.params)

    # -- the policy on the device ---------------------------------------------

    @torch.no_grad()
    def act(self, obs: np.ndarray, explore: bool = True, **explore_kwargs):
        """(actions, logp, vf) for a batch of observations, as numpy: the
        observations go to the device in one copy and the three come back
        in one; logp is zeros and vf None where the module gives none."""
        x = torch.from_numpy(obs).to(self.device)
        if explore:
            actions, logp, vf = self.module.forward_exploration(
                self.params, x, self.generator, **explore_kwargs)
        else:
            actions, logp, vf = (self.module.forward_inference(self.params, x),
                                 None, None)
        b = x.shape[0]
        cols = [actions.reshape(b, -1).float()]
        cols += [t.reshape(b, 1).float() for t in (logp, vf) if t is not None]
        out = torch.cat(cols, dim=1).cpu().numpy()
        n_act = cols[0].shape[1]
        acts = out[:, :n_act].reshape((b,) + self._act_shape).astype(
            self._act_dtype)
        rest = iter(out[:, n_act:].T)
        logp = next(rest) if logp is not None else np.zeros(b, np.float32)
        vf = next(rest) if vf is not None else None
        return acts, logp, vf

    @torch.no_grad()
    def values(self, obs: np.ndarray) -> np.ndarray:
        """The value head on a batch of observations, as numpy."""
        x = torch.from_numpy(obs).to(self.device)
        return self.module.forward_train(self.params, x)[1].cpu().numpy()

    # -- sampling -------------------------------------------------------------

    def sample(self, num_steps: Optional[int] = None,
               explore: bool = True, **explore_kwargs) -> Dict[str, Any]:
        """Collect a time-major fragment: arrays shaped (T, B, ...).

        Truncated (not terminated) episodes get their value bootstrap
        folded into the reward at the truncation step, so downstream
        GAE/v-trace can treat every done as terminal without leaking
        across episode boundaries.
        """
        with ieee_fp32(self.device):
            return self._sample(num_steps, explore, **explore_kwargs)

    def _sample(self, num_steps, explore, **explore_kwargs):
        T = num_steps or self.fragment_len
        B = self.num_envs
        obs_shape = self._env_to_module.transform_obs_shape(
            self._obs.shape[1:])
        obs_buf = np.zeros((T, B) + obs_shape, np.float32)
        act_buf = np.zeros((T, B) + self._act_shape, self._act_dtype)
        trunc_buf = np.zeros((T, B), np.bool_)  # pure time-limit cuts
        rew_buf = np.zeros((T, B), np.float32)
        term_buf = np.zeros((T, B), np.bool_)
        logp_buf = np.zeros((T, B), np.float32)
        vf_buf = np.zeros((T, B), np.float32)
        gamma = float(self.config.get("gamma", 0.99))

        for t in range(T):
            obs = self._obs.astype(np.float32)
            if len(self._env_to_module):
                obs = self._env_to_module(obs)
            obs_buf[t] = obs
            actions, logp, vf = self.act(obs, explore, **explore_kwargs)
            act_buf[t] = actions
            logp_buf[t] = logp
            if vf is not None:
                vf_buf[t] = vf
            env_actions = actions
            if len(self._module_to_env):
                env_actions = self._module_to_env(actions)

            if self._vec is not None:
                nobs, r, terminated, truncated, info = \
                    self._vec.step_batch(env_actions)
                self._ep_return += r
                self._ep_len += 1
                rew_buf[t] = r
                done = terminated | truncated
                term_buf[t] = done
                pure_trunc = truncated & ~terminated
                trunc_buf[t] = pure_trunc
                if pure_trunc.any() and self._has_value_head:
                    # Fold the value bootstrap into the truncation step
                    # (same semantics as the per-env path below). peek is
                    # fed the FULL batch so stateful connectors
                    # (FrameStack) see their sampling-time batch shape and
                    # per-slot history; truncated rows are selected after.
                    fobs = info["final_obs"].astype(np.float32)
                    if len(self._env_to_module):
                        fobs = self._env_to_module.peek(fobs)
                    vals = self.values(fobs)
                    rew_buf[t, pure_trunc] += gamma * vals[pure_trunc]
                if done.any():
                    for i in np.nonzero(done)[0]:
                        self._completed.append({
                            "episode_return": float(self._ep_return[i]),
                            "episode_len": int(self._ep_len[i]),
                        })
                        self._env_to_module.on_episode_done(int(i))
                    self._ep_return[done] = 0.0
                    self._ep_len[done] = 0
                self._obs = nobs
                continue

            truncated_next_obs = {}
            done_idx = []
            for i, env in enumerate(self.envs):
                a_i = (env_actions[i] if self._continuous
                       else int(env_actions[i]))
                nobs, r, terminated, truncated, _ = env.step(a_i)
                self._ep_return[i] += r
                self._ep_len[i] += 1
                rew_buf[t, i] = r
                done = terminated or truncated
                term_buf[t, i] = done
                trunc_buf[t, i] = truncated and not terminated
                if truncated and not terminated:
                    truncated_next_obs[i] = nobs
                if done:
                    self._completed.append({
                        "episode_return": float(self._ep_return[i]),
                        "episode_len": int(self._ep_len[i]),
                    })
                    done_idx.append(i)
                    self._ep_return[i] = 0.0
                    self._ep_len[i] = 0
                    nobs = env.reset()[0]
                self._obs[i] = nobs
            if truncated_next_obs and self._has_value_head:
                # Full-batch peek (see vec path): connector state must see
                # its sampling-time batch shape, and must not be advanced
                # or zeroed before this transform.
                full = self._obs.astype(np.float32).copy()
                for i, fo in truncated_next_obs.items():
                    full[i] = fo
                if len(self._env_to_module):
                    full = self._env_to_module.peek(full)
                vals = self.values(full)
                for i in truncated_next_obs:
                    rew_buf[t, i] += gamma * float(vals[i])
            for i in done_idx:
                self._env_to_module.on_episode_done(i)

        self._total_steps += T * B
        episodes, self._completed = self._completed, []
        bootstrap = self._obs.astype(np.float32).copy()
        if len(self._env_to_module):
            # peek: the same raw obs is re-transformed for real at the next
            # fragment's first step, so connector state must not advance.
            bootstrap = self._env_to_module.peek(bootstrap)
        return {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "terminateds": term_buf, "truncateds": trunc_buf,
            "action_logp": logp_buf,
            "vf_preds": vf_buf,
            "bootstrap_obs": bootstrap,
            "episodes": episodes,
            "env_steps": T * B,
        }

    def evaluate(self, num_episodes: int = 5,
                 max_steps: int = 1000) -> Dict[str, float]:
        """Greedy episodes on a fresh env (reference: evaluation workers)."""
        with ieee_fp32(self.device):
            return self._evaluate(num_episodes, max_steps)

    def _evaluate(self, num_episodes, max_steps):
        env = make_env(self.config["env"],
                       {**dict(self.config.get("env_config") or {}),
                        "num_envs": 1})
        vec = getattr(env, "is_vector_env", False)
        # Fresh connector state for eval episodes (FrameStack etc. must not
        # leak sampling state into greedy rollouts).
        eval_pipe, eval_act_pipe = _build_pipelines(self.config)
        returns = []
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=None if self._seed is None
                               else self._seed + 7919 * (ep + 1))
            if vec:
                obs = obs[0]
            total = 0.0
            for _ in range(max_steps):
                mobs = obs[None].astype(np.float32)
                if len(eval_pipe):
                    mobs = eval_pipe(mobs)
                a = self.act(mobs, explore=False)[0][0]
                if len(eval_act_pipe):
                    a = eval_act_pipe(a[None])[0]
                if not self._continuous:
                    a = int(a)
                if vec:
                    nobs, r, term, trunc, _ = env.step_batch(
                        np.asarray([a]))
                    obs, r = nobs[0], float(r[0])
                    terminated, truncated = bool(term[0]), bool(trunc[0])
                else:
                    obs, r, terminated, truncated, _ = env.step(a)
                total += r
                if terminated or truncated:
                    break
            eval_pipe.on_episode_done(0)
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns)),
                "num_episodes": num_episodes}


    def total_steps(self) -> int:
        return self._total_steps

    def ping(self) -> bool:
        return True


class EnvRunnerGroup:
    """Fan-out over remote env runners, or the local runner (reference
    analogue: ``rllib/evaluation/worker_set.py:82`` / ``EnvRunnerGroup``).

    ``num_env_runners=0`` samples in process. Otherwise runner ``i`` (its
    ``worker_index`` is ``i + 1``) is a worker process of the port's
    runtime with ``num_cpus=1``, as the JAX group asks; construction
    waits until every runner has started (``startup_s``: each one's
    seconds from launch to its first reply) and stops them all if one
    fails. The JAX group's ``resources_per_runner`` is not taken: no
    caller passes it, and the port's runtime has no resources other than
    ``num_cpus``.
    """

    def __init__(self, config: Dict[str, Any], num_env_runners: int):
        self.num_env_runners = num_env_runners
        self.local_runner: Optional[SingleAgentEnvRunner] = None
        self.remote_runners: list = []
        self.startup_s: List[float] = []
        if num_env_runners <= 0:
            self.local_runner = SingleAgentEnvRunner(
                {**config, "worker_index": 0})
            return
        config = {**config, "env_registration": env_registration(
            config["env"])}
        actor_cls = runtime.remote(SingleAgentEnvRunner).options(num_cpus=1)
        try:
            t0 = time.monotonic()
            for i in range(num_env_runners):
                self.remote_runners.append(actor_cls.remote(
                    {**config, "worker_index": i + 1}))
            self.startup_s = self._await_start(t0)
        except BaseException:
            self.stop()
            raise

    def _await_start(self, t0: float) -> List[float]:
        pending = {r.ping.remote(): i
                   for i, r in enumerate(self.remote_runners)}
        started = [0.0] * len(pending)
        while pending:
            left = START_TIMEOUT_S - (time.monotonic() - t0)
            ready, _ = runtime.wait(list(pending), num_returns=1,
                                    timeout=max(0.0, left))
            if not ready:
                raise GetTimeoutError(
                    f"{len(pending)} env runner(s) did not start within "
                    f"{START_TIMEOUT_S} s")
            runtime.get(ready[0])  # raises if the runner's constructor did
            started[pending.pop(ready[0])] = time.monotonic() - t0
        return started

    def sample(self, **kwargs) -> List[Dict[str, Any]]:
        if self.local_runner is not None:
            return [self.local_runner.sample(**kwargs)]
        return runtime.get([r.sample.remote(**kwargs)
                            for r in self.remote_runners])

    def sample_refs(self, **kwargs):
        """Async sampling (IMPALA): one in-flight ref per runner."""
        if self.local_runner is not None:
            return [runtime.put(self.local_runner.sample(**kwargs))]
        return [r.sample.remote(**kwargs) for r in self.remote_runners]

    def sync_weights(self, weights) -> None:
        if self.local_runner is not None:
            self.local_runner.set_weights(weights)
            return
        ref = runtime.put(weights)
        runtime.get([r.set_weights.remote(ref)
                     for r in self.remote_runners])

    def evaluate(self, num_episodes: int) -> Dict[str, float]:
        if self.local_runner is not None:
            return self.local_runner.evaluate(num_episodes)
        per = max(1, num_episodes // len(self.remote_runners))
        outs = runtime.get([r.evaluate.remote(per)
                            for r in self.remote_runners])
        return {"episode_return_mean": float(np.mean(
            [o["episode_return_mean"] for o in outs])),
            "num_episodes": per * len(self.remote_runners)}

    def stop(self) -> None:
        for r in self.remote_runners:
            runtime.kill(r)
        self.remote_runners = []
