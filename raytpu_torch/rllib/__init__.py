"""raytpu_torch.rllib — the port of :mod:`raytpu.rllib` to PyTorch.

Reference analogue: ``rllib/`` new stack (``rllib/core/rl_module``,
``rllib/core/learner``, ``rllib/env/env_runner.py``,
``rllib/algorithms/``), with the JAX package's public names. PPO,
IMPALA, APPO, DQN, SAC, CQL and BC/MARWIL train with one learner on the
card (or, with ``.resources(device="cpu")``, on the CPU), sampling in
process or, with ``num_env_runners > 0``, in runner processes of
:mod:`raytpu_torch.runtime` (IMPALA and APPO then keep a fragment in
flight per runner); the update is eager torch where the JAX package
compiles one program. No TPU kernel lies on this path, so none is ported for it.
:mod:`raytpu_torch.rllib.convert` carries the JAX package's weights
across.
"""

from raytpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from raytpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from raytpu_torch.rllib.algorithms.bc import BC, MARWIL, BCConfig, MARWILConfig
from raytpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from raytpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from raytpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from raytpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from raytpu_torch.rllib.algorithms.sac import SAC, SACConfig
from raytpu_torch.rllib.connectors import (
    ClipActions,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    FrameStack,
    ObsScaler,
)
from raytpu_torch.rllib.core.learner import Learner, compute_gae, vtrace
from raytpu_torch.rllib.core.rl_module import (
    ConvPolicyModule,
    DiscretePolicyModule,
    GaussianPolicyModule,
    QModule,
    RLModule,
    RLModuleSpec,
    SACModule,
)
from raytpu_torch.rllib.env.env_runner import EnvRunnerGroup, SingleAgentEnvRunner
from raytpu_torch.rllib.env.envs import (
    CartPoleEnv,
    CatchEnv,
    PendulumEnv,
    make_env,
    register_env,
)
from raytpu_torch.rllib.utils.replay_buffer import ReplayBuffer

__all__ = [
    "Algorithm", "AlgorithmConfig", "PPO", "PPOConfig", "IMPALA",
    "IMPALAConfig", "APPO", "APPOConfig", "DQN", "DQNConfig", "SAC",
    "SACConfig", "BC", "BCConfig", "MARWIL", "MARWILConfig",
    "CQL", "CQLConfig",
    "Learner", "compute_gae", "vtrace",
    "RLModule", "RLModuleSpec", "DiscretePolicyModule", "QModule",
    "ConvPolicyModule", "GaussianPolicyModule", "SACModule",
    "Connector", "ConnectorPipeline", "ObsScaler", "FlattenObs",
    "FrameStack", "ClipActions",
    "EnvRunnerGroup", "SingleAgentEnvRunner", "register_env", "make_env",
    "CartPoleEnv", "PendulumEnv", "CatchEnv", "ReplayBuffer",
]

from raytpu_torch.util import usage_stats as _usage_stats

_usage_stats.record_library_usage("rllib")
