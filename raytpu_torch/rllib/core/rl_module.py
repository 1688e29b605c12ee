"""RLModule — the neural-network container: the port of
:mod:`raytpu.rllib.core.rl_module`.

The JAX package's modules own a flax net and take an explicit params
pytree in every forward. The port keeps that pure API. Each net is an
``nn.Module`` built on the ``meta`` device, a template that holds no
weights; the parameters are a dict of tensors named as the net's
``state_dict`` (``pi_0.weight``, ``torso.conv_0.bias`` ...; SAC's are
``{"pi": ..., "q1": ..., "q2": ...}``), and every forward runs the
template over them with :func:`torch.func.functional_call`. So a learner
and an env runner each hold their own parameters, and a target network
is a copy of a dict.

Initialisers follow Flax's: Dense and Conv kernels lecun-normal (a normal
truncated at two standard deviations, variance 1 / fan-in), biases 0, and
``pi_out`` orthogonal with gain 0.01, which makes the initial policy
nearly uniform. The draws are torch's, from ``seed`` on the CPU, so the
same seed gives the same weights on the CPU and on the card; the JAX
package's weights come across through :mod:`raytpu_torch.rllib.convert`.

Randomness comes from an explicit ``torch.Generator``. The Gaussian
policies also take their normal noise as an argument, so a test can feed
both packages one draw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from raytpu_torch.models.common import lecun_normal_

Params = Dict[str, Any]  # name -> tensor; SAC: "pi"/"q1"/"q2" -> such dicts


@contextlib.contextmanager
def ieee_fp32(device: torch.device):
    """On a CUDA device, cuDNN's convolutions and cuBLAS's fp32 products
    in IEEE fp32 (no TF32) while the block runs, then the process's flags
    as they were. cuDNN's default is TF32, cuBLAS's is not; the RL nets
    are small, so the card keeps the CPU's arithmetic (and the card check
    its 1e-4). The backward passes run inside the block too."""
    if device.type != "cuda":
        yield
        return
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


@dataclasses.dataclass
class RLModuleSpec:
    """Builds an RLModule (reference: ``SingleAgentRLModuleSpec``)."""

    module_class: Optional[type] = None
    observation_dim: int = 0
    action_dim: int = 0
    model_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Structured observations (pixel envs): when set, modules see
    # (B, *observation_shape) instead of flat (B, observation_dim).
    observation_shape: Optional[Tuple[int, ...]] = None
    # Continuous (Box) action spaces: bounds for squashed policies —
    # scalar, or per-dimension sequence of length action_dim.
    continuous: bool = False
    action_low: Any = -1.0
    action_high: Any = 1.0

    def build(self) -> "RLModule":
        cls = self.module_class
        if cls is None:
            if self.continuous:
                cls = GaussianPolicyModule
            elif self.observation_shape is not None:
                cls = ConvPolicyModule
            else:
                cls = DiscretePolicyModule
        kwargs = {}
        if self.observation_shape is not None:
            kwargs["observation_shape"] = self.observation_shape
        if self.continuous:
            kwargs["action_low"] = self.action_low
            kwargs["action_high"] = self.action_high
        return cls(self.observation_dim, self.action_dim, self.model_config,
                   **kwargs)


def _tower(net: nn.Module, prefix: str, n_in: int,
           hidden: Sequence[int]) -> int:
    """Add Dense layers ``{prefix}_{i}`` of widths ``hidden`` to ``net``;
    returns the last width."""
    for i, h in enumerate(hidden):
        net.add_module(f"{prefix}_{i}", nn.Linear(n_in, h))
        n_in = h
    return n_in


def _run_tower(net: nn.Module, prefix: str, n: int, x, act):
    for i in range(n):
        x = act(getattr(net, f"{prefix}_{i}")(x))
    return x


class _PolicyValueNet(nn.Module):
    """Shared-nothing policy + value towers (reference default model:
    ``rllib/models/catalog.py`` fcnet), tanh activations."""

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256), dual_head: bool = True):
        super().__init__()
        self.n_hidden = len(hidden)
        self.dual_head = dual_head
        self.pi_out = nn.Linear(_tower(self, "pi", obs_dim, hidden),
                                action_dim)
        if dual_head:
            self.vf_out = nn.Linear(_tower(self, "vf", obs_dim, hidden), 1)

    def forward(self, obs):
        x = _run_tower(self, "pi", self.n_hidden, obs, torch.tanh)
        logits = self.pi_out(x)
        if not self.dual_head:
            return logits, None
        v = _run_tower(self, "vf", self.n_hidden, obs, torch.tanh)
        return logits, self.vf_out(v)[..., 0]


def _same_padding(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: the output has ceil(n /
    s) places, and an odd total pads one more after than before (at
    stride 2: H = 10 pads 0 above and 1 below, W = 5 one each side)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _ConvTorso(nn.Module):
    """Small CNN for pixel observations (reference: ``rllib/models``
    vision nets). Takes channels-last (..., H, W, C) as the JAX net does:
    the convolutions run on NCHW, each 3x3 stride-2 one padded as XLA's
    ``SAME``, and the flatten is in NHWC order, so ``torso_out`` takes
    the JAX kernel's rows as they are."""

    def __init__(self, obs_shape: Sequence[int],
                 features: Sequence[int] = (16, 32), dense: int = 256):
        super().__init__()
        h, w, c = obs_shape
        self.n_conv = len(features)
        for i, f in enumerate(features):
            self.add_module(f"conv_{i}", nn.Conv2d(c, f, 3, stride=2))
            h, w, c = -(-h // 2), -(-w // 2), f
        self.torso_out = nn.Linear(h * w * c, dense)

    def forward(self, obs):
        lead = obs.shape[:-3]
        x = obs.reshape(-1, *obs.shape[-3:]).permute(0, 3, 1, 2)
        for i in range(self.n_conv):
            (top, bottom), (left, right) = (_same_padding(x.shape[2]),
                                            _same_padding(x.shape[3]))
            x = F.relu(getattr(self, f"conv_{i}")(
                F.pad(x, (left, right, top, bottom))))
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)
        return F.relu(self.torso_out(x))


class _ConvPolicyValueNet(nn.Module):
    def __init__(self, obs_shape: Sequence[int], action_dim: int,
                 features: Sequence[int] = (16, 32), dense: int = 256):
        super().__init__()
        self.torso = _ConvTorso(obs_shape, features, dense)
        self.pi_out = nn.Linear(dense, action_dim)
        self.vf_out = nn.Linear(dense, 1)

    def forward(self, obs):
        x = self.torso(obs)
        return self.pi_out(x), self.vf_out(x)[..., 0]


class _GaussianPolicyNet(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.n_hidden = len(hidden)
        d = _tower(self, "pi", obs_dim, hidden)
        self.mean = nn.Linear(d, action_dim)
        self.log_std = nn.Linear(d, action_dim)

    def forward(self, obs):
        x = _run_tower(self, "pi", self.n_hidden, obs, F.relu)
        return self.mean(x), torch.clamp(self.log_std(x), -20.0, 2.0)


class _QCriticNet(nn.Module):
    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (256, 256)):
        super().__init__()
        self.n_hidden = len(hidden)
        self.q_out = nn.Linear(_tower(self, "q", obs_dim + action_dim,
                                      hidden), 1)

    def forward(self, obs, act):
        x = torch.cat([obs, act], dim=-1)
        return self.q_out(_run_tower(self, "q", self.n_hidden, x,
                                     F.relu))[..., 0]


# Layers whose kernel Flax initialises orthogonal(0.01), by name.
_ORTHOGONAL = ("pi_out",)


def init_net(net: nn.Module, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Params:
    """Fresh parameters for the template ``net``, drawn on the CPU from
    ``generator`` in the order of ``named_parameters`` and moved to
    ``device``."""
    out = {}
    for name, p in net.named_parameters():
        t = torch.empty(p.shape)
        if name.endswith(".bias"):
            t.zero_()
        elif name.rsplit(".", 1)[0] in _ORTHOGONAL:
            nn.init.orthogonal_(t, gain=0.01, generator=generator)
        else:
            lecun_normal_(t, generator)
        out[name] = t.to(device) if device is not None else t
    return out


def _categorical(logits, generator):
    """A draw per row from softmax(logits), by the Gumbel-max trick that
    ``jax.random.categorical`` uses (the draws are torch's)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    tiny = torch.finfo(logits.dtype).tiny
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(tiny))),
                        dim=-1)


class RLModule:
    """Base: categorical-policy module over a torch net.

    Pure-function API, as the JAX package's:
      - ``forward_exploration(params, obs, generator)`` → actions, logp, vf
      - ``forward_inference(params, obs)`` → greedy actions
      - ``forward_train(params, obs)`` → logits, vf (used by losses)
    """

    # Sampling-plane contract (env runners size their buffers off these):
    action_shape: Tuple[int, ...] = ()      # per-env action shape
    action_dtype: Any = np.int32
    is_continuous: bool = False
    has_value_head: bool = True  # forward_train returns (logits, vf)

    def __init__(self, observation_dim: int, action_dim: int,
                 model_config: Optional[Dict[str, Any]] = None,
                 observation_shape: Optional[Tuple[int, ...]] = None,
                 action_low: Any = -1.0, action_high: Any = 1.0):
        self.observation_dim = observation_dim
        self.observation_shape = (tuple(observation_shape)
                                  if observation_shape else None)
        self.action_dim = action_dim
        # Per-dimension bound vectors (scalars broadcast up).
        self.action_low = np.broadcast_to(
            np.asarray(action_low, np.float32), (action_dim,)).copy()
        self.action_high = np.broadcast_to(
            np.asarray(action_high, np.float32), (action_dim,)).copy()
        self.model_config = model_config or {}
        with torch.device("meta"):
            self.net = self._build_net()

    def _hidden(self) -> Tuple[int, ...]:
        return tuple(self.model_config.get("fcnet_hiddens", (256, 256)))

    def _build_net(self) -> nn.Module:
        return _PolicyValueNet(self.observation_dim, self.action_dim,
                               self._hidden(),
                               self.model_config.get("dual_head", True))

    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> Params:
        return init_net(self.net, torch.Generator().manual_seed(seed),
                        device)

    # -- pure forwards --------------------------------------------------------

    def forward_train(self, params: Params, obs):
        return functional_call(self.net, params, (obs,))

    def forward_exploration(self, params: Params, obs,
                            generator: torch.Generator):
        logits, vf = self.forward_train(params, obs)
        actions = _categorical(logits, generator)
        logp = F.log_softmax(logits, dim=-1)
        action_logp = torch.gather(logp, -1, actions[..., None])[..., 0]
        return actions, action_logp, vf

    def forward_inference(self, params: Params, obs):
        logits, _ = self.forward_train(params, obs)
        return torch.argmax(logits, dim=-1)

    def logp_entropy(self, params: Params, obs, actions):
        logits, vf = self.forward_train(params, obs)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1, actions[..., None].long())[..., 0]
        probs = F.softmax(logits, dim=-1)
        entropy = -torch.sum(probs * logp_all, dim=-1)
        return logp, entropy, vf


class DiscretePolicyModule(RLModule):
    """Default module (policy + value heads)."""


class QModule(RLModule):
    """Q-network module for DQN-family algorithms: the "policy head" emits
    Q-values; no value head."""

    has_value_head = False

    def _build_net(self) -> nn.Module:
        return _PolicyValueNet(self.observation_dim, self.action_dim,
                               self._hidden(), dual_head=False)

    def q_values(self, params: Params, obs):
        q, _ = self.forward_train(params, obs)
        return q

    def forward_exploration(self, params: Params, obs,
                            generator: torch.Generator,
                            epsilon: float = 0.1):
        q, _ = self.forward_train(params, obs)
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, self.action_dim, greedy.shape,
                                 generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < epsilon
        actions = torch.where(explore, random_a, greedy)
        return actions, torch.zeros(actions.shape, device=q.device), None


class ConvPolicyModule(RLModule):
    """Categorical policy over a shared CNN torso — the pixel-observation
    module (reference: RLlib vision catalog models)."""

    def _build_net(self) -> nn.Module:
        return _ConvPolicyValueNet(
            self.observation_shape, self.action_dim,
            tuple(self.model_config.get("conv_features", (16, 32))),
            int(self.model_config.get("dense", 256)))


def _pi(params: Params) -> Params:
    """The policy's parameters of a SAC tree or of a policy alone."""
    return params["pi"] if "pi" in params else params


class GaussianPolicyModule(RLModule):
    """Tanh-squashed diagonal Gaussian for continuous (Box) actions.

    ``sample(params, obs, generator, noise=None)`` returns (action, logp)
    with the tanh change-of-variables correction; actions land in
    [action_low, action_high]. ``noise`` is the standard normal draw,
    shaped as the actions; None draws it from ``generator``.
    """

    action_dtype = np.float32
    is_continuous = True
    has_value_head = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.action_shape = (self.action_dim,)
        self._bounds_on: Dict[torch.device, tuple] = {}

    def _build_net(self) -> nn.Module:
        return _GaussianPolicyNet(self.observation_dim, self.action_dim,
                                  self._hidden())

    def _bounds(self, device: torch.device):
        """(low, high, the log-Jacobian of the affine rescale) on
        ``device``, copied there once."""
        if device not in self._bounds_on:
            lo = torch.as_tensor(self.action_low, device=device)
            hi = torch.as_tensor(self.action_high, device=device)
            self._bounds_on[device] = (
                lo, hi, torch.sum(torch.log((hi - lo) * 0.5 + 1e-8)))
        return self._bounds_on[device]

    def _squash(self, u):
        lo, hi, _ = self._bounds(u.device)
        return lo + (torch.tanh(u) + 1.0) * 0.5 * (hi - lo)

    def sample(self, params: Params, obs,
               generator: Optional[torch.Generator] = None, noise=None):
        mean, log_std = functional_call(self.net, _pi(params), (obs,))
        std = torch.exp(log_std)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
        u = mean + std * noise
        # logp under the squashed distribution: N(u) minus the tanh and
        # per-dimension affine-rescale jacobians.
        logp_u = -0.5 * (((u - mean) / std) ** 2 + 2 * log_std
                         + math.log(2 * math.pi))
        logp = torch.sum(logp_u - 2.0 * (math.log(2.0) - u
                                         - F.softplus(-2.0 * u)), dim=-1)
        return self._squash(u), logp - self._bounds(u.device)[2]

    def forward_exploration(self, params: Params, obs,
                            generator: torch.Generator):
        a, logp = self.sample(params, obs, generator)
        return a, logp, None

    def forward_inference(self, params: Params, obs):
        mean, _ = functional_call(self.net, _pi(params), (obs,))
        return self._squash(mean)


class SACModule(GaussianPolicyModule):
    """SAC container: squashed-Gaussian actor + twin Q critics
    (reference: ``rllib/algorithms/sac/sac_torch_model.py`` twin-Q). The
    two critics share one template."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        with torch.device("meta"):
            self.critic = _QCriticNet(self.observation_dim, self.action_dim,
                                      self._hidden())

    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> Params:
        g = torch.Generator().manual_seed(seed)
        return {"pi": init_net(self.net, g, device),
                "q1": init_net(self.critic, g, device),
                "q2": init_net(self.critic, g, device)}

    def q(self, q_params: Params, obs, act):
        """One critic's Q(obs, act) under ``q_params``."""
        return functional_call(self.critic, q_params, (obs, act))

    def q_values(self, params: Params, obs, act):
        return (self.q(params["q1"], obs, act),
                self.q(params["q2"], obs, act))
