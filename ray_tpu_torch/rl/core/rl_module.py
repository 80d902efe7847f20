"""RLModule — the neural-network component of the RL stack, in PyTorch.

The port of ``ray_tpu/rl/core/rl_module.py`` (ref: rllib/core/rl_module/
rl_module.py:260 — forward_inference / forward_exploration / forward_train
over a framework network). A module is an ``nn.Module`` that holds its
parameters; the reference keeps them in a pytree beside a static module.
Parameter names are the reference's pytree paths (``pi.layers.0.w``,
``pi.head.b``, ``convs.0.w``), dense weights are stored (in, out) and used
as ``x @ w + b``, so ``models.convert.rl_params_from_numpy`` copies every
leaf but the conv kernels, which torch keeps as OIHW against JAX's HWIO.

Initialisation is orthogonal at the reference's scales (sqrt(2) for torsos
and convs, 0.01 for the policy head, 1.0 for the value head) with zero
biases, drawn on the CPU from a generator seeded with ``seed``: the same
weights on every device, other numbers than JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import DeviceLike, resolve_device


class Columns:
    """Batch column names (ref: rllib/core/columns.py Columns)."""

    OBS = "obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    ACTION_DIST_INPUTS = "action_dist_inputs"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"
    NEXT_OBS = "next_obs"
    EPS_ID = "eps_id"
    WEIGHTS = "weights"  # importance weights (prioritized replay)


# --------------------------------------------------------------------------
# Action distributions (ref: rllib/models/distributions.py Distribution API)
# --------------------------------------------------------------------------


class Categorical:
    """Discrete distribution over logits."""

    @staticmethod
    def sample(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
        """Gumbel-max draws, as ``jax.random.categorical`` makes them; the
        uniforms come from ``generator`` on its own device and move to the
        logits' (a host generator draws the same numbers for every
        device)."""
        u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                       device=generator.device).to(logits.device)
        u = u.clamp_min(torch.finfo(logits.dtype).tiny)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    @staticmethod
    def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        logp_all = torch.log_softmax(logits, dim=-1)
        return logp_all.gather(-1, actions.long().unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(dim=-1)

    @staticmethod
    def deterministic(logits: torch.Tensor) -> torch.Tensor:
        # torch.argmax returns the first maximum, as jnp.argmax does.
        return torch.argmax(logits, dim=-1)


class DiagGaussian:
    """Continuous distribution; dist inputs = concat(mean, log_std)."""

    @staticmethod
    def _split(inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = inputs.chunk(2, dim=-1)
        return mean, log_std.clamp(-20.0, 2.0)

    @staticmethod
    def sample(generator: torch.Generator, inputs: torch.Tensor) -> torch.Tensor:
        mean, log_std = DiagGaussian._split(inputs)
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=generator.device).to(mean.device)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def logp(inputs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        mean, log_std = DiagGaussian._split(inputs)
        var = torch.exp(2 * log_std)
        return (-0.5 * ((actions - mean) ** 2 / var + 2 * log_std
                        + math.log(2 * math.pi))).sum(dim=-1)

    @staticmethod
    def entropy(inputs: torch.Tensor) -> torch.Tensor:
        _, log_std = DiagGaussian._split(inputs)
        return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(dim=-1)

    @staticmethod
    def deterministic(inputs: torch.Tensor) -> torch.Tensor:
        mean, _ = DiagGaussian._split(inputs)
        return mean


# --------------------------------------------------------------------------
# Module base + default actor-critic
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RLModuleSpec:
    """(ref: rllib/core/rl_module/rl_module.py:69 RLModuleSpec) — carries the
    module class + ctor config so env runners and learners build identical
    networks from one spec."""

    module_class: type
    observation_dim: int
    action_dim: int
    discrete: bool = True
    model_config: Dict[str, Any] = field(default_factory=dict)

    def build(self, seed: int = 0, device: DeviceLike = None) -> "RLModule":
        """The module with weights from ``seed``, on ``device`` (the card
        unless the caller asks for the CPU)."""
        module = self.module_class(
            observation_dim=self.observation_dim,
            action_dim=self.action_dim,
            discrete=self.discrete,
            seed=seed,
            **self.model_config,
        )
        return module.to(resolve_device(device))


class RLModule(nn.Module):
    """Base module: the network's parameters and its forward passes."""

    def __init__(self, observation_dim: int, action_dim: int, discrete: bool = True,
                 **model_config: Any):
        super().__init__()
        self.observation_dim = observation_dim
        self.action_dim = action_dim
        self.discrete = discrete
        self.model_config = model_config

    # -- to implement
    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter in place from ``generator`` (a CPU one)."""
        raise NotImplementedError

    def forward_train(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Full outputs for the loss (dist inputs + value preds)."""
        raise NotImplementedError

    # -- defaults derived from forward_train
    def forward_inference(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_train(obs)

    def forward_exploration(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_train(obs)

    def forward(self, obs: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.forward_train(obs)

    def _obs(self, obs) -> torch.Tensor:
        """Observations as float32 on the module's device."""
        dev = next(self.parameters()).device
        return torch.as_tensor(obs, dtype=torch.float32, device=dev)

    @property
    def action_dist(self):
        return Categorical if self.discrete else DiagGaussian

    @property
    def dist_input_dim(self) -> int:
        return self.action_dim if self.discrete else 2 * self.action_dim


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _orthogonal(generator: torch.Generator, shape: Sequence[int],
                scale: float) -> torch.Tensor:
    """An orthogonal matrix of ``shape`` flattened to (prod(shape[:-1]),
    shape[-1]), as ``jax.nn.initializers.orthogonal`` lays it out."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    w = torch.empty(rows, cols)
    nn.init.orthogonal_(w, gain=scale, generator=generator)
    return w.reshape(*shape)


class _Dense(nn.Module):
    """``x @ w + b`` with ``w`` stored (in, out), the reference's layout."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out))

    def init(self, generator: torch.Generator, scale: float) -> None:
        with torch.no_grad():
            self.w.copy_(_orthogonal(generator, self.w.shape, scale))
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.w) + self.b


class _MLP(nn.Module):
    """Tanh torso + linear head (ref: rl_module.py _mlp_init/_mlp_apply)."""

    def __init__(self, sizes: Sequence[int], out_dim: int, in_dim: int,
                 out_scale: float = 0.01):
        super().__init__()
        dims = [in_dim, *sizes]
        self.layers = nn.ModuleList(_Dense(dims[i], dims[i + 1])
                                    for i in range(len(dims) - 1))
        self.head = _Dense(dims[-1], out_dim)
        self.out_scale = out_scale

    def init(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init(generator, math.sqrt(2.0))
        self.head.init(generator, self.out_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return self.head(x)


class DefaultActorCritic(RLModule):
    """Separate policy/value MLPs — the default small-obs module
    (ref: rllib/core/rl_module/default_model_config.py DefaultModelConfig,
    fcnet_hiddens=[256,256]; PPO's default torso)."""

    def __init__(self, observation_dim, action_dim, discrete=True,
                 hiddens: Sequence[int] = (64, 64), seed: int = 0, **kw):
        super().__init__(observation_dim, action_dim, discrete,
                         hiddens=tuple(hiddens), **kw)
        self.hiddens = tuple(hiddens)
        self.pi = _MLP(self.hiddens, self.dist_input_dim, observation_dim,
                       out_scale=0.01)
        self.vf = _MLP(self.hiddens, 1, observation_dim, out_scale=1.0)
        self.init_params(_generator(seed))

    def init_params(self, generator: torch.Generator) -> None:
        self.pi.init(generator)
        self.vf.init(generator)

    def forward_train(self, obs) -> Dict[str, torch.Tensor]:
        obs = self._obs(obs)
        return {
            Columns.ACTION_DIST_INPUTS: self.pi(obs),
            Columns.VF_PREDS: self.vf(obs)[..., 0],
        }

    def forward_exploration(self, obs) -> Dict[str, torch.Tensor]:
        return {Columns.ACTION_DIST_INPUTS: self.pi(self._obs(obs))}

    forward_inference = forward_exploration


def conv_out_dim(obs_shape, conv_filters) -> Tuple[int, int, int]:
    """(H, W, C) after a VALID-padded conv stack, validated: a kernel
    outgrowing the shrinking feature map fails HERE with the offending
    layer named, not as an opaque negative-shape error downstream."""
    h, w, c = obs_shape
    for i, (out_c, k, s) in enumerate(conv_filters):
        h = (h - k) // s + 1
        w = (w - k) // s + 1
        c = out_c
        if h <= 0 or w <= 0:
            raise ValueError(
                f"conv_filters[{i}]=({out_c},{k},{s}) shrinks the feature "
                f"map to {h}x{w} for obs_shape {tuple(obs_shape)} — reduce "
                f"kernel/stride or the number of layers")
    return h, w, c


class _Conv(nn.Module):
    """A VALID conv; ``w`` is OIHW (torch's layout; the reference's is
    HWIO)."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(out_c, in_c, k, k))
        self.b = nn.Parameter(torch.zeros(out_c))
        self.stride = stride

    def init(self, generator: torch.Generator, scale: float) -> None:
        out_c, in_c, k, _ = self.w.shape
        with torch.no_grad():
            hwio = _orthogonal(generator, (k, k, in_c, out_c), scale)
            self.w.copy_(hwio.permute(3, 2, 0, 1))
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w, self.b, stride=self.stride)


class CNNActorCritic(RLModule):
    """Conv encoder + shared-torso actor-critic for PIXEL observations
    (ref: rllib/core/models/configs.py:653 CNNEncoderConfig — the new
    stack's conv encoder; the default Atari torso shape).

    Env runners flatten observations to float32 vectors; this module
    reshapes them back to ``obs_shape`` (H, W, C), scales to [0, 1], runs
    the conv stack in NCHW and flattens in the reference's (h, w, c) order,
    so the torso's first layer reads the features the JAX module feeds it.

    model_config:
      obs_shape      (H, W, C) — required.
      conv_filters   ((out_channels, kernel, stride), ...).
      hiddens        dense widths after flattening.
    """

    def __init__(self, observation_dim, action_dim, discrete=True,
                 obs_shape=None,
                 conv_filters=((16, 4, 2), (32, 3, 1)),
                 hiddens: Sequence[int] = (128,), seed: int = 0, **kw):
        if obs_shape is None:
            raise ValueError("CNNActorCritic requires model_config["
                             "'obs_shape'] = (H, W, C)")
        super().__init__(observation_dim, action_dim, discrete,
                         obs_shape=tuple(obs_shape),
                         conv_filters=tuple(map(tuple, conv_filters)),
                         hiddens=tuple(hiddens), **kw)
        self.obs_shape = tuple(obs_shape)
        self.conv_filters = tuple(map(tuple, conv_filters))
        self.hiddens = tuple(hiddens)
        convs, in_c = [], self.obs_shape[-1]
        for out_c, k, s in self.conv_filters:
            convs.append(_Conv(in_c, out_c, k, s))
            in_c = out_c
        self.convs = nn.ModuleList(convs)
        h, w, c = conv_out_dim(self.obs_shape, self.conv_filters)
        self.torso = _MLP(self.hiddens[:-1], self.hiddens[-1], h * w * c,
                          out_scale=math.sqrt(2.0))
        self.pi = _MLP((), self.dist_input_dim, self.hiddens[-1],
                       out_scale=0.01)
        self.vf = _MLP((), 1, self.hiddens[-1], out_scale=1.0)
        self.init_params(_generator(seed))

    def init_params(self, generator: torch.Generator) -> None:
        for conv in self.convs:
            conv.init(generator, math.sqrt(2.0))
        for mlp in (self.torso, self.pi, self.vf):
            mlp.init(generator)

    def _embed(self, obs) -> torch.Tensor:
        x = self._obs(obs)
        # Learners batch as (B, T, obs_dim), runners as (N, obs_dim): fold
        # every leading dim into the conv batch, restore after the torso.
        lead = x.shape[:-1]
        x = (x.reshape(-1, *self.obs_shape) / 255.0).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        z = F.relu(self.torso(x))
        return z.reshape(*lead, z.shape[-1])

    def forward_train(self, obs) -> Dict[str, torch.Tensor]:
        z = self._embed(obs)
        return {
            Columns.ACTION_DIST_INPUTS: self.pi(z),
            Columns.VF_PREDS: self.vf(z)[..., 0],
        }

    def forward_exploration(self, obs) -> Dict[str, torch.Tensor]:
        return {Columns.ACTION_DIST_INPUTS: self.pi(self._embed(obs))}

    forward_inference = forward_exploration


class DefaultQModule(RLModule):
    """Q-network module for DQN (ref: rllib/algorithms/dqn/default_dqn_rl_module.py).

    Holds both the online and the target network; the target's parameters
    take no gradient, and the learner updates them on its own schedule.
    """

    def __init__(self, observation_dim, action_dim, discrete=True,
                 hiddens: Sequence[int] = (64, 64), seed: int = 0, **kw):
        if not discrete:
            raise ValueError("DQN requires a discrete action space")
        super().__init__(observation_dim, action_dim, discrete,
                         hiddens=tuple(hiddens), **kw)
        self.hiddens = tuple(hiddens)
        self.q = _MLP(self.hiddens, action_dim, observation_dim, out_scale=0.01)
        self.target_q = _MLP(self.hiddens, action_dim, observation_dim,
                             out_scale=0.01)
        self.target_q.requires_grad_(False)
        self.init_params(_generator(seed))

    def init_params(self, generator: torch.Generator) -> None:
        self.q.init(generator)
        self.target_q.load_state_dict(self.q.state_dict())

    def forward_train(self, obs) -> Dict[str, torch.Tensor]:
        q = self.q(self._obs(obs))
        return {"q_values": q, Columns.ACTION_DIST_INPUTS: q}

    def forward_target(self, obs) -> torch.Tensor:
        return self.target_q(self._obs(obs))

    forward_inference = forward_train
    forward_exploration = forward_train
