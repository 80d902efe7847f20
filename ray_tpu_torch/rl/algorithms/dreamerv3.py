"""DreamerV3 — model-based RL: an RSSM world model trained on replayed
sequences, with actor and critic trained entirely in imagination.

The port of ``ray_tpu/rl/algorithms/dreamerv3.py`` (ref: rllib/algorithms/
dreamerv3/ — dreamerv3.py config/algorithm, torch/dreamerv3_torch_learner.py
world-model + actor + critic losses; Hafner et al. 2023), with the same
architecture and the same reductions:

* RSSM with categorical latents (S groups x C classes), straight-through
  gradients, 1% unimix; a GRU deterministic path written as the reference
  writes it (``gates = [x, h] @ W + b``, ``cand = tanh(r * c)``), not
  ``nn.GRUCell``.
* World-model loss: symlog-MSE reconstruction, a twohot symlog reward head
  (255 buckets over symlog [-20, 20], zero-initialised output layer), a
  Bernoulli continue head, KL balancing (beta_dyn 0.5 / beta_rep 0.1) with
  1-nat free bits.
* Actor-critic on imagined rollouts: lambda-returns, a twohot critic
  against a slow EMA target, a REINFORCE actor with return-range
  normalisation and an entropy bonus.
* Vector observations use an MLP encoder; pixel observations
  (``config.obs_shape=(H, W, C)``) the conv stack of ``core/rl_module.py``
  (SiLU after every conv) and a ConvTranspose decoder mirroring it whenever
  the stack inverts exactly; otherwise an MLP decoder with a warning.

The modules live on the config's device (the card unless
``.resources(device="cpu")``); the world-model update, the actor-critic
update and the policy step run there. Parameter names are the reference's
tree (``encoder.0.w``, ``gru.w``, ``decoder.deconvs.1.w``); dense weights
are (in, out), conv kernels OIHW, transposed-conv kernels (in, out, kH, kW)
as ``F.conv_transpose2d`` takes them, flipped in both spatial axes against
the reference's HWIO (``jax.lax.conv_transpose`` does not flip).

Two optimizers, each optax's ``clip_by_global_norm(grad_clip)`` then Adam:
one over the world model's leaves together, one over actor and critic
together. The target critic is a module of its own outside both, with
``requires_grad=False``, moved by ``critic_ema`` after each actor-critic
step. The world-model update's features come from the weights before its
step and reach the actor-critic update detached; imagination runs under
``no_grad`` (actions are discrete and the straight-through latents depend
on the world model only, so no gradient of the actor-critic loss flows
through them).

Categorical draws are ``argmax(logits + gumbel)``, ``jax.random.
categorical``'s own form; every Gumbel draw comes from the algorithm's
``torch.Generator`` through one method, ``_draw_noise``, which a parity
test replaces with the reference's draws. The host's numpy generator
(``default_rng(seed)``) draws the env reset seeds and the replayed
sequences in the reference's order. The bucket grid is the port's own
``torch.linspace`` in one buffer (``_head_buckets``): it differs from
``jnp.linspace`` in the last bit of some values.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rl.algorithm import Algorithm
from ray_tpu_torch.rl.config import AlgorithmConfig
from ray_tpu_torch.rl.core.learner import host_copy
from ray_tpu_torch.rl.core.rl_module import _Conv, _Dense, conv_out_dim
from ray_tpu_torch.rl.env import cartpole
from ray_tpu_torch.rl.utils.metrics import MetricsLogger


class DreamerV3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or DreamerV3)
        self.lr = 4e-4
        self.ac_lr = 1e-4
        self.grad_clip = 100.0
        self.gamma = 0.997
        self.lambda_ = 0.95
        self.horizon = 10           # imagination length
        self.batch_size = 8         # replayed sequences per update
        self.batch_length = 16      # steps per replayed sequence
        self.deter_dim = 128
        self.stoch_groups = 8
        self.stoch_classes = 8
        self.hidden = 128
        self.free_bits = 1.0
        self.beta_dyn = 0.5
        self.beta_rep = 0.1
        self.entropy_coeff = 3e-3
        self.critic_ema = 0.98
        self.unimix = 0.01
        #: Twohot symlog distributional reward/value heads: K buckets
        #: spanning symlog [-20, 20].
        self.num_buckets = 255
        self.bucket_low = -20.0
        self.bucket_high = 20.0
        #: (H, W, C) to run the conv encoder on pixel observations (None =
        #: vector obs, MLP encoder).
        self.obs_shape = None
        self.conv_filters = ((16, 4, 2), (32, 3, 1))
        self.env_steps_per_iteration = 200
        self.updates_per_iteration = 20
        self.min_buffer_steps = 300
        self.train_batch_size = 128  # unused; base-config surface


# ------------------------------------------------------------ math utils
def symlog(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def _buckets(num: int, lo: float, hi: float, device=None) -> torch.Tensor:
    return torch.linspace(lo, hi, num, device=device)


def twohot(x: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """Twohot encoding of symlog-space targets over ``buckets`` (K,): the
    probability mass splits linearly between the two nearest buckets."""
    K = buckets.shape[0]
    x = torch.clamp(x, buckets[0], buckets[-1])
    k1 = torch.clamp(torch.searchsorted(buckets, x.contiguous()), 1, K - 1)
    k0 = k1 - 1
    b0, b1 = buckets[k0], buckets[k1]
    w1 = (x - b0) / torch.clamp(b1 - b0, min=1e-8)
    w0 = 1.0 - w1
    return (F.one_hot(k0, K) * w0[..., None]
            + F.one_hot(k1, K) * w1[..., None])


def _head_mean(logits: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """symexp(E[bucket]) of a twohot head, the expectation taken in symlog
    space."""
    return symexp(torch.sum(torch.softmax(logits, -1) * buckets, -1))


def _head_loss(logits: torch.Tensor, target_raw: torch.Tensor,
               buckets: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of twohot(symlog(target)) under the head's logits."""
    tgt = twohot(symlog(target_raw), buckets)
    return -torch.sum(tgt * torch.log_softmax(logits, -1), -1)


def _unimix_logits(logits: torch.Tensor, unimix: float,
                   classes: int) -> torch.Tensor:
    probs = torch.softmax(logits, -1)
    probs = (1 - unimix) * probs + unimix / classes
    return torch.log(probs)


def _gumbel_argmax(gumbel: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical``: the argmax of logits plus Gumbel noise."""
    return torch.argmax(logits + gumbel, -1)


def _sample_onehot(gumbel: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Straight-through one-hot categorical sample (per latent group)."""
    onehot = F.one_hot(_gumbel_argmax(gumbel, logits),
                       logits.shape[-1]).to(logits.dtype)
    probs = torch.softmax(logits, -1)
    return probs + (onehot - probs).detach()


def _kl_categorical(p_logits: torch.Tensor,
                    q_logits: torch.Tensor) -> torch.Tensor:
    """KL(p || q) summed over classes and groups, per batch element."""
    p = torch.softmax(p_logits, -1)
    logp = torch.log_softmax(p_logits, -1)
    logq = torch.log_softmax(q_logits, -1)
    return torch.sum(p * (logp - logq), dim=(-2, -1))


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _clip_by_global_norm(params: List[torch.Tensor], max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the parameters' gradients, in
    place: ``g`` if the global norm is below ``max_norm``, else
    ``g / norm * max_norm``. A parameter the loss did not read gets a zero
    gradient, as optax's Adam sees one."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


# --------------------------------------------------------------- networks
class _SiluMLP(nn.ModuleList):
    """Dense layers with SiLU between them (the reference's ``_mlp``); a
    list, so parameter names are the reference's (``reward.1.w``)."""

    def __init__(self, sizes: List[int]):
        super().__init__(_Dense(a, b) for a, b in zip(sizes[:-1], sizes[1:]))

    def init(self, generator: torch.Generator, zero_final: bool = False) -> None:
        with torch.no_grad():
            for layer in self:
                n_in = layer.w.shape[0]
                layer.w.copy_(torch.randn(layer.w.shape, generator=generator)
                              / np.sqrt(n_in))
                layer.b.zero_()
            if zero_final:
                # Randomly initialised reward/critic heads emit large early
                # predictions that delay learning (Hafner et al. 2023).
                self[-1].w.zero_()

    def forward(self, x: torch.Tensor, final_act=None) -> torch.Tensor:
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = F.silu(x)
            elif final_act is not None:
                x = final_act(x)
        return x


def _init_kernel(w: torch.Tensor, generator: torch.Generator,
                 fan_in: int) -> None:
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator) / np.sqrt(fan_in))


class _Deconv(nn.Module):
    """A VALID transposed conv; ``w`` is (in, out, k, k), the reference's
    HWIO kernel flipped in both spatial axes. Where k < s the reference's
    output is ``in * s`` and torch's ``(in - 1) * s + k``: the difference is
    ``output_padding``."""

    def __init__(self, in_c: int, out_c: int, k: int, stride: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_c, out_c, k, k))
        self.b = nn.Parameter(torch.zeros(out_c))
        self.stride = stride
        self.output_padding = max(0, stride - k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.w, self.b, stride=self.stride,
                                  output_padding=self.output_padding)


class _PixelEncoder(nn.Module):
    """The conv stack (SiLU after every conv) and a one-layer SiLU torso on
    the features flattened in (h, w, c) order."""

    def __init__(self, obs_shape, conv_filters, hidden: int):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        convs, in_c = [], self.obs_shape[-1]
        for out_c, k, s in conv_filters:
            convs.append(_Conv(in_c, out_c, k, s))
            in_c = out_c
        self.convs = nn.ModuleList(convs)
        ch, cw, cc = conv_out_dim(self.obs_shape, conv_filters)
        self.torso = _SiluMLP([ch * cw * cc, hidden])

    def init(self, generator: torch.Generator) -> None:
        for conv in self.convs:
            _, in_c, k, _ = conv.w.shape
            _init_kernel(conv.w, generator, k * k * in_c)
            with torch.no_grad():
                conv.b.zero_()
        self.torso.init(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        x = x.reshape(-1, *self.obs_shape).permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.silu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.torso(x, final_act=F.silu)
        return x.reshape(*lead, x.shape[-1])


class _DeconvDecoder(nn.Module):
    """A SiLU torso to the conv stack's output map, then the transposed
    mirror of the stack (layer i undoes encoder layer -(i+1)); the last
    layer is linear (pixels in the [-0.5, 0.5] preprocessing space)."""

    def __init__(self, obs_shape, conv_filters, feat: int):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = int(np.prod(obs_shape))
        self.map_shape = conv_out_dim(self.obs_shape, conv_filters)
        ch, cw, cc = self.map_shape
        self.torso = _SiluMLP([feat, ch * cw * cc])
        chain = [self.obs_shape[-1]] + [f[0] for f in conv_filters]
        self.deconvs = nn.ModuleList(
            _Deconv(chain[i + 1], chain[i], conv_filters[i][1],
                    conv_filters[i][2])
            for i in range(len(conv_filters) - 1, -1, -1))

    def init(self, generator: torch.Generator) -> None:
        self.torso.init(generator)
        for deconv in self.deconvs:
            in_c, _, k, _ = deconv.w.shape
            _init_kernel(deconv.w, generator, k * k * in_c)
            with torch.no_grad():
                deconv.b.zero_()

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        lead = feat.shape[:-1]
        x = self.torso(feat.reshape(-1, feat.shape[-1]), final_act=F.silu)
        x = x.reshape(-1, *self.map_shape).permute(0, 3, 1, 2)
        for j, deconv in enumerate(self.deconvs):
            x = deconv(x)
            if j < len(self.deconvs) - 1:
                x = F.silu(x)
        return x.permute(0, 2, 3, 1).reshape(*lead, self.obs_dim)


class _GRU(nn.Module):
    """The reference's GRU: ``gates = [x, h] @ w + b`` split into update,
    reset and candidate; ``h' = u * tanh(r * c) + (1 - u) * h``."""

    def __init__(self, deter: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(2 * deter, 3 * deter))
        self.b = nn.Parameter(torch.zeros(3 * deter))

    def init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=generator) * 0.02)
            self.b.zero_()

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        gates = torch.cat([x, h], -1) @ self.w + self.b
        u, r, c = torch.chunk(gates, 3, -1)
        u = torch.sigmoid(u)
        r = torch.sigmoid(r)
        cand = torch.tanh(r * c)
        return u * cand + (1 - u) * h


class DreamerV3Model(nn.Module):
    """World model (encoder, ``gru_in``, ``gru``, ``prior``, ``post``,
    decoder, ``reward``, ``cont``) and actor and critic, under the
    reference's parameter names."""

    WORLD_MODEL = ("encoder", "gru_in", "gru", "prior", "post", "decoder",
                   "reward", "cont")

    def __init__(self, cfg: DreamerV3Config, obs_dim: int, n_actions: int,
                 pixel: bool, deconv: bool):
        super().__init__()
        D, S, C, H = (cfg.deter_dim, cfg.stoch_groups, cfg.stoch_classes,
                      cfg.hidden)
        Z, K = S * C, cfg.num_buckets
        feat = D + Z
        if pixel:
            self.encoder = _PixelEncoder(cfg.obs_shape, cfg.conv_filters, H)
            self.decoder = (_DeconvDecoder(cfg.obs_shape, cfg.conv_filters,
                                           feat)
                            if deconv else _SiluMLP([feat, H, obs_dim]))
        else:
            self.encoder = _SiluMLP([obs_dim, H, H])
            self.decoder = _SiluMLP([feat, H, obs_dim])
        self.gru_in = _SiluMLP([Z + n_actions, D])
        self.gru = _GRU(D)
        self.prior = _SiluMLP([D, H, Z])
        self.post = _SiluMLP([D + H, H, Z])
        self.reward = _SiluMLP([feat, H, K])
        self.cont = _SiluMLP([feat, H, 1])
        self.actor = _SiluMLP([feat, H, n_actions])
        self.critic = _SiluMLP([feat, H, K])

    def init_params(self, generator: torch.Generator) -> None:
        for name in ("encoder", "decoder", "gru_in", "gru", "prior", "post",
                     "cont", "actor"):
            getattr(self, name).init(generator)
        self.reward.init(generator, zero_final=True)
        self.critic.init(generator, zero_final=True)

    def world_model_parameters(self) -> List[nn.Parameter]:
        return [p for name in self.WORLD_MODEL
                for p in getattr(self, name).parameters()]

    def actor_critic_parameters(self) -> List[nn.Parameter]:
        return [*self.actor.parameters(), *self.critic.parameters()]


class DreamerV3(Algorithm):
    config_class = DreamerV3Config
    learner_class = None  # self-contained: world model + AC live here

    # ------------------------------------------------------------- setup
    def setup(self, config) -> None:
        cfg = self._coerce_config(config)
        self.algo_config = cfg
        self.device = resolve_device(cfg.device)
        self.metrics = MetricsLogger()
        self._lifetime_steps = 0
        self.env_runner_group = _NullRunnerGroup()

        self._env = self._make_env()
        self._obs_dim = int(np.prod(self._env.observation_space.shape))
        self._n_actions = int(self._env.action_space.n)
        self._pixel = cfg.obs_shape is not None
        env_shape = tuple(self._env.observation_space.shape)
        if self._pixel and tuple(cfg.obs_shape) != env_shape:
            # Compare shapes, not element counts: a permuted obs_shape
            # (CHW vs HWC) has the same prod but scrambles every pixel.
            raise ValueError(
                f"obs_shape {tuple(cfg.obs_shape)} does not match the "
                f"env's observation shape {env_shape}")
        self._deconv = self._pixel and _deconv_invertible(cfg.obs_shape,
                                                          cfg.conv_filters)
        if self._pixel and not self._deconv:
            warnings.warn(
                "DreamerV3: conv_filters do not invert exactly on "
                f"obs_shape {tuple(cfg.obs_shape)} ((in-k) % s != 0 at some "
                "layer); pixel decoder falls back to an MLP",
                RuntimeWarning, stacklevel=2)
        self._head_buckets = _buckets(cfg.num_buckets, cfg.bucket_low,
                                      cfg.bucket_high, device=self.device)
        self._rng = np.random.default_rng(cfg.seed)
        self._generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        model = DreamerV3Model(cfg, self._obs_dim, self._n_actions,
                               self._pixel, self._deconv)
        # Drawn on the host from one seed: the card and the CPU start from
        # the same weights.
        model.init_params(torch.Generator().manual_seed(cfg.seed + 1))
        self.model = model.to(self.device)
        self.target_critic = _SiluMLP(
            [cfg.deter_dim + cfg.stoch_groups * cfg.stoch_classes,
             cfg.hidden, cfg.num_buckets]).to(self.device)
        self.target_critic.load_state_dict(self.model.critic.state_dict())
        self.target_critic.requires_grad_(False)
        self._wm_params = self.model.world_model_parameters()
        self._ac_params = self.model.actor_critic_parameters()
        self._wm_opt = torch.optim.Adam(self._wm_params, lr=cfg.lr)
        self._ac_opt = torch.optim.Adam(self._ac_params, lr=cfg.ac_lr)
        self._retnorm = 1.0  # EMA of the imagined-return 5-95% span
        self._buffer: List[Dict[str, np.ndarray]] = []  # episode segments
        self._buffer_steps = 0
        self._episode_returns: List[float] = []
        self._obs = None
        self._filter_state = None

    # ------------------------------------------------------------- noise
    def _draw_noise(self, site: str, *lead: int) -> Dict[str, torch.Tensor]:
        """Gumbel noise for one call site, from the algorithm's generator on
        the device: ``"policy"`` (B) gives ``z`` (B, S, C) then ``action``
        (B, A), both drawn in greedy mode too; ``"world_model"`` (T, B)
        gives ``z`` (T, B, S, C); ``"imagine"`` (H, B) gives ``action``
        (H, B, A) then ``z`` (H, B, S, C)."""
        cfg = self.algo_config
        z_shape = (*lead, cfg.stoch_groups, cfg.stoch_classes)
        a_shape = (*lead, self._n_actions)
        order = {"policy": (("z", z_shape), ("action", a_shape)),
                 "world_model": (("z", z_shape),),
                 "imagine": (("action", a_shape), ("z", z_shape))}[site]
        tiny = torch.finfo(torch.float32).tiny
        out = {}
        for name, shape in order:
            u = torch.rand(shape, generator=self._generator,
                           device=self.device).clamp_min(tiny)
            out[name] = -torch.log(-torch.log(u))
        return out

    # --------------------------------------------------------- RSSM core
    def _preprocess(self, obs: torch.Tensor) -> torch.Tensor:
        """Pixels to [-0.5, 0.5], vectors through symlog; the decoder
        reconstructs this space."""
        if self._pixel:
            return obs / 255.0 - 0.5
        return symlog(obs)

    def _prior_logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.algo_config
        logits = self.model.prior(h).reshape(*h.shape[:-1], cfg.stoch_groups,
                                             cfg.stoch_classes)
        return _unimix_logits(logits, cfg.unimix, cfg.stoch_classes)

    def _post_logits(self, h: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
        cfg = self.algo_config
        logits = self.model.post(torch.cat([h, embed], -1)).reshape(
            *h.shape[:-1], cfg.stoch_groups, cfg.stoch_classes)
        return _unimix_logits(logits, cfg.unimix, cfg.stoch_classes)

    def _step_deter(self, h, z_flat, action_onehot) -> torch.Tensor:
        x = self.model.gru_in(torch.cat([z_flat, action_onehot], -1))
        return self.model.gru(x, h)

    # ---------------------------------------------------- world-model update
    def _wm_loss(self, batch: Dict[str, torch.Tensor]):
        cfg = self.algo_config
        m = self.model
        obs = self._preprocess(batch["obs"])           # (B, T, O)
        acts = batch["actions"].long()                  # (B, T)
        B, T = acts.shape
        embed = m.encoder(obs)
        a_onehot = F.one_hot(acts, self._n_actions).float()
        noise = self._draw_noise("world_model", T, B)["z"]
        # Time-major: a_prev[t] = the action taken before observing obs[t]
        # (the first step gets zeros).
        a_prev = torch.cat([torch.zeros(1, B, self._n_actions,
                                        device=self.device),
                            a_onehot.transpose(0, 1)[:-1]], 0)
        e_tm = embed.transpose(0, 1)
        firsts = batch["is_first"].transpose(0, 1)
        h = torch.zeros(B, cfg.deter_dim, device=self.device)
        z_flat = torch.zeros(B, cfg.stoch_groups * cfg.stoch_classes,
                             device=self.device)
        hs, zs, priors, posts = [], [], [], []
        for t in range(T):
            # is_first masking: sequences pack across episode resets, so the
            # recurrent state and previous action zero out at each episode
            # start; no transition is learned across a reset.
            keep = (1.0 - firsts[t])[:, None]
            h = self._step_deter(h * keep, z_flat * keep, a_prev[t] * keep)
            prior = self._prior_logits(h)
            post = self._post_logits(h, e_tm[t])
            z_flat = _sample_onehot(noise[t], post).reshape(B, -1)
            hs.append(h)
            zs.append(z_flat)
            priors.append(prior)
            posts.append(post)
        feat = torch.cat([torch.stack(hs), torch.stack(zs)], -1)  # (T, B, F)
        priors, posts = torch.stack(priors), torch.stack(posts)

        recon = m.decoder(feat)
        rew_logits = m.reward(feat)                     # (T, B, K)
        cont_logit = m.cont(feat)[..., 0]
        obs_tm = obs.transpose(0, 1)
        rew_tm = batch["rewards"].transpose(0, 1)
        cont_tm = (1.0 - batch["terminateds"]).transpose(0, 1)

        recon_loss = torch.mean(torch.sum((recon - obs_tm) ** 2, -1))
        reward_loss = torch.mean(_head_loss(rew_logits, rew_tm,
                                            self._head_buckets))
        cont_loss = torch.mean(_sigmoid_bce(cont_logit, cont_tm))
        dyn = _kl_categorical(posts.detach(), priors)
        rep = _kl_categorical(posts, priors.detach())
        kl = (cfg.beta_dyn * torch.clamp(dyn, min=cfg.free_bits)
              + cfg.beta_rep * torch.clamp(rep, min=cfg.free_bits))
        total = recon_loss + reward_loss + cont_loss + torch.mean(kl)
        aux = {"recon_loss": recon_loss, "reward_loss": reward_loss,
               "cont_loss": cont_loss, "kl": torch.mean(dyn)}
        return total, aux, feat.detach()

    def _wm_update(self, batch: Dict[str, torch.Tensor]):
        """One world-model step: (loss, aux, features from the weights
        before the step), all on the device."""
        self._wm_opt.zero_grad(set_to_none=True)
        loss, aux, feat = self._wm_loss(batch)
        loss.backward()
        _clip_by_global_norm(self._wm_params, self.algo_config.grad_clip)
        self._wm_opt.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, feat

    # --------------------------------------------------- actor-critic update
    @torch.no_grad()
    def _imagine(self, feat0: torch.Tensor):
        """Roll the prior forward ``horizon`` steps with actor actions:
        (H, B, F) features and (H, B) actions."""
        cfg = self.algo_config
        B = feat0.shape[0]
        h = feat0[:, :cfg.deter_dim]
        z_flat = feat0[:, cfg.deter_dim:]
        noise = self._draw_noise("imagine", cfg.horizon, B)
        feats, acts = [], []
        for t in range(cfg.horizon):
            feat = torch.cat([h, z_flat], -1)
            act = _gumbel_argmax(noise["action"][t], self.model.actor(feat))
            a_onehot = F.one_hot(act, self._n_actions).float()
            h = self._step_deter(h, z_flat, a_onehot)
            z_flat = _sample_onehot(noise["z"][t],
                                    self._prior_logits(h)).reshape(B, -1)
            feats.append(feat)
            acts.append(act)
        return torch.stack(feats), torch.stack(acts)

    def _ac_loss(self, feat0: torch.Tensor, retnorm: float):
        cfg = self.algo_config
        m = self.model
        bk = self._head_buckets
        feats, acts = self._imagine(feat0)
        with torch.no_grad():
            rew = _head_mean(m.reward(feats), bk)
            disc = cfg.gamma * torch.sigmoid(m.cont(feats)[..., 0])
            v_target = _head_mean(self.target_critic(feats), bk)
            v_next = torch.cat([v_target[1:], v_target[-1:]], 0)
            returns = torch.empty_like(v_target)      # (H, B)
            nxt = v_target[-1]
            for t in range(cfg.horizon - 1, -1, -1):
                nxt = rew[t] + disc[t] * ((1 - cfg.lambda_) * v_next[t]
                                          + cfg.lambda_ * nxt)
                returns[t] = nxt
        v_logits = m.critic(feats)
        critic_loss = torch.mean(_head_loss(v_logits, returns, bk))
        v_mean = _head_mean(v_logits.detach(), bk)

        logp = torch.log_softmax(m.actor(feats), -1)
        act_logp = torch.gather(logp, -1, acts[..., None])[..., 0]
        adv = (returns - v_mean) / retnorm
        # Trajectory discount weights, so late imagined steps (past a
        # predicted termination) count less.
        weights = torch.cumprod(
            torch.cat([torch.ones_like(disc[:1]), disc[:-1]], 0), 0)
        entropy = -torch.sum(torch.exp(logp) * logp, -1)
        actor_loss = -torch.mean(weights * (act_logp * adv.detach()
                                            + cfg.entropy_coeff * entropy))
        total = actor_loss + critic_loss
        flat = returns.reshape(-1)
        span = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
        aux = {"actor_loss": actor_loss.detach(),
               "critic_loss": critic_loss.detach(),
               "imagined_return": torch.mean(returns),
               "return_span": span,
               "actor_entropy": torch.mean(entropy).detach()}
        return total, aux

    def _ac_update(self, feat0: torch.Tensor, retnorm: float):
        """One actor-critic step on the world model as it stands, then the
        target critic's EMA toward the stepped critic."""
        self._ac_opt.zero_grad(set_to_none=True)
        loss, aux = self._ac_loss(feat0, retnorm)
        loss.backward()
        _clip_by_global_norm(self._ac_params, self.algo_config.grad_clip)
        self._ac_opt.step()
        ema = self.algo_config.critic_ema
        with torch.no_grad():
            for t, o in zip(self.target_critic.parameters(),
                            self.model.critic.parameters()):
                t.copy_(ema * t + (1 - ema) * o)
        return loss.detach(), aux

    # ------------------------------------------------------------- acting
    @torch.no_grad()
    def _policy_step(self, h, z_flat, a_prev, obs, explore: bool):
        m = self.model
        embed = m.encoder(self._preprocess(obs))
        h = self._step_deter(h, z_flat, a_prev)
        post = self._post_logits(h, embed)
        noise = self._draw_noise("policy", obs.shape[0])
        z_flat = _sample_onehot(noise["z"], post).reshape(obs.shape[0], -1)
        logits = m.actor(torch.cat([h, z_flat], -1))
        act = (_gumbel_argmax(noise["action"], logits) if explore
               else torch.argmax(logits, -1))
        return h, z_flat, act

    def _act(self, obs: np.ndarray, explore: bool = True) -> int:
        cfg = self.algo_config
        if self._filter_state is None:
            self._filter_state = (
                torch.zeros(1, cfg.deter_dim, device=self.device),
                torch.zeros(1, cfg.stoch_groups * cfg.stoch_classes,
                            device=self.device),
                torch.zeros(1, self._n_actions, device=self.device))
        h, z_flat, a_prev = self._filter_state
        obs_t = torch.as_tensor(np.asarray(obs, np.float32)[None],
                                device=self.device)
        h, z_flat, act = self._policy_step(h, z_flat, a_prev, obs_t, explore)
        action = int(act[0])
        self._filter_state = (h, z_flat,
                              F.one_hot(act, self._n_actions).float())
        return action

    # ------------------------------------------------------- replay buffer
    def _collect(self, n_steps: int) -> int:
        env = self._env
        seg: Dict[str, list] = {"obs": [], "actions": [], "rewards": [],
                                "terminateds": [], "is_first": []}
        collected = 0
        if self._obs is None:
            self._obs, _ = env.reset(seed=int(self._rng.integers(1 << 30)))
            self._filter_state = None
            self._ep_return = 0.0
            self._ep_first = True
        while collected < n_steps:
            obs = np.asarray(self._obs, np.float32).ravel()
            act = self._act(obs)
            nxt, rew, term, trunc, _ = env.step(act)
            seg["obs"].append(obs)
            seg["actions"].append(act)
            seg["rewards"].append(float(rew))
            seg["terminateds"].append(1.0 if term else 0.0)
            seg["is_first"].append(1.0 if self._ep_first else 0.0)
            self._ep_first = False
            self._ep_return += float(rew)
            collected += 1
            if term or trunc:
                self._episode_returns.append(self._ep_return)
                self._obs, _ = env.reset(
                    seed=int(self._rng.integers(1 << 30)))
                self._filter_state = None
                self._ep_return = 0.0
                self._ep_first = True
            else:
                self._obs = nxt
        segment = {k: np.asarray(v, np.float32 if k != "actions"
                                 else np.int32) for k, v in seg.items()}
        self._buffer.append(segment)
        self._buffer_steps += collected
        # Bounded replay: drop oldest segments past ~50k steps.
        while self._buffer_steps > 50_000 and len(self._buffer) > 1:
            self._buffer_steps -= len(self._buffer[0]["actions"])
            self._buffer.pop(0)
        return collected

    def _sample_sequences(self) -> Optional[Dict[str, torch.Tensor]]:
        cfg = self.algo_config
        B, L = cfg.batch_size, cfg.batch_length
        eligible = [s for s in self._buffer if len(s["actions"]) >= L]
        if not eligible:
            return None
        batch: Dict[str, list] = {k: [] for k in
                                  ("obs", "actions", "rewards",
                                   "terminateds", "is_first")}
        for _ in range(B):
            seg = eligible[self._rng.integers(len(eligible))]
            start = self._rng.integers(0, len(seg["actions"]) - L + 1)
            for k in batch:
                batch[k].append(seg[k][start:start + L])
        return {k: torch.as_tensor(np.stack(v), device=self.device)
                for k, v in batch.items()}

    # ------------------------------------------------------- training step
    def training_step(self) -> Dict[str, Any]:
        cfg = self.algo_config
        stepped = self._collect(cfg.env_steps_per_iteration)
        self._lifetime_steps += stepped
        if self._buffer_steps < cfg.min_buffer_steps:
            return {"learners": {}, "buffer_steps": self._buffer_steps}

        results: Dict[str, Any] = {}
        for _ in range(cfg.updates_per_iteration):
            batch = self._sample_sequences()
            if batch is None:
                break
            wm_loss, wm_aux, feat = self._wm_update(batch)
            feat0 = feat.reshape(-1, feat.shape[-1])
            _, ac_aux = self._ac_update(feat0, max(self._retnorm, 1.0))
            self._retnorm = 0.99 * self._retnorm \
                + 0.01 * float(ac_aux["return_span"])
            results = {"world_model_loss": float(wm_loss),
                       "recon_loss": float(wm_aux["recon_loss"]),
                       "reward_loss": float(wm_aux["reward_loss"]),
                       "kl": float(wm_aux["kl"]),
                       "actor_loss": float(ac_aux["actor_loss"]),
                       "critic_loss": float(ac_aux["critic_loss"]),
                       "imagined_return": float(ac_aux["imagined_return"]),
                       "actor_entropy": float(ac_aux["actor_entropy"])}
        out = {"learners": results, "buffer_steps": self._buffer_steps}
        if self._episode_returns:
            recent = self._episode_returns[-20:]
            out["episode_return_mean"] = float(np.mean(recent))
        return out

    def _make_env(self):
        env = self.algo_config.env
        return env() if callable(env) else cartpole.make(env)

    # --------------------------------------------------------- evaluation
    def evaluate(self) -> Dict[str, Any]:
        """Greedy-policy episodes on a fresh env (the base Algorithm's
        evaluate needs the learner-group machinery DreamerV3 replaces)."""
        env = self._make_env()
        returns = []
        n_episodes = int(getattr(self.algo_config,
                                 "evaluation_duration", 5) or 5)
        for ep in range(n_episodes):
            obs, _ = env.reset(seed=1000 + ep)
            saved = self._filter_state
            self._filter_state = None
            total, done = 0.0, False
            while not done:
                act = self._act(np.asarray(obs, np.float32).ravel(),
                                explore=False)
                obs, rew, term, trunc, _ = env.step(act)
                total += float(rew)
                done = term or trunc
            self._filter_state = saved
            returns.append(total)
        try:
            env.close()
        except Exception:
            pass
        return {"env_runners": {
            "episode_return_mean": float(np.mean(returns)),
            "num_episodes": len(returns)}}

    # ------------------------------------------------------- checkpointing
    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        state = {
            "params": host_copy(self.model.state_dict()),
            "target_critic": host_copy(self.target_critic.state_dict()),
            "wm_state": host_copy(self._wm_opt.state_dict()),
            "ac_state": host_copy(self._ac_opt.state_dict()),
            "retnorm": self._retnorm,
            "lifetime_steps": self._lifetime_steps,
        }
        with open(os.path.join(checkpoint_dir, "dreamer_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)
        return None

    def load_checkpoint(self, data, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "dreamer_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.model.load_state_dict(state["params"])
        self.target_critic.load_state_dict(state["target_critic"])
        self._wm_opt.load_state_dict(state["wm_state"])
        self._ac_opt.load_state_dict(state["ac_state"])
        self._retnorm = state["retnorm"]
        self._lifetime_steps = state["lifetime_steps"]
        self._filter_state = None

    def cleanup(self) -> None:
        try:
            self._env.close()
        except Exception:
            pass


def _deconv_invertible(obs_shape, conv_filters) -> bool:
    """A VALID conv stack mirrors exactly through conv_transpose only when
    no layer's floor-division drops rows ((in - k) % s == 0 throughout)."""
    h, w, _ = obs_shape
    for _out_c, k, s in conv_filters:
        if (h - k) % s or (w - k) % s:
            return False
        h = (h - k) // s + 1
        w = (w - k) // s + 1
    return True


class _NullRunnerGroup:
    """Algorithm.step() surface for a self-contained env loop."""

    def get_metrics(self) -> List[Dict[str, Any]]:
        return []

    def stop(self) -> None:
        pass

    def sync_weights(self, *a, **kw) -> None:
        pass
