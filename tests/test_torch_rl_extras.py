"""The port's DQN, IMPALA, APPO, SAC, CQL, BC, MARWIL and offline data
(ray_tpu_torch.rl) against the JAX package's (ray_tpu.rl), on the CPU in
fp32.

Weights: the reference's init as numpy, loaded into the port's modules by
``models.convert.rl_params_from_numpy``; inputs from numpy seeds. V-trace on
padded, masked (B, T) rows within ``VTRACE_TOL`` of the reference's vmapped
scan, and ``build_vtrace_batch`` equal exactly. One or two
``update_from_batch`` calls of each learner (DQN with its TD errors and both
target syncs, IMPALA, APPO with and without its KL loss, SAC and CQL with
the reference's JAX noise injected in place of the port's draw): every
weight and Adam moment within ``UPDATE_TOL``, every metric within it
relative (measured on this CPU at lr 1e-2 to 5e-2: weights and TD errors
at most 1.9e-6, moments 1.7e-6, metrics 2.4e-7 relative).
Whole ``algo.train()`` iterations of BC and MARWIL from the same data and
weights: the same offline batches, weights within ``UPDATE_TOL``. Files
written by either package's ``record_episodes`` read back the same in both,
and both ``OfflineData`` modes draw the same batches. Then the port's own
counterparts of ``tests/test_rl.py``'s DQN and IMPALA cases and of
``tests/test_rl_extras.py``.
"""

import importlib
import math

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.dataset  # noqa: F401 — on the main thread: its first import on a
#                         read task's thread crashed the interpreter here
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_rl import (UPDATE_TOL, _assert_learner_equal, _assert_metrics_equal,
                       _flat, _np_tree, _port_moments, _ref_moments)
from _torch_runtimes import fresh_init, gc_paused
from ray_tpu.rl.algorithms import appo as jappo
from ray_tpu.rl.algorithms import bc as jbc
from ray_tpu.rl.algorithms import cql as jcql
from ray_tpu.rl.algorithms import dqn as jdqn
from ray_tpu.rl.algorithms import impala as jimpala
from ray_tpu.rl.algorithms import marwil as jmarwil
from ray_tpu.rl.algorithms import sac as jsac
from ray_tpu.rl import offline as joffline
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu.rl.env.episode import SingleAgentEpisode as JEpisode
from ray_tpu_torch.models.convert import rl_params_from_numpy, rl_params_to_numpy
from ray_tpu_torch.rl import Columns, OfflineData, SingleAgentEpisode, record_episodes
from ray_tpu_torch.rl import offline as poffline
from ray_tpu_torch.rl.algorithms import (APPOConfig, APPOLearner, BCConfig,
                                         CQLConfig, CQLLearner, DQNConfig,
                                         DQNLearner, IMPALAConfig, IMPALALearner,
                                         MARWILConfig, SACConfig, SACLearner)
from ray_tpu_torch.rl.algorithms.dqn import DQN
from ray_tpu_torch.rl.algorithms.impala import IMPALA, build_vtrace_batch, vtrace
from ray_tpu_torch.rl.algorithms.marwil import returns_to_go
from ray_tpu_torch.rl.algorithms.sac import SACModule, SquashedGaussian
from ray_tpu_torch.rl.core.rl_module import (DefaultActorCritic, DefaultQModule,
                                             RLModuleSpec)
from ray_tpu_torch.rl.env import cartpole

VTRACE_TOL = 1e-6
DIST_TOL = 1e-6


@pytest.fixture
def rt():
    runtime = fresh_init(ray_tpu_torch, num_cpus=8)
    yield runtime
    ray_tpu_torch.shutdown()


# ------------------------------------------------------------------ V-trace
def _vtrace_rows(seed, B=5, T=8):
    """(B, T) V-trace inputs: rows of lengths T, 3, 5, 1, 6 padded with
    discount 0 and mask 0, one terminal row (discount 0 at its end)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    lengths = [T, 3, 5, 1, 6][:B]
    mask = np.zeros((B, T), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    disc = 0.9 * mask
    disc[2, lengths[2] - 1] = 0.0
    return dict(behavior_logp=f(B, T) - 0.7, target_logp=f(B, T) - 0.7,
                rewards=f(B, T), values=f(B, T), bootstrap_value=f(B),
                discounts=disc, mask=mask)


@pytest.mark.parametrize("clip_rho,clip_pg_rho", [(1.0, 1.0), (0.8, 1.5)])
def test_vtrace_matches_the_reference(clip_rho, clip_pg_rho):
    rows = _vtrace_rows(0)
    want = jax.vmap(lambda blp, tlp, r, v, bv, d, m: jimpala.vtrace(
        blp, tlp, r, v, bv, d, clip_rho, clip_pg_rho, mask=m))(
        *(rows[k] for k in ("behavior_logp", "target_logp", "rewards",
                            "values", "bootstrap_value", "discounts", "mask")))
    got = vtrace(**{k: torch.from_numpy(v) for k, v in rows.items()},
                 clip_rho=clip_rho, clip_pg_rho=clip_pg_rho)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=VTRACE_TOL,
                                   rtol=0)
    # A padded step's reward reaches no real step (its delta is masked and
    # its discount 0). Its value does reach the real step before it, as in
    # the reference: that step's delta reads values[t + 1].
    noisy = {k: v.copy() for k, v in rows.items()}
    pad = rows["mask"] == 0
    noisy["rewards"][pad] += 100.0
    again = vtrace(**{k: torch.from_numpy(v) for k, v in noisy.items()},
                   clip_rho=clip_rho, clip_pg_rho=clip_pg_rho)
    for g, a in zip(got, again):
        real = torch.from_numpy(~pad)
        np.testing.assert_allclose(a[real].numpy(), g[real].numpy(), atol=1e-6)


def _episode_pair(seed, T, terminated=False, truncated=False, obs_dim=4,
                  continuous=False):
    """The same trajectory as a reference and a port episode."""
    rng = np.random.default_rng(seed)
    pair = (JEpisode(), SingleAgentEpisode())
    obs0 = rng.normal(size=obs_dim).astype(np.float32)
    for ep in pair:
        ep.add_env_reset(obs0)
    for t in range(T):
        obs = rng.normal(size=obs_dim).astype(np.float32)
        act = (rng.uniform(-2, 2, size=(1,)).astype(np.float32) if continuous
               else int(rng.integers(0, 2)))
        rew = float(rng.normal())
        logp = float(-0.7 + 0.1 * rng.normal())
        last = t == T - 1
        for ep in pair:
            ep.add_env_step(obs, act, rew, terminated=terminated and last,
                            truncated=truncated and last,
                            extra={Columns.ACTION_LOGP: logp})
    return pair


def _episodes(seeds_lengths, **kw):
    pairs = [_episode_pair(s, n, terminated=(i % 3 == 0), truncated=(i % 3 == 1),
                           **kw) for i, (s, n) in enumerate(seeds_lengths)]
    return [a for a, _ in pairs], [b for _, b in pairs]


def test_build_vtrace_batch_equals_the_reference():
    """Fragments longer than T split into rows, short ones padded; the
    terminal chunk's discount and bootstrap flag; equal bit for bit."""
    ref_eps, port_eps = _episodes([(1, 23), (2, 4), (3, 10), (4, 17)])
    want = jimpala.build_vtrace_batch(ref_eps, 10, 0.97)
    got = build_vtrace_batch(port_eps, 10, 0.97)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    assert got[Columns.OBS].shape == (7, 10, 4)  # rows of 23, 4, 10, 17 steps: 3+1+1+2
    assert int(got["mask"].sum()) == 23 + 4 + 10 + 17


# ------------------------------------------------------------ DQN learner
def _q_batch(rng, n, weights=False):
    batch = {
        Columns.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        Columns.ACTIONS: rng.integers(0, 2, n).astype(np.int64),
        Columns.REWARDS: rng.normal(size=n).astype(np.float32),
        Columns.NEXT_OBS: rng.normal(size=(n, 4)).astype(np.float32),
        Columns.TERMINATEDS: (rng.random(n) < 0.2).astype(np.float32),
        Columns.TRUNCATEDS: np.zeros(n, np.float32),
    }
    if weights:
        batch[Columns.WEIGHTS] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return batch


@pytest.mark.parametrize("double_q,prioritized,tau", [
    (True, True, 1.0), (False, False, 0.5)])
def test_dqn_update_matches_the_reference(double_q, prioritized, tau):
    """Two updates, the target synced after each (hard: a copy; soft: tau
    0.5), from a target network that differs from the online one; the TD
    errors before and after."""
    training = dict(lr=1e-2, double_q=double_q, target_network_update_freq=1,
                    tau=tau, gamma=0.9)
    kw = dict(observation_dim=4, action_dim=2, discrete=True,
              model_config={"hiddens": (16, 16)})
    jl = jdqn.DQNLearner(config=jdqn.DQNConfig().training(**training),
                         module_spec=jrl.RLModuleSpec(
                             module_class=jrl.DefaultQModule, **kw), seed=0)
    jl.params["target_q"] = jax.tree.map(lambda x: x * 1.7, jl.params["target_q"])
    pl = DQNLearner(config=DQNConfig().training(**training).resources(device="cpu"),
                    module_spec=RLModuleSpec(module_class=DefaultQModule, **kw),
                    seed=0)
    rl_params_from_numpy(pl.module, _np_tree(jl.params))
    rng = np.random.default_rng(3)
    batches = [_q_batch(rng, 48, weights=prioritized) for _ in range(2)]
    np.testing.assert_allclose(pl.compute_td_errors(batches[0]),
                               jl.compute_td_errors(batches[0]),
                               atol=UPDATE_TOL, rtol=0)
    for batch in batches:
        want = jl.update_from_batch(dict(batch))
        got = pl.update_from_batch(dict(batch))
        _assert_metrics_equal(got, want)
    _assert_learner_equal(jl.params, _ref_moments(jl.opt_state), pl.module,
                          _port_moments([pl.optimizer], pl.module))
    if tau >= 1.0:
        assert all(torch.equal(a, b) for a, b in zip(
            pl.module.target_q.parameters(), pl.module.q.parameters()))
    assert not any(p.requires_grad for p in pl.module.target_q.parameters())
    np.testing.assert_allclose(pl.compute_td_errors(batches[1]),
                               jl.compute_td_errors(batches[1]),
                               atol=UPDATE_TOL, rtol=0)


# ------------------------------------------------ IMPALA and APPO learners
def _vtrace_batch(jmodule, jparams, seed):
    """A (B, T) V-trace batch from padded fragments, behaviour log-probs the
    module's own plus noise (ratios leave APPO's clip range)."""
    _, port_eps = _episodes([(seed, 13), (seed + 1, 5), (seed + 2, 8),
                             (seed + 3, 2)])
    batch = build_vtrace_batch(port_eps, 6, 0.95)
    rng = np.random.default_rng(seed)
    inputs = jmodule.forward_train(jparams, batch[Columns.OBS])[
        Columns.ACTION_DIST_INPUTS]
    logp = np.asarray(jrl.Categorical.logp(inputs, batch[Columns.ACTIONS]))
    batch[Columns.ACTION_LOGP] = (logp + rng.normal(0.15, 0.5, logp.shape)
                                  ).astype(np.float32) * batch["mask"]
    batch.pop("bootstrap_obs")
    batch.pop("bootstrap_terminated")
    batch["bootstrap_value"] = rng.normal(size=len(batch["mask"])).astype(np.float32)
    return batch


@pytest.mark.parametrize("algo,use_kl_loss,grad_clip", [
    ("impala", False, None), ("impala", False, 0.3), ("appo", False, None),
    ("appo", True, None)])
def test_vtrace_learner_update_matches_the_reference(algo, use_kl_loss,
                                                     grad_clip):
    """Two epochs over the (B, T) rows (the reference's permutation order),
    entropy bonus on; APPO with clip 0.2 and, with its KL loss, the
    coefficient riding the batch as a 0-d entry."""
    training = dict(lr=1e-2, entropy_coeff=0.01, grad_clip=grad_clip)
    if algo == "appo":
        training.update(clip_param=0.2, use_kl_loss=use_kl_loss)
        jcls, jcfg, pcls, pcfg = (jappo.APPOLearner, jappo.APPOConfig,
                                  APPOLearner, APPOConfig)
    else:
        jcls, jcfg, pcls, pcfg = (jimpala.IMPALALearner, jimpala.IMPALAConfig,
                                  IMPALALearner, IMPALAConfig)
    kw = dict(observation_dim=4, action_dim=2, discrete=True,
              model_config={"hiddens": (16, 16)})
    jl = jcls(config=jcfg().training(**training), module_spec=jrl.RLModuleSpec(
        module_class=jrl.DefaultActorCritic, **kw), seed=0)
    pl = pcls(config=pcfg().training(**training).resources(device="cpu"),
              module_spec=RLModuleSpec(module_class=DefaultActorCritic, **kw),
              seed=0)
    rl_params_from_numpy(pl.module, _np_tree(jl.params))
    batch = _vtrace_batch(jl.module, jl.params, 5)
    if use_kl_loss:
        batch["kl_coeff"] = np.float32(0.3)
    want = jl.update_from_batch(dict(batch), num_epochs=2)
    got = pl.update_from_batch(dict(batch), num_epochs=2)
    _assert_metrics_equal(got, want)
    if algo == "appo":
        assert ("mean_kl" in got) == use_kl_loss and "mean_ratio" in got
        assert not use_kl_loss or got["mean_kl"] > 0  # the penalty engaged
    if grad_clip:
        assert got["grad_norm"] > grad_clip
    _assert_learner_equal(jl.params, _ref_moments(jl.opt_state), pl.module,
                          _port_moments([pl.optimizer], pl.module))


# ------------------------------------------------------- SAC and CQL learners
def _sac_noise(key, B, A, cql=None):
    """The reference step's noise for its key (``sac.py`` ``step``: split
    into k_next, k_new; k_next split again into k_pen, k_next; CQL splits
    k_pen into k_rand and k_pi, and k_pi into one key per policy sample)."""
    k_next, k_new = jax.random.split(key)
    noise = {"next": jax.random.normal(k_next, (B, A)),
             "new": jax.random.normal(k_new, (B, A))}
    if cql is not None:
        n, scale = cql
        k_pen, _ = jax.random.split(k_next)
        k_rand, k_pi = jax.random.split(k_pen)
        noise["rand"] = jax.random.uniform(k_rand, (n, B, A), minval=-scale,
                                           maxval=scale)
        noise["pi"] = jnp.stack([jax.random.normal(k, (B, A))
                                 for k in jax.random.split(k_pi, n)])
    return {k: torch.from_numpy(np.array(v)) for k, v in noise.items()}


def _pendulum_batch(rng, n):
    th = rng.uniform(-np.pi, np.pi, n)
    obs = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, n)], 1)
    th2 = th + rng.normal(0, 0.1, n)
    nxt = np.stack([np.cos(th2), np.sin(th2), rng.uniform(-8, 8, n)], 1)
    return {Columns.OBS: obs.astype(np.float32),
            Columns.ACTIONS: rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            Columns.REWARDS: -rng.uniform(0, 10, n).astype(np.float32),
            Columns.NEXT_OBS: nxt.astype(np.float32),
            Columns.TERMINATEDS: (rng.random(n) < 0.1).astype(np.float32),
            Columns.TRUNCATEDS: np.zeros(n, np.float32)}


def _sac_pair(algo, **training):
    kw = dict(observation_dim=3, action_dim=1, discrete=False,
              model_config={"hiddens": (16, 16), "action_scale": 2.0})
    jcls, jcfg, pcls, pcfg = ((jcql.CQLLearner, jcql.CQLConfig, CQLLearner,
                               CQLConfig) if algo == "cql" else
                              (jsac.SACLearner, jsac.SACConfig, SACLearner,
                               SACConfig))
    jl = jcls(config=jcfg().training(**training), module_spec=jrl.RLModuleSpec(
        module_class=jsac.SACModule, **kw), seed=0)
    pl = pcls(config=pcfg().training(**training).resources(device="cpu"),
              module_spec=RLModuleSpec(module_class=SACModule, **kw), seed=0)
    return jl, pl


def _sac_moments(jl):
    return _ref_moments(
        [jl.opt_state["pi"], jl.opt_state["q"], jl.opt_state["alpha"]],
        ("pi.", lambda k: ("q1." if k.startswith("0.") else "q2.") + k[2:],
         lambda k: "log_alpha"))


@pytest.mark.parametrize("algo", ["sac", "cql"])
def test_sac_update_matches_the_reference_with_its_noise(algo):
    """Two updates from the same weights (the target critics moved off the
    online ones), each with the reference's JAX noise for its key: every
    metric, weight (actor, critics, targets, log_alpha) and the three
    optimizers' moments."""
    training = dict(lr=1e-2, critic_lr=2e-2, alpha_lr=5e-2, tau=0.1,
                    initial_alpha=0.5, gamma=0.95)
    if algo == "cql":
        training.update(min_q_weight=5.0, num_penalty_actions=3)
    jl, pl = _sac_pair(algo, **training)
    for k in ("target_q1", "target_q2"):
        jl.params[k] = jax.tree.map(lambda x: x * 1.3, jl.params[k])
    rl_params_from_numpy(pl.module, _np_tree(jl.params))
    rng = np.random.default_rng(2)
    batches = [_pendulum_batch(rng, 32) for _ in range(2)]
    key, noises = jl._key, []
    for _ in batches:
        key, sub = jax.random.split(key)
        noises.append(_sac_noise(sub, 32, 1, (3, 2.0) if algo == "cql" else None))
    draws = iter(noises)
    pl._draw_noise = lambda batch_size: next(draws)
    for batch in batches:
        want = jl.update_from_batch(dict(batch))
        got = pl.update_from_batch(dict(batch))
        _assert_metrics_equal(got, want)
    _assert_learner_equal(jl.params, _sac_moments(jl), pl.module,
                          _port_moments(pl.optimizers.values(), pl.module))
    assert set(pl.get_weights()) == {k for k in pl.module.state_dict()
                                     if k.startswith("pi.")}


def test_sac_noise_is_drawn_in_one_place_in_order():
    """Without injection the port draws its own noise from the learner's
    generator: one seed, the same update twice."""
    results = []
    for _ in range(2):
        _, pl = _sac_pair("cql", num_penalty_actions=2)
        batch = _pendulum_batch(np.random.default_rng(0), 16)
        results.append(pl.update_from_batch(dict(batch)))
    assert results[0] == results[1]
    _, pl = _sac_pair("cql", num_penalty_actions=2)
    noise = pl._draw_noise(16)
    assert list(noise) == ["next", "new", "rand", "pi"]
    assert noise["rand"].shape == (2, 16, 1)
    assert noise["rand"].abs().max() <= 2.0


def test_sac_refuses_several_learners():
    spec = RLModuleSpec(module_class=SACModule, observation_dim=3, action_dim=1,
                        discrete=False, model_config={"hiddens": (8,)})
    with pytest.raises(NotImplementedError, match="multi-learner"):
        SACLearner(config=SACConfig().resources(device="cpu"), module_spec=spec,
                   rank=0, world_size=2)


def test_squashed_gaussian_matches_the_reference():
    rng = np.random.default_rng(4)
    inputs = (rng.normal(size=(64, 4)) * 2).astype(np.float32)
    inputs[:3, 2:] = [[-30.0, 5.0]] * 3  # log_std clipped both ways
    noise = rng.normal(size=(64, 2)).astype(np.float32)
    jd, pd = jsac.SquashedGaussian(2.0), SquashedGaussian(2.0)
    it, nt = torch.from_numpy(inputs), torch.from_numpy(noise)
    mean, log_std = np.split(inputs, 2, axis=-1)
    pre = mean + np.exp(np.clip(log_std, -20, 2)) * noise
    act, logp = pd.sample_with_logp(nt, it)
    np.testing.assert_allclose(act.numpy(), np.tanh(pre) * 2.0, atol=DIST_TOL)
    # The reference's log-density at the port's tanh: 1 - tanh**2 cancels
    # near saturation, where one ulp of tanh moves the log by ~0.1.
    want_logp = np.asarray(jd._logp_pre(inputs, pre, act.numpy() / 2.0))
    np.testing.assert_allclose(logp.numpy(), want_logp, atol=1e-5, rtol=1e-6)
    # logp of given actions, away from the saturated ends and from the rows
    # whose std is clipped to e^-20 (both amplify atanh's last bit).
    acts = rng.uniform(-1.9, 1.9, size=(61, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pd.logp(it[3:], torch.from_numpy(acts)).numpy(),
        np.asarray(jd.logp(inputs[3:], acts)), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(pd.entropy(it).numpy(),
                               np.asarray(jd.entropy(inputs)), atol=DIST_TOL)
    np.testing.assert_allclose(pd.deterministic(it).numpy(),
                               np.asarray(jd.deterministic(inputs)),
                               atol=DIST_TOL)


def test_sac_module_tree_carries_across():
    """``rl_params_to_numpy`` gives the reference's tree (``log_alpha`` a
    0-d leaf), and the round trip is exact."""
    jm = jsac.SACModule(3, 1, False, hiddens=(8,), action_scale=2.0)
    jp = _np_tree(jm.init_params(jax.random.key(1)))
    jp["log_alpha"] = np.float32(-0.25)
    pm = rl_params_from_numpy(SACModule(3, 1, False, hiddens=(8,),
                                        action_scale=2.0), jp)
    back = rl_params_to_numpy(pm)
    assert set(back) == {"pi", "q1", "q2", "target_q1", "target_q2", "log_alpha"}
    assert back["log_alpha"].shape == () and back["log_alpha"] == np.float32(-0.25)
    want, got = _flat(jp), _flat(back)
    assert set(want) == set(got)
    assert all(np.array_equal(want[k], got[k]) for k in want)
    assert not any(p.requires_grad for p in pm.target_q1.parameters())
    assert pm.target_q1.layers[0].w.data_ptr() != pm.q1.layers[0].w.data_ptr()
    obs = torch.randn(5, 3)
    np.testing.assert_allclose(
        pm.forward_train(obs)[Columns.ACTION_DIST_INPUTS].detach().numpy(),
        np.asarray(jm.forward_train(jp, obs.numpy())[Columns.ACTION_DIST_INPUTS]),
        atol=1e-6)


# ------------------------------------------------------ offline: BC, MARWIL
def _expert_action(obs) -> int:
    """Scripted CartPole policy: push toward the pole's lean."""
    return int(obs[2] + obs[3] > 0)


def _record_cartpole(n_steps, mixed=False, episode_cls=SingleAgentEpisode):
    """Episodes of the port's CartPole (gymnasium's, bit for bit) under the
    expert, or half expert and half random (numpy seed 0)."""
    env = cartpole.make("CartPole-v1")
    rng = np.random.default_rng(0)
    episodes, steps = [], 0
    while steps < n_steps:
        obs, _ = env.reset(seed=steps)
        ep = episode_cls()
        ep.add_env_reset(np.asarray(obs, np.float32))
        done = False
        while not done:
            if not mixed or rng.random() < 0.5:
                act = _expert_action(obs)
            else:
                act = int(rng.integers(0, 2))
            obs, reward, term, trunc, _ = env.step(act)
            ep.add_env_step(np.asarray(obs, np.float32), act, reward,
                            terminated=term, truncated=trunc)
            steps += 1
            done = term or trunc
        episodes.append(ep)
    return episodes


def _offline_columns(n_steps, mixed):
    from ray_tpu_torch.rl.connectors import episodes_to_transitions

    return episodes_to_transitions(_record_cartpole(n_steps, mixed))


@pytest.mark.parametrize("algo", ["bc", "marwil"])
def test_offline_iterations_match_the_reference(algo):
    """Two ``train()`` iterations of 8 updates each from the same in-memory
    dataset and the same initial weights: the same batches (numpy draws of
    ``default_rng(seed)``), MARWIL's returns-to-go equal exactly, every
    weight within ``UPDATE_TOL``."""
    cols = _offline_columns(600, mixed=True)
    jcfg_cls, pcfg_cls = ((jbc.BCConfig, BCConfig) if algo == "bc"
                          else (jmarwil.MARWILConfig, MARWILConfig))

    def configure(cfg):
        return (cfg.environment("CartPole-v1")
                .offline_data(input_={k: v.copy() for k, v in cols.items()},
                              updates_per_iteration=8)
                .training(train_batch_size=64, lr=3e-3)
                .rl_module(model_config={"hiddens": (16, 16)})
                .debugging(seed=0))

    with gc_paused():
        fresh_init(ray_tpu)
        ref = configure(jcfg_cls()).build_algo()
        ref_results = [ref.train()["learners"] for _ in range(2)]
        ref_next = ref.offline.sample(8)
        ref_params = _np_tree(ref.learner_group._local.params)
        ref_init = _np_tree(ref.learner_group._local.module.init_params(
            jax.random.key(0)))
        ref_cols = {k: v.copy() for k, v in ref.offline.columns.items()}
        ref.stop()
        ray_tpu.shutdown()
    fresh_init(ray_tpu_torch)
    try:
        port = configure(pcfg_cls()).resources(device="cpu").build_algo()
        rl_params_from_numpy(port.learner_group._local.module, ref_init)
        port.env_runner_group.sync_weights(port.get_weights())
        results = [port.train()["learners"] for _ in range(2)]
        nxt = port.offline.sample(8)
        for a, b in zip(results, ref_results):
            _assert_metrics_equal(a, b)
        for k in ref_next:
            assert np.array_equal(nxt[k], ref_next[k]), k
        assert set(port.offline.columns) == set(ref_cols)
        for k in ref_cols:
            assert port.offline.columns[k].tobytes() == ref_cols[k].tobytes(), k
        got = _flat(rl_params_to_numpy(port.learner_group._local.module))
        for k, w in _flat(ref_params).items():
            np.testing.assert_allclose(got[k], w, atol=UPDATE_TOL, rtol=0,
                                       err_msg=k)
        port.stop()
    finally:
        ray_tpu_torch.shutdown()


def test_returns_to_go_equals_the_reference():
    rng = np.random.default_rng(7)
    rewards = rng.normal(size=50).astype(np.float32)
    bounds = rng.random(50) < 0.15
    assert returns_to_go(rewards, bounds, 0.97).tobytes() == \
        jmarwil.returns_to_go(rewards, bounds, 0.97).tobytes()


def _pendulum_episodes(n_steps, episode_cls):
    env = cartpole.make("Pendulum-v1")
    rng = np.random.default_rng(0)
    episodes, steps = [], 0
    while steps < n_steps:
        obs, _ = env.reset(seed=steps)
        ep = episode_cls()
        ep.add_env_reset(np.asarray(obs, np.float32))
        for _ in range(60):
            act = rng.uniform(-2, 2, size=(1,)).astype(np.float32)
            obs, reward, term, trunc, _ = env.step(act)
            ep.add_env_step(np.asarray(obs, np.float32), act, reward,
                            terminated=term, truncated=trunc)
            steps += 1
        episodes.append(ep)
    return episodes


def _read(pkg, path, fmt):
    offline = joffline if pkg is ray_tpu else poffline
    data = offline.OfflineData(path, format=fmt, seed=0)
    return {k: (v.dtype.str, v.shape, v.tobytes())
            for k, v in sorted(data.columns.items())}, data.size


@pytest.mark.parametrize("fmt", ["parquet", "json"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_recorded_files_read_back_the_same_in_both_packages(tmp_path, fmt, writer):
    """CartPole and Pendulum (a (1,)-action column) transitions written by
    one package's ``record_episodes`` and read by both ``OfflineData``s:
    every column's dtype, shape and bytes equal, and equal to the
    transitions themselves."""
    for name, make_eps in (("cartpole", lambda cls: _record_cartpole(150, True, cls)),
                           ("pendulum", lambda cls: _pendulum_episodes(120, cls))):
        path = str(tmp_path / f"{writer}_{name}_{fmt}")
        if writer == "reference":
            with gc_paused():
                fresh_init(ray_tpu)
                joffline.record_episodes(make_eps(JEpisode), path, format=fmt)
                ray_tpu.shutdown()
        else:
            fresh_init(ray_tpu_torch)
            record_episodes(make_eps(SingleAgentEpisode), path, format=fmt)
            ray_tpu_torch.shutdown()
        with gc_paused():
            fresh_init(ray_tpu)
            want = _read(ray_tpu, path, fmt)
            ray_tpu.shutdown()
        fresh_init(ray_tpu_torch)
        try:
            got = _read(ray_tpu_torch, path, fmt)
        finally:
            ray_tpu_torch.shutdown()
        assert got == want, name
        from ray_tpu_torch.rl.connectors import episodes_to_transitions

        cols = episodes_to_transitions(make_eps(SingleAgentEpisode))
        data = OfflineData(cols, seed=0)
        assert got[1] == data.size
        for k, (dtype, shape, raw) in got[0].items():
            assert (dtype, shape, raw) == (data.columns[k].dtype.str,
                                           data.columns[k].shape,
                                           data.columns[k].tobytes()), (name, k)


def _stream_batches(pkg, rows, streaming, n=12, size=48):
    data_mod = importlib.import_module(pkg.__name__ + ".data")
    offline = joffline if pkg is ray_tpu else poffline
    source = (data_mod.from_items(rows).repartition(4) if streaming
              else {k: np.asarray([r[k] for r in rows]) for k in rows[0]})
    data = offline.OfflineData(source, seed=3, streaming=streaming,
                               window_rows=100)
    return [{k: (v.dtype.str, v.tobytes()) for k, v in sorted(
        data.sample(size).items())} for _ in range(n)]


@pytest.mark.parametrize("streaming", [False, True])
def test_offline_data_draws_the_same_batches_in_both_packages(streaming):
    """Materialized: uniform index draws; streaming: a shuffled pipeline
    into a refilling window (its shuffle seeds and window permutations from
    the same numpy generator, past the end of an epoch)."""
    rows = [{"obs": [float(i), 0.5 * i], "actions": i % 3, "rewards": 0.1 * i}
            for i in range(300)]
    with gc_paused():
        fresh_init(ray_tpu, num_cpus=4)
        want = _stream_batches(ray_tpu, rows, streaming)
        ray_tpu.shutdown()
    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        got = _stream_batches(ray_tpu_torch, rows, streaming)
    finally:
        ray_tpu_torch.shutdown()
    assert got == want


# ------------------------------------- the reference's cases, on the port
def test_dqn_cartpole_smoke(rt):
    """(ref: tests/test_rl.py::test_dqn_cartpole_smoke)"""
    config = (DQNConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=1,
                           rollout_fragment_length=8)
              .training(train_batch_size=32,
                        replay_buffer_capacity=2000,
                        num_steps_sampled_before_learning_starts=64,
                        target_network_update_freq=10)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    for _ in range(12):
        result = algo.train()
    assert result["replay_size"] > 64
    assert "td_error_mean" in result["learners"]
    algo.stop()


def test_dqn_prioritized_replay_updates_priorities(rt):
    """(ref: tests/test_rl.py::test_dqn_prioritized_replay_updates_priorities)"""
    config = (DQNConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=0, rollout_fragment_length=8)
              .training(train_batch_size=16, prioritized_replay=True,
                        replay_buffer_capacity=500,
                        num_steps_sampled_before_learning_starts=32,
                        target_network_update_freq=5)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    for _ in range(8):
        algo.train()
    prios = algo.replay._priorities[:len(algo.replay)]
    # priorities must have been refreshed away from the uniform initial 1.0
    assert len(set(np.round(prios[prios > 0], 6))) > 1, prios[:20]
    algo.stop()


def test_dqn_epsilon_piecewise():
    """(ref: tests/test_rl.py::test_dqn_epsilon_piecewise)"""
    cfg = DQNConfig().environment("CartPole-v1")
    cfg.epsilon = [(0, 1.0), (100, 0.5), (1000, 0.1)]
    algo = object.__new__(DQN)
    algo.algo_config = cfg
    for t, eps in ((0, 1.0), (50, 0.75), (100, 0.5), (550, 0.3), (5000, 0.1)):
        algo._lifetime_steps = t
        assert abs(DQN._epsilon(algo) - eps) < 1e-6


def test_impala_batch_chunks_and_masks():
    """(ref: tests/test_rl.py::test_impala_batch_chunks_and_masks)"""
    cfg = IMPALAConfig().environment("CartPole-v1")
    cfg.rollout_fragment_length = 10
    algo = object.__new__(IMPALA)
    algo.algo_config = cfg
    ep = SingleAgentEpisode()
    ep.add_env_reset(np.zeros(4, np.float32))
    for i in range(23):  # 23 steps -> rows of 10, 10, 3
        ep.add_env_step(np.full(4, i + 1, np.float32), 1, 1.0,
                        terminated=(i == 22),
                        extra={Columns.ACTION_LOGP: -0.5})
    batch = IMPALA._batch_from_episodes(algo, [ep])
    assert batch[Columns.OBS].shape == (3, 10, 4)
    np.testing.assert_array_equal(batch["mask"][0], np.ones(10))
    np.testing.assert_array_equal(batch["mask"][2],
                                  [1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
    assert batch["discounts"][2][2] == 0.0
    assert batch["bootstrap_terminated"][2] == 1.0
    assert batch["bootstrap_terminated"][0] == 0.0
    assert int(batch["mask"].sum()) == 23


def test_impala_cartpole_async(rt):
    """(ref: tests/test_rl.py::test_impala_cartpole_async)"""
    config = (IMPALAConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=20)
              .training(train_batch_size=80)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    for _ in range(4):
        result = algo.train()
    assert "policy_loss" in result["learners"]
    assert result["num_env_steps_sampled_lifetime"] > 0
    algo.stop()


def test_impala_aggregator_actors_pipeline(rt):
    """(ref: tests/test_rl.py::test_impala_aggregator_actors_pipeline)"""
    config = (IMPALAConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=20)
              .training(train_batch_size=80, num_aggregator_actors=2)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    learned = 0
    sampled = 0
    for _ in range(12):
        result = algo.train()
        learned += result.get("num_batches_learned", 0)
        sampled = result["num_env_steps_sampled_lifetime"]
    assert learned >= 3, f"aggregators produced only {learned} batches"
    assert sampled > 0
    algo.stop()


def test_async_broadcast_is_a_snapshot(rt):
    """A fire-and-forget broadcast (``block=False``) carries the weights of
    its moment: the learner's next in-place step does not reach what the
    runners sample with."""
    config = (APPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=1, num_envs_per_env_runner=1,
                           rollout_fragment_length=8)
              .training(train_batch_size=16, lr=0.05)
              .resources(device="cpu"))
    algo = config.build_algo()
    group = algo.env_runner_group
    sent = algo.learner_group.get_weights()
    group.sync_weights(sent, block=False)
    learner = algo.learner_group._local
    for p in learner.module.parameters():
        p.data.add_(1.0)  # an in-place step after the broadcast
    state = ray_tpu_torch.get(group.runners[0].get_state.remote())
    assert all(torch.equal(state["params"][k], sent[k]) for k in sent)
    algo.stop()


@pytest.mark.slow  # learning soak (its reference twin is slow too)
def test_impala_aggregated_learning_improves(rt):
    """(ref: tests/test_rl.py::test_impala_aggregated_learning_improves)"""
    import time as _time

    config = (IMPALAConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                           rollout_fragment_length=25)
              .training(train_batch_size=100, num_aggregator_actors=2,
                        lr=1e-3, entropy_coeff=0.005)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    best = 0.0
    deadline = _time.time() + 150
    for _ in range(300):
        result = algo.train()
        m = result.get("env_runners", {}).get("episode_return_mean")
        if m:
            best = max(best, m)
        if best > 35 or _time.time() > deadline:
            break
    assert best > 35, f"no learning through the aggregator tier (best {best})"
    algo.stop()


def test_sac_pendulum_runs_and_is_finite(rt):
    """(ref: tests/test_rl_extras.py::test_sac_pendulum_runs_and_is_finite),
    on the port's Pendulum-v1."""
    config = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_envs_per_env_runner=1, rollout_fragment_length=32)
        .training(train_batch_size=64,
                  num_steps_sampled_before_learning_starts=128,
                  replay_buffer_capacity=10_000)
        .rl_module(model_config={"hiddens": (32, 32), "action_scale": 2.0})
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build_algo()
    result = {}
    for _ in range(6):
        result = algo.train()
    learners = result["learners"]
    assert {"critic_loss", "actor_loss", "alpha_loss", "alpha"} <= set(learners)
    for k, v in learners.items():
        assert np.isfinite(v), (k, v)
    assert learners["alpha"] > 0.0
    assert result["replay_size"] > 128
    # The runner samples with the broadcast actor; its critics stay as built.
    runner = algo.env_runner_group._local_runner
    learner = algo.learner_group._local
    assert all(torch.equal(runner.module.state_dict()[k], v)
               for k, v in learner.get_weights().items())
    assert not torch.equal(runner.module.q1.layers[0].w,
                           learner.module.q1.layers[0].w)
    algo.stop()


def test_sac_squashed_actions_respect_scale():
    """(ref: tests/test_rl_extras.py::test_sac_squashed_actions_respect_scale)"""
    dist = SquashedGaussian(scale=2.0)
    inputs = torch.from_numpy(
        np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32) * 3)
    acts = dist.sample(torch.Generator().manual_seed(0), inputs)
    assert torch.all(acts.abs() <= 2.0)
    assert torch.all(torch.isfinite(dist.logp(inputs, acts)))
    assert torch.all(dist.deterministic(inputs).abs() <= 2.0)


def _record_to(tmp_path, name, episodes, fmt="parquet"):
    return record_episodes(episodes, str(tmp_path / name), format=fmt)


def test_record_and_read_roundtrip(rt, tmp_path):
    """(ref: tests/test_rl_extras.py::test_record_and_read_roundtrip)"""
    path = _record_to(tmp_path, "cartpole_expert", _record_cartpole(300))
    data = OfflineData(path, seed=0)
    assert data.size >= 300
    batch = data.sample(32)
    assert batch[Columns.OBS].shape == (32, 4)
    assert batch[Columns.NEXT_OBS].shape == (32, 4)
    assert set(batch) >= {Columns.OBS, Columns.ACTIONS, Columns.REWARDS,
                          Columns.NEXT_OBS, Columns.TERMINATEDS}


def _agreement(algo, seed) -> float:
    module = algo.module_spec.build(device="cpu")
    module.load_state_dict(algo.get_weights())
    obs = np.random.default_rng(seed).uniform(-1, 1, size=(512, 4)).astype(np.float32)
    with torch.no_grad():
        out = module.forward_inference(torch.from_numpy(obs))
    greedy = module.action_dist.deterministic(
        out[Columns.ACTION_DIST_INPUTS]).numpy()
    expert = np.array([_expert_action(o) for o in obs])
    return float((greedy == expert).mean())


def test_bc_imitates_expert(rt, tmp_path):
    """(ref: tests/test_rl_extras.py::test_bc_imitates_expert)"""
    path = _record_to(tmp_path, "cartpole_expert", _record_cartpole(2000))
    config = (
        BCConfig()
        .environment("CartPole-v1")
        .offline_data(input_=path, updates_per_iteration=40)
        .training(train_batch_size=256, lr=3e-3)
        .rl_module(model_config={"hiddens": (32, 32)})
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build_algo()
    for _ in range(5):
        result = algo.train()
    assert result["learners"]["bc_logp"] > -0.35  # near-deterministic match
    assert _agreement(algo, 0) > 0.9
    ret = algo.evaluate()["env_runners"]["episode_return_mean"]
    assert ret > 100, ret
    algo.stop()


def test_marwil_beats_bc_on_mixed_data(rt, tmp_path):
    """(ref: tests/test_rl_extras.py::test_marwil_beats_bc_on_mixed_data)"""
    path = _record_to(tmp_path, "cartpole_mixed",
                      _record_cartpole(3000, mixed=True))
    config = (
        MARWILConfig()
        .environment("CartPole-v1")
        .offline_data(input_=path, updates_per_iteration=40)
        .training(train_batch_size=256, lr=3e-3, beta=1.0)
        .rl_module(model_config={"hiddens": (32, 32)})
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build_algo()
    for _ in range(6):
        result = algo.train()
    assert np.isfinite(result["learners"]["policy_loss"])
    marwil_agreement = _agreement(algo, 1)
    algo.stop()
    assert marwil_agreement > 0.75, marwil_agreement


def test_offline_data_streaming_window(rt):
    """(ref: tests/test_rl_extras.py::test_offline_data_streaming_window)"""
    import ray_tpu_torch.data as rdata

    rows = [{"obs": [float(i), 0.0], "actions": i % 3, "rewards": 0.1}
            for i in range(2000)]
    ds = rdata.from_items(rows).repartition(8)
    data_stream = OfflineData(ds, seed=0, streaming=True, window_rows=256)
    assert data_stream.size is None  # unknown by design
    seen = set()
    for _ in range(40):
        batch = data_stream.sample(64)
        assert batch["obs"].shape == (64, 2)
        assert batch["obs"].dtype == np.float32
        seen.update(int(x) for x in batch["obs"][:, 0])
    assert len(seen) > 1200, len(seen)
    with pytest.raises(ValueError, match="streaming"):
        _ = data_stream.columns
    assert not hasattr(data_stream, "columns")  # probes must keep working
    assert data_stream.is_streaming
    assert data_stream.has_column("obs")
    assert not data_stream.has_column("returns")


def test_marwil_beta_zero_is_bc_with_baseline(rt, tmp_path):
    """(ref: tests/test_rl_extras.py::test_marwil_beta_zero_is_bc_with_baseline)"""
    path = _record_to(tmp_path, "cartpole_mixed",
                      _record_cartpole(1000, mixed=True))
    config = (
        MARWILConfig()
        .environment("CartPole-v1")
        .offline_data(input_=path, updates_per_iteration=10)
        .training(train_batch_size=128, beta=0.0)
        .rl_module(model_config={"hiddens": (16, 16)})
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build_algo()
    learners = algo.train()["learners"]
    assert np.isfinite(learners["policy_loss"])
    assert np.isfinite(learners["vf_loss"])
    algo.stop()


def test_cql_offline_runs_and_penalty_is_conservative(rt, tmp_path):
    """(ref: tests/test_rl_extras.py::
    test_cql_offline_runs_and_penalty_is_conservative)"""
    path = _record_to(tmp_path, "pendulum_random",
                      _pendulum_episodes(600, SingleAgentEpisode))
    config = (
        CQLConfig()
        .environment("Pendulum-v1")
        .offline_data(input_=path, updates_per_iteration=15)
        .training(train_batch_size=64, min_q_weight=5.0)
        .rl_module(model_config={"hiddens": (32, 32), "action_scale": 2.0})
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build_algo()
    for _ in range(3):
        result = algo.train()
    learners = result["learners"]
    for k, v in learners.items():
        assert np.isfinite(v), (k, v)
    assert result["dataset_size"] >= 600
    assert learners["critic_loss"] != 0.0
    algo.stop()


@pytest.mark.slow  # learning soak (its reference twin is slow too)
def test_appo_learns_cartpole(rt):
    """(ref: tests/test_rl_extras.py::test_appo_learns_cartpole)"""
    config = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .training(train_batch_size=256, lr=5e-4, entropy_coeff=0.01,
                  clip_param=0.3)
        .resources(device="cpu")
        .debugging(seed=0)
    )
    algo = config.build_algo()
    best = 0.0
    for _ in range(200):
        result = algo.train()
        ret = result.get("episode_return_mean")
        if ret is not None and ret == ret:
            best = max(best, ret)
        if best > 60:
            break
    learners = result["learners"]
    assert np.isfinite(learners.get("total_loss", 0.0))
    assert "mean_ratio" in learners
    assert best > 60, best
    algo.stop()


def test_offline_algorithms_need_input():
    for cfg in (BCConfig().environment("CartPole-v1"),
                CQLConfig().environment("Pendulum-v1")):
        with pytest.raises(ValueError, match="offline_data"):
            cfg.resources(device="cpu").build_algo()


def test_gymnasium_pendulum_is_the_ports():
    """The reference's CQL and SAC cases run on ``gym.make("Pendulum-v1")``;
    the port's runs on its own, and a seeded episode of each is the same."""
    ref, port = gym.make("Pendulum-v1"), cartpole.make("Pendulum-v1")
    a, _ = ref.reset(seed=5)
    b, _ = port.reset(seed=5)
    assert a.tobytes() == b.tobytes()
    for t in range(200):
        u = np.array([math.sin(t / 7.0) * 2.5], np.float32)
        x, y = ref.step(u), port.step(u)
        assert x[0].tobytes() == y[0].tobytes() and x[1:4] == y[1:4]
    assert x[3] and y[3]
