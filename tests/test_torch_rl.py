"""The port's RL core and PPO (ray_tpu_torch.rl) against the JAX package's
(ray_tpu.rl), on the CPU in fp32.

Weights: the reference's init as numpy, loaded into the port's modules by
``models.convert.rl_params_from_numpy``; inputs from numpy seeds. The
distributions' log-probs, entropies and greedy actions within 1e-6; the
modules' forwards (actor-critic, CNN, Q) within 1e-5; ``batch_episodes``
and GAE on the same episodes within 1e-5; a two-epoch PPO update with the
KL penalty and the gradient clip engaged, every weight and metric within
1e-5. Sampling (Gumbel-max from a ``torch.Generator``; JAX's streams
cannot be matched) is held statistically. Then the port's own counterparts
of ``tests/test_rl.py``'s PPO cases (learning CartPole, remote runners and
learners, checkpoints, Tune), two learners against one, and the weight
snapshot a broadcast takes. Multi-agent PPO is in
tests/test_torch_rl_multi_agent.py.
"""

import math

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_runtimes import fresh_init
from ray_tpu.rl.algorithms.ppo import PPOConfig as JPPOConfig
from ray_tpu.rl.algorithms.ppo import PPOLearner as JPPOLearner
from ray_tpu.rl.connectors import ConnectorPipeline as JConnectorPipeline
from ray_tpu.rl.connectors import GeneralAdvantageEstimation as JGAE
from ray_tpu.rl.connectors import batch_episodes as jbatch_episodes
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu.rl.env.episode import SingleAgentEpisode as JEpisode
from ray_tpu_torch.models.convert import rl_params_from_numpy, rl_params_to_numpy
from ray_tpu_torch.rl import (Columns, DefaultActorCritic, DefaultQModule,
                              LearnerGroup, RLModuleSpec, SingleAgentEnvRunner,
                              SingleAgentEpisode, TorchLearner)
from ray_tpu_torch.rl.algorithms import PPO, PPOConfig, PPOLearner
from ray_tpu_torch.rl.algorithms.ppo import make_vf_fn
from ray_tpu_torch.rl.connectors import (ConnectorPipeline, GeneralAdvantageEstimation,
                                         batch_episodes)
from ray_tpu_torch.rl.core.rl_module import (Categorical, CNNActorCritic,
                                             DiagGaussian)
from ray_tpu_torch.rl.env.env_runner_group import EnvRunnerGroup
from ray_tpu_torch.rl.utils.replay_buffers import (PrioritizedReplayBuffer,
                                                   ReplayBuffer)

DIST_TOL = 1e-6
TOL = 1e-5


@pytest.fixture
def rt():
    runtime = fresh_init(ray_tpu_torch, num_cpus=8)
    yield runtime
    ray_tpu_torch.shutdown()


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port_module(jax_module, port_cls, jax_params, **kw):
    """The port's module with the reference's weights."""
    module = port_cls(jax_module.observation_dim, jax_module.action_dim,
                      jax_module.discrete, **kw)
    return rl_params_from_numpy(module, _np_tree(jax_params))


def _cartpole_spec():
    return RLModuleSpec(module_class=DefaultActorCritic, observation_dim=4,
                        action_dim=2, discrete=True,
                        model_config={"hiddens": (32, 32)})


# ------------------------------------------------------------ distributions
def _logits(rng, n=64, a=5):
    x = rng.normal(size=(n, a)).astype(np.float32) * 3
    x[0] = [1.0, 2.0, 2.0, -1.0, 2.0]  # ties: the first maximum wins
    return x


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = _logits(rng)
    actions = rng.integers(0, 5, 64).astype(np.int32)
    lt, at = torch.from_numpy(logits), torch.from_numpy(actions)
    np.testing.assert_allclose(Categorical.logp(lt, at).numpy(),
                               np.asarray(jrl.Categorical.logp(logits, actions)),
                               atol=DIST_TOL, rtol=0)
    np.testing.assert_allclose(Categorical.entropy(lt).numpy(),
                               np.asarray(jrl.Categorical.entropy(logits)),
                               atol=DIST_TOL, rtol=0)
    greedy = Categorical.deterministic(lt).numpy()
    np.testing.assert_array_equal(greedy,
                                  np.asarray(jrl.Categorical.deterministic(logits)))
    assert greedy[0] == 1


def test_diag_gaussian_matches_jax():
    rng = np.random.default_rng(1)
    inputs = rng.normal(size=(64, 6)).astype(np.float32)
    inputs[:4, 3:] = [[-30.0, 5.0, 0.0]] * 4  # log_std clipped both ways
    actions = rng.normal(size=(64, 3)).astype(np.float32)
    it, at = torch.from_numpy(inputs), torch.from_numpy(actions)
    np.testing.assert_allclose(DiagGaussian.logp(it, at).numpy(),
                               np.asarray(jrl.DiagGaussian.logp(inputs, actions)),
                               atol=DIST_TOL, rtol=DIST_TOL)
    np.testing.assert_allclose(DiagGaussian.entropy(it).numpy(),
                               np.asarray(jrl.DiagGaussian.entropy(inputs)),
                               atol=DIST_TOL, rtol=0)
    np.testing.assert_array_equal(
        DiagGaussian.deterministic(it).numpy(),
        np.asarray(jrl.DiagGaussian.deterministic(inputs)))


def test_categorical_samples_follow_the_softmax():
    """200k draws per row: every action's frequency within 5 sigma of its
    probability; the same seed draws the same actions."""
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0], [3.0, 3.0, -2.0, 0.5]])
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    draws = Categorical.sample(gen, logits.expand(n, 2, 4))
    probs = torch.softmax(logits, -1).numpy()
    for row in range(2):
        freq = np.bincount(draws[:, row].numpy(), minlength=4) / n
        sigma = np.sqrt(probs[row] * (1 - probs[row]) / n)
        assert np.all(np.abs(freq - probs[row]) <= 5 * sigma + 1e-9), (freq, probs[row])
    again = Categorical.sample(torch.Generator().manual_seed(0),
                               logits.expand(n, 2, 4))
    assert torch.equal(draws, again)


def test_diag_gaussian_samples_have_the_moments():
    inputs = torch.tensor([[0.5, -2.0, math.log(0.3), math.log(2.0)]])
    n = 200_000
    draws = DiagGaussian.sample(torch.Generator().manual_seed(1),
                                inputs.expand(n, 4)).numpy()
    mean, std = np.array([0.5, -2.0]), np.array([0.3, 2.0])
    assert np.all(np.abs(draws.mean(0) - mean) <= 5 * std / np.sqrt(n))
    # The sample std's own std is ~ std / sqrt(2n).
    assert np.all(np.abs(draws.std(0) - std) <= 5 * std / np.sqrt(2 * n))


# ------------------------------------------------------------------ modules
def test_actor_critic_forward_matches_jax():
    jm = jrl.DefaultActorCritic(4, 3, True, hiddens=(64, 64))
    jp = jm.init_params(jax.random.key(0))
    # Scale the heads so the outputs are not all near zero.
    jp["pi"]["head"]["w"] = jp["pi"]["head"]["w"] * 100.0
    pm = _port_module(jm, DefaultActorCritic, jp, hiddens=(64, 64))
    obs = np.random.default_rng(2).normal(size=(33, 4)).astype(np.float32)
    want, got = jm.forward_train(jp, obs), pm.forward_train(torch.from_numpy(obs))
    for key in (Columns.ACTION_DIST_INPUTS, Columns.VF_PREDS):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL)
    # (B, T, obs) batches keep their leading dims; exploration is the pi head.
    got3 = pm.forward_exploration(torch.from_numpy(obs[:32].reshape(4, 8, 4)))
    np.testing.assert_allclose(
        got3[Columns.ACTION_DIST_INPUTS].detach().numpy().reshape(32, 3),
        np.asarray(want[Columns.ACTION_DIST_INPUTS])[:32], atol=TOL, rtol=TOL)


def test_gaussian_actor_critic_forward_matches_jax():
    jm = jrl.DefaultActorCritic(3, 2, False, hiddens=(16,))
    jp = jm.init_params(jax.random.key(1))
    pm = _port_module(jm, DefaultActorCritic, jp, hiddens=(16,))
    obs = np.random.default_rng(3).normal(size=(10, 3)).astype(np.float32)
    got = pm.forward_train(torch.from_numpy(obs))
    assert got[Columns.ACTION_DIST_INPUTS].shape == (10, 4)
    np.testing.assert_allclose(got[Columns.ACTION_DIST_INPUTS].detach().numpy(),
                               np.asarray(jm.forward_train(jp, obs)[
                                   Columns.ACTION_DIST_INPUTS]), atol=TOL)


def test_cnn_forward_matches_jax():
    """obs (8, 8, 3) through two convs to a 2 x 2 x 5 map: the torso reads
    the features in the reference's (h, w, c) order."""
    kw = dict(obs_shape=(8, 8, 3), conv_filters=((6, 3, 1), (5, 3, 2)),
              hiddens=(32, 16))
    jm = jrl.CNNActorCritic(192, 4, True, **kw)
    jp = jm.init_params(jax.random.key(2))
    jp["pi"]["head"]["w"] = jp["pi"]["head"]["w"] * 100.0
    pm = _port_module(jm, CNNActorCritic, jp, **kw)
    assert tuple(pm.convs[0].w.shape) == (6, 3, 3, 3)  # OIHW
    obs = np.random.default_rng(4).uniform(0, 255, size=(2, 3, 192)).astype(np.float32)
    want = jm.forward_train(jp, obs)
    got = pm.forward_train(torch.from_numpy(obs))
    for key in (Columns.ACTION_DIST_INPUTS, Columns.VF_PREDS):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=TOL, rtol=TOL)
    # Round trip back to the reference's pytree, HWIO kernels included.
    back = rl_params_to_numpy(pm)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(_np_tree(jp)),
                                 jax.tree_util.tree_leaves_with_path(back)):
        assert a.shape == b.shape and np.array_equal(a, b), path


def test_q_module_forward_and_target_match_jax():
    jm = jrl.DefaultQModule(4, 2, True, hiddens=(32,))
    jp = jm.init_params(jax.random.key(3))
    jp["target_q"]["head"]["w"] = jp["target_q"]["head"]["w"] * 3.0
    pm = _port_module(jm, DefaultQModule, jp, hiddens=(32,))
    obs = np.random.default_rng(5).normal(size=(12, 4)).astype(np.float32)
    np.testing.assert_allclose(
        pm.forward_train(torch.from_numpy(obs))["q_values"].detach().numpy(),
        np.asarray(jm.forward_train(jp, obs)["q_values"]), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        pm.forward_target(torch.from_numpy(obs)).detach().numpy(),
        np.asarray(jm.forward_target(jp, obs)), atol=TOL, rtol=TOL)
    assert not any(p.requires_grad for p in pm.target_q.parameters())
    assert set(rl_params_to_numpy(pm)) == {"q", "target_q"}


def test_converter_refuses_a_tree_of_another_module():
    jm = jrl.DefaultActorCritic(4, 2, True, hiddens=(8,))
    jp = _np_tree(jm.init_params(jax.random.key(0)))
    with pytest.raises(KeyError, match="missing"):
        rl_params_from_numpy(DefaultActorCritic(4, 2, True, hiddens=(8, 8)), jp)


@pytest.mark.parametrize("name,scale", [
    ("pi.layers.0.w", math.sqrt(2.0)), ("pi.layers.1.w", math.sqrt(2.0)),
    ("pi.head.w", 0.01), ("vf.layers.0.w", math.sqrt(2.0)),
    ("vf.head.w", 1.0)])
def test_init_is_orthogonal_at_the_reference_scales(name, scale):
    m = DefaultActorCritic(4, 2, True, hiddens=(64, 64), seed=5)
    w = m.state_dict()[name].double()
    gram = w @ w.T if w.shape[0] < w.shape[1] else w.T @ w
    np.testing.assert_allclose(gram.numpy(), scale ** 2 * np.eye(len(gram)),
                               atol=1e-5 * max(1.0, scale ** 2))
    assert all(not v.any() for k, v in m.state_dict().items() if k.endswith(".b"))
    assert torch.equal(w, DefaultActorCritic(4, 2, True, hiddens=(64, 64),
                                             seed=5).state_dict()[name].double())


def test_cnn_init_is_orthogonal_over_the_flattened_kernel():
    m = CNNActorCritic(192, 2, True, obs_shape=(8, 8, 3),
                       conv_filters=((6, 3, 1), (5, 3, 2)), hiddens=(16,))
    hwio = m.convs[1].w.detach().permute(2, 3, 1, 0).reshape(-1, 5).double()
    np.testing.assert_allclose((hwio.T @ hwio).numpy(), 2.0 * np.eye(5), atol=1e-5)


# ------------------------------------------------------ episodes, buffers
def test_episode_cut_carries_return():
    ep = SingleAgentEpisode()
    ep.add_env_reset(np.zeros(4))
    for _ in range(5):
        ep.add_env_step(np.zeros(4), 0, 1.0)
    frag2 = ep.cut()
    assert frag2.total_return == 5.0 and len(frag2) == 0
    frag2.add_env_step(np.zeros(4), 1, 2.0)
    assert frag2.total_return == 7.0 and frag2.total_len == 6


def test_replay_buffers():
    buf = ReplayBuffer(capacity=100, seed=0)
    rng = np.random.default_rng(0)
    batch = {Columns.OBS: rng.normal(size=(150, 4)).astype(np.float32),
             Columns.ACTIONS: rng.integers(0, 2, 150),
             Columns.REWARDS: np.ones(150, np.float32)}
    buf.add(batch)
    assert len(buf) == 100  # FIFO wrap
    assert buf.sample(32)[Columns.OBS].shape == (32, 4)
    pbuf = PrioritizedReplayBuffer(capacity=100, seed=0)
    pbuf.add({k: v[:50] for k, v in batch.items()})
    s = pbuf.sample(16)
    assert Columns.WEIGHTS in s
    pbuf.update_priorities(rng.random(16))


# ------------------------------------------------------------ connectors
def _episodes(pkg_episode):
    """Three episodes of 5-dim observations: terminated, truncated, and a
    fragment cut mid-episode."""
    rng = np.random.default_rng(6)
    out = []
    for length, end in ((7, "term"), (5, "trunc"), (9, "cut")):
        ep = pkg_episode()
        ep.add_env_reset(rng.normal(size=4).astype(np.float32))
        for t in range(length):
            ep.add_env_step(rng.normal(size=4).astype(np.float32),
                            int(rng.integers(0, 2)), float(rng.normal()),
                            terminated=end == "term" and t == length - 1,
                            truncated=end == "trunc" and t == length - 1,
                            extra={Columns.ACTION_LOGP: float(-rng.random())})
        out.append(ep)
    return out


@pytest.mark.parametrize("normalize", [True, False])
def test_gae_and_batch_episodes_match_the_reference(normalize):
    jm = jrl.DefaultActorCritic(4, 2, True, hiddens=(16, 16))
    jp = jm.init_params(jax.random.key(7))
    pm = _port_module(jm, DefaultActorCritic, jp, hiddens=(16, 16))
    jpipe = JConnectorPipeline([jbatch_episodes,
                                JGAE(gamma=0.97, lambda_=0.9,
                                     normalize_advantages=normalize)])
    ppipe = ConnectorPipeline([batch_episodes,
                               GeneralAdvantageEstimation(
                                   gamma=0.97, lambda_=0.9,
                                   normalize_advantages=normalize)])
    want = jpipe({}, _episodes(JEpisode), params=jp,
                 vf_fn=lambda p, o: jm.forward_train(p, o)[Columns.VF_PREDS])
    got = ppipe({}, _episodes(SingleAgentEpisode), params=None,
                vf_fn=make_vf_fn(pm))
    assert set(got) == set(want)
    assert got["_eps_bounds"] == want["_eps_bounds"] == [(0, 7), (7, 12), (12, 21)]
    assert got["_eps_terminated"] == want["_eps_terminated"]
    for key in (Columns.OBS, Columns.ACTIONS, Columns.REWARDS,
                Columns.ACTION_LOGP, "_last_obs", Columns.ADVANTAGES,
                Columns.VALUE_TARGETS, Columns.VF_PREDS):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=key)


def test_gae_connector_shapes():
    runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=_cartpole_spec(),
                                  num_envs=2, rollout_fragment_length=16,
                                  device="cpu")
    episodes = runner.sample(num_timesteps=32)
    module = _cartpole_spec().build(device="cpu")
    pipe = ConnectorPipeline([batch_episodes, GeneralAdvantageEstimation()])
    batch = pipe({}, episodes, params=module.state_dict(), vf_fn=make_vf_fn(module))
    n = len(batch[Columns.OBS])
    assert n == 32
    assert batch[Columns.ADVANTAGES].shape == (n,)
    assert batch[Columns.VALUE_TARGETS].shape == (n,)
    assert abs(float(batch[Columns.ADVANTAGES].mean())) < 1e-5  # normalized
    with pytest.raises(ValueError, match="vf_fn"):
        GeneralAdvantageEstimation()(batch_episodes({}, episodes), episodes)
    runner.stop()


# ------------------------------------------------------------- PPO learner
def _ppo_batch(jm, jp, n, seed=8):
    """A PPO batch whose behaviour log-probs are the module's own plus
    noise of mean 0.1, so that ratios leave the clip range and the KL
    estimate is mostly positive (its penalty engaged); value targets wide
    enough that some squared errors pass ``vf_clip_param``."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    actions = rng.integers(0, 2, n).astype(np.int32)
    logits = jm.forward_train(jp, obs)[Columns.ACTION_DIST_INPUTS]
    logp = np.asarray(jrl.Categorical.logp(logits, actions))
    return {
        Columns.OBS: obs,
        Columns.ACTIONS: actions,
        Columns.ACTION_LOGP: (logp + rng.normal(0.1, 0.4, size=n)).astype(np.float32),
        Columns.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        Columns.VALUE_TARGETS: (rng.normal(size=n) * 4).astype(np.float32),
        "kl_coeff": np.float32(0.2),
    }


def _learner_pair(**training):
    spec_kw = dict(observation_dim=4, action_dim=2, discrete=True,
                   model_config={"hiddens": (32, 32)})
    jcfg = JPPOConfig().training(**training)
    jl = JPPOLearner(config=jcfg, module_spec=jrl.RLModuleSpec(
        module_class=jrl.DefaultActorCritic, **spec_kw), seed=0)
    pcfg = PPOConfig().training(**training).resources(device="cpu")
    pl = PPOLearner(config=pcfg, module_spec=RLModuleSpec(
        module_class=DefaultActorCritic, **spec_kw), seed=0)
    rl_params_from_numpy(pl.module, _np_tree(jl.params))
    return jl, pl


def test_ppo_update_matches_the_reference():
    """Two epochs of minibatch 32 over 128 rows (8 updates in the
    reference's permutation order), KL penalty 0.2, the value clip and the
    gradient clip engaged: every weight and metric within 1e-5."""
    jl, pl = _learner_pair(lr=1e-3, grad_clip=0.2, entropy_coeff=0.01,
                           vf_clip_param=4.0)
    batch = _ppo_batch(jl.module, jl.params, 128)
    want = jl.update_from_batch(dict(batch), num_epochs=2, minibatch_size=32)
    got = pl.update_from_batch(dict(batch), num_epochs=2, minibatch_size=32)
    assert set(got) == set(want) == {"total_loss", "policy_loss", "vf_loss",
                                     "entropy", "mean_kl", "grad_norm"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=key)
    assert got["grad_norm"] > 0.2  # the clip engaged
    assert got["mean_kl"] > 0  # so did the KL penalty
    want_w, got_w = _np_tree(jl.params), rl_params_to_numpy(pl.module)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(want_w),
                                 jax.tree_util.tree_leaves_with_path(got_w)):
        np.testing.assert_allclose(b, a, atol=TOL, rtol=0, err_msg=str(path))
    moved = max(float(np.abs(b - a).max()) for a, b in zip(
        jax.tree.leaves(_np_tree(jl.module.init_params(jax.random.key(0)))),
        jax.tree.leaves(got_w)))
    assert moved > 1e-3
    assert pl._steps == jl._steps == 2


def test_learner_state_round_trip_copies():
    _, pl = _learner_pair(lr=1e-3)
    jm = jrl.DefaultActorCritic(4, 2, True, hiddens=(32, 32))
    batch = _ppo_batch(jm, jm.init_params(jax.random.key(0)), 64)
    pl.update_from_batch(dict(batch), minibatch_size=32)
    state = pl.get_state()
    assert all(t.device.type == "cpu" for t in state["params"].values())
    saved = {k: v.clone() for k, v in state["params"].items()}
    weights = pl.get_weights()
    pl.update_from_batch(dict(batch), minibatch_size=32)
    for k, v in state["params"].items():
        assert torch.equal(v, saved[k]), k  # the step left the copies alone
        assert torch.equal(weights[k], saved[k]), k
    other = PPOLearner(config=pl.config, module_spec=_cartpole_spec(), seed=9)
    other.set_state(state)
    pl.set_state(state)
    pl.update_from_batch(dict(batch), minibatch_size=32)
    other.update_from_batch(dict(batch), minibatch_size=32)
    for k, v in other.get_weights().items():
        assert torch.equal(v, pl.get_weights()[k]), k
        assert torch.equal(state["params"][k], saved[k]), k


def test_base_learner_has_no_loss():
    learner = TorchLearner(config=PPOConfig().resources(device="cpu"),
                           module_spec=_cartpole_spec())
    with pytest.raises(NotImplementedError):
        learner.update_from_batch({"obs": np.zeros((2, 4), np.float32)})


# ------------------------------------------------------------ two learners
def _flat(weights):
    return np.concatenate([v.detach().cpu().numpy().ravel()
                           for _, v in sorted(weights.items())])


def test_multi_learner_grad_sync_equivalence(rt):
    """Mean-allreduce over 2 half-batch learners == 1 full-batch learner
    (ref: tests/test_rl.py::test_multi_learner_grad_sync_equivalence)."""

    def make_group(num_learners):
        cfg = (PPOConfig()
               .environment("CartPole-v1")
               .training(lr=1e-2, num_epochs=1, minibatch_size=None,
                         normalize_advantages=False, entropy_coeff=0.0)
               .resources(device="cpu")
               .debugging(seed=7))
        return LearnerGroup(learner_class=PPO.learner_class, config=cfg,
                            module_spec=cfg.module_spec(),
                            num_learners=num_learners, seed=7)

    g1 = make_group(0)   # local single learner
    g2 = make_group(2)   # 2 remote learners, collective grad sync
    np.testing.assert_array_equal(_flat(g1.get_weights()), _flat(g2.get_weights()))

    rng = np.random.default_rng(0)
    n = 64
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(n,)).astype(np.int32),
        "action_logp": np.full((n,), -0.693, np.float32),
        "advantages": rng.normal(size=(n,)).astype(np.float32),
        "value_targets": rng.normal(size=(n,)).astype(np.float32),
    }
    r1 = g1.update_from_batch(dict(batch))
    r2 = g2.update_from_batch(dict(batch))
    w0 = _flat(make_group(0).get_weights())
    w1, w2 = _flat(g1.get_weights()), _flat(g2.get_weights())
    # Identical update modulo fp32 reduction order across the allreduce.
    np.testing.assert_allclose(w1, w2, atol=5e-5)
    assert np.abs(w1 - w0).max() > 1e-3
    np.testing.assert_allclose(r2["grad_norm"], r1["grad_norm"], rtol=1e-5)
    g2.stop()


# --------------------------------------------------------- weight snapshot
@pytest.mark.parametrize("remote,block", [(False, True), (True, True),
                                          (True, False)])
def test_a_learner_step_leaves_synced_runner_weights_alone(rt, remote, block):
    """The broadcast hands the learner's own tensors; its next in-place
    optimizer step must not reach the runners."""
    cfg = PPOConfig().training(lr=1e-2).resources(device="cpu")
    spec = _cartpole_spec()
    learner = PPOLearner(config=cfg, module_spec=spec, seed=3)
    group = EnvRunnerGroup(env="CartPole-v1", env_config={}, module_spec=spec,
                           num_env_runners=2 if remote else 0,
                           num_envs_per_env_runner=1, rollout_fragment_length=8,
                           device="cpu")
    before = {k: v.clone() for k, v in learner.params.items()}
    group.sync_weights(learner.params, block=block)
    jm = jrl.DefaultActorCritic(4, 2, True, hiddens=(32, 32))
    learner.update_from_batch(_ppo_batch(jm, jm.init_params(jax.random.key(0)), 64))
    assert any(not torch.equal(v, before[k]) for k, v in learner.params.items())
    for state in group.foreach_env_runner("get_state"):
        for k, v in state["params"].items():
            assert torch.equal(v, before[k]), k
    group.sample(num_timesteps=4)
    group.stop()


# ---------------------------------------------------------- env runner
def test_env_runner_sample_timesteps():
    runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=_cartpole_spec(),
                                  num_envs=2, rollout_fragment_length=20,
                                  device="cpu")
    episodes = runner.sample(num_timesteps=40)
    assert sum(len(e) for e in episodes) >= 40
    for ep in episodes:
        assert len(ep.observations) == len(ep) + 1
        assert Columns.ACTION_LOGP in ep.extra
    runner.stop()


def test_env_runner_sample_episodes_greedy():
    runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=_cartpole_spec(),
                                  num_envs=1, device="cpu")
    episodes = runner.sample(num_episodes=2, explore=False)
    assert len([e for e in episodes if e.is_done]) >= 2
    runner.stop()


def test_runner_logps_are_the_sampled_actions():
    runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=_cartpole_spec(),
                                  num_envs=4, device="cpu", seed=2)
    episodes = runner.sample(num_timesteps=64)
    module = runner.module
    for ep in episodes:
        arr = ep.to_numpy()
        logits = module.forward_exploration(torch.from_numpy(arr["obs"][:-1]))[
            Columns.ACTION_DIST_INPUTS]
        want = Categorical.logp(logits, torch.from_numpy(arr["actions"])).detach()
        np.testing.assert_allclose(arr[Columns.ACTION_LOGP], want.numpy(), atol=1e-6)
    runner.stop()


# --------------------------------------------------------------- PPO algo
def test_ppo_cartpole_learns(rt):
    """(ref: tests/test_rl.py::test_ppo_cartpole_learns) best >= 150 within
    50 iterations at the reference's small budget."""
    config = (PPOConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .training(train_batch_size=512, minibatch_size=128,
                        num_epochs=6, lr=3e-4, entropy_coeff=0.01)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    best = 0.0
    for _ in range(50):
        result = algo.train()
        best = max(best, result.get("episode_return_mean", 0.0))
        if best >= 150.0:
            break
    timers = result["timers"]
    assert set(timers) == {"sample_s", "learn_s", "update_s"}
    assert 0 < timers["update_s"] < timers["learn_s"]
    algo.stop()
    assert best >= 150.0, f"PPO failed to learn CartPole: best={best}"


def test_ppo_remote_runners_and_learners(rt):
    config = (PPOConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=32)
              .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
              .learners(num_learners=2)
              .resources(device="cpu")
              .debugging(seed=1))
    algo = config.build_algo()
    r1 = algo.train()
    r2 = algo.train()
    assert "total_loss" in r2["learners"]
    assert r1["num_env_steps_sampled_lifetime"] == 128
    assert r2["num_env_steps_sampled_lifetime"] == 256
    algo.stop()


def test_ppo_checkpoint_restore(rt, tmp_path):
    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                           rollout_fragment_length=16)
              .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
              .resources(device="cpu"))
    algo = config.build_algo()
    algo.train()
    ckpt = algo.save()
    weights_before = algo.get_weights()
    opt_before = algo.learner_group.get_state()["opt_state"]

    algo2 = config.copy().build_algo()
    algo2.restore(ckpt)
    w1 = ray_tpu_torch.get(ray_tpu_torch.put(weights_before))  # serializable
    w2 = algo2.get_weights()
    assert list(w1) == list(w2)
    for k in w1:
        assert torch.equal(w1[k], w2[k]), k
    opt_after = algo2.learner_group.get_state()["opt_state"]
    for pid, st in opt_before["state"].items():
        for key, t in st.items():
            assert torch.equal(t, opt_after["state"][pid][key]), (pid, key)
    # The restored runner samples with the restored weights.
    runner_w = algo2.env_runner_group._local_runner.get_state()["params"]
    assert all(torch.equal(runner_w[k], w2[k]) for k in w2)
    assert algo2.iteration == 1 and algo2._lifetime_steps == 64
    # Both go on to the same next step.
    algo.train()
    algo2.train()
    algo.stop()
    algo2.stop()


def test_ppo_with_tune(rt):
    from ray_tpu_torch import tune

    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                           rollout_fragment_length=16)
              .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
              .resources(device="cpu"))
    tuner = tune.Tuner(
        PPO,
        param_space={"_base_config": config,
                     "lr": tune.grid_search([1e-3, 3e-4])},
        run_config=tune.RunConfig(stop={"training_iteration": 2}),
    )
    results = tuner.fit()
    assert len(results) == 2
    assert all(r.metrics.get("training_iteration") == 2 for r in results)
    assert sorted(r.metrics["config"]["lr"] for r in results) == [3e-4, 1e-3]


def test_evaluation_runs_on_its_own_greedy_runner(rt):
    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
              .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
              .evaluation(evaluation_interval=1, evaluation_duration=2)
              .resources(device="cpu"))
    algo = config.build_algo()
    result = algo.train()
    ev = result["evaluation"]["env_runners"]
    assert ev["num_episodes"] >= 2 and ev["episode_return_mean"] > 0
    assert algo._eval_runner is not algo.env_runner_group._local_runner
    algo.stop()


def test_config_dict_round_trip_and_unknown_keys():
    cfg = PPOConfig().training(lr=1e-3).resources(device="cpu")
    d = cfg.to_dict()
    assert d["device"] == "cpu" and d["lr"] == 1e-3
    assert PPOConfig().update_from_dict({"lr": 2e-3, "device": "cpu"}).lr == 2e-3
    with pytest.raises(AttributeError):
        PPOConfig().training(not_a_key=1)
    with pytest.raises(AttributeError):
        PPOConfig().update_from_dict({"not_a_key": 1})
    algo = PPO._coerce_config({"_base_config": cfg, "lr": 5e-4})
    assert algo.lr == 5e-4 and cfg.lr == 1e-3 and algo.device == "cpu"
