"""The port's pixel path (``rl/env/pixel_gridworld.py``, ``CNNActorCritic``
under IMPALA) against the JAX package's.

``PixelGridworld`` equals the reference's (a ``gym.Env``) step for step:
rendered frames bit for bit, rewards, flags and its numpy seeding, shaped
and not; its spaces sample what gymnasium's sample from the same seed. One
IMPALA update of the CNN module from the reference's weights: every metric,
weight and Adam moment (conv kernels HWIO against the port's OIHW) within
``UPDATE_TOL`` (measured: at most 1.2e-7). Then the port's own counterparts
of ``tests/test_rl_pixel.py``'s cases.
"""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_rl import (_assert_learner_equal, _assert_metrics_equal, _np_tree,
                       _port_moments, _ref_moments)
from _torch_runtimes import fresh_init
from ray_tpu.rl.algorithms import impala as jimpala
from ray_tpu.rl.core import rl_module as jrl
from ray_tpu.rl.env.pixel_gridworld import PixelGridworld as JPixelGridworld
from ray_tpu_torch.models.convert import rl_params_from_numpy
from ray_tpu_torch.rl.algorithms import IMPALAConfig, IMPALALearner
from ray_tpu_torch.rl.core.rl_module import CNNActorCritic, Columns, RLModuleSpec
from ray_tpu_torch.rl.env.pixel_gridworld import PixelGridworld, make_pixel_gridworld

UPDATE_TOL = 1e-6
CNN_KW = dict(obs_shape=(8, 8, 3), conv_filters=((8, 3, 2), (16, 3, 1)),
              hiddens=(32,))


def test_pixel_gridworld_env_contract():
    """(ref: tests/test_rl_pixel.py::test_pixel_gridworld_env_contract)"""
    env = PixelGridworld(n=4, cell=2, max_steps=10)
    obs, _ = env.reset(seed=3)
    assert obs.shape == (8, 8, 3) and obs.dtype == np.uint8
    assert obs[..., 1].max() == 255  # goal painted
    steps = 0
    done = False
    while not done and steps < 12:
        obs, r, term, trunc, _ = env.step(env.action_space.sample())
        done = term or trunc
        steps += 1
    assert done


@pytest.mark.parametrize("kw", [dict(n=4, cell=2, max_steps=16, shaped=True),
                                dict(n=5, cell=3, max_steps=30, seed=4)])
def test_pixel_gridworld_equals_the_reference(kw):
    """Seeded random actions over several episodes (a reset with a seed,
    then resets drawing on): every frame, reward and flag equal."""
    ref, port = JPixelGridworld(**kw), PixelGridworld(**kw)
    rng = np.random.default_rng(1)
    for episode in range(6):
        seed = 11 if episode == 0 else None
        ro, _ = ref.reset(seed=seed)
        po, _ = port.reset(seed=seed)
        assert ro.dtype == po.dtype and ro.tobytes() == po.tobytes()
        for _ in range(kw["max_steps"] + 2):
            a = int(rng.integers(0, 4))
            r, p = ref.step(a), port.step(a)
            assert r[0].tobytes() == p[0].tobytes() and r[1:4] == p[1:4]
            if p[2] or p[3]:
                break
        assert p[2] or p[3]


def test_pixel_gridworld_spaces_sample_as_gymnasium():
    ref, port = JPixelGridworld(n=4, cell=2), PixelGridworld(n=4, cell=2)
    assert ref.observation_space.shape == port.observation_space.shape
    assert port.action_space.n == ref.action_space.n == 4
    for space_r, space_p in ((ref.action_space, port.action_space),
                             (ref.observation_space, port.observation_space)):
        space_r.seed(5)
        space_p.seed(5)
        for _ in range(4):
            a, b = np.asarray(space_r.sample()), np.asarray(space_p.sample())
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert make_pixel_gridworld({"n": 3}).n == 3


def test_cnn_module_shapes_and_grads():
    """(ref: tests/test_rl_pixel.py::test_cnn_module_shapes_and_grads)"""
    mod = CNNActorCritic(observation_dim=8 * 8 * 3, action_dim=4,
                         discrete=True, obs_shape=(8, 8, 3),
                         conv_filters=((8, 3, 2), (16, 3, 1)), hiddens=(32,))
    obs = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (5, 8 * 8 * 3)).astype(np.float32))
    out = mod.forward_train(obs)
    assert out[Columns.ACTION_DIST_INPUTS].shape == (5, 4)
    assert out[Columns.VF_PREDS].shape == (5,)
    loss = (out[Columns.VF_PREDS] ** 2).mean() + \
        (out[Columns.ACTION_DIST_INPUTS] ** 2).mean()
    loss.backward()
    grads = [p.grad for p in mod.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(g.abs().max() > 0 for g in grads)


def test_cnn_module_through_spec():
    """(ref: tests/test_rl_pixel.py::test_cnn_module_through_spec)"""
    spec = RLModuleSpec(module_class=CNNActorCritic,
                        observation_dim=8 * 8 * 3, action_dim=4,
                        discrete=True,
                        model_config={"obs_shape": (8, 8, 3),
                                      "conv_filters": ((8, 3, 2),),
                                      "hiddens": (16,)})
    mod = spec.build(seed=1, device="cpu")
    out = mod.forward_inference(torch.zeros((2, 8 * 8 * 3)))
    assert out[Columns.ACTION_DIST_INPUTS].shape == (2, 4)


def _pixel_batch(jmodule, jparams):
    """(B, T) = (4, 6) rows of gridworld frames, padded past each row's
    length, behaviour log-probs the module's own plus noise."""
    rng = np.random.default_rng(2)
    env = JPixelGridworld(n=4, cell=2, max_steps=16, shaped=True)
    B, T = 4, 6
    obs = np.zeros((B, T, 8 * 8 * 3), np.float32)
    actions = np.zeros((B, T), np.int64)
    rewards = np.zeros((B, T), np.float32)
    mask = np.zeros((B, T), np.float32)
    for b, n in enumerate((6, 4, 6, 2)):
        o, _ = env.reset(seed=b)
        for t in range(n):
            a = int(rng.integers(0, 4))
            obs[b, t] = o.ravel()
            actions[b, t] = a
            o, rewards[b, t], term, trunc, _ = env.step(a)
            mask[b, t] = 1.0
    inputs = jmodule.forward_train(jparams, obs)[Columns.ACTION_DIST_INPUTS]
    logp = np.asarray(jrl.Categorical.logp(inputs, actions))
    return {Columns.OBS: obs, Columns.ACTIONS: actions, Columns.REWARDS: rewards,
            Columns.ACTION_LOGP: ((logp + rng.normal(0, 0.3, logp.shape))
                                  * mask).astype(np.float32),
            "discounts": 0.95 * mask, "mask": mask,
            "bootstrap_value": rng.normal(size=B).astype(np.float32)}


def test_cnn_impala_update_matches_the_reference():
    """One two-epoch IMPALA update of the CNN module over padded frame
    rows, from the reference's weights."""
    training = dict(lr=5e-3, entropy_coeff=0.003)
    kw = dict(observation_dim=8 * 8 * 3, action_dim=4, discrete=True,
              model_config=CNN_KW)
    jl = jimpala.IMPALALearner(
        config=jimpala.IMPALAConfig().training(**training),
        module_spec=jrl.RLModuleSpec(module_class=jrl.CNNActorCritic, **kw),
        seed=0)
    pl = IMPALALearner(config=IMPALAConfig().training(**training)
                       .resources(device="cpu"),
                       module_spec=RLModuleSpec(module_class=CNNActorCritic, **kw),
                       seed=0)
    rl_params_from_numpy(pl.module, _np_tree(jl.params))
    batch = _pixel_batch(jl.module, jl.params)
    want = jl.update_from_batch(dict(batch), num_epochs=2)
    got = pl.update_from_batch(dict(batch), num_epochs=2)
    _assert_metrics_equal(got, want, tol=UPDATE_TOL)
    _assert_learner_equal(jl.params, _ref_moments(jl.opt_state), pl.module,
                          _port_moments([pl.optimizer], pl.module),
                          tol=UPDATE_TOL)


@pytest.fixture
def rt():
    runtime = fresh_init(ray_tpu_torch, num_cpus=8)
    yield runtime
    ray_tpu_torch.shutdown()


def test_pixel_impala_iterations_run(rt):
    """Two remote runners of the gridworld feeding the CNN learner: a few
    iterations, finite losses, the lifetime step count growing."""
    config = (IMPALAConfig()
              .environment(make_pixel_gridworld,
                           env_config={"n": 4, "cell": 2, "max_steps": 16,
                                       "shaped": True})
              .rl_module(module_class=CNNActorCritic, model_config=CNN_KW)
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=20)
              .training(train_batch_size=80, lr=2e-3, entropy_coeff=0.003)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    steps = []
    for _ in range(3):
        result = algo.train()
        steps.append(result["num_env_steps_sampled_lifetime"])
        assert all(np.isfinite(v) for v in result["learners"].values())
    assert steps[0] > 0 and steps == sorted(steps) and steps[-1] > steps[0]
    algo.stop()


@pytest.mark.slow  # learning soak (its reference twin is slow too)
def test_pixel_impala_learns(rt):
    """(ref: tests/test_rl_pixel.py::test_pixel_impala_learns)"""
    config = (IMPALAConfig()
              .environment(make_pixel_gridworld,
                           env_config={"n": 4, "cell": 2, "max_steps": 16,
                                       "shaped": True})
              .rl_module(module_class=CNNActorCritic,
                         model_config={"obs_shape": (8, 8, 3),
                                       "conv_filters": ((8, 3, 2), (16, 3, 1)),
                                       "hiddens": (64,)})
              .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                           rollout_fragment_length=20)
              .training(train_batch_size=160, lr=2e-3, entropy_coeff=0.003)
              .resources(device="cpu")
              .debugging(seed=0))
    algo = config.build_algo()
    best = -99.0
    try:
        for _ in range(45):
            result = algo.train()
            ret = result.get("env_runners", {}).get("episode_return_mean")
            if ret is not None:
                best = max(best, ret)
            if best >= 0.5:
                break
        assert best >= 0.5, f"pixel IMPALA did not learn (best={best})"
    finally:
        algo.stop()
