"""The port's CartPole-v1 and spaces (ray_tpu_torch/rl/env/cartpole.py)
against gymnasium's, and the port's env runner against the reference's.

The port carries its own CartPole because the card's machine has no
gymnasium. Here it is held to ``gymnasium.make("CartPole-v1")`` bit for
bit: reset observations over 20 seeds, reset after reset from one seeded
generator, whole trajectories under fixed action sequences to termination
and to the 500-step truncation (observations, rewards, flags), and the
seeded samples of ``Discrete`` and ``Box``. Then greedy runner episodes of
the port (the reference's weights through the converter, the policy head
scaled so that no greedy action sits on a near-tie) equal the reference
runner's: observations and actions exactly, log-probs within 1e-6.
"""

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.rl.core import rl_module as jrl
from ray_tpu.rl.env.env_runner import SingleAgentEnvRunner as JRunner
from ray_tpu_torch.models.convert import rl_params_from_numpy
from ray_tpu_torch.rl import Columns, DefaultActorCritic, RLModuleSpec
from ray_tpu_torch.rl.env import cartpole
from ray_tpu_torch.rl.env.env_runner import SingleAgentEnvRunner, env_spaces


def _pair(seed=None):
    ref, port = gym.make("CartPole-v1"), cartpole.make("CartPole-v1")
    return ref, port, ref.reset(seed=seed), port.reset(seed=seed)


def _same_obs(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (4,)
    assert a.tobytes() == b.tobytes(), (a, b)


@pytest.mark.parametrize("seed", range(20))
def test_reset_observations_equal_gymnasium(seed):
    ref, port, (ro, _), (po, _) = _pair(seed)
    _same_obs(ro, po)
    # Later resets draw on from the same generator.
    for _ in range(3):
        _same_obs(ref.reset()[0], port.reset()[0])


def _run(env, actions):
    out = []
    for a in actions:
        obs, reward, term, trunc, info = env.step(a)
        out.append((obs.tobytes(), reward, term, trunc))
        if term or trunc:
            break
    return out


@pytest.mark.parametrize("seed,pattern", [
    (0, "right"), (1, "left"), (2, "alternate"), (3, "random"),
    (4, "random"), (5, "balance"), (6, "balance")])
def test_trajectories_equal_gymnasium(seed, pattern):
    """Fixed action sequences until the episode ends; "balance" (a linear
    controller on the observation, pushing toward the pole's fall and
    back to the centre) lasts until the 500-step truncation."""
    ref, port, (ro, _), (po, _) = _pair(seed)
    rand = np.random.default_rng(seed).integers(0, 2, 600)
    runs = []
    for env, obs in ((ref, ro), (port, po)):
        steps = []
        for t in range(600):
            a = {"right": 1, "left": 0, "alternate": t % 2,
                 "random": int(rand[t]),
                 "balance": int(3 * obs[2] + obs[3] + 0.1 * obs[0]
                                + 0.3 * obs[1] > 0)}[pattern]
            obs, reward, term, trunc, _ = env.step(a)
            steps.append((obs.tobytes(), reward, term, trunc))
            if term or trunc:
                break
        runs.append(steps)
    assert runs[0] == runs[1]
    last = runs[1][-1]
    if pattern == "balance":
        assert len(runs[1]) == 500 and last[3] and not last[2]
    else:
        assert last[2] and not last[3] and len(runs[1]) < 500


def test_step_after_termination_equals_gymnasium():
    import warnings

    ref, port, _, _ = _pair(7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a = _run(ref.unwrapped, [1] * 40)
        b = _run(port, [1] * 40)
        assert a == b and a[-1][2]
        # Stepping on after the fall: reward 0, terminated stays true.
        assert _run(ref.unwrapped, [0, 0]) == _run(port, [0, 0])


def test_spaces_and_seeded_samples_equal_gymnasium():
    ref, port = gym.make("CartPole-v1"), cartpole.make("CartPole-v1")
    assert port.action_space.n == ref.action_space.n == 2
    np.testing.assert_array_equal(port.observation_space.low,
                                  ref.observation_space.low)
    np.testing.assert_array_equal(port.observation_space.high,
                                  ref.observation_space.high)
    for space_r, space_p in ((ref.action_space, port.action_space),
                             (ref.observation_space, port.observation_space),
                             (gym.spaces.Box(-1.0, 2.0, (3,), np.float32),
                              cartpole.Box(-1.0, 2.0, (3,), np.float32)),
                             (gym.spaces.Box(np.array([0.0, -np.inf]),
                                             np.array([np.inf, 1.0]),
                                             dtype=np.float32),
                              cartpole.Box(np.array([0.0, -np.inf]),
                                           np.array([np.inf, 1.0]),
                                           dtype=np.float32))):
        space_r.seed(11)
        space_p.seed(11)
        for _ in range(10):
            a, b = space_r.sample(), space_p.sample()
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
            assert space_p.contains(b)
    assert not port.action_space.contains(2)
    assert not port.action_space.contains(1.0)
    with pytest.raises(ValueError, match="invalid"):
        port.step(3)


def test_make_knows_cartpole_only_and_a_callable_env_works():
    env = cartpole.make("CartPole-v1", max_episode_steps=3)
    env.reset(seed=0)
    assert [env.step(0)[3] for _ in range(3)] == [False, False, True]
    with pytest.raises(ValueError, match="unknown env"):
        cartpole.make("Pendulum-v1")
    with pytest.raises(ValueError, match="non-negative"):
        env.reset(seed=-1)
    assert env_spaces("CartPole-v1", {}) == (4, 2, True)
    # A callable env(env_config), as the reference takes it; a gymnasium env
    # works too (its Discrete has ``n``).
    assert env_spaces(lambda cfg: gym.make("CartPole-v1", **cfg), {}) == (4, 2, True)
    assert env_spaces(lambda cfg: gym.make("Pendulum-v1"), {}) == (3, 1, False)


def test_runner_makes_its_envs_without_gymnasium(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "gymnasium", None)
    spec = RLModuleSpec(module_class=DefaultActorCritic, observation_dim=4,
                        action_dim=2, model_config={"hiddens": (8,)})
    runner = SingleAgentEnvRunner(env="CartPole-v1", module_spec=spec,
                                  num_envs=2, device="cpu")
    assert all(isinstance(e, cartpole.CartPoleEnv) for e in runner.envs)
    acts, logps = runner._random_actions(None)
    assert acts.shape == (2,) and np.allclose(logps, -np.log(2))
    assert len(runner.sample(num_timesteps=8, random_actions=True)) >= 2


@pytest.mark.parametrize("seed,num_envs", [(0, 2), (3, 3)])
def test_greedy_runner_episodes_equal_the_reference(seed, num_envs):
    """The same weights (the policy head scaled x200 so that greedy actions
    have real margins), the same reset seeds: the same episodes."""
    jspec = jrl.RLModuleSpec(module_class=jrl.DefaultActorCritic,
                             observation_dim=4, action_dim=2,
                             model_config={"hiddens": (32, 32)})
    jparams = jspec.build().init_params(jax.random.key(seed))
    jparams["pi"]["head"]["w"] = jparams["pi"]["head"]["w"] * 200.0
    pspec = RLModuleSpec(module_class=DefaultActorCritic, observation_dim=4,
                         action_dim=2, model_config={"hiddens": (32, 32)})
    port_module = rl_params_from_numpy(pspec.build(device="cpu"),
                                       jax.tree.map(np.asarray, jparams))
    kw = dict(env="CartPole-v1", num_envs=num_envs, explore=False, seed=seed)
    ref = JRunner(module_spec=jspec, **kw)
    port = SingleAgentEnvRunner(module_spec=pspec, device="cpu", **kw)
    ref.set_state({"params": jparams})
    port.set_state({"params": port_module.state_dict()})
    want = ref.sample(num_episodes=5)
    got = port.sample(num_episodes=5)
    assert len(got) == len(want) >= 5
    for a, b in zip(want, got):
        assert (a.is_terminated, a.is_truncated, len(a)) == \
            (b.is_terminated, b.is_truncated, len(b))
        np.testing.assert_array_equal(np.asarray(b.observations),
                                      np.asarray(a.observations))
        np.testing.assert_array_equal(np.asarray(b.actions), np.asarray(a.actions))
        assert b.rewards == a.rewards
        np.testing.assert_allclose(b.extra[Columns.ACTION_LOGP],
                                   a.extra[Columns.ACTION_LOGP], atol=1e-6)
    # Every greedy choice had a margin far above the frameworks' rounding.
    obs = np.concatenate([np.asarray(e.observations[:-1]) for e in got])
    logits = port_module.forward_inference(torch.from_numpy(obs))[
        Columns.ACTION_DIST_INPUTS].detach().numpy()
    assert np.abs(logits[:, 0] - logits[:, 1]).min() > 1e-3
    assert ref.get_metrics() == port.get_metrics()
    ref.stop()
    port.stop()
