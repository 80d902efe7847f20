"""The port's multi-agent RL (``MultiAgentCartPole``, ``MultiAgentEpisode``,
``MultiAgentEnvRunner``, ``.multi_agent(...)`` configs, per-policy learner
groups in ``Algorithm``, multi-agent PPO) against the JAX package's.

``MultiAgentCartPole`` equals the reference's (on ``gym.make``) step for
step, bit for bit, under seeded random actions; greedy runner episodes of
the port (the reference's weights through the converter, the policy heads
scaled so that no greedy action sits on a near-tie) equal the reference
runner's, log-probs within 1e-6. Then the port's own counterparts of
``tests/test_rl_multi_agent.py``'s cases, and the checkpoint round trip bit
for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch
from _torch_runtimes import fresh_init
from ray_tpu.rl.algorithms import PPOConfig as JPPOConfig
from ray_tpu.rl.env.multi_agent_env import MultiAgentCartPole as JMultiAgentCartPole
from ray_tpu.rl.env.multi_agent_env_runner import MultiAgentEnvRunner as JRunner
from ray_tpu_torch.models.convert import rl_params_from_numpy
from ray_tpu_torch.rl import (Columns, MultiAgentCartPole, MultiAgentEnvRunner,
                              MultiAgentEpisode)
from ray_tpu_torch.rl.algorithms import DQNConfig, PPOConfig


@pytest.fixture
def rt():
    runtime = fresh_init(ray_tpu_torch, num_cpus=8)
    yield runtime
    ray_tpu_torch.shutdown()


def _mapping(aid):
    return f"p{int(aid.split('_')[1]) % 2}"


def _two_policy_config(cls=PPOConfig, device="cpu", **training):
    cfg = (
        cls()
        .environment(MultiAgentCartPole if cls is not JPPOConfig
                     else JMultiAgentCartPole, env_config={"num_agents": 2})
        .multi_agent(policies={"p0": None, "p1": None},
                     policy_mapping_fn=_mapping)
        .env_runners(rollout_fragment_length=64)
        .training(train_batch_size=512, minibatch_size=128, num_epochs=4,
                  lr=1e-3, entropy_coeff=0.01, **training)
        .rl_module(model_config={"hiddens": (32, 32)})
        .debugging(seed=0)
    )
    return cfg if cls is JPPOConfig else cfg.resources(device=device)


def test_multi_agent_env_contract():
    """(ref: tests/test_rl_multi_agent.py::test_multi_agent_env_contract)"""
    env = MultiAgentCartPole({"num_agents": 3})
    obs, infos = env.reset(seed=0)
    assert set(obs) == {"agent_0", "agent_1", "agent_2"}
    actions = {a: env.action_spaces[a].sample() for a in obs}
    obs2, rewards, terms, truncs, _ = env.step(actions)
    assert "__all__" in terms and "__all__" in truncs
    assert all(rewards[a] == 1.0 for a in actions)
    env.close()


@pytest.mark.parametrize("seed,num_agents", [(0, 2), (7, 3)])
def test_multi_agent_cartpole_equals_the_reference(seed, num_agents):
    """Seeded random actions until every pole has fallen (and on past an
    agent's end, which the env then skips): every observation, reward and
    flag dict equal, observations bit for bit."""
    ref = JMultiAgentCartPole({"num_agents": num_agents})
    port = MultiAgentCartPole({"num_agents": num_agents})
    ro, _ = ref.reset(seed=seed)
    po, _ = port.reset(seed=seed)
    assert list(ro) == list(po)
    assert all(ro[a].tobytes() == po[a].tobytes() for a in ro)
    rng = np.random.default_rng(seed)
    for _ in range(600):
        actions = {a: int(rng.integers(0, 2)) for a in port.possible_agents}
        r, p = ref.step(actions), port.step(actions)
        assert list(r[0]) == list(p[0])
        assert all(r[0][a].tobytes() == p[0][a].tobytes() for a in r[0])
        assert r[1:4] == p[1:4]
        if p[2]["__all__"]:
            break
    assert p[2]["__all__"]


def test_multi_agent_episode_routes_by_module():
    ep = MultiAgentEpisode(agent_to_module={"a": "p0", "b": "p1"})
    ep.add_env_reset({"a": np.zeros(2), "b": np.ones(2)})
    ep.add_env_step({"a": np.ones(2), "b": np.zeros(2)}, {"a": 0, "b": 1},
                    {"a": 1.0, "b": 2.0}, terminateds={"a": False, "b": True,
                                                       "__all__": False},
                    truncateds={"__all__": False})
    # A late joiner opens its own trajectory.
    ep.add_env_step({"a": np.ones(2), "c": np.ones(2)}, {"a": 1},
                    {"a": 1.0}, terminateds={"__all__": True},
                    truncateds={"__all__": False})
    assert ep.is_done and len(ep) == 2 and ep.total_env_steps == 3
    assert ep.total_return == 4.0
    by = ep.episodes_by_module()
    assert {k: len(v) for k, v in by.items()} == {"p0": 1, "p1": 1}
    assert "c" in ep.agent_episodes and len(ep.agent_episodes["c"]) == 0


def test_multi_agent_env_runner_routes_by_policy():
    """(ref: tests/test_rl_multi_agent.py::
    test_multi_agent_env_runner_routes_by_policy)"""
    cfg = _two_policy_config()
    runner = MultiAgentEnvRunner(
        env=MultiAgentCartPole, env_config={"num_agents": 2},
        module_spec=cfg.multi_module_spec(),
        policy_mapping_fn=cfg.policy_mapping_fn,
        rollout_fragment_length=32, seed=0, device="cpu")
    episodes = runner.sample(num_timesteps=32)
    assert episodes
    by_module = {}
    for ma_ep in episodes:
        for mid, eps in ma_ep.episodes_by_module().items():
            by_module.setdefault(mid, []).extend(eps)
    assert set(by_module) == {"p0", "p1"}
    for eps in by_module.values():
        for ep in eps:
            arr = ep.to_numpy()
            assert len(arr["actions"]) == len(ep)
            assert Columns.ACTION_LOGP in arr
    runner.stop()


def test_multi_module_spec_equals_the_reference():
    want = _two_policy_config(JPPOConfig).multi_module_spec().module_specs
    got = _two_policy_config().multi_module_spec().module_specs
    assert set(got) == set(want) == {"p0", "p1"}
    for pid in want:
        assert (got[pid].observation_dim, got[pid].action_dim,
                got[pid].discrete, got[pid].model_config) == \
            (want[pid].observation_dim, want[pid].action_dim,
             want[pid].discrete, want[pid].model_config)
    with pytest.raises(ValueError, match="no agent maps"):
        _two_policy_config().multi_agent(
            policies={"p0": None, "p9": None}).multi_module_spec()


@pytest.mark.parametrize("seed", [0, 5])
def test_greedy_runner_episodes_equal_the_reference(seed):
    """The reference runner's weights (each policy head scaled x200) in the
    port's runner; the same reset seeds: the same episodes."""
    jcfg = _two_policy_config(JPPOConfig)
    jrunner = JRunner(env=JMultiAgentCartPole, env_config={"num_agents": 2},
                      module_spec=jcfg.multi_module_spec(),
                      policy_mapping_fn=_mapping, explore=False, seed=seed)
    params = {}
    for pid, p in jrunner.get_state()["params"].items():
        p = jax.tree.map(np.asarray, p)
        p["pi"]["head"]["w"] = p["pi"]["head"]["w"] * 200.0
        params[pid] = p
    jrunner.set_state({"params": params})
    pcfg = _two_policy_config()
    runner = MultiAgentEnvRunner(env=MultiAgentCartPole,
                                 env_config={"num_agents": 2},
                                 module_spec=pcfg.multi_module_spec(),
                                 policy_mapping_fn=_mapping, explore=False,
                                 seed=seed, device="cpu")
    runner.set_state({"params": {
        pid: rl_params_from_numpy(runner.module[pid], p).state_dict()
        for pid, p in params.items()}})
    want = jrunner.sample(num_episodes=3)
    got = runner.sample(num_episodes=3)
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert list(a.agent_episodes) == list(b.agent_episodes)
        assert a.agent_to_module == b.agent_to_module
        for aid, ea in a.agent_episodes.items():
            eb = b.agent_episodes[aid]
            assert (ea.is_terminated, ea.is_truncated, len(ea)) == \
                (eb.is_terminated, eb.is_truncated, len(eb))
            np.testing.assert_array_equal(np.asarray(eb.observations),
                                          np.asarray(ea.observations))
            assert eb.actions == ea.actions and eb.rewards == ea.rewards
            np.testing.assert_allclose(eb.extra[Columns.ACTION_LOGP],
                                       ea.extra[Columns.ACTION_LOGP], atol=1e-6)
    assert runner.get_metrics() == jrunner.get_metrics()
    # The runner copies what it is sent: the sender's tensors stay its own.
    sent = runner.get_state()["params"]["p0"]
    sent["pi.head.w"].add_(1.0)
    assert not torch.equal(runner.module["p0"].pi.head.w, sent["pi.head.w"])
    jrunner.stop()
    runner.stop()


def test_multi_agent_ppo_iteration_updates_both_policies(rt):
    """One iteration: each policy's learner group updates on its agents'
    trajectories, and the runner samples with the new weights."""
    algo = _two_policy_config().build_algo()
    before = algo.get_weights()
    result = algo.train()
    learners = result["learners"]
    assert set(learners) == {"p0", "p1"}
    assert all(np.isfinite(res["total_loss"]) for res in learners.values())
    after = algo.get_weights()
    for pid in ("p0", "p1"):
        assert not torch.equal(before[pid]["pi.head.w"], after[pid]["pi.head.w"])
        runner_w = algo.env_runner_group.runner.module[pid].state_dict()
        assert all(torch.equal(runner_w[k], v) for k, v in after[pid].items())
    assert result["num_env_steps_sampled_lifetime"] >= 512
    assert "evaluation" not in result
    ev = algo.evaluate()
    assert ev["env_runners"]["num_episodes"] >= 1
    assert isinstance(algo._eval_runner, MultiAgentEnvRunner)
    algo.stop()


@pytest.mark.slow  # learning soak (its reference twin is slow too)
def test_multi_agent_ppo_learns_both_policies(rt):
    """(ref: tests/test_rl_multi_agent.py::
    test_multi_agent_ppo_learns_both_policies)"""
    algo = _two_policy_config().build_algo()
    best = 0.0
    for _ in range(12):
        result = algo.train()
        ret = result.get("episode_return_mean")
        if ret is not None and ret == ret:
            best = max(best, ret)
    learners = result["learners"]
    assert set(learners) == {"p0", "p1"}
    for mid, res in learners.items():
        assert np.isfinite(res["total_loss"]), (mid, res)
    assert best > 60, best
    w = algo.get_weights()
    assert not torch.allclose(w["p0"]["pi.head.w"], w["p1"]["pi.head.w"])
    algo.stop()


def test_multi_agent_checkpoint_roundtrip(rt, tmp_path):
    """(ref: tests/test_rl_multi_agent.py::test_multi_agent_checkpoint_roundtrip),
    bit for bit, Adam's state included."""
    algo = _two_policy_config().build_algo()
    algo.train()
    ckpt = str(tmp_path / "ma_ckpt")
    os.makedirs(ckpt, exist_ok=True)
    algo.save_checkpoint(ckpt)
    w_before = algo.get_weights()

    algo2 = _two_policy_config().build_algo()
    algo2.load_checkpoint(None, ckpt)
    w_after = algo2.get_weights()
    for pid in ("p0", "p1"):
        assert list(w_before[pid]) == list(w_after[pid])
        assert all(torch.equal(w_before[pid][k], w_after[pid][k])
                   for k in w_before[pid])
        a = algo.learner_groups[pid].get_state()["opt_state"]["state"]
        b = algo2.learner_groups[pid].get_state()["opt_state"]["state"]
        assert all(torch.equal(a[i][k], b[i][k]) for i in a for k in a[i])
        runner_w = algo2.env_runner_group.runner.module[pid].state_dict()
        assert all(torch.equal(runner_w[k], v) for k, v in w_after[pid].items())
    algo.stop()
    algo2.stop()


def test_only_multi_agent_algorithms_take_policies():
    cfg = (DQNConfig().environment(MultiAgentCartPole)
           .multi_agent(policies={"p0": None}).resources(device="cpu"))
    with pytest.raises(ValueError, match="does not support multi-agent"):
        cfg.build_algo()
    assert PPOConfig().multi_agent(policies={"x": None}).is_multi_agent()
    assert not PPOConfig().is_multi_agent()
    assert PPOConfig().policy_mapping_fn("agent_3") == "default_policy"
