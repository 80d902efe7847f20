"""The port's DreamerV3 (ray_tpu_torch.rl.algorithms.dreamerv3) against the
JAX package's, on the CPU in fp32.

Both algorithms are built at small widths (``deter_dim`` 16, ``hidden`` 16,
4 x 4 latents, B=4, T=8, ``horizon`` 5, K=255); the reference's initial
weights, target critic and bucket grid go into the port through
``models.convert.dreamerv3_params_from_numpy``, inputs come from numpy
seeds, and the port's Gumbel draws are replaced by the reference's own
(``jax.random.gumbel`` of the keys its code splits, in its order). Checked:
the math within ``MATH_TOL``; each module's forward (the vector and pixel
encoders, the ConvTranspose decoder at the reference test's filters and a
k < s layer, the MLP fallback and its warning, the GRU, prior and
posterior) within ``FWD_TOL``; one world-model and one actor-critic update,
vector and pixel: every weight, Adam moment, the target critic and the
return span within ``UPDATE_TOL``, losses and aux within ``AUX_TOL``; the
policy step explore and greedy; two ``training_step``s on LineWalk with the
reference's key chain replayed (the same actions, env steps and returns,
metrics within ``STEP_TOL``); a checkpoint round trip bit for bit. Then the
port's counterparts of ``tests/test_dreamerv3.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rl import (UPDATE_TOL, _assert_learner_equal, _flat, _np_tree,
                       _port_moments, _ref_moments)
from ray_tpu.rl.algorithms import DreamerV3Config as JDreamerV3Config
from ray_tpu.rl.algorithms import dreamerv3 as jd
from ray_tpu_torch.models.convert import (_dreamer_to_ref,
                                          dreamerv3_params_from_numpy,
                                          dreamerv3_params_to_numpy)
from ray_tpu_torch.rl.algorithms import DreamerV3Config
from ray_tpu_torch.rl.algorithms import dreamerv3 as pd

MATH_TOL = 1e-6
FWD_TOL = 1e-6
AUX_TOL = 1e-5
STEP_TOL = 1e-4
#: torch.linspace(-20, 20, 255) against jnp.linspace's grid (float32):
#: largest gap, measured here (jax 0.9.0, torch 2.13): 1.9073486e-06, one
#: ulp at 20.
GRID_GAP = 2e-6

SMALL = dict(deter_dim=16, hidden=16, stoch_groups=4, stoch_classes=4,
             batch_size=4, batch_length=8, horizon=5)
PIXEL = dict(obs_shape=(8, 8, 3), conv_filters=((8, 2, 2), (16, 2, 1)))


class LineWalk:
    """1-D walk: start at 0, reach +1 (reward 1, terminate) within 12
    steps; step cost -0.02 (tests/test_dreamerv3.py's env)."""

    class _Space:
        def __init__(self, n=None, shape=None):
            self.n = n
            self.shape = shape

    def __init__(self):
        self.observation_space = self._Space(shape=(2,))
        self.action_space = self._Space(n=2)
        self._x = 0.0
        self._t = 0

    def reset(self, seed=None):
        self._x, self._t = 0.0, 0
        return self._obs(), {}

    def _obs(self):
        return np.array([self._x, self._t / 12.0], np.float32)

    def step(self, action):
        self._x += 0.25 if action == 1 else -0.25
        self._t += 1
        if self._x >= 1.0:
            return self._obs(), 1.0, True, False, {}
        trunc = self._t >= 12
        return self._obs(), -0.02, False, trunc, {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file: its many small ops otherwise wait
    on each other's threads when the suite runs workers side by side (the
    pixel case took 96 s with the default threads and 24 s with one on an
    8-core host beside six busy processes; 4 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gridworld():
    from ray_tpu_torch.rl.env.pixel_gridworld import PixelGridworld

    return PixelGridworld(n=4, cell=2, max_steps=12, shaped=True)


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(got, want, tol, msg="", rtol=0.0):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=rtol, err_msg=msg)


def _pair(env=LineWalk, **training):
    """The reference and the port from one seed, the reference's weights,
    target critic and bucket grid loaded into the port."""
    kw = dict(SMALL, **training)
    ref = (JDreamerV3Config().environment(env).training(**kw)
           .debugging(seed=0).build_algo())
    port = (DreamerV3Config().environment(env).training(**kw)
            .resources(device="cpu").debugging(seed=0).build_algo())
    dreamerv3_params_from_numpy(port, _np_tree(ref._params),
                                _np_tree(ref._target_critic),
                                buckets=np.asarray(ref._head_buckets))
    return ref, port


def _gumbel(key, shape):
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape,
                                                       jnp.float32)))


class _KeyChain:
    """The reference's key chain as the port's ``_draw_noise``: ``_act``
    splits the algorithm's key and its policy step splits that into
    (z, action); each update splits it into (k1, k2), the world model k1
    into T keys, imagination k2 into H keys, each split into (action,
    z)."""

    def __init__(self, algo, seed):
        self.algo = algo
        self.key = jax.random.key(seed)
        self._k2 = None

    def __call__(self, site, *lead):
        cfg = self.algo.algo_config
        S, C, A = cfg.stoch_groups, cfg.stoch_classes, self.algo._n_actions
        if site == "policy":
            self.key, k = jax.random.split(self.key)
            kz, ka = jax.random.split(k)
            return policy_noise(kz, ka, lead[0], S, C, A)
        if site == "world_model":
            self.key, k1, self._k2 = jax.random.split(self.key, 3)
            return world_model_noise(k1, lead[0], lead[1], S, C)
        return imagine_noise(self._k2, lead[0], lead[1], S, C, A)


def policy_noise(kz, ka, B, S, C, A):
    return {"z": _gumbel(kz, (B, S, C)), "action": _gumbel(ka, (B, A))}


def world_model_noise(k1, T, B, S, C):
    return {"z": torch.stack([_gumbel(k, (B, S, C))
                              for k in jax.random.split(k1, T)])}


def imagine_noise(k2, H, B, S, C, A):
    acts, zs = [], []
    for k in jax.random.split(k2, H):
        ka, kz = jax.random.split(k)
        acts.append(_gumbel(ka, (B, A)))
        zs.append(_gumbel(kz, (B, S, C)))
    return {"action": torch.stack(acts), "z": torch.stack(zs)}


def _batch(seed, B, T, obs_dim, n_actions, pixel=False):
    rng = np.random.default_rng(seed)
    obs = (rng.integers(0, 256, (B, T, obs_dim)) if pixel
           else rng.normal(0, 2, (B, T, obs_dim)))
    first = (rng.random((B, T)) < 0.2).astype(np.float32)
    first[:, 0] = 1.0
    return {"obs": obs.astype(np.float32),
            "actions": rng.integers(0, n_actions, (B, T)).astype(np.int32),
            "rewards": rng.normal(0, 1, (B, T)).astype(np.float32),
            "terminateds": (rng.random((B, T)) < 0.1).astype(np.float32),
            "is_first": first}


def _dreamer_layout(name, t):
    return _dreamer_to_ref(name, t).contiguous().numpy()


def _params_tree(port):
    return dreamerv3_params_to_numpy(port)[0]


# ------------------------------------------------------------------ math
def test_symlog_symexp_inverse():
    """(ref: tests/test_dreamerv3.py::test_symlog_symexp_inverse)"""
    x = np.array([-100.0, -1.0, 0.0, 0.5, 42.0, 1e4], np.float32)
    np.testing.assert_allclose(pd.symexp(pd.symlog(_t(x))).numpy(), x,
                               rtol=1e-4)


def test_symlog_symexp_match_the_reference():
    x = np.random.default_rng(0).normal(0, 30, 256).astype(np.float32)
    _close(pd.symlog(_t(x)), jd.symlog(jnp.asarray(x)), MATH_TOL)
    y = np.random.default_rng(1).normal(0, 3, 256).astype(np.float32)
    np.testing.assert_allclose(pd.symexp(_t(y)).numpy(),
                               np.asarray(jd.symexp(jnp.asarray(y))),
                               rtol=MATH_TOL, atol=MATH_TOL)


def test_bucket_grids_differ_by_at_most_one_ulp():
    """The port computes its own grid; it is not jnp.linspace's bit for
    bit (134 of 255 values differ here), and its largest gap is stated."""
    want = np.asarray(jd._buckets(255, -20.0, 20.0))
    got = pd._buckets(255, -20.0, 20.0).numpy()
    gap = float(np.abs(got - want).max())
    assert 0 < gap <= GRID_GAP, gap
    assert got[0] == want[0] == -20.0 and got[-1] == want[-1] == 20.0


def test_twohot_matches_the_reference():
    buckets = np.asarray(jd._buckets(255, -20.0, 20.0))
    bk = _t(buckets)
    x = np.concatenate([
        np.random.default_rng(0).uniform(-19.9, 19.9, 64),
        [-25.0, -20.0, 20.0, 31.0],              # clipped at both ends
        buckets[[0, 1, 5, 127, 200, 253, 254]],  # exactly on a bucket
    ]).astype(np.float32)
    got = pd.twohot(_t(x), bk)
    want = jd.twohot(jnp.asarray(x), jnp.asarray(buckets))
    _close(got, want, MATH_TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_heads_unimix_and_kl_match_the_reference():
    rng = np.random.default_rng(0)
    buckets = np.asarray(jd._buckets(255, -20.0, 20.0))
    logits = rng.normal(0, 2, (6, 255)).astype(np.float32)
    target = rng.normal(0, 20, 6).astype(np.float32)
    # symexp of E[bucket] reaches 1e2 here: relative to its size.
    _close(pd._head_mean(_t(logits), _t(buckets)),
           jd._head_mean(jnp.asarray(logits), jnp.asarray(buckets)), MATH_TOL,
           rtol=MATH_TOL)
    _close(pd._head_loss(_t(logits), _t(target), _t(buckets)),
           jd._head_loss(jnp.asarray(logits), jnp.asarray(target),
                         jnp.asarray(buckets)), 1e-5)
    p = rng.normal(0, 2, (5, 4, 4)).astype(np.float32)
    q = rng.normal(0, 2, (5, 4, 4)).astype(np.float32)
    _close(pd._unimix_logits(_t(p), 0.01, 4),
           jd._unimix_logits(jnp.asarray(p), 0.01, 4), MATH_TOL)
    _close(pd._kl_categorical(_t(p), _t(q)),
           jd._kl_categorical(jnp.asarray(p), jnp.asarray(q)), MATH_TOL)


def test_straight_through_sample_takes_the_reference_draw():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1, (5, 4, 4)).astype(np.float32)
    key = jax.random.key(3)
    want = jd._sample_onehot(key, jnp.asarray(logits))
    got = pd._sample_onehot(_gumbel(key, logits.shape), _t(logits))
    _close(got, want, MATH_TOL)


# -------------------------------------------------------------- modules
@pytest.fixture(scope="module")
def vector_pair():
    return _pair()


@pytest.fixture(scope="module")
def pixel_pair():
    return _pair(_gridworld, **PIXEL)


def test_vector_encoder_gru_prior_post_match(vector_pair):
    ref, port = vector_pair
    rng = np.random.default_rng(0)
    D, H = SMALL["deter_dim"], SMALL["hidden"]
    obs = rng.normal(0, 2, (3, 5, 2)).astype(np.float32)
    x, h = (rng.normal(0, 1, (7, D)).astype(np.float32) for _ in range(2))
    embed = rng.normal(0, 1, (7, H)).astype(np.float32)
    p = ref._params
    with torch.no_grad():
        _close(port.model.encoder(port._preprocess(_t(obs))),
               ref._encode(p, ref._preprocess(jnp.asarray(obs))), FWD_TOL)
        _close(port.model.gru(_t(x), _t(h)),
               ref._gru(p, jnp.asarray(x), jnp.asarray(h)), FWD_TOL)
        _close(port._prior_logits(_t(h)),
               ref._prior_logits(p, jnp.asarray(h)), FWD_TOL)
        _close(port._post_logits(_t(h), _t(embed)),
               ref._post_logits(p, jnp.asarray(h), jnp.asarray(embed)),
               FWD_TOL)
        _close(port.model.decoder(_t(np.concatenate([h, h], -1))),
               ref._decode(p, jnp.asarray(np.concatenate([h, h], -1))),
               FWD_TOL)


def test_pixel_encoder_and_deconv_decoder_match(pixel_pair):
    ref, port = pixel_pair
    assert ref._deconv and port._deconv
    assert isinstance(port.model.decoder, pd._DeconvDecoder)
    rng = np.random.default_rng(0)
    obs = rng.integers(0, 256, (2, 3, 192)).astype(np.float32)
    feat = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    p = ref._params
    with torch.no_grad():
        _close(port.model.encoder(port._preprocess(_t(obs))),
               ref._encode(p, ref._preprocess(jnp.asarray(obs))), FWD_TOL)
        got = port.model.decoder(_t(feat))
        assert got.shape == (2, 3, 192)
        _close(got, ref._decode(p, jnp.asarray(feat)), FWD_TOL)


@pytest.mark.parametrize("k,s", [(1, 2), (2, 1), (2, 2), (4, 2), (3, 1)])
def test_one_deconv_layer_matches_conv_transpose(k, s):
    """Each layer is ``jax.lax.conv_transpose(..., "VALID")`` with the
    kernel unflipped; k < s needs ``output_padding`` (JAX's output is
    ``in * s``)."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(0, 1, (2, 5, 5, 3)).astype(np.float32)
    w = rng.normal(0, 1, (k, k, 3, 6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    want = jd._deconv_apply([{"w": jnp.asarray(w), "b": jnp.asarray(b)}],
                            ((3, k, s),), jnp.asarray(x), jax.nn.silu)
    layer = pd._Deconv(3, 6, k, s)
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(w).flip(0, 1).permute(2, 3, 0, 1))
        layer.b.copy_(torch.from_numpy(b))
        got = layer(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want, 2e-5)


def test_mlp_decoder_fallback_warns_and_matches():
    """Filters that do not invert exactly: both packages decide so, the
    port warns and decodes with the reference's MLP on the same weights."""
    filters = ((8, 3, 2),)  # (8 - 3) % 2 != 0: no exact mirror
    assert not jd._deconv_invertible((8, 8, 3), filters)
    with pytest.warns(RuntimeWarning, match="falls back to an MLP"):
        port = (DreamerV3Config().environment(_gridworld)
                .training(**SMALL, obs_shape=(8, 8, 3), conv_filters=filters)
                .resources(device="cpu").debugging(seed=0).build_algo())
    assert not port._deconv
    assert isinstance(port.model.decoder, pd._SiluMLP)
    decoder = jax.tree.map(jnp.asarray, _params_tree(port)["decoder"])
    assert [layer["w"].shape for layer in decoder] == [(32, 16), (16, 192)]
    feat = np.random.default_rng(0).normal(0, 1, (3, 32)).astype(np.float32)
    with torch.no_grad():
        _close(port.model.decoder(_t(feat)),
               jd._mlp(decoder, jnp.asarray(feat)), FWD_TOL)


# ------------------------------------------------------------- updates
def _one_update_each(env, training, pixel):
    """One world-model update (key k1) and one actor-critic update (k2)
    on both sides from the same weights and batch."""
    ref, port = _pair(env, **training)
    cfg = port.algo_config
    S, C, A = cfg.stoch_groups, cfg.stoch_classes, port._n_actions
    B, T = cfg.batch_size, cfg.batch_length
    batch = _batch(7, B, T, port._obs_dim, A, pixel)
    _, k1, k2 = jax.random.split(jax.random.key(11), 3)
    draws = iter([world_model_noise(k1, T, B, S, C),
                  imagine_noise(k2, cfg.horizon, B * T, S, C, A)])
    port._draw_noise = lambda site, *lead: next(draws)

    wm, ac = ref._split(ref._params)
    wm, wm_state, wm_loss, wm_aux = ref._wm_update(
        wm, ref._wm_state, {k: jnp.asarray(v) for k, v in batch.items()}, k1)
    loss, aux, feat = port._wm_update({k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    _close(loss, wm_loss, AUX_TOL, "world_model_loss")
    for k in ("recon_loss", "reward_loss", "cont_loss", "kl"):
        _close(aux[k], wm_aux[k], AUX_TOL, k)
    _close(feat, wm_aux["feat"], UPDATE_TOL, "feat")

    feat0 = wm_aux["feat"].reshape(-1, wm_aux["feat"].shape[-1])
    ac, ac_state, target, ac_loss, ac_aux = ref._ac_update(
        ac, ref._ac_state, wm, ref._target_critic, feat0, k2,
        jnp.float32(1.3))
    _, paux = port._ac_update(feat.reshape(-1, feat.shape[-1]), 1.3)
    for k in ("actor_loss", "critic_loss", "imagined_return",
              "actor_entropy"):
        _close(paux[k], ac_aux[k], AUX_TOL, k)
    _close(paux["return_span"], ac_aux["return_span"], UPDATE_TOL,
           "return_span")
    _assert_learner_equal(
        {**wm, **ac}, _ref_moments((wm_state, ac_state), ("", "")), port,
        _port_moments([port._wm_opt, port._ac_opt], port.model,
                      _dreamer_layout),
        to_numpy=_params_tree)
    want_t, got_t = _flat(_np_tree(target)), _flat(
        dreamerv3_params_to_numpy(port)[1])
    assert set(want_t) == set(got_t)
    for k in want_t:
        _close(got_t[k], want_t[k], UPDATE_TOL, f"target {k}")
    # The update moved every head the losses read.
    assert np.abs(_flat(_params_tree(port))["critic.1.w"]).max() > 0
    return port


def test_world_model_and_actor_critic_updates_match_vector():
    port = _one_update_each(LineWalk, {}, pixel=False)
    assert all(not p.requires_grad for p in port.target_critic.parameters())


def test_world_model_and_actor_critic_updates_match_pixel():
    _one_update_each(_gridworld, PIXEL, pixel=True)


@pytest.mark.parametrize("explore", [True, False])
def test_policy_step_matches(vector_pair, explore):
    ref, port = vector_pair
    cfg = port.algo_config
    rng = np.random.default_rng(2)
    B, D, Z, A = 4, cfg.deter_dim, cfg.stoch_groups * cfg.stoch_classes, 2
    h = rng.normal(0, 1, (B, D)).astype(np.float32)
    z = np.eye(cfg.stoch_classes, dtype=np.float32)[
        rng.integers(0, cfg.stoch_classes, (B, cfg.stoch_groups))].reshape(B, Z)
    a_prev = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    obs = rng.normal(0, 1, (B, 2)).astype(np.float32)
    key = jax.random.key(5)
    kz, ka = jax.random.split(key)
    want = ref._make_policy_step()(ref._params, *map(jnp.asarray,
                                                     (h, z, a_prev, obs)),
                                   key, jnp.asarray(explore))
    seen = []

    def draw(site, *lead):
        seen.append((site, lead))
        return policy_noise(kz, ka, B, cfg.stoch_groups, cfg.stoch_classes, A)

    port._draw_noise = draw
    got = port._policy_step(*map(_t, (h, z, a_prev, obs)), explore)
    del port._draw_noise
    assert seen == [("policy", (B,))]  # drawn in greedy mode too
    _close(got[0], want[0], FWD_TOL)
    _close(got[1], want[1], FWD_TOL)
    assert got[2].tolist() == np.asarray(want[2]).tolist()


def test_noise_is_drawn_from_one_generator_in_each_mode():
    """The generator advances by the same draws whether the policy
    explores or not, and in evaluate."""
    _, port = _pair()
    obs = np.zeros(2, np.float32)
    states = []
    for explore in (True, False):
        port._generator.manual_seed(0)
        port._filter_state = None
        port._act(obs, explore=explore)
        states.append(port._generator.get_state())
    assert torch.equal(states[0], states[1])
    seen = []
    inner = port._draw_noise
    port._draw_noise = lambda site, *lead: seen.append(site) or inner(site, *lead)
    port.evaluate()
    assert seen and set(seen) == {"policy"}


# -------------------------------------------------------- training steps
def test_two_training_steps_match_with_the_reference_key_chain():
    """Two iterations on LineWalk: the second updates. The port draws the
    reference's Gumbel noise through its key chain; the actions, env steps
    and episode returns are equal, learner metrics within STEP_TOL."""
    training = dict(env_steps_per_iteration=40, updates_per_iteration=2,
                    min_buffer_steps=60)
    ref, port = _pair(LineWalk, **training)
    port._draw_noise = _KeyChain(port, 0)
    acts = {"ref": [], "port": []}
    for name, algo in (("ref", ref), ("port", port)):
        inner = algo._act

        def logged(obs, explore=True, inner=inner, name=name):
            a = inner(obs, explore)
            acts[name].append(a)
            return a

        algo._act = logged
    for i in range(2):
        want, got = ref.training_step(), port.training_step()
        assert acts["port"] == acts["ref"], i
        assert got["buffer_steps"] == want["buffer_steps"]
        assert port._episode_returns == ref._episode_returns
        assert set(got["learners"]) == set(want["learners"])
        for k, v in want["learners"].items():
            np.testing.assert_allclose(got["learners"][k], v, atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=k)
    assert got["learners"] and port._lifetime_steps == ref._lifetime_steps
    np.testing.assert_allclose(port._retnorm, ref._retnorm, rtol=STEP_TOL)
    for k, v in _flat(_np_tree(ref._params)).items():
        _close(_flat(_params_tree(port))[k], v, STEP_TOL, k)


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
    cfg = (DreamerV3Config().environment(LineWalk)
           .training(**SMALL, env_steps_per_iteration=40,
                     updates_per_iteration=2, min_buffer_steps=40)
           .resources(device="cpu").debugging(seed=0))
    algo = cfg.build_algo()
    algo.training_step()
    algo.save_checkpoint(str(tmp_path))
    fresh = cfg.build_algo()
    fresh.load_checkpoint(None, str(tmp_path))
    for a, b in ((algo.model, fresh.model),
                 (algo.target_critic, fresh.target_critic)):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for oa, ob in ((algo._wm_opt, fresh._wm_opt), (algo._ac_opt, fresh._ac_opt)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sorted(sa) == sorted(sb) and sa
        for p in sa:
            for k in sa[p]:
                assert torch.equal(sa[p][k], sb[p][k]), (p, k)
    assert fresh._retnorm == algo._retnorm
    assert fresh._lifetime_steps == algo._lifetime_steps == 40
    # A moved model differs from the fresh init: the check has teeth.
    init = cfg.build_algo()
    assert not all(torch.equal(v, init.model.state_dict()[k])
                   for k, v in algo.model.state_dict().items())


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DreamerV3Config().environment(LineWalk).build_algo()


# ----------------------------------- tests/test_dreamerv3.py on the port
def test_dreamerv3_pixel_conv_encoder():
    """(ref: tests/test_dreamerv3.py::test_dreamerv3_pixel_conv_encoder)"""
    config = (DreamerV3Config()
              .environment(_gridworld)
              .training(obs_shape=(8, 8, 3),
                        conv_filters=((8, 2, 2), (16, 2, 1)),
                        deter_dim=64, hidden=64, stoch_groups=4,
                        stoch_classes=4, batch_size=4, batch_length=8,
                        env_steps_per_iteration=120,
                        updates_per_iteration=5, min_buffer_steps=120)
              .resources(device="cpu").debugging(seed=0))
    algo = config.build_algo()
    assert algo._deconv
    assert "decoder.deconvs.0.w" in algo.model.state_dict()
    history = []
    for _ in range(10):
        r = algo.training_step()["learners"]
        if r:
            history.append(r["recon_loss"])
            assert np.isfinite(r["world_model_loss"])
    assert len(history) >= 6
    assert history[-1] < history[0] * 0.9, history  # fitting pixels
    algo.stop()


@pytest.mark.slow  # learning soak, as the reference marks it
def test_world_model_losses_decrease():
    """(ref: tests/test_dreamerv3.py::test_world_model_losses_decrease)"""
    config = (DreamerV3Config()
              .environment(LineWalk)
              .training(env_steps_per_iteration=300,
                        updates_per_iteration=0, min_buffer_steps=200)
              .resources(device="cpu").debugging(seed=0))
    algo = config.build_algo()
    algo.training_step()  # fill the buffer only (0 updates)
    algo.algo_config.env_steps_per_iteration = 1
    algo.algo_config.updates_per_iteration = 1
    history = []
    for _ in range(30):
        r = algo.training_step()["learners"]
        if r:
            history.append((r["recon_loss"], r["reward_loss"]))
    assert len(history) >= 20
    recon_first = np.mean([h[0] for h in history[:3]])
    recon_last = np.mean([h[0] for h in history[-3:]])
    rew_first = np.mean([h[1] for h in history[:3]])
    rew_last = np.mean([h[1] for h in history[-3:]])
    assert recon_last < recon_first * 0.75, (recon_first, recon_last)
    assert rew_last < rew_first - 0.25, (rew_first, rew_last)
    algo.stop()


@pytest.mark.slow  # learning soak, as the reference marks it
def test_dreamerv3_learns_linewalk():
    """(ref: tests/test_dreamerv3.py::test_dreamerv3_learns_linewalk)"""
    config = (DreamerV3Config()
              .environment(LineWalk)
              .resources(device="cpu").debugging(seed=0))
    algo = config.build_algo()
    best = -10.0
    deadline = time.time() + 240
    for _ in range(60):
        result = algo.train()
        best = max(best, result.get("episode_return_mean", -10.0))
        if best > 0.8 or time.time() > deadline:
            break
    assert best > 0.8, f"DreamerV3 failed to learn LineWalk (best {best})"
    algo.stop()
