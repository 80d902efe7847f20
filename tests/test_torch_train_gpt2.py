"""The port's GPT-2 training step (ray_tpu_torch.models.gpt2, ray_tpu_torch.optim)
against the JAX package's.

Both sides get ``GPTConfig.tiny()`` in fp32 (2 layers, D=128, 4 heads,
S=128, V=1024), the same parameters (JAX's init, as numpy, through the
converter) and the same tokens (numpy, from a seed). Splash attention and the
fused loss run the JAX Pallas kernels in interpret mode and the port's plain
versions, so what is compared is the gradient each kernel computes.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import bench, optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import attention, fused_ce

# fp32 on both sides: sums over 256 positions and 128-wide products taken in
# other orders (the loss itself agrees to ~1e-6).
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _configs(**kw):
    jcfg = dataclasses.replace(jgpt2.GPTConfig.tiny(), dtype=jnp.float32,
                               logits_dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(tgpt2.GPTConfig.tiny(), dtype=torch.float32,
                               logits_dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    return jax.tree.map(np.asarray, jgpt2.init_params(jcfg, jax.random.key(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1024, (2, 129)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _torch_batch(batch):
    return tuple(torch.as_tensor(a, dtype=torch.long) for a in batch)


def _port_loss_and_grads(jax_params, batch, tcfg):
    params = convert.params_from_numpy(jax_params, device="cpu")
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tgpt2.loss_fn(params, *_torch_batch(batch), tcfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _leaves_with_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("loss_impl", ["dense", "fused"])
@pytest.mark.parametrize("attn_impl", ["xla", "splash"])
def test_loss_and_every_gradient_match_jax(jax_params, batch, attn_impl,
                                           loss_impl):
    jcfg, tcfg = _configs(attn_impl=attn_impl, loss_impl=loss_impl)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, t, y: jgpt2.loss_fn(p, t, y, jcfg)))(
            jax_params, *map(jnp.asarray, batch))
    loss, grads = _port_loss_and_grads(jax_params, batch, tcfg)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for (name, w), g in zip(_leaves_with_names(want), grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(remat_policy="attn_outside"), dict(remat_policy="full"),
    dict(remat=False), dict(remat_policy="save_attn_mlp"),
    dict(remat_policy="attn_outside", save_mlp_act=True),
    dict(remat_policy="save_matmuls"),
    dict(remat_policy="full", attn_impl="xla"),
    dict(remat_policy="save_attn", attn_impl="xla")],
    ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_remat_schedules_give_identical_loss_and_gradients(jax_params, batch,
                                                           kw):
    """Remat changes what is kept and what reruns, never the numbers
    (mirrors tests/test_models.py:128-158): every schedule against the
    default save_attn on the same attention path."""
    attn = kw.get("attn_impl", "splash")
    _, base = _configs(attn_impl=attn)
    ref_loss, ref = _port_loss_and_grads(jax_params, batch, base)
    _, tcfg = _configs(**{"attn_impl": attn, **kw})
    loss, grads = _port_loss_and_grads(jax_params, batch, tcfg)
    assert loss == ref_loss
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("policy,forwards", [
    ("attn_outside", 2), ("save_attn", 2), ("full", 4)])
def test_which_schedules_rerun_the_splash_forward(monkeypatch, jax_params,
                                                  batch, policy, forwards):
    """One loss and gradient of the 2-layer model: the split schedules run
    SplashAttention's forward once per layer (its saved q, k, v, o, lse
    outlive the forward), "full" once more per layer in the backward. On
    the card these are the kernel's launches (chip_smoke.py counts them)."""
    calls = []
    real = attention.attention_reference
    monkeypatch.setattr(attention, "attention_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tcfg = _configs(attn_impl="splash", remat_policy=policy)
    _port_loss_and_grads(jax_params, batch, tcfg)
    assert len(calls) == forwards


def test_remat_schedule_mapping():
    """Which torch.utils.checkpoint schedule each policy gets (see the
    GPTConfig.remat comment)."""
    _, tiny = _configs(attn_impl="splash")
    split = {"attn_outside", "save_attn", "save_attn_qkv", "save_attn_mlp",
             "save_attn_qkv_mlp"}
    for policy in tgpt2._REMAT_POLICIES:
        fn = tgpt2.block_fn(dataclasses.replace(tiny, remat_policy=policy))
        target = getattr(fn, "func", None)
        if policy in split:
            assert target is tgpt2._block_split, policy
            assert fn.keywords["keep_mlp_act"] == ("mlp" in policy), policy
        elif policy == "full":
            assert target is None, policy  # the whole block under checkpoint
        else:
            assert target is tgpt2._block, policy
    assert getattr(tgpt2.block_fn(dataclasses.replace(tiny, remat=False)),
                   "func", None) is tgpt2._block


def _grads_from_seed(jax_params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
        jax_params)


@pytest.mark.parametrize("mu_dtype,mu_tol", [
    (torch.float32, 1e-6), (torch.bfloat16, 2.0**-8)], ids=["mu_fp32", "mu_bf16"])
def test_optimizer_matches_optax(jax_params, mu_dtype, mu_tol):
    """Three AdamW steps on the same parameters and gradients (numpy, from a
    seed; the first step's gradients have a global norm above 1, so the
    clip acts, the later ones below), against optax ``make_optimizer`` under
    jit. Parameters and nu within 1e-6 of each leaf's largest entry (ulps of
    fp32: the global norm sums in another order); mu within ``mu_tol``: the
    same for an fp32 mu, one bf16 ulp (2**-8) for a bf16 mu, since an fp32
    value one ulp apart may round to the neighbouring bf16."""
    tol = 1e-6
    jdt = jnp.float32 if mu_dtype == torch.float32 else jnp.bfloat16
    jopt = jgpt2.make_optimizer(1e-3, mu_dtype=jdt)
    topt = tgpt2.make_optimizer(1e-3, mu_dtype=mu_dtype)
    jp = jax_params
    jstate = jopt.init(jp)
    params = convert.params_from_numpy(jax_params, device="cpu")
    state = topt.init(params)

    @jax.jit
    def jstep(p, s, g):
        updates, s = jopt.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for i, scale in enumerate((1e-2, 1e-4, 1e-5)):
        g = _grads_from_seed(jax_params, i, scale)
        jp, jstate = jstep(jp, jstate, g)
        state = topt.update(convert.params_from_numpy(g, device="cpu"),
                            state, params)
    assert state["count"] == 3
    adam = jstate[1][0]
    for (name, want), got in zip(_leaves_with_names(jp),
                                 optim.tree_leaves(params)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max(), name
    for tree, ours, dt, t in ((adam.mu, state["mu"], mu_dtype, mu_tol),
                              (adam.nu, state["nu"], torch.float32, tol)):
        for (name, want), got in zip(_leaves_with_names(tree),
                                     optim.tree_leaves(ours)):
            assert got.dtype == dt
            want = np.asarray(want, np.float32)
            assert np.abs(got.float().numpy() - want).max() <= \
                t * np.abs(want).max(), name


def test_bf16_moment_follows_the_jitted_optax_update():
    """optax multiplies the stored bf16 mu by the Python float b1, which JAX
    rounds to bf16. Eager JAX rounds the product to bf16 too; under jit, as
    the JAX train step runs, XLA keeps it in fp32, and the two updates part
    by more than 1e-3 within three steps. The port follows the jitted one,
    within 1e-6 (fp32 ulps)."""
    rng = np.random.default_rng(0)
    grads = [(rng.standard_normal(4096) * s).astype(np.float32)
             for s in (1e-2, 1e-4, 1e-5)]
    adam = optax.scale_by_adam(b1=0.9, b2=0.95, eps=1e-8,
                               mu_dtype=jnp.bfloat16)
    jitted = jax.jit(adam.update)
    s_jit = s_eager = adam.init(jnp.zeros(4096))
    # lr = -1 and no decay: the port's parameter moves by exactly the update.
    port = optim.AdamW(learning_rate=-1.0, weight_decay=0.0, grad_clip=1e9)
    p = torch.zeros(4096)
    state = port.init({"p": p})
    eager_gap = 0.0
    for g in grads:
        u_jit, s_jit = jitted(jnp.asarray(g), s_jit)
        u_eager, s_eager = adam.update(jnp.asarray(g), s_eager)
        before = p.clone()
        state = port.update({"p": torch.from_numpy(g)}, state, {"p": p})
        np.testing.assert_allclose((p - before).numpy(), np.asarray(u_jit),
                                   atol=1e-6, rtol=0)
        eager_gap = max(eager_gap, float(jnp.abs(u_jit - u_eager).max()))
    assert eager_gap > 1e-3


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16],
                         ids=["mu_fp32", "mu_bf16"])
def test_three_train_steps_match_jax(jax_params, batch, mu_dtype):
    """make_train_step against the JAX step (jit), 3 steps from the same
    start: every parameter within 1e-5 absolute, 3% of one step's update
    (lr = 3e-4). The gradients agree to ~1e-6 relative, but Adam divides
    each by its own scale, so an entry whose gradient is near zero moves by
    up to a few percent of a step differently (5e-6 measured)."""
    tol = 1e-5
    jdt = jnp.float32 if mu_dtype == torch.float32 else jnp.bfloat16
    jcfg, tcfg = _configs(attn_impl="xla")
    jopt = jgpt2.make_optimizer(3e-4, mu_dtype=jdt)
    jstep = jax.jit(jgpt2.make_train_step(jcfg, jopt))
    jp, js = jax_params, jopt.init(jax_params)
    topt = tgpt2.make_optimizer(3e-4, mu_dtype=mu_dtype)
    params = convert.params_from_numpy(jax_params, device="cpu")
    state = topt.init(params)
    step = tgpt2.make_train_step(tcfg, topt)
    toks = _torch_batch(batch)
    for _ in range(3):
        jp, js, jloss = jstep(jp, js, *map(jnp.asarray, batch))
        params, state, loss = step(params, state, *toks)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for (name, want), got in zip(_leaves_with_names(jp),
                                 optim.tree_leaves(params)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=tol, rtol=0, err_msg=name)


def test_loss_decreases_training():
    """Mirrors tests/test_models.py:48: ten steps at lr 1e-2 on a repeated
    pattern take the loss below 0.8x its first value."""
    _, tcfg = _configs()
    optimizer = tgpt2.make_optimizer(learning_rate=1e-2)
    params = tgpt2.init_params(tcfg, seed=0, device="cpu")
    opt_state = optimizer.init(params)
    step = tgpt2.make_train_step(tcfg, optimizer)
    rng = np.random.default_rng(0)
    seq = np.tile(rng.integers(0, tcfg.vocab_size, (1, 8)),
                  (4, tcfg.seq_len // 8 + 1))
    toks = torch.as_tensor(seq[:, :tcfg.seq_len + 1], dtype=torch.long)
    first = None
    for _ in range(10):
        params, opt_state, loss = step(params, opt_state, toks[:, :-1],
                                       toks[:, 1:])
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.8
    assert opt_state["count"] == 10
    assert all(p.grad is None for p in optim.tree_leaves(params))


def test_eval_step_is_the_loss(jax_params, batch):
    _, tcfg = _configs()
    params = convert.params_from_numpy(jax_params, device="cpu")
    toks = _torch_batch(batch)
    loss = tgpt2.make_eval_step(tcfg)(params, *toks)
    assert not loss.requires_grad
    assert torch.equal(loss, tgpt2.loss_fn(params, *toks, tcfg))


def test_cpu_training_launches_no_kernel(batch):
    attention.reset_launches()
    fused_ce.reset_launches()
    _, tcfg = _configs(attn_impl="splash", loss_impl="fused")
    params = tgpt2.init_params(tcfg, seed=0, device="cpu")
    optimizer = tgpt2.make_optimizer()
    tgpt2.make_train_step(tcfg, optimizer)(params, optimizer.init(params),
                                           *_torch_batch(batch))
    assert set(attention.LAUNCHES.values()) == {0}
    assert set(fused_ce.LAUNCHES.values()) == {0}


def test_pipeline_stages_raise(jax_params, batch):
    """A pipelined step builds, as the reference's does; called without a
    mesh it raises ValueError, as the reference's ("the context mesh cannot
    be empty"). tests/test_torch_pipeline.py runs it on a pipe mesh."""
    jcfg, tcfg = _configs(pp_stages=2)
    jopt = jgpt2.make_optimizer()
    jstep = jgpt2.make_train_step(jcfg, jopt)
    with pytest.raises(ValueError, match="mesh"):
        jstep(jax_params, jopt.init(jax_params), *map(jnp.asarray, batch))
    step = tgpt2.make_train_step(tcfg, tgpt2.make_optimizer())
    params = convert.params_from_numpy(jax_params, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        step(params, tgpt2.make_optimizer().init(params),
             *_torch_batch(batch))


@pytest.mark.parametrize("loss_impl", ["dense", "fused"])
def test_bench_prints_one_json_line(capsys, loss_impl):
    bench.main(["--tiny", "--device", "cpu", "--steps", "1",
                "--loss-impl", loss_impl])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "gpt2_124m_train_mfu_cuda"
    assert res["value"] is None and res["device"] == "cpu"  # no CPU peak
    assert res["loss_impl"] == loss_impl and np.isfinite(res["loss"])
    assert res["batch"] == bench.TINY_BATCH
    assert res["tokens_per_sec_per_chip"] > 0 and len(res["window_s"]) == 3
