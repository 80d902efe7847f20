"""The port's context parallelism (ray_tpu_torch.ops.ring_attention,
ray_tpu_torch.parallel) against the JAX package's.

JAX runs ring and Ulysses attention under shard_map on the virtual 8-device
CPU mesh (tests/conftest.py); the port folds the seq axis onto one device.
Both sides get the same numpy inputs from a seed. The fused ring runs JAX's
splash kernels in interpret mode and the port's plain step versions, so what
is compared is the function and the gradient each ring kernel computes; the
kernels themselves are held to the plain versions on the GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu._private.jax_compat import set_mesh
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops import ring_attention as jra
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from ray_tpu_torch import optim
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.ops import attention
from ray_tpu_torch.ops import ring_attention as ra
from ray_tpu_torch.parallel import (MeshSpec, current_mesh, jit_train_step,
                                    make_mesh, use_mesh)

# fp32 on both sides, sums in other orders (tests/test_long_context.py's).
FWD_TOL = 2e-5
GRAD_TOL = 5e-4
# GPT-2 loss and gradients: tests/test_torch_train_gpt2.py:29-30.
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


def _inputs(seed, B=2, S=64, H=4, D=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def jmesh8():
    return jmake_mesh(JMeshSpec(seq=8))


def _jax_ring(mesh, arrays, **kw):
    return np.asarray(jax.jit(lambda q, k, v: jra.ring_attention(
        q, k, v, mesh=mesh, **kw))(*map(jnp.asarray, arrays)))


def _port(fn, arrays, world, **kw):
    with use_mesh(MeshSpec(seq=world)):
        return fn(*(torch.from_numpy(a) for a in arrays), **kw)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("causal", [True, False])
def test_einsum_body_matches_jax(jmesh8, causal):
    arrays = _inputs(0)
    want = _jax_ring(jmesh8, arrays, causal=causal, impl="einsum")
    got = _port(ra.ring_attention, arrays, 8, causal=causal, impl="einsum")
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


@pytest.fixture(scope="module")
def fused_inputs():
    """S=1024 over 8 ranks: S_local=128, the smallest legal splash block, so
    both sides run the fused body (JAX's in interpret mode)."""
    return _inputs(1, B=1, S=1024, H=2, D=64, n=4)


@pytest.mark.parametrize("causal", [True, False])
def test_fused_body_matches_jax(jmesh8, fused_inputs, causal):
    arrays = fused_inputs[:3]
    want = _jax_ring(jmesh8, arrays, causal=causal, impl="fused")
    with use_mesh(MeshSpec(seq=8)):
        q, k, v = (torch.from_numpy(a) for a in arrays)
        got = ra.ring_attention(q, k, v, causal=causal, impl="fused")
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_fused_gradients_match_jax(jmesh8, fused_inputs):
    q, k, v, do = fused_inputs
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jra.ring_attention(
        q, k, v, mesh=jmesh8, causal=True, impl="fused") * do),
        argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with use_mesh(MeshSpec(seq=8)):
        out = ra.ring_attention(qt, kt, vt, causal=True, impl="fused")
    assert type(out.grad_fn).__name__ == "FusedRingBackward"
    out.backward(torch.from_numpy(do))
    for got, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


def test_einsum_gradients_match_jax(jmesh8):
    q, k, v, do = _inputs(2, n=4)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jra.ring_attention(
        q, k, v, mesh=jmesh8, causal=True, impl="einsum") * do),
        argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with use_mesh(MeshSpec(seq=8)):
        ra.ring_attention(qt, kt, vt, impl="einsum").backward(
            torch.from_numpy(do))
    for got, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


# ------------------------------------------------------------------ Ulysses
def test_ulysses_matches_jax(jmesh8):
    arrays = _inputs(3, H=8)  # heads % world == 0
    want = np.asarray(jax.jit(lambda q, k, v: jra.ulysses_attention(
        q, k, v, mesh=jmesh8))(*map(jnp.asarray, arrays)))
    got = _port(ra.ulysses_attention, arrays, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_ulysses_attn_fn_sees_the_head_shards():
    """attn_fn gets each rank's (full sequence, H/W heads) block, the W ranks
    folded into the batch."""
    seen = []

    def attn_fn(q, k, v):
        seen.append(tuple(q.shape))
        return ra._xla_attention(q, k, v)

    arrays = _inputs(4, H=8)
    got = _port(ra.ulysses_attention, arrays, 4, attn_fn=attn_fn)
    assert seen == [(4 * 2, 64, 2, 16)]
    want = attention.attention_reference(
        *(torch.from_numpy(a) for a in arrays))[0]
    torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_ulysses_rejects_indivisible_heads():
    with pytest.raises(ValueError, match="heads"):
        _port(ra.ulysses_attention, _inputs(5, H=4), 8)


# ----------------------------------------------------------------- routing
def test_ring_block_matches_jax():
    for n in range(0, 2100):
        assert ra._ring_block(n) == jra._ring_block(n), n


@pytest.mark.parametrize("S,fused", [(1024, True), (64, False)])
def test_auto_picks_the_body_jax_picks(monkeypatch, S, fused):
    """impl='auto' routes S_local=128 to the fused body (FusedRing) and
    S_local=8 to the einsum body, as ray_tpu/ops/ring_attention.py:371-376."""
    calls = []
    real = ra.FusedRing.apply
    monkeypatch.setattr(ra.FusedRing, "apply",
                        lambda *a: calls.append(1) or real(*a))
    arrays = _inputs(6, B=1, S=S, H=2)
    got = _port(ra.ring_attention, arrays, 8)
    assert bool(calls) == fused
    want = attention.attention_reference(
        *(torch.from_numpy(a) for a in arrays))[0]
    torch.testing.assert_close(got, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_fused_needs_a_legal_block():
    with pytest.raises(ValueError, match="einsum"):
        _port(ra.ring_attention, _inputs(7), 8, impl="fused")


def test_the_rotation():
    """At step s rank r holds chunk (r - s) mod W; under the causal mask only
    the ranks r >= s compute, and step 0 is every rank's own chunk."""
    assert [ra.ring_source(1, r, 4) for r in range(4)] == [3, 0, 1, 2]
    assert ra.ring_pairs(0, 4, True) == [(0, 0), (1, 1), (2, 2), (3, 3)]
    assert ra.ring_pairs(1, 4, True) == [(1, 0), (2, 1), (3, 2)]
    assert ra.ring_pairs(3, 4, True) == [(3, 0)]
    assert ra.ring_pairs(1, 4, False) == [(0, 3), (1, 0), (2, 1), (3, 2)]
    # W(W+1)/2 causal rank-steps, W*W full.
    assert sum(len(ra.ring_pairs(s, 4, True)) for s in range(4)) == 10
    for s in range(4):  # no two pairs of a step share a rank or a chunk
        for causal in (True, False):
            ranks, chunks = zip(*ra.ring_pairs(s, 4, causal))
            assert len(set(ranks)) == len(ranks) == len(set(chunks))


# ----------------------------------------------------------- plain versions
@pytest.mark.parametrize("causal", [True, False])
def test_step_plain_versions_give_dense_attention(causal):
    """W steps of ring_fwd_step_reference and ring_bwd_step_reference
    (through ring_forward, ring_backward) give dense attention's o, lse and
    gradients; the first step from o = 0, lse = -1e30 gives exactly its
    block's own (o, lse)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(8, S=96, n=4))
    o_ref, lse_ref = attention.attention_reference(q, k, v, causal=causal)
    o, lse = ra.ring_forward(q, k, v, world=4, causal=causal, plain=True)
    torch.testing.assert_close(o, o_ref, atol=FWD_TOL, rtol=FWD_TOL)
    torch.testing.assert_close(lse, lse_ref, atol=FWD_TOL, rtol=FWD_TOL)
    grads = ra.ring_backward(q, k, v, o, lse, do, world=4, causal=causal,
                             plain=True)
    refs = attention.attention_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                             causal=causal)
    for g, r in zip(grads, refs):
        torch.testing.assert_close(g, r, atol=GRAD_TOL, rtol=GRAD_TOL)

    o0 = torch.zeros((2, 24, 4, 16))
    lse0 = torch.full((2, 4, 24), ra._NEG)
    blk = attention.attention_reference(q[:, :24], k[:, 24:48], v[:, 24:48],
                                        causal=causal)
    o1, lse1 = ra.ring_fwd_step_reference(q[:, :24], k[:, 24:48],
                                          v[:, 24:48], o0, lse0, causal)
    assert torch.equal(o1, blk[0]) and torch.equal(lse1, blk[1])


@pytest.mark.parametrize("causal", [True, False])
def test_first_step_reads_no_accumulator(causal):
    """Step 0 (every rank's own chunk) writes o, lse, dq, dk and dv and reads
    none of them: from NaN-filled accumulators the plain steps give exactly
    what they give from o = 0, lse = -1e30 and zero gradients, and that is
    what merging into o = 0, lse = -1e30 (and adding into zeros) gives."""
    W, shard = 4, 8
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(11, S=W * shard, n=4))
    o_ref, lse_ref = ra.ring_forward(q, k, v, world=W, causal=causal,
                                     plain=True)
    delta = ra.ring_delta(o_ref, do)
    runs = {}
    for fill in ("nan", "zero"):
        nan = fill == "nan"
        o = torch.full(q.shape, float("nan") if nan else 0.0)
        lse = torch.full((2, 4, W * shard), float("nan") if nan else ra._NEG)
        grads = [torch.full(q.shape, float("nan") if nan else 0.0)
                 for _ in range(3)]
        ra.ring_fwd_step_plain(q, k, v, o, lse, step=0, world=W,
                               causal=causal)
        ra.ring_bwd_step_plain(q, k, v, do, lse_ref, delta, *grads, step=0,
                               world=W, causal=causal)
        runs[fill] = (o, lse, *grads)
    for a, b in zip(runs["nan"], runs["zero"]):
        assert torch.isfinite(a).all() and torch.equal(a, b)
    o, lse, dq, dk, dv = runs["nan"]
    for r in range(W):
        rs = slice(r * shard, (r + 1) * shard)
        zero = torch.zeros((2, shard, 4, 16))
        o1, lse1 = ra.ring_fwd_step_reference(
            q[:, rs], k[:, rs], v[:, rs], zero, torch.full((2, 4, shard),
                                                           ra._NEG), causal)
        assert torch.equal(o[:, rs], o1) and torch.equal(lse[:, :, rs], lse1)
        g1 = ra.ring_bwd_step_reference(
            q[:, rs], k[:, rs], v[:, rs], None, lse_ref[:, :, rs], do[:, rs],
            delta[:, :, rs], zero, zero, zero, causal)
        for got, want in zip((dq, dk, dv), g1):
            assert torch.equal(got[:, rs], want)


def test_step_wrappers_update_in_place_on_cpu():
    """ring_fwd_step (the kernel wrapper) runs the plain step on CPU
    tensors: step 1 of a causal ring of 4 touches ranks 1-3 only."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, S=32))
    o = torch.zeros((2, 32, 4, 16))
    lse = torch.full((2, 4, 32), ra._NEG)
    ra.ring_fwd_step(q, k, v, o, lse, step=1, world=4, causal=True)
    assert torch.all(o[:, :8] == 0) and torch.all(lse[:, :, :8] == ra._NEG)
    o1, lse1 = ra.ring_fwd_step_reference(
        q[:, 8:16], k[:, :8], v[:, :8], torch.zeros((2, 8, 4, 16)),
        torch.full((2, 4, 8), ra._NEG), False)
    assert torch.equal(o[:, 8:16], o1) and torch.equal(lse[:, :, 8:16], lse1)


def test_cpu_ring_launches_no_kernel():
    ra.reset_launches()
    q, k, v, do = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(10, B=1, S=256, H=2, n=4))
    out = ra.FusedRing.apply(q, k, v, 2, True, 0.25)
    out.backward(do.detach())
    assert ra.LAUNCHES == {"ring_attention_fwd": 0, "ring_attention_bwd": 0}


@pytest.mark.parametrize("kw,err", [
    (dict(dtype=torch.float32), TypeError),
    (dict(hd=32), ValueError),
    (dict(o_dtype=torch.bfloat16), ValueError),
    (dict(S=30), ValueError),
    (dict(step=4), ValueError)])
def test_kernel_wrappers_refuse_before_launch(kw, err):
    """What the ring kernels do not take raises in the wrapper, before any
    build or launch."""
    hd, dt, S = kw.get("hd", 64), kw.get("dtype", torch.bfloat16), kw.get("S", 32)
    x = torch.zeros((1, S, 2, hd), dtype=dt)
    o = torch.zeros((1, S, 2, hd), dtype=kw.get("o_dtype", torch.float32))
    lse = torch.zeros((1, 2, S))
    with pytest.raises(err):
        ra._ring_fwd_cuda(x, x, x, o, lse, kw.get("step", 0), 4, True, 0.125)
    with pytest.raises(err):
        ra._ring_bwd_cuda(x, x, x, x, lse, lse, o, o, o, kw.get("step", 0), 4,
                          True, 0.125)


# --------------------------------------------------------------------- mesh
@pytest.mark.parametrize("axis", ["data", "fsdp", "tensor", "pipe", "expert"])
def test_make_mesh_rejects_other_axes_above_one(axis):
    """In one process the seq axis folds onto the device alone. Beside
    another axis above 1 it spans the process group like any other mesh
    (tests/test_torch_long_context.py runs it over gloo ranks), so here,
    in a process that joined no group, it is refused as a mesh larger than
    the group, as is that axis alone (pipe included)."""
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(MeshSpec(seq=2, **{axis: 2}))
    with pytest.raises(ValueError, match="process group has 1"):
        make_mesh(MeshSpec(**{axis: 2}))
    assert make_mesh(MeshSpec(seq=4, **{axis: 1})).shape["seq"] == 4


def test_mesh_spec_is_the_jax_packages():
    from ray_tpu.parallel.mesh import AXIS_NAMES as JAXIS_NAMES

    assert make_mesh(MeshSpec(seq=8)).axis_names == JAXIS_NAMES
    for n in (8, 16):
        assert dataclasses.asdict(MeshSpec.auto(n, seq=4)) == \
            dataclasses.asdict(JMeshSpec.auto(n, seq=4))
    assert MeshSpec(seq=4, data=2).size == 8
    with pytest.raises(ValueError):
        MeshSpec.auto(6, seq=4)


def test_use_mesh_nests_and_restores():
    assert current_mesh() is None
    with use_mesh(MeshSpec(seq=2)) as outer:
        with use_mesh(MeshSpec(seq=4)):
            assert current_mesh().shape["seq"] == 4
        assert current_mesh() is outer
    assert current_mesh() is None


def test_attention_needs_a_mesh_and_a_divisible_sequence():
    q, k, v = (torch.from_numpy(a) for a in _inputs(11))
    with pytest.raises(ValueError, match="mesh"):
        ra.ring_attention(q, k, v)
    with pytest.raises(ValueError, match="mesh"):
        ra.ulysses_attention(q, k, v)
    with pytest.raises(ValueError, match="divisible"):
        ra.ring_attention(q, k, v, mesh=MeshSpec(seq=5))
    got = ra.ring_attention(q, k, v, mesh=MeshSpec(seq=4))  # explicit mesh
    torch.testing.assert_close(got, attention.attention_reference(q, k, v)[0],
                               atol=FWD_TOL, rtol=FWD_TOL)


# ------------------------------------------------------------------- GPT-2
def _gpt_configs(seq_len, attn_impl, **kw):
    common = dict(vocab_size=512, n_layer=2, n_head=4, d_model=128,
                  seq_len=seq_len, attn_impl=attn_impl, remat=False, **kw)
    return (jgpt2.GPTConfig(dtype=jnp.float32, logits_dtype=jnp.float32,
                            **common),
            tgpt2.GPTConfig(dtype=torch.float32, logits_dtype=torch.float32,
                            **common))


def _gpt_batch(seq_len):
    rng = np.random.default_rng(seq_len)
    toks = rng.integers(0, 512, (2, seq_len + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _port_loss_and_grads(jax_params, batch, tcfg, world):
    params = convert.params_from_numpy(jax_params, device="cpu")
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = [torch.as_tensor(a, dtype=torch.long) for a in batch]
    with use_mesh(MeshSpec(seq=world)):
        loss = tgpt2.loss_fn(params, *toks, tcfg)
        grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _leaves_with_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_names(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("impl,seq_len,world", [
    ("ring", 256, 2),      # S_local 128: the fused body on both sides
    ("ring", 64, 4),       # S_local 16: the einsum body
    ("ulysses", 64, 4)])
def test_gpt2_loss_and_every_gradient_match_jax(impl, seq_len, world):
    jcfg, tcfg = _gpt_configs(seq_len, impl)
    jax_params = jax.tree.map(np.asarray,
                              jgpt2.init_params(jcfg, jax.random.key(0)))
    batch = _gpt_batch(seq_len)
    with set_mesh(jmake_mesh(JMeshSpec(seq=world))):
        want_loss, want = jax.jit(jax.value_and_grad(
            lambda p, t, y: jgpt2.loss_fn(p, t, y, jcfg)))(
                jax_params, *map(jnp.asarray, batch))
    loss, grads = _port_loss_and_grads(jax_params, batch, tcfg, world)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    for (name, w), g in zip(_leaves_with_names(want), grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("impl,seq_len", [("ring", 256), ("ulysses", 64)])
def test_gpt2_context_parallel_train_step_equals_xla(impl, seq_len):
    """Mirrors tests/test_long_context.py:212-243 in one process: a train
    step through jit_train_step(mesh=MeshSpec(seq=2)) gives the loss of the
    same step with plain attention, and updates the parameters."""
    losses, moved = {}, {}
    for attn in ("xla", impl):
        _, tcfg = _gpt_configs(seq_len, attn)
        params = tgpt2.init_params(tcfg, seed=0, device="cpu")
        before = params["blocks"]["qkv_w"].clone()
        optimizer = tgpt2.make_optimizer(1e-3)
        step = jit_train_step(tgpt2.make_train_step(tcfg, optimizer),
                              mesh=MeshSpec(seq=2))
        toks = [torch.as_tensor(a, dtype=torch.long)
                for a in _gpt_batch(seq_len)]
        params, _, loss = step(params, optimizer.init(params), *toks)
        losses[attn] = float(loss)
        moved[attn] = not torch.equal(params["blocks"]["qkv_w"], before)
    assert current_mesh() is None
    assert abs(losses[impl] - losses["xla"]) < 1e-5, losses
    assert all(moved.values())


@pytest.mark.parametrize("policy", ["attn_outside", "full", "save_attn_mlp"])
def test_ring_under_every_remat_schedule(policy):
    """Remat changes what is kept and what reruns, never the numbers:
    FusedRing keeps its own residuals between the checkpointed halves, and
    "full" reruns it inside the backward, which still sees the mesh."""
    jcfg, base = _gpt_configs(256, "ring")
    tcfg = dataclasses.replace(base, remat=True, remat_policy=policy)
    jax_params = jax.tree.map(np.asarray,
                              jgpt2.init_params(jcfg, jax.random.key(1)))
    batch = _gpt_batch(256)
    ref_loss, ref = _port_loss_and_grads(jax_params, batch, base, 2)
    loss, grads = _port_loss_and_grads(jax_params, batch, tcfg, 2)
    assert loss == ref_loss
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_jit_train_step_without_a_mesh_is_the_step():
    def step(*a):
        return a

    assert jit_train_step(step) is step
    # The mesh is validated at wrap time: a data axis spans the process
    # group, which is one process here.
    with pytest.raises(ValueError, match="process group has 1"):
        jit_train_step(step, mesh=MeshSpec(data=2))
