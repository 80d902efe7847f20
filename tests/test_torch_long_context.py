"""The port's context parallelism across process ranks against the JAX
package's (``tests/test_long_context.py:41-146`` and ``:212``).

JAX runs ring and Ulysses attention under ``shard_map`` on the 8-device CPU
mesh of tests/conftest.py; the port runs them on a mesh whose ``seq`` axis
spans a world of 8 gloo processes (``_torch_mesh``; the rank side is
``_torch_cp_cases``), each rank holding its (B/data, S/seq) shard, K/V
moving between the ranks. Both get the same numpy inputs from a seed. The
fused ring runs the per-rank steps' plain versions here (the kernels are
held to them on the card: tests/test_torch_cuda.py, chip_smoke.py) and is
held, as in the reference's tests, to the reference's dense attention.
Tolerances are tests/test_torch_ring_attention.py's; GPT-2's and Llama's
steps those of tests/test_torch_mesh.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cp_cases as cases
import _torch_mesh_cases as mesh_cases
from _torch_mesh import world
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.ops import ring_attention as jra
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import make_mesh as jmake_mesh
from test_torch_mesh import GPT, _tokens, assert_step_matches
from test_torch_ring_attention import FWD_TOL, GRAD_TOL

SEQ8 = {"seq": 8}
MIXED = {"data": 2, "seq": 4}


def _inputs(seed, B=2, S=64, H=4, D=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(n)]


def _jax_ring(spec, arrays, **kw):
    """The reference's ring or Ulysses (``fn``) on its mesh of ``spec``,
    inputs placed over (batch, seq) as tests/test_long_context.py does."""
    fn = kw.pop("fn", jra.ring_attention)
    mesh = jmake_mesh(JMeshSpec(**spec))
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(("data", "fsdp"), "seq"))
    placed = [jax.device_put(jnp.asarray(a), sh) for a in arrays]
    return np.asarray(jax.jit(lambda q, k, v: fn(q, k, v, mesh=mesh, **kw))(
        *placed))


def _dense_grads(arrays, causal=True):
    def loss(q, k, v):
        return jnp.sum(jra._xla_attention(q, k, v, causal=causal) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, arrays))]


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("spec", [SEQ8, MIXED], ids=["seq8", "data2_seq4"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_the_reference(spec, causal):
    """``test_ring_matches_dense`` and ``test_ring_on_mixed_mesh``: the
    einsum ring (S/W below a splash block) on 8 ranks, every rank holding
    its shard, equals the reference's ring on its mesh."""
    arrays = _inputs(0, B=4 if spec is MIXED else 2)
    out = world(8).run(cases.context_parallel, spec, "ring", arrays, causal)
    want = _jax_ring(spec, arrays, causal=causal)
    b = 4 // spec.get("data", 1) if spec is MIXED else 2
    for rank in out:
        assert rank["local"] == (b, 64 // spec["seq"], 4, 16)
        assert rank["launches"] == {"ring_attention_fwd": 0,
                                    "ring_attention_bwd": 0}
        _close(rank["out"], want, FWD_TOL)


def test_ulysses_matches_the_reference():
    arrays = _inputs(2, H=8)  # heads % world == 0
    out = world(8).run(cases.context_parallel, SEQ8, "ulysses", arrays)
    want = _jax_ring(SEQ8, arrays, fn=jra.ulysses_attention)
    for rank in out:
        _close(rank["out"], want, FWD_TOL)


def test_ulysses_rejects_indivisible_heads():
    """4 heads on an 8-way seq axis: the reference raises, and so does every
    rank of the port."""
    arrays = _inputs(3, H=4)
    with pytest.raises(Exception):
        _jax_ring(SEQ8, arrays, fn=jra.ulysses_attention)
    out = world(8).run(cases.context_parallel, SEQ8, "ulysses", arrays)
    assert all("Ulysses needs heads (4) % seq axis (8)" in r["error"]
               for r in out)


# ----------------------------------------------------------------- backward
@pytest.mark.parametrize("kind,spec", [("ring", SEQ8), ("ulysses", SEQ8),
                                       ("ring", MIXED)],
                         ids=["ring-seq8", "ulysses-seq8", "ring-data2_seq4"])
def test_gradients_match_the_reference(kind, spec):
    """``test_ring_gradients_match_dense`` and
    ``test_ulysses_gradients_match_dense``: the gradients of sum(out ** 2)
    through the process ring (``ppermute``'s inverse shifts) and Ulysses
    (``all_to_all``'s inverse) against the reference's on its mesh."""
    arrays = _inputs(4, H=8 if kind == "ulysses" else 4,
                     B=4 if spec is MIXED else 2)
    fn = jra.ring_attention if kind == "ring" else jra.ulysses_attention
    mesh = jmake_mesh(JMeshSpec(**spec))
    sh = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(("data", "fsdp"), "seq"))

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, mesh=mesh, causal=True) ** 2)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jax.device_put(jnp.asarray(a), sh) for a in arrays))
    out = world(8).run(cases.context_parallel, spec, kind, arrays, True,
                       "auto", True)
    for rank in out:
        for g, w in zip(rank["grads"], want):
            _close(g, np.asarray(w), GRAD_TOL)


# ------------------------------------------------------------ fused ring
# S=1024 over 8 ranks: S_local=128, the smallest legal splash block, so the
# fused path runs (its per-rank steps' plain versions on the CPU).
@pytest.mark.parametrize("causal", [True, False])
def test_fused_ring_matches_dense(causal):
    arrays = _inputs(6, B=1, S=1024, H=2, D=64)
    want = np.asarray(jra._xla_attention(*map(jnp.asarray, arrays),
                                         causal=causal))
    out = world(8).run(cases.context_parallel, SEQ8, "ring", arrays, causal,
                       "fused")
    for rank in out:
        _close(rank["out"], want, FWD_TOL)


def test_fused_ring_gradients_match_dense():
    arrays = _inputs(7, B=1, S=1024, H=2, D=64)
    want = _dense_grads(arrays)
    out = world(8).run(cases.context_parallel, SEQ8, "ring", arrays, True,
                       "auto", True)
    for rank in out:
        for g, w in zip(rank["grads"], want):
            _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_process_ring_equals_the_folded_ring(causal):
    """Each rank's ring steps on its own shard, the chunks and the dk, dv
    accumulators shifted between the ranks, give the folded ring's o, lse,
    dq, dk, dv of that rank's rows: the same blocks, merged and summed in
    the same order. On the card the kernels make them equal bit for bit
    (tests/test_torch_cuda.py); the CPU's plain blocks go through BLAS,
    whose blocking follows the operands' layout, hence 1e-6 here."""
    arrays = _inputs(8, B=1, S=1024, H=2, D=64, n=4)
    out = world(8).run(cases.process_ring_steps, SEQ8, arrays, causal)
    assert all(d <= 1e-6 for rank in out for d in rank), out


# ------------------------------------------------ positions and batches
def test_wpe_positions_are_each_shards_global_ones():
    """GPT-2's position embedding on a seq shard adds the table rows of the
    shard's global positions, ``seq_index * S/W + arange(S/W)``, not rows
    0..S/W-1 (XLA partitions the global arrays in the reference)."""
    cfg = jgpt2.GPTConfig(**GPT, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.init_params(cfg,
                                                        jax.random.key(0)))
    x, _ = _tokens(GPT["vocab_size"], 4, GPT["seq_len"])
    want = params["wte"][x] + params["wpe"][:GPT["seq_len"]]
    out = world(8).run(cases.embed_positions, MIXED, params, x)
    for rank in out:
        np.testing.assert_array_equal(rank, want)


LLAMA = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
             d_ff=128, seq_len=64)


def test_rope_positions_are_each_shards_global_ones():
    """Llama's rotary embedding on a seq shard turns each row by its global
    position: the ring's logits on ``(data=2, seq=4)`` are the reference's
    single-device forward."""
    jcfg = jllama.LlamaConfig(**LLAMA, dtype=jnp.float32,
                              logits_dtype=jnp.float32, attn_impl="xla")
    params = jllama.init_params(jcfg, jax.random.key(0))
    x, _ = _tokens(LLAMA["vocab_size"], 4, LLAMA["seq_len"])
    want = np.asarray(jllama.forward(params, jnp.asarray(x), jcfg))
    tcfg = dict(LLAMA, dtype=torch.float32, logits_dtype=torch.float32,
                attn_impl="ring")
    out = world(8).run(cases.llama_forward, MIXED, tcfg,
                       jax.tree.map(np.asarray, params), x)
    for rank in out:
        _close(rank, want, FWD_TOL * np.abs(want).max())


def test_create_sharded_state_on_a_seq_mesh_over_ranks():
    """A seq-only mesh that spans the ranks holds sharded state like any
    other (every leaf replicated over ``seq``), bit for bit
    ``init_params``."""
    out = world(8).run(mesh_cases.sharded_state, "gpt2", SEQ8, GPT, 3)
    for rank in out:
        assert all(rank["same"]) and all(rank["placed"])


def test_local_batch_to_global_gives_each_rank_its_block():
    """``local_batch_to_global(mesh, block, batch_sharding(mesh).spec)``:
    each rank passes its (B/data, S/seq) block of tokens and the global
    batch is the whole array, sharded over both."""
    tokens = np.arange(4 * 16, dtype=np.int64).reshape(4, 16)
    out = world(8).run(cases.batch_blocks, MIXED, tokens)
    for rank in out:
        assert rank["shape"] == (4, 16)
        assert rank["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
        np.testing.assert_array_equal(rank["full"], tokens)


# ------------------------------------------------------- the model steps
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt2_context_parallel_step_matches_reference(impl):
    """``test_gpt2_context_parallel_train_step`` on ``(data=2, seq=4)``:
    the port's loss, every synced gradient and one AdamW update against
    the reference's step with the same attention on its mesh (rank 0's
    gradients before the sync must fail the gate)."""
    jcfg = jgpt2.GPTConfig(**GPT, dtype=jnp.float32, attn_impl=impl,
                           logits_dtype=jnp.float32, remat=False)
    tcfg = dict(GPT, dtype=torch.float32, attn_impl=impl, remat=False,
                logits_dtype=torch.float32)
    params = jgpt2.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(GPT["vocab_size"], 4, GPT["seq_len"])
    assert_step_matches("gpt2", tcfg, jgpt2, jcfg, params, jnp.asarray(x),
                        jnp.asarray(y), MIXED,
                        jgpt2.make_optimizer(1e-3, mu_dtype=jnp.float32),
                        {"learning_rate": 1e-3, "mu_dtype": torch.float32},
                        ambient=True)


def test_llama_ring_step_matches_reference():
    """Llama's train step with the ring on ``(data=2, seq=4)``, where RoPE's
    positions count, against the reference's on its mesh."""
    jcfg = jllama.LlamaConfig(**LLAMA, dtype=jnp.float32,
                              logits_dtype=jnp.float32, attn_impl="ring")
    tcfg = dict(LLAMA, dtype=torch.float32, logits_dtype=torch.float32,
                attn_impl="ring")
    params = jllama.init_params(jcfg, jax.random.key(0))
    x, y = _tokens(LLAMA["vocab_size"], 4, LLAMA["seq_len"])
    assert_step_matches("llama", tcfg, jllama, jcfg, params, jnp.asarray(x),
                        jnp.asarray(y), MIXED, jllama.make_optimizer(1e-3),
                        {"learning_rate": 1e-3}, ambient=True)

