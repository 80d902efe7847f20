"""Long-context training with ring attention over the ``seq`` mesh axis:
the port of ``examples/long_context_ring_attention.py``.

Shards a 4k-token sequence across 4 process ranks (context parallelism) on
a ``MeshSpec(data=2, seq=4)`` of 8 ranks: each rank holds S/4 of every
sequence of its half of the batch, attention runs as a ring of K/V shifts
between the ranks with a streaming logsumexp (``ops/ring_attention.py``),
and the train step syncs each gradient over the axes its shards ran on.
The ranks are processes joined over gloo; on the card they share card 0
(NCCL refuses two ranks on one device), and the ring's steps run the ring
kernels on each rank's shard. The reference's 8 heads of 32 become 4 of
64, a head size the kernels take.

Run on the card: ``python3 -m ray_tpu_torch.examples.long_context_ring_attention``;
on the CPU (plain ring steps, fp32): ``... --device cpu``.
"""

from __future__ import annotations

import argparse
import socket
import time
from functools import partial

MESH = {"data": 2, "seq": 4}
CONFIG = dict(vocab_size=2048, n_layer=2, n_head=4, d_model=256,
              seq_len=4096, attn_impl="ring")
BATCH = 4


def _rank(rank: int, world: int, port: int, device: str, steps: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import distributed
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import (MeshSpec, batch_sharding,
                                        create_sharded_state, jit_train_step,
                                        make_mesh)
    from ray_tpu_torch.parallel.mesh import axis_index

    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        dtype = {} if device == "cuda" else {"dtype": torch.float32,
                                             "logits_dtype": torch.float32}
        config = gpt2.GPTConfig(**CONFIG, **dtype)
        spec = MeshSpec(**MESH)
        mesh = make_mesh(spec, device=device)
        opt = gpt2.make_optimizer(learning_rate=1e-3)
        params, opt_state = create_sharded_state(
            partial(gpt2.init_params, config), gpt2.logical_axes(config),
            mesh, 0, opt)
        step = jit_train_step(gpt2.make_train_step(config, opt), mesh=mesh)
        # Every rank draws the same batch and feeds its (B/data, S/seq)
        # block of it.
        rng = np.random.default_rng(0)
        toks = rng.integers(0, config.vocab_size, (BATCH, config.seq_len + 1))
        b, s = BATCH // spec.data, config.seq_len // spec.seq
        d, j = axis_index(mesh, "data"), axis_index(mesh, "seq")
        tokens, targets = (distributed.local_batch_to_global(
            mesh, a[d * b:(d + 1) * b, j * s:(j + 1) * s],
            axis=batch_sharding(mesh).spec)
            for a in (toks[:, :-1], toks[:, 1:]))
        if rank == 0:
            print(f"mesh={spec.axis_sizes()} seq_len={config.seq_len} "
                  f"(per-rank shard: {s}) device={device}", flush=True)
        t0 = time.perf_counter()
        for i in range(steps):
            params, opt_state, loss = step(params, opt_state, tokens,
                                           targets)
            if rank == 0:
                print(f"step {i}: loss={float(loss):.4f} "
                      f"({time.perf_counter() - t0:.1f}s)", flush=True)
        if rank == 0:
            print("ring-attention training step OK", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--steps", type=int, default=2)
    args = p.parse_args(argv)

    import torch.multiprocessing as mp

    from ray_tpu_torch._private.device import resolve_device

    resolve_device(args.device)  # raises without a GPU unless told "cpu"
    world = MESH["data"] * MESH["seq"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(world, port, args.device, args.steps),
             nprocs=world)


if __name__ == "__main__":
    main()
