"""Pipeline-parallel inference over a compiled DAG of process actors: the
port of ``examples/pp_inference_dag.py``.

Two worker processes each hold half of GPT-2's layers (``GPT2Stage``); a
compiled DAG streams requests through stage A -> stage B over shared-memory
edges, overlapping the stages across consecutive requests (ref:
python/ray/dag/compiled_dag_node.py:711,
experimental/channel/shared_memory_channel.py). On the GPU each stage takes
half a card (``num_gpus=0.5``) and the hidden state crosses as a host copy
that lands on stage B's card.

Run: python -m ray_tpu_torch.examples.pp_inference_dag
     (GPT-2 124M, both stages on the GPU)
     python -m ray_tpu_torch.examples.pp_inference_dag --device cpu --tiny
     (the reference example's 4-layer model, on the CPU)

``--nodes`` (the stages on two worker nodes, over the object plane) needs
real nodes, which are not ported yet (ROADMAP.md, Queue 1 item 13.8b), and
raises. Each stage builds its weights from ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.serve.gpt2 import GPT2Stage

# The reference example's model (examples/pp_inference_dag.py:CFG).
TINY = dict(vocab_size=512, n_layer=4, n_head=4, d_model=128, seq_len=32,
            dtype=torch.float32)


class StageA(GPT2Stage):
    """The embeddings and the first half of the blocks."""

    def forward(self, tokens):
        return self.head(tokens), os.getpid()


class StageB(GPT2Stage):
    """The second half of the blocks, the final norm and the head's
    greedy token."""

    def forward(self, payload):
        hidden, stage_a_pid = payload
        return {"next_token": self.next_token(hidden),
                "stage_pids": (stage_a_pid, os.getpid())}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--tiny", action="store_true",
                        help="the reference example's 4-layer model instead "
                             "of GPT-2 124M")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--requests", type=int, default=16)
    parser.add_argument("--nodes", action="store_true",
                        help="stages on two worker nodes (not ported)")
    args = parser.parse_args(argv)
    if args.nodes:
        raise NotImplementedError(
            "--nodes needs real worker nodes and the object plane's remote "
            "channels, which are not ported yet (ROADMAP.md, Queue 1 item "
            "13.8b)")

    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models import gpt2

    config = gpt2.GPTConfig(**TINY) if args.tiny else gpt2.GPTConfig()
    device = args.device or "cuda"
    gpus = 0.5 if device == "cuda" else 0
    half = config.n_layer // 2
    ray_tpu_torch.init(ignore_reinit_error=True)
    try:
        opts = {"isolation": "process", "num_gpus": gpus}
        # Both spawns start at once: each stage's construction waits on its
        # own worker.
        a = ray_tpu_torch.remote(StageA).options(**opts).remote(
            (0, half), config, seed=args.seed, device=device)
        b = ray_tpu_torch.remote(StageB).options(**opts).remote(
            (half, config.n_layer), config, seed=args.seed, device=device)
        with InputNode() as inp:
            out = b.forward.bind(a.forward.bind(inp))
        dag = out.experimental_compile()
        rng = np.random.default_rng(args.seed)
        shape = (1, config.seq_len)
        try:
            first = dag.execute(
                rng.integers(0, config.vocab_size, shape)).get(timeout=300)
            pa, pb = first["stage_pids"]
            if pa == pb or os.getpid() in (pa, pb):
                raise RuntimeError("the stages must run in two processes of "
                                   "their own")
            print(f"stages in pids {pa} and {pb} (driver {os.getpid()})")
            n = args.requests
            t0 = time.perf_counter()
            refs = [dag.execute(rng.integers(0, config.vocab_size, shape))
                    for _ in range(min(8, n))]
            outs = [r.get(timeout=120) for r in refs]
            for _ in range(n - len(outs)):
                outs.append(dag.execute(rng.integers(
                    0, config.vocab_size, shape)).get(timeout=120))
            dt = time.perf_counter() - t0
        finally:
            dag.teardown()
        if not all(0 <= o["next_token"] < config.vocab_size for o in outs):
            raise RuntimeError(f"an answer without a token: {outs}")
        print(f"{n} pipelined requests in {dt:.2f}s "
              f"({n / dt:.1f} req/s through 2 process stages)")
    finally:
        ray_tpu_torch.shutdown()
    print("pp_inference_dag OK")
    return {"stage_pids": (pa, pb),
            "next_tokens": [first["next_token"]]
            + [o["next_token"] for o in outs]}


if __name__ == "__main__":
    main()
