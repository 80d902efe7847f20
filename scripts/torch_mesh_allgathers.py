"""Where the all-gathers of one GPT-2 train step on an fsdp x tensor mesh
come from, on the CPU.

Four gloo processes build ``MeshSpec(fsdp=2, tensor=2)``, the sharded
state of ``GPTConfig.tiny()`` and a batch of 8, and take one
``make_train_step`` step under DTensor's ``CommDebugMode``. Every call of
the functional all-gather (what DTensor's Shard -> Replicate runs) is
traced to the innermost frame of the port that led to it: one of the
port's own redistributions (``parallel.mesh.gather``, the tables that
``_embed`` and ``sharded_mean`` gather under ``shard_map``), an operator
whose sharding DTensor propagates, or the backward pass. Rank 0 prints
one JSON line: the collective counts by kind and the all-gathers by
origin.

    python3 scripts/torch_mesh_allgathers.py
"""

import json
import os
import socket
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "ray_tpu_torch") + os.sep
# The port's functions that redistribute on purpose (the rest is DTensor's
# own propagation through an operator).
OWN = {"gather": "parallel.mesh.gather", "_embed": "gpt2._embed",
       "sharded_mean": "gpt2.sharded_mean"}


def _origin(stack) -> str:
    frames = [f for f in stack if f.filename.startswith(PORT_DIR)]
    for f in reversed(frames):
        if f.name in OWN or (f.name == "one" and f.filename.endswith(
                os.path.join("parallel", "mesh.py"))):
            return "port: " + OWN.get(f.name, OWN["gather"])
    inner = frames[-1] if frames else None
    if inner is None or inner.name == "step":
        return "DTensor: backward"
    rel = os.path.relpath(inner.filename, ROOT)
    return f"DTensor: {rel}:{inner.name} ({(inner.line or '').strip()})"


def rank_main(rank: int, port: int, world: int) -> None:
    sys.path.insert(0, ROOT)
    from functools import partial

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.collective import distributed
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import (MeshSpec, create_sharded_state,
                                        make_mesh)

    origins = {}
    for name in ("all_gather_single", "all_gather_tensor"):
        orig = getattr(funcol, name, None)
        if orig is None:
            continue

        def traced(*args, _orig=orig, **kwargs):
            where = _origin(traceback.extract_stack()[:-1])
            origins[where] = origins.get(where, 0) + 1
            return _orig(*args, **kwargs)

        setattr(funcol, name, traced)

    cfg = gpt2.GPTConfig.tiny()
    mesh = make_mesh(MeshSpec(fsdp=2, tensor=2), device="cpu")
    opt = gpt2.make_optimizer(1e-3)
    params, state = create_sharded_state(
        partial(gpt2.init_params, cfg), gpt2.logical_axes(cfg), mesh, 0, opt)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, cfg.seq_len + 1)))
    fsdp_rank = mesh.device_mesh.get_local_rank("fsdp")
    mine = tokens[4 * fsdp_rank:4 * (fsdp_rank + 1)]
    x = distributed.local_batch_to_global(mesh, mine[:, :-1].contiguous())
    y = distributed.local_batch_to_global(mesh, mine[:, 1:].contiguous())
    step = gpt2.make_train_step(cfg, opt)
    with CommDebugMode() as comm:
        _, _, loss = step(params, state, x, y)
    if rank == 0:
        print(json.dumps({
            "config": "GPTConfig.tiny()", "mesh": {"fsdp": 2, "tensor": 2},
            "torch": torch.__version__, "loss": float(loss),
            "collectives": {str(k): v
                            for k, v in comm.get_comm_counts().items()},
            "all_gathers_by_origin": dict(sorted(origins.items()))},
            indent=1), flush=True)
    dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(port, 4), nprocs=4)


if __name__ == "__main__":
    main()
