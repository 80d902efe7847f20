"""Which collectives gloo runs on CUDA tensors, for process ranks that share
one card (NCCL refuses two ranks on one device).

Each case runs in fresh processes (4 gloo ranks on ``cuda:0``), so a case
that kills its ranks only fails itself. A case is a c10d collective on the
world group or on 2-rank subgroups, a point-to-point send and recv, a
functional collective (what DTensor calls), or a DTensor redistribution on
a "cuda" device mesh. One JSON line per case: its return code, rank 0's
result and any error the ranks wrote.

    python3 scripts/torch_gloo_cuda_probe.py
"""

import json
import os
import subprocess
import sys
import time

WORLD = 4
N = 9_656_832  # the largest of GPT-2 124M's per-layer gathers, in floats
RING_N = 8 * 512 * 12 * 64
CASES = [
    ("all_reduce", "world", 8), ("all_reduce", "sub", N),
    ("broadcast", "world", 8),
    ("all_gather_into_tensor", "world", N), ("all_gather_into_tensor", "sub",
                                             N),
    ("reduce_scatter_tensor", "world", 8), ("reduce_scatter_tensor", "sub",
                                            2 * N),
    ("all_to_all_single", "world", 8), ("send_recv", "world", 8),
    ("funcol_all_reduce", "world", 8), ("funcol_all_gather", "world", 8),
    ("funcol_reduce_scatter", "world", 8),
    ("dtensor_1d_shard_to_replicate", "world", 8),
    ("dtensor_2d_shard_to_replicate", "world", 8),
    ("dtensor_2d_partial_to_shard", "world", 8),
    ("dtensor_2d_partial_to_replicate", "world", 8),
    # K or V of one (8, 512, 12, 64) sequence shard, in floats.
    ("host_staged_ring", "world", RING_N), ("host_staged_ring", "sub", RING_N),
    ("all_to_all_single_uneven", "world", 10),
    ("all_to_all_single_uneven", "sub", 10),
]


def rank_main(rank, port, op, grp, n):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    g = None
    if grp == "sub":
        groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        g = groups[rank // 2]
    size = dist.get_world_size(g)
    x = torch.full((n,), float(rank + 1), device="cuda")
    t0 = time.time()
    if op == "all_reduce":
        dist.all_reduce(x, group=g)
        out = x
    elif op == "broadcast":
        dist.broadcast(x, 0, group=g)
        out = x
    elif op == "all_gather_into_tensor":
        out = torch.empty(n * size, device="cuda")
        dist.all_gather_into_tensor(out, x, group=g)
    elif op == "reduce_scatter_tensor":
        out = torch.empty(n // size, device="cuda")
        dist.reduce_scatter_tensor(out, x, group=g)
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=g)
    elif op == "host_staged_ring":
        # What parallel's ppermute does over gloo: the CUDA tensor copied to
        # the host, one batch of isend/irecv to the next rank of the group,
        # the received copy back onto the card.
        ranks = list(range(WORLD)) if g is None else \
            dist.get_process_group_ranks(g)
        i = ranks.index(rank)
        host = x.cpu()
        got = torch.empty_like(host)
        ops = [dist.P2POp(dist.isend, host, ranks[(i + 1) % size], g),
               dist.P2POp(dist.irecv, got, ranks[(i - 1) % size], g)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        out = got.to("cuda")
    elif op == "all_to_all_single_uneven":
        # Rank r sends j + 1 values to rank j and gets r + 1 from each.
        me = dist.get_rank(g)
        send = [j + 1 for j in range(size)]
        x = torch.cat([torch.full((j + 1,), float(10 * rank + j),
                                  device="cuda") for j in range(size)])
        out = torch.empty(size * (me + 1), device="cuda")
        dist.all_to_all_single(out, x, output_split_sizes=[me + 1] * size,
                               input_split_sizes=send, group=g)
    elif op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        elif rank == 1:
            dist.recv(x, 0)
        out = x
    elif op.startswith("funcol"):
        import torch.distributed._functional_collectives as funcol

        world = dist.group.WORLD
        out = {"funcol_all_reduce": lambda: funcol.all_reduce(x, "sum", world),
               "funcol_all_gather": lambda: funcol.all_gather_tensor(
                   x, 0, world),
               "funcol_reduce_scatter": lambda: funcol.reduce_scatter_tensor(
                   x, "sum", 0, world)}[op]()
        out = out.wait() if hasattr(out, "wait") else out
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        if op.startswith("dtensor_1d"):
            m = init_device_mesh("cuda", (WORLD,), mesh_dim_names=("a",))
            out = DTensor.from_local(x, m, [Shard(0)]).redistribute(
                m, [Replicate()]).to_local()
        else:
            m = init_device_mesh("cuda", (2, 2), mesh_dim_names=("a", "b"))
            src, dst = {
                "dtensor_2d_shard_to_replicate": ([Shard(0)] * 2,
                                                  [Replicate()] * 2),
                "dtensor_2d_partial_to_shard": ([Partial()] * 2,
                                                [Shard(0)] * 2),
                "dtensor_2d_partial_to_replicate": ([Partial()] * 2,
                                                    [Replicate()] * 2)}[op]
            out = DTensor.from_local(x, m, src).redistribute(m, dst)\
                .to_local()
        out = out.wait() if hasattr(out, "wait") else out
    torch.cuda.synchronize()
    line = json.dumps({"rank": rank, "ms": (time.time() - t0) * 1e3,
                       "head": out[:2].tolist(), "numel": out.numel(),
                       "values": out.tolist() if out.numel() <= 16
                       else None})
    os.write(1, (line + "\n").encode())  # one write: ranks never interleave
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    import torch

    print(out.stdout.strip(), torch.__version__, flush=True)
    for i, (op, grp, n) in enumerate(CASES):
        try:
            r = subprocess.run([sys.executable, __file__, op, grp, str(n),
                                str(29800 + i)], capture_output=True,
                               text=True, timeout=120)
            ranks = [json.loads(line) for line in r.stdout.splitlines()
                     if line.startswith('{"rank": 0,')]
            err = [line.strip() for line in r.stderr.splitlines()
                   if "what()" in line or "Segmentation" in line
                   or "Error" in line][:3]
            print(json.dumps({"op": op, "group": grp, "n": n,
                              "rc": r.returncode, "rank0": ranks[:1],
                              "err": err}), flush=True)
        except subprocess.TimeoutExpired:
            print(json.dumps({"op": op, "group": grp, "n": n,
                              "timeout_s": 120}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        import torch.multiprocessing as mp

        op, grp, n, port = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
            int(sys.argv[4])
        mp.spawn(rank_main, args=(port, op, grp, n), nprocs=WORLD)
    else:
        main()
