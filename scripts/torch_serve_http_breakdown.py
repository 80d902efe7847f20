#!/usr/bin/env python3
"""Where a request's time goes on the port's HTTP serving path.

    python3 scripts/torch_serve_http_breakdown.py [--device cuda|cpu]
        [--requests 20] [--switch-interval SECONDS]

Serves GPT-2 124M (``GPTConfig()``, weights from seed 0; ``--device cpu``
serves a 2-layer model instead) through ``serve.run`` and the HTTP proxy
with tracing on, and splits each request by its spans
(``ray_tpu_torch/util/tracing.py``), all on the host clock:

- unary (``POST /gpt2``, 100 tokens): ``client`` (urllib, start to answer),
  ``proxy_in`` (HTTP span start to route span start: parse, executor hop,
  handle), ``route`` (replica pick and actor submit), ``to_replica``
  (route end to the replica's task span: mailbox, event loop),
  ``replica`` (the task span: the forward), ``back`` (task end to HTTP
  span end: result, the waiting thread, executor hop back), and
  ``outside`` (client minus the HTTP span: socket and urllib);
- streamed (``GET /gpt2stream``, 64-token prompt, 16 tokens): per pull,
  ``pull`` (the replica's ``next_stream`` task span: one forward) and
  ``between`` (one pull's end to the next's start: the item's way back to
  the proxy, the chunk written, the next pull's way in);
- the same two for an empty replica (no model: the control plane alone).

One JSON line each, medians over ``--requests``; the card's name and power
limit first. Tracing itself costs a few spans' worth of Python per request.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _spans_by_trace():
    from ray_tpu_torch.util import tracing

    out = {}
    for s in tracing.exported_spans():
        out.setdefault(s["trace_id"], []).append(s)
    tracing.clear_spans()
    return out


def _one(spans, name):
    found = [s for s in spans if s["name"] == name]
    return found[0] if len(found) == 1 else None


def _post(addr, path, body):
    req = urllib.request.Request(f"{addr}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=120) as resp:
        resp.read()
    return t0, time.time()


def _get_sse(addr, path):
    req = urllib.request.Request(f"{addr}{path}",
                                 headers={"Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return sum(1 for raw in resp if raw.startswith(b"data: "))


def unary_breakdown(addr, path, body, n):
    rows = []
    _spans_by_trace()
    for _ in range(n):
        t0, t1 = _post(addr, path, body)
        traces = _spans_by_trace()
        spans = next((v for v in traces.values()
                      if _one(v, "serve.http_request")), None)
        http = _one(spans, "serve.http_request")
        route = _one(spans, "serve.route")
        task = _one(spans, "task::ReplicaActor.handle_request")
        rows.append({
            "client": t1 - t0,
            "outside": (t1 - t0) - (http["end"] - http["start"]),
            "proxy_in": route["start"] - http["start"],
            "route": route["end"] - route["start"],
            "to_replica": task["start"] - route["end"],
            "replica": task["end"] - task["start"],
            "back": http["end"] - task["end"],
        })
    return {k: statistics.median(r[k] for r in rows) * 1e3 for k in rows[0]}


def stream_breakdown(addr, path, n):
    pulls, betweens, tokens = [], [], 0
    _spans_by_trace()
    for _ in range(n):
        tokens = _get_sse(addr, path)
        for spans in _spans_by_trace().values():
            tasks = sorted((s for s in spans
                            if s["name"] == "task::ReplicaActor.next_stream"),
                           key=lambda s: s["start"])
            pulls += [s["end"] - s["start"] for s in tasks]
            betweens += [b["start"] - a["end"] for a, b in zip(tasks, tasks[1:])]
    return {"pull": statistics.median(pulls) * 1e3,
            "between": statistics.median(betweens) * 1e3,
            "tokens_per_request": tokens}


class Empty:
    """A replica that does no work: the control plane's own cost."""

    async def __call__(self, request):
        await request.json()
        return {"next_token": 0}


class EmptyStream:
    def __call__(self, request):
        for i in range(int(request.query_params.get("max_new", "8"))):
            yield json.dumps({"token": i})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--switch-interval", type=float, default=None,
                        help="sys.setswitchinterval for the run")
    args = parser.parse_args()
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.util import tracing

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(card, flush=True)
        config = gpt2.GPTConfig()
    else:
        config = gpt2.GPTConfig(vocab_size=2048, n_layer=2, n_head=4,
                                d_model=256, seq_len=1024, dtype=torch.float32)
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    print(json.dumps({"switch_interval_s": sys.getswitchinterval()}), flush=True)
    params = gpt2.init_params(config, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    unary = {"tokens": rng.integers(0, config.vocab_size, 100).tolist()}
    prompt = ",".join(map(str, rng.integers(0, config.vocab_size, 64)))
    stream_path = f"/gpt2stream?tokens={prompt}&max_new=16"

    ray_tpu_torch.init()
    try:
        serve.start(http_options={"port": 0})
        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address
        deploy = serve.deployment(num_replicas=1)
        serve.run(deploy(serve.GPT2Next).bind(config, params=params,
                                              device=args.device),
                  name="gpt2", route_prefix="/gpt2")
        serve.run(deploy(serve.GPT2Stream).bind(config, params=params,
                                                device=args.device),
                  name="gpt2stream", route_prefix="/gpt2stream")
        serve.run(deploy(Empty).bind(), name="empty", route_prefix="/empty")
        serve.run(deploy(EmptyStream).bind(), name="empty_stream",
                  route_prefix="/empty_stream")
        for _ in range(3):  # warm-up: shapes, cuBLAS handles, threads
            _post(addr, "/gpt2", unary)
            _get_sse(addr, stream_path)
        tracing.enable_tracing()
        rows = {
            "unary": unary_breakdown(addr, "/gpt2", unary, args.requests),
            "stream": stream_breakdown(addr, stream_path, args.requests),
            "empty_unary": unary_breakdown(addr, "/empty", unary,
                                           args.requests),
            "empty_stream": stream_breakdown(
                addr, "/empty_stream?max_new=16", args.requests),
        }
        tracing.disable_tracing()
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    for name, row in rows.items():
        print(f"{name} " + json.dumps({k: round(v, 4) for k, v in row.items()}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
