"""Serve GPT-2 behind HTTP on the port: unary next-token AND streamed greedy
decoding, tokens reaching the client chunk by chunk over SSE. The port of
``examples/serve_gpt2.py``, step for step, with the port's ``GPT2Next`` and
``GPT2Stream`` replica bodies as the deployments.

Run: python -m ray_tpu_torch.examples.serve_gpt2
     (GPT-2 124M on the GPU, attention on the splash kernel)
     python -m ray_tpu_torch.examples.serve_gpt2 --device cpu --tiny
     (the reference example's 2-layer model, on the CPU)

Each replica builds its weights from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import urllib.request
from typing import Optional, Sequence

import torch

# The reference example's model (examples/serve_gpt2.py:GPT2Next).
TINY = dict(vocab_size=2048, n_layer=2, n_head=4, d_model=256, seq_len=128,
            dtype=torch.float32)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--tiny", action="store_true",
                        help="the reference example's 2-layer model instead "
                             "of GPT-2 124M")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models import gpt2

    config = gpt2.GPTConfig(**TINY) if args.tiny else gpt2.GPTConfig()
    ray_tpu_torch.init(ignore_reinit_error=True)
    serve.start(http_options={"port": 0})
    try:
        GPT2Next = serve.deployment(num_replicas=1)(serve.GPT2Next)
        serve.run(GPT2Next.bind(config, seed=args.seed, device=args.device),
                  name="gpt2", route_prefix="/gpt2")

        # Streaming app: greedy-decode one token per yield; the HTTP proxy
        # forwards each as an SSE event / HTTP chunk the moment it exists.
        GPT2Stream = serve.deployment(num_replicas=1)(serve.GPT2Stream)
        serve.run(GPT2Stream.bind(config, seed=args.seed, device=args.device),
                  name="gpt2stream", route_prefix="/gpt2stream")

        from ray_tpu_torch.serve.api import _state

        addr = _state["proxy"].address
        req = urllib.request.Request(
            f"{addr}/gpt2", data=json.dumps({"tokens": [1, 2, 3, 4]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.load(resp)
        print("HTTP response:", out)
        if "next_token" not in out:
            raise RuntimeError(f"unary answer without next_token: {out}")

        # Stream tokens (same wire format a `curl -N .../gpt2stream` sees).
        stream_req = urllib.request.Request(
            f"{addr}/gpt2stream?tokens=1,2,3&max_new=5",
            headers={"Accept": "text/event-stream"})
        with urllib.request.urlopen(stream_req, timeout=60) as resp:
            ctype = resp.headers["Content-Type"]
            if not ctype.startswith("text/event-stream"):
                raise RuntimeError(f"stream Content-Type {ctype}")
            events = []
            for raw in resp:
                line = raw.decode().strip()
                if line.startswith("data: "):
                    events.append(json.loads(line[len("data: "):]))
                    print("streamed:", events[-1])
        if len(events) != 5 or not all("token" in e for e in events):
            raise RuntimeError(f"stream gave {events}, wanted 5 tokens")
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    print("serve_gpt2 OK")


if __name__ == "__main__":
    main()
