"""GPT-2 replica bodies: the port of the two deployments in
``examples/serve_gpt2.py``.

``GPT2Next`` answers a unary next-token request (greedy argmax at the last
position); ``GPT2Stream`` decodes greedily, padding every step to
``seq_len`` as the reference does, so each token is one full forward at the
model's fixed shape. ``__call__`` keeps the example's request contract
(``serve.run(GPT2Next.bind(...))`` serves it over HTTP), and the work is in
plain methods (``next_token``, ``generate``) so a caller can also drive a
replica in-process.

Both default to GPT-2 124M (``GPTConfig()``) on the GPU, with attention on
the splash kernel. Behind ``serve.run`` a replica's methods run on the
runtime's threads (the async ``__call__`` on the replica's event loop, each
step of the streaming generator on whichever executor thread pulls it), so
every forward sets the replica's device on the calling thread instead of
relying on that thread's current device.
"""

from __future__ import annotations

import contextlib
import json
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._private.device import (
    DeviceLike, granted_cuda_device, resolve_device)
from ray_tpu_torch.models import gpt2


class _Replica:
    def __init__(self, config: Optional[gpt2.GPTConfig] = None, seed: int = 0,
                 device: DeviceLike = None, params=None):
        self.config = gpt2.GPTConfig() if config is None else config
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # Pin the card now: the threads that later run the forwards
            # each have a current device of their own. Behind serve.run it
            # is the card the runtime granted this replica.
            self.device = granted_cuda_device()
        if params is None:
            params = gpt2.init_params(self.config, seed, self.device)
        # Matmul weights once in the compute type: the same logits, half the
        # bytes read per request.
        self.params = gpt2.inference_params(params, self.config)

    def _tokens(self, tokens: Sequence[int], extra: int = 0) -> List[int]:
        """Validates a request's tokens; ``extra`` more positions must fit."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            raise ValueError("a request needs at least one token")
        if len(tokens) + extra > self.config.seq_len:
            raise ValueError(
                f"{len(tokens)} tokens (+{extra} to generate) exceed "
                f"seq_len {self.config.seq_len}")
        bad = [t for t in tokens if not 0 <= t < self.config.vocab_size]
        if bad:
            raise ValueError(
                f"token ids out of range [0, {self.config.vocab_size}): {bad[:5]}")
        return tokens

    @torch.inference_mode()
    def logits_at(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        """float32 logits (V,) at position ``pos`` of the (1, S) ``tokens``.
        Only that row goes through the LM head: a request reads no other."""
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            t = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
            x = gpt2.forward_hidden(self.params, t, self.config)
            return gpt2.lm_head(x[0, pos], self.params["wte"], torch.float32)


class GPT2Next(_Replica):
    """Unary next-token replica (``examples/serve_gpt2.py:GPT2Next``)."""

    def logits(self, tokens: Sequence[int]) -> torch.Tensor:
        tokens = self._tokens(tokens)
        return self.logits_at(np.asarray(tokens)[None, :], len(tokens) - 1)

    def next_token(self, tokens: Sequence[int]) -> int:
        return int(torch.argmax(self.logits(tokens)))

    async def __call__(self, request):
        body = await request.json()
        return {"next_token": self.next_token(body["tokens"])}


class GPT2Stream(_Replica):
    """Greedy streaming decoder (``examples/serve_gpt2.py:GPT2Stream``)."""

    def generate(self, tokens: Sequence[int], max_new: int) -> Iterator[int]:
        """Yields ``max_new`` greedy tokens. Every step pads the sequence to
        ``seq_len``, as the reference does to keep one compiled shape."""
        tokens = self._tokens(tokens, extra=max(max_new - 1, 0))
        S = self.config.seq_len
        for _ in range(max_new):
            arr = np.zeros((1, S), np.int64)
            arr[0, :len(tokens)] = tokens
            nxt = int(torch.argmax(self.logits_at(arr, len(tokens) - 1)))
            tokens.append(nxt)
            yield nxt

    def __call__(self, request):
        tokens = request.query_params.get("tokens", "1,2,3").split(",")
        n = int(request.query_params.get("max_new", "8"))
        for nxt in self.generate(tokens, n):
            yield json.dumps({"token": nxt})
