"""GPT-2 replica bodies: the port of the two deployments in
``examples/serve_gpt2.py``, and three that serve the same model batched.

``GPT2Next`` answers a unary next-token request (greedy argmax at the last
position); ``GPT2Stream`` decodes greedily, padding every step to
``seq_len`` as the reference does, so each token is one full forward at the
model's fixed shape. ``__call__`` keeps the example's request contract
(``serve.run(GPT2Next.bind(...))`` serves it over HTTP), and the work is in
plain methods (``next_token``, ``generate``) so a caller can also drive a
replica in-process.

The batched bodies compose ``serve.batch``, ``serve.continuous_batch`` and
``serve.multiplexed`` with one batched forward (``_Replica.logits_rows``):

- ``GPT2BatchNext`` keeps ``GPT2Next``'s request contract; concurrent
  requests are coalesced (up to 32, waiting at most 10 ms) into one
  forward over the batch right-padded to its longest request. Causal
  attention keeps the padding out of every row's last real position.
- ``GPT2ContinuousStream`` keeps ``GPT2Stream``'s query contract; every
  iteration steps all live streams in one (B, seq_len) forward, and a
  stream admitted mid-flight joins at the next iteration.
- ``GPT2MultiplexNext`` serves one weight set per multiplexed model id
  ``"seed-<n>"`` (GPT-2 built from seed n), an LRU of them per replica; a
  batch only ever holds requests for one model.

``GPT2Stage`` holds a span of the layers, for a forward split over thread
actors of a compiled DAG or over the deployments of ``serve.pipeline``.

Each defaults to GPT-2 124M (``GPTConfig()``) on the GPU, with attention on
the splash kernel. Behind ``serve.run`` a replica's methods run on the
runtime's threads (the async ``__call__`` on the replica's event loop, each
step of the streaming generator and each vectorized call on whichever
executor thread runs it), so every forward sets the replica's device on the
calling thread instead of relying on that thread's current device.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import (
    DeviceLike, granted_cuda_device, resolve_device)
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.serve._sync import run_in_executor
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.context import get_multiplexed_model_id
from ray_tpu_torch.serve.continuous import EOS, Emissions, continuous_batch
from ray_tpu_torch.serve.multiplex import multiplexed


def _pin_device(device: DeviceLike) -> torch.device:
    """The replica's device. A CUDA device without an index is pinned now:
    the threads that later run the forwards each have a current device of
    their own. Behind serve.run it is the card the runtime granted this
    replica."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = granted_cuda_device()
    return dev


def _check_tokens(tokens: Sequence[int], config: gpt2.GPTConfig,
                  extra: int = 0) -> List[int]:
    """Validates a request's tokens; ``extra`` more positions must fit."""
    tokens = [int(t) for t in tokens]
    if not tokens:
        raise ValueError("a request needs at least one token")
    if len(tokens) + extra > config.seq_len:
        raise ValueError(
            f"{len(tokens)} tokens (+{extra} to generate) exceed "
            f"seq_len {config.seq_len}")
    bad = [t for t in tokens if not 0 <= t < config.vocab_size]
    if bad:
        raise ValueError(
            f"token ids out of range [0, {config.vocab_size}): {bad[:5]}")
    return tokens


class _Replica:
    def __init__(self, config: Optional[gpt2.GPTConfig] = None, seed: int = 0,
                 device: DeviceLike = None, params=None):
        self.config = gpt2.GPTConfig() if config is None else config
        self.device = _pin_device(device)
        if params is None:
            params = gpt2.init_params(self.config, seed, self.device)
        # Matmul weights once in the compute type: the same logits, half the
        # bytes read per request.
        self.params = gpt2.inference_params(params, self.config)

    def _tokens(self, tokens: Sequence[int], extra: int = 0) -> List[int]:
        return _check_tokens(tokens, self.config, extra)

    @torch.inference_mode()
    def logits_rows(self, tokens: np.ndarray,
                    positions: Sequence[int]) -> torch.Tensor:
        """float32 logits (B, V): row b at position ``positions[b]`` of the
        (B, L) ``tokens``. One forward runs over the whole batch, and only
        the B chosen rows go through the LM head: a request reads no
        other."""
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()):
            t = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
            x = gpt2.forward_hidden(self.params, t, self.config)
            pos = torch.as_tensor(positions, dtype=torch.long,
                                  device=self.device)
            x = x[torch.arange(len(pos), device=self.device), pos]
            return gpt2.lm_head(x, self.params["wte"], torch.float32)

    def logits_at(self, tokens: np.ndarray, pos: int) -> torch.Tensor:
        """float32 logits (V,) at position ``pos`` of the (1, S) ``tokens``."""
        return self.logits_rows(tokens, [pos])[0]

    def next_tokens(self, token_lists: Sequence[Sequence[int]]) -> List[int]:
        """The greedy next token of each request, from one forward over the
        requests right-padded to the longest of them."""
        lists = [self._tokens(t) for t in token_lists]
        arr = np.zeros((len(lists), max(map(len, lists))), np.int64)
        for row, toks in enumerate(lists):
            arr[row, :len(toks)] = toks
        logits = self.logits_rows(arr, [len(t) - 1 for t in lists])
        return torch.argmax(logits, dim=-1).tolist()


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


class GPT2Stage:
    """The layers ``[lo, hi)`` of GPT-2 on one device, one stage of a
    forward split by layers: ``head(tokens)`` embeds (B, S) token ids and
    runs the span (the first stage), ``tail(hidden)`` runs the span, the
    final layernorm and the tied LM head, giving float32 logits (B, S, V)
    (the last stage), and ``next_token(hidden)`` answers as ``GPT2Next``
    does from the last stage (each row's greedy token at its last
    position). A stage keeps its span's blocks and the weights its ends
    use, cast as ``GPT2Next`` casts them; ``params`` are the whole model's
    (``gpt2.init_params``), else built from ``seed`` on ``device``."""

    def __init__(self, layers: Tuple[int, int],
                 config: Optional[gpt2.GPTConfig] = None, seed: int = 0,
                 device: DeviceLike = None, params=None):
        self.config = gpt2.GPTConfig() if config is None else config
        lo, hi = layers
        if not 0 <= lo < hi <= self.config.n_layer:
            raise ValueError(f"layers {layers} outside [0, "
                             f"{self.config.n_layer}) or empty")
        self.layers = (lo, hi)
        self.first, self.last = lo == 0, hi == self.config.n_layer
        self.device = _pin_device(device)
        if params is None:
            params = gpt2.init_params(self.config, seed, self.device)
        keep = {"blocks": {n: w[lo:hi] for n, w in params["blocks"].items()}}
        if self.first:
            keep.update(wte=params["wte"], wpe=params["wpe"])
        if self.last:
            keep.update(wte=params["wte"], lnf_scale=params["lnf_scale"],
                        lnf_bias=params["lnf_bias"])
        self.params = gpt2.inference_params(keep, self.config)

    def _device_scope(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    @torch.inference_mode()
    def _hidden(self, x, first: bool) -> torch.Tensor:
        with self._device_scope():
            x = torch.as_tensor(x, dtype=torch.long if first else None,
                                device=self.device)
            if first and x.dim() == 1:
                x = x[None, :]
            return gpt2.stage_hidden(self.params, x, self.config,
                                     first=first, last=self.last)

    def head(self, tokens) -> torch.Tensor:
        """(B, S) token ids (a list, an array or a tensor; one request's
        list is a row) -> this span's hidden states (B, S, D)."""
        if not self.first:
            raise ValueError(f"stage {self.layers} is not the first")
        if not isinstance(tokens, torch.Tensor):
            tokens = np.asarray(tokens)
            if tokens.ndim == 1:
                _check_tokens(tokens.tolist(), self.config)
        return self._hidden(tokens, first=True)

    def tail(self, hidden: torch.Tensor) -> torch.Tensor:
        """The previous stage's hidden states -> float32 logits (B, S, V)."""
        x = self._last_hidden(hidden)
        with self._device_scope(), torch.inference_mode():
            return gpt2.lm_head(x, self.params["wte"], torch.float32)

    def next_token(self, hidden: torch.Tensor) -> int:
        """One request's (1, S) hidden states -> its greedy next token, the
        LM head on its last position alone (as ``GPT2Next``)."""
        x = self._last_hidden(hidden)
        with self._device_scope(), torch.inference_mode():
            logits = gpt2.lm_head(x[:, -1], self.params["wte"], torch.float32)
            return int(torch.argmax(logits[0]))

    def _last_hidden(self, hidden) -> torch.Tensor:
        if not self.last:
            raise ValueError(f"stage {self.layers} is not the last")
        return self._hidden(hidden, first=False)


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


class GPT2BatchNext(_Replica):
    """``GPT2Next`` with concurrent requests batched: ``@serve.batch``
    coalesces up to 32 of them into one vectorized ``next_tokens`` call
    (the reference bench's settings, scripts/bench_serve.py)."""

    @batch(max_batch_size=32, batch_wait_timeout_s=0.01)
    def next_token(self, token_lists: List[List[int]]) -> List[int]:
        """Called with one request's tokens; runs with the batch's list."""
        return self.next_tokens(token_lists)

    async def __call__(self, request):
        body = await request.json()
        tokens = self._tokens(body["tokens"])
        return {"next_token": await self.next_token(tokens)}


class GPT2ContinuousStream(_Replica):
    """``GPT2Stream`` with continuous batching: every iteration pads each
    live stream to ``seq_len`` and steps all of them in one forward; a
    stream's last token ends it in the same iteration."""

    def _admit(self, state: Dict[str, Any], request) -> None:
        query = request.query_params
        n = int(query.get("max_new", "8"))
        state["tokens"] = self._tokens(query.get("tokens", "1,2,3").split(","),
                                       extra=max(n - 1, 0))
        state["left"] = n

    @continuous_batch(max_batch_size=32)
    def __call__(self, slots) -> List[Any]:
        outs: List[Any] = [EOS] * len(slots)
        live = []
        for i, slot in enumerate(slots):
            if "tokens" not in slot.state:
                try:
                    self._admit(slot.state, slot.request)
                except Exception as e:  # noqa: BLE001 — fails this stream only
                    outs[i] = e
                    continue
            if slot.state["left"] > 0:
                live.append(i)
        if not live:
            return outs
        S = self.config.seq_len
        arr = np.zeros((len(live), S), np.int64)
        for row, i in enumerate(live):
            toks = slots[i].state["tokens"]
            arr[row, :len(toks)] = toks
        logits = self.logits_rows(
            arr, [len(slots[i].state["tokens"]) - 1 for i in live])
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i, tok in zip(live, nxt):
            state = slots[i].state
            state["tokens"].append(tok)
            state["left"] -= 1
            item = json.dumps({"token": tok})
            outs[i] = (Emissions([item], eos=True) if state["left"] == 0
                       else item)
        return outs


def _seed_of(model_id: str) -> int:
    prefix = "seed-"
    if not model_id.startswith(prefix) or not model_id[len(prefix):].isdigit():
        raise ValueError(f"model id {model_id!r} is not 'seed-<n>'")
    return int(model_id[len(prefix):])


class GPT2MultiplexNext:
    """Next-token replica over many GPT-2 weight sets: the request's
    multiplexed model id ``"seed-<n>"`` (``handle.options(
    multiplexed_model_id=...)``) names the weights, built from seed n on
    the replica's card. An LRU keeps ``max_num_models_per_replica`` of them.
    Eviction only drops the LRU's reference: a batch still running on the
    evicted weights keeps them whole, and they are freed when it returns.
    Requests are batched per model id, so one vectorized call always runs
    on one weight set. A request is ``{"tokens": [...]}`` (or an HTTP
    request with that body) and the answer ``{"next_token": n}``."""

    def __init__(self, config: Optional[gpt2.GPTConfig] = None,
                 device: DeviceLike = None,
                 max_num_models_per_replica: int = 3):
        self.config = gpt2.GPTConfig() if config is None else config
        self.device = _pin_device(device)
        self.get_model = multiplexed(
            max_num_models_per_replica=max_num_models_per_replica)(self._load)

    async def _load(self, model_id: str) -> _Replica:
        seed = _seed_of(model_id)
        return await run_in_executor(_Replica, self.config, seed, self.device)

    @batch(max_batch_size=32, batch_wait_timeout_s=0.01)
    async def next_token(self, items: List[tuple]) -> List[int]:
        """Called with one ``(model_id, tokens)``; runs with the batch's
        list, all for the model id of the batch's queue."""
        model_id = get_multiplexed_model_id()
        stray = sorted({mid for mid, _ in items if mid != model_id})
        if stray:
            raise RuntimeError(f"a batch for model {model_id!r} holds "
                               f"requests for {stray}")
        model = await self.get_model(model_id)
        return await run_in_executor(model.next_tokens,
                                     [toks for _, toks in items])

    async def __call__(self, request):
        body = request if isinstance(request, dict) else await request.json()
        model_id = get_multiplexed_model_id()
        if not model_id:
            raise ValueError("GPT2MultiplexNext serves requests that name a "
                             "model: handle.options(multiplexed_model_id="
                             "'seed-<n>')")
        _seed_of(model_id)
        tokens = _check_tokens(body["tokens"], self.config)
        return {"next_token": await self.next_token((model_id, tokens))}
