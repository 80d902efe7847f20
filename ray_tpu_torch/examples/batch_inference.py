"""Batch inference on GPU actors through ``Dataset.map_batches``: the
counterpart of ``examples/batch_inference_tpu.py`` (BASELINE config 3; ref
pattern: release/nightly_tests/dataset/ map_batches inference), with GPT-2
124M in place of its MLP.

A stateful scorer class is constructed once per pool actor, on the card its
lease names (``num_gpus=1``: one model per card), and blocks of token
windows stream through it with backpressure. For each row of a ``tokens``
batch, (B, S + 1) ids, it returns the greedy next token after
``tokens[:, :S]`` and the row's mean next-token loss against
``tokens[:, 1:]``, from the fused LM-head cross-entropy forward
(``ops/fused_ce.py:ce_fwd``): the (B·S, vocab) logits are never formed.

Run on the card: ``python3 -m ray_tpu_torch.examples.batch_inference``;
on the CPU at a tiny size: ``... --device cpu --tiny``.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

#: One record per scorer constructed in this process (thread-tier pool
#: actors run here): the cards its lease named, its device, and the
#: seconds its constructor took.
CONSTRUCTED: List[Dict[str, Any]] = []


class GPT2Scorer:
    """Scores batches of token windows with GPT-2 (``GPTConfig()`` unless
    given): weights from ``seed``, or ``params`` (a float32 tree of numpy
    arrays or tensors, e.g. ``models.convert.params_to_numpy`` of the JAX
    model's), on ``device`` (``None``: the card the actor's lease names)."""

    def __init__(self, config=None, seed: int = 0, device=None,
                 params: Optional[Dict[str, Any]] = None):
        import torch

        import ray_tpu_torch
        from ray_tpu_torch._private.device import (
            granted_cuda_device,
            resolve_device,
        )
        from ray_tpu_torch.models import convert, gpt2

        t0 = time.perf_counter()
        self.config = gpt2.GPTConfig() if config is None else config
        dev = resolve_device(device)
        self.device = granted_cuda_device() if dev.type == "cuda" and \
            dev.index is None else dev
        if params is None:
            params = gpt2.init_params(self.config, seed, self.device)
        elif not isinstance(params["wte"], torch.Tensor):
            params = convert.params_from_numpy(params, device=self.device)
        self.params = gpt2.inference_params(params, self.config)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        CONSTRUCTED.append({"gpu_ids": ray_tpu_torch.get_gpu_ids(),
                            "device": str(self.params["wte"].device),
                            "seconds": time.perf_counter() - t0})

    def score(self, tokens) -> Dict[str, np.ndarray]:
        """``tokens`` (B, S + 1) -> ``next_token`` (B,) int64 and ``nll``
        (B,) float32."""
        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.ops.fused_ce import ce_fwd

        S = self.config.seq_len
        with torch.inference_mode(), (
                torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext()):
            t = torch.as_tensor(np.array(tokens), device=self.device)
            if t.ndim != 2 or t.shape[1] != S + 1:
                raise ValueError(f"tokens must be (B, {S + 1}), got "
                                 f"{tuple(t.shape)}")
            t = t.long()
            x = gpt2.forward_hidden(self.params, t[:, :S], self.config)
            B, _, D = x.shape
            wte = self.params["wte"]
            lse, tgt = ce_fwd(x.reshape(B * S, D), wte, t[:, 1:].reshape(-1))
            nll = (lse - tgt).view(B, S).mean(dim=1)
            last = gpt2.lm_head(x[:, -1], wte, torch.float32)
            nxt = torch.argmax(last, dim=-1)
            return {"next_token": nxt.cpu().numpy().astype(np.int64),
                    "nll": nll.float().cpu().numpy()}

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {k: v for k, v in batch.items() if k != "tokens"}
        out.update(self.score(batch["tokens"]))
        return out


def token_windows(rows: int, seq_len: int, vocab: int, seed: int = 0
                  ) -> np.ndarray:
    """``rows`` windows of ``seq_len + 1`` token ids in [0, vocab), drawn by
    numpy ``default_rng(seed)``."""
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq_len + 1), dtype=np.int64)


def token_dataset(tokens: np.ndarray, blocks: int):
    """A materialized dataset of ``row`` and ``tokens`` columns held as
    ``blocks`` blocks of equal size."""
    from ray_tpu_torch import data

    return data.from_items(
        [{"row": i, "tokens": tokens[i]} for i in range(len(tokens))]
    ).repartition(blocks).materialize()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=2048)
    parser.add_argument("--blocks", type=int, default=16)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--device", default=None,
                        help="cpu to run on the host (no card is leased)")
    parser.add_argument("--tiny", action="store_true",
                        help="a 2-layer, 64-wide GPT-2 at S=32, float32")
    args = parser.parse_args(argv)

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2

    config = (gpt2.GPTConfig(vocab_size=256, n_layer=2, n_head=2,
                             d_model=64, seq_len=32, dtype=torch.float32)
              if args.tiny else gpt2.GPTConfig())
    on_cpu = args.device == "cpu"
    ray_tpu_torch.init(ignore_reinit_error=True,
                       **({"num_gpus": 0} if on_cpu else {}))
    try:
        tokens = token_windows(args.rows, config.seq_len,
                               min(config.vocab_size, 50257))
        ds = token_dataset(tokens, args.blocks).map_batches(
            GPT2Scorer, batch_size=args.batch, num_gpus=0 if on_cpu else 1,
            concurrency=1,  # one model per card
            fn_constructor_args=(config, 0, args.device))
        t0 = time.perf_counter()
        rows: List[int] = []
        for b in ds.iter_batches(batch_size=args.batch):
            rows.extend(b["row"].tolist())
            if not np.isfinite(b["nll"]).all():
                print("batch_inference: a non-finite nll", file=sys.stderr)
                return 1
        dt = time.perf_counter() - t0
    finally:
        ray_tpu_torch.shutdown()
    ok = sorted(rows) == list(range(args.rows))
    print(f"batch_inference rows={len(rows)} rows/s={len(rows) / dt:,.1f} "
          f"tokens/s={len(rows) * config.seq_len / dt:,.0f} "
          f"elapsed={dt:.2f}s {'OK' if ok else 'ROWS DIFFER'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
