"""Windowed shuffle: larger-than-memory randomization at O(window) memory.

(ref: the reference's local_shuffle_buffer_size on iter_batches — a
bounded reservoir between the block stream and the batcher.)  A full
random_shuffle materializes the epoch; the window holds at most W items
(and optionally a byte budget) and emits a uniformly-random resident item
each time a new one arrives, so randomization quality degrades gracefully
with memory instead of falling off a cliff.  Combined with the per-epoch
shard-order permutation in ingest.py (which shuffles at the source level),
two rows that were adjacent on disk can land an entire epoch apart while
the window itself stays small.
"""

from __future__ import annotations

import random
from typing import Callable, Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")


def window_shuffle(items: Iterable[T], window: int,
                   rng: random.Random, *,
                   size_of: Optional[Callable[[T], int]] = None,
                   max_bytes: Optional[int] = None) -> Iterator[T]:
    """Yield every item of ``items`` exactly once, shuffled within a
    sliding window of ``window`` items (optionally also capped at
    ``max_bytes`` via ``size_of``).  ``window <= 1`` is a passthrough.

    Emission rule: once the buffer is full, swap a uniformly-random
    resident item to the tail and pop it — each emission is uniform over
    the current window, and an item admitted at input position p is
    emitted no later than output position p + window (bounded delay =
    bounded memory).  The tail drains fully shuffled.
    """
    buf: list = []
    buf_bytes = 0
    for item in items:
        buf.append(item)
        if size_of is not None:
            buf_bytes += size_of(item)
        while len(buf) >= max(window, 1) or (
                max_bytes is not None and size_of is not None
                and buf_bytes > max_bytes and len(buf) > 1):
            j = rng.randrange(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            out = buf.pop()
            if size_of is not None:
                buf_bytes -= size_of(out)
            yield out
    rng.shuffle(buf)
    for out in buf:
        yield out


def epoch_rng(seed: Optional[int], epoch: int, salt: int = 0) -> random.Random:
    """Deterministic per-epoch RNG: a fixed seed reproduces the exact same
    epoch order; consecutive epochs differ (the reference reshuffles per
    epoch too).  ``seed=None`` derives a random base once per process."""
    if seed is None:
        seed = _PROCESS_SEED
    return random.Random((seed * 1_000_003 + epoch) ^ (salt * 7_919))


_PROCESS_SEED = random.SystemRandom().getrandbits(48)
