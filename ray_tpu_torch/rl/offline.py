"""Offline RL data path — record experience, read it back as train batches.

The port of ``ray_tpu/rl/offline.py`` (ref: rllib/offline/ —
offline_data.py OfflineData reads Ray Data datasets of episodes/transitions
and feeds learner batches; output writers in rllib/offline/output_writer.py
record env-runner experience).

Transitions are flat numpy columns (the learner's batch format), stored
through ``ray_tpu_torch.data`` (parquet or json), and sampled as uniform
minibatches on the host with the reference's ``default_rng(seed)`` draws.
``record_episodes`` builds its columns from numpy, as the reference's
DataFrame holds them (python floats and ints, a list per row for a
multi-dimensional column), so either package reads the other's files; the
formats import pyarrow where they run, and pandas is never needed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Union

import numpy as np

from ray_tpu_torch.rl.connectors import episodes_to_transitions
from ray_tpu_torch.rl.core.rl_module import Columns


def _column(v: np.ndarray) -> np.ndarray:
    """A transition column as the reference's ``pd.DataFrame`` infers it
    from ``tolist()`` rows: float64 / int64 / bool scalars, or an object
    array of python lists for a multi-dimensional column."""
    if v.ndim > 1:
        out = np.empty(len(v), dtype=object)
        out[:] = [row.tolist() for row in v]
        return out
    return np.asarray(v.tolist())


def record_episodes(episodes, path: str, *, format: str = "parquet") -> str:
    """Write episodes as flat transition rows (offline training input).

    (ref: rllib/offline/output_writer.py / ``config.output`` recording.)
    """
    from ray_tpu_torch.data.block import block_from_batch
    from ray_tpu_torch.data.dataset import Dataset
    from ray_tpu_torch.data.plan import InputData

    if format not in ("parquet", "json"):
        raise ValueError(f"unsupported offline format: {format}")
    cols = episodes_to_transitions(episodes)
    ds = Dataset(InputData([block_from_batch(
        {k: _column(v) for k, v in cols.items()})]))
    os.makedirs(path, exist_ok=True)
    if format == "parquet":
        ds.write_parquet(path)
    else:
        ds.write_json(path)
    return path


class StreamingColumnsError(AttributeError, ValueError):
    """`columns` was accessed on a streaming OfflineData.  AttributeError
    ancestry keeps hasattr()/getattr(default) probes working; ValueError
    ancestry keeps it catchable as the config error it really is."""


class OfflineData:
    """Uniformly samples learner batches from a recorded dataset
    (ref: rllib/offline/offline_data.py OfflineData / OfflinePreLearner).

    Accepts a path (parquet/json dir), a ``ray_tpu_torch.data`` Dataset, or
    an in-memory column dict. Two modes:

    * **materialized** (default): numpy columns once, exact uniform
      sampling — right for control-task corpora that fit host memory.
    * **streaming=True**: the dataset-scale path (ref: offline_data.py's
      streaming OfflinePreLearner) — blocks stream through the data
      pipeline's shuffle, and ``sample`` draws from a bounded in-memory
      window that continuously refills, so the corpus never materializes
      on one host.
    """

    def __init__(self, source: Union[str, Dict[str, np.ndarray], Any],
                 *, format: str = "parquet", seed: int = 0,
                 streaming: bool = False, window_rows: int = 50_000):
        self._rng = np.random.default_rng(seed)
        self._stream = None
        if isinstance(source, dict):
            self.columns = {k: np.asarray(v) for k, v in source.items()}
        else:
            if isinstance(source, str):
                import ray_tpu_torch.data as rdata

                ds = (rdata.read_parquet(source) if format == "parquet"
                      else rdata.read_json(source))
            else:
                ds = source
            if streaming:
                self._init_streaming(ds, window_rows)
                return
            rows = ds.take_all()
            if not rows:
                raise ValueError("offline dataset is empty")
            keys = rows[0].keys()
            self.columns = {
                k: np.asarray([r[k] for r in rows]) for k in keys}
        for k in (Columns.OBS, Columns.ACTIONS):
            if k not in self.columns:
                raise ValueError(f"offline data missing column {k!r}")
        self.columns = {k: np.asarray(v, np.float32)
                        if np.asarray(v).dtype == np.float64 else np.asarray(v)
                        for k, v in self.columns.items()}
        self.size = len(self.columns[Columns.OBS])

    # ------------------------------------------------------------ streaming
    def _init_streaming(self, ds, window_rows: int) -> None:
        self._base_ds = ds  # epochs reshuffle FROM HERE (chaining shuffle
        #                     ops onto the shuffled result would re-execute
        #                     every prior epoch's shuffle)
        self._window_rows = window_rows
        self._window: dict = {}
        self._cursor = 0
        self.size = None  # unknown without a full pass — by design
        self._stream = self._batches()
        self._refill(1)
        for k in (Columns.OBS, Columns.ACTIONS):
            if k not in self._window:
                raise ValueError(f"offline data missing column {k!r}")

    def _batches(self):
        while True:  # epoch loop: a fresh shuffle of the BASE dataset
            shuffled = self._base_ds.random_shuffle(
                seed=int(self._rng.integers(1 << 30)))
            got_any = False
            for batch in shuffled.iter_batches(batch_size=4096):
                got_any = True
                yield batch
            if not got_any:
                raise ValueError("offline dataset is empty")

    @property
    def is_streaming(self) -> bool:
        return self._stream is not None

    def has_column(self, name: str) -> bool:
        return name in (self._window if self._stream is not None
                        else self.columns)

    def __getattr__(self, name: str):
        # Only reached when normal lookup fails — i.e. streaming mode, where
        # `columns` is never materialized. The error subclasses
        # AttributeError so hasattr()/getattr(..., default) probes work.
        if name == "columns":
            raise StreamingColumnsError(
                "this OfflineData is streaming (streaming=True): full-dataset "
                "columns are never materialized. Algorithms that need whole-"
                "dataset returns derivation (e.g. MARWIL without a 'returns' "
                "column) require streaming=False, or precompute 'returns' in "
                "the dataset.")
        raise AttributeError(name)

    def _remaining(self) -> int:
        if not self._window:
            return 0
        return len(next(iter(self._window.values()))) - self._cursor

    def _refill(self, need: int) -> None:
        """Compact the unconsumed tail, append stream batches up to the
        window target, then shuffle ONCE — sample() just advances a cursor
        (O(batch) per draw, not O(window))."""
        target = max(self._window_rows, need)
        parts: Dict[str, list] = {}
        total = self._remaining()
        for k, v in self._window.items():
            parts[k] = [v[self._cursor:]]
        while total < target:
            batch = next(self._stream)
            total += len(next(iter(batch.values())))
            for k, v in batch.items():
                v = np.asarray(v)
                if v.dtype == np.float64:
                    v = v.astype(np.float32)
                parts.setdefault(k, []).append(v)
        window = {k: np.concatenate(vs) if len(vs) > 1 else vs[0]
                  for k, vs in parts.items()}
        order = self._rng.permutation(total)
        self._window = {k: v[order] for k, v in window.items()}
        self._cursor = 0

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        if self._stream is None:
            idx = self._rng.integers(0, self.size, batch_size)
            return {k: v[idx] for k, v in self.columns.items()}
        if self._remaining() < batch_size:
            self._refill(batch_size)
        start = self._cursor
        self._cursor += batch_size
        return {k: v[start:self._cursor] for k, v in self._window.items()}
