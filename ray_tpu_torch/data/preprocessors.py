"""Preprocessors: fit-on-dataset, transform-as-map_batches feature prep
(the counterpart of ``ray_tpu/data/preprocessors.py``).

Counterpart of the reference's `ray.data.preprocessors`
(ref: python/ray/data/preprocessors/ — scaler.py StandardScaler/MinMaxScaler,
encoder.py LabelEncoder/OneHotEncoder, imputer.py SimpleImputer,
concatenator.py Concatenator, chain.py Chain): `fit()` computes statistics
with dataset aggregates, `transform()` appends a `map_batches` stage so the
work runs inside the streaming executor; `Concatenator` produces the single
dense feature matrix a torch train loop wants.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Preprocessor:
    """fit/transform contract (ref: preprocessor.py Preprocessor)."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return ds.map_batches(self._transform_batch)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Direct batch application (serving path)."""
        if not self._fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return self._transform_batch(dict(batch))

    # overridables
    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds) -> None:
        pass

    def _transform_batch(self, batch):
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (ref: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        for col in self.columns:
            mean = ds.mean(col)
            sq = ds.map_batches(
                lambda b, c=col: {"_sq": np.asarray(b[c], np.float64) ** 2})
            var = sq.mean("_sq") - mean ** 2
            self.stats_[col] = (mean, float(np.sqrt(max(var, 0.0))))

    def _transform_batch(self, batch):
        for col in self.columns:
            mean, std = self.stats_[col]
            batch[col] = (np.asarray(batch[col], np.float64) - mean) / (std or 1.0)
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        for col in self.columns:
            self.stats_[col] = (ds.min(col), ds.max(col))

    def _transform_batch(self, batch):
        for col in self.columns:
            lo, hi = self.stats_[col]
            span = (hi - lo) or 1.0
            batch[col] = (np.asarray(batch[col], np.float64) - lo) / span
        return batch


class LabelEncoder(Preprocessor):
    """Categorical column -> integer codes (ref: preprocessors/encoder.py)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: List = []

    def _fit(self, ds) -> None:
        values = set()
        for batch in ds.iter_batches(batch_format="numpy"):
            values.update(np.asarray(batch[self.label_column]).tolist())
        self.classes_ = sorted(values)
        self._index = {v: i for i, v in enumerate(self.classes_)}

    def _transform_batch(self, batch):
        col = np.asarray(batch[self.label_column])
        batch[self.label_column] = np.asarray(
            [self._index[v] for v in col.tolist()], np.int64)
        return batch


class OneHotEncoder(Preprocessor):
    """Each category becomes a 0/1 column `col_value`."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.categories_: Dict[str, List] = {}

    def _fit(self, ds) -> None:
        for col in self.columns:
            values = set()
            for batch in ds.iter_batches(batch_format="numpy"):
                values.update(np.asarray(batch[col]).tolist())
            self.categories_[col] = sorted(values)

    def _transform_batch(self, batch):
        for col in self.columns:
            data = np.asarray(batch.pop(col))
            for cat in self.categories_[col]:
                batch[f"{col}_{cat}"] = (data == cat).astype(np.int8)
        return batch


class SimpleImputer(Preprocessor):
    """Fill NaNs with the column mean (or a constant)."""

    def __init__(self, columns: List[str], strategy: str = "mean",
                 fill_value: Optional[float] = None):
        if strategy not in ("mean", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' needs fill_value")
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        self.fills_: Dict[str, float] = {}

    def _needs_fit(self) -> bool:
        return self.strategy == "mean"

    def _fit(self, ds) -> None:
        if self.strategy != "mean":
            return
        for col in self.columns:
            total = n = 0.0
            for batch in ds.iter_batches(batch_format="numpy"):
                arr = np.asarray(batch[col], np.float64)
                mask = ~np.isnan(arr)
                total += float(arr[mask].sum())
                n += float(mask.sum())
            self.fills_[col] = total / n if n else 0.0

    def _transform_batch(self, batch):
        for col in self.columns:
            arr = np.asarray(batch[col], np.float64)
            fill = (self.fill_value if self.strategy == "constant"
                    else self.fills_[col])
            batch[col] = np.where(np.isnan(arr), fill, arr)
        return batch


class Concatenator(Preprocessor):
    """Pack columns into one dense matrix column — the shape a torch train
    step consumes (ref: preprocessors/concatenator.py)."""

    def __init__(self, columns: List[str], output_column_name: str = "concat_out",
                 dtype=np.float32):
        self.columns = columns
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _transform_batch(self, batch):
        mats = []
        for col in self.columns:
            arr = np.asarray(batch.pop(col))
            mats.append(arr[:, None] if arr.ndim == 1 else arr)
        batch[self.output_column_name] = np.concatenate(
            mats, axis=1).astype(self.dtype)
        return batch


class Chain(Preprocessor):
    """Sequential composition (ref: preprocessors/chain.py)."""

    def __init__(self, *stages: Preprocessor):
        self.stages = stages

    def _needs_fit(self) -> bool:
        return any(s._needs_fit() for s in self.stages)

    def fit(self, ds) -> "Chain":
        for stage in self.stages:
            if stage._needs_fit():
                stage.fit(ds)
            ds = stage.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        for stage in self.stages:
            ds = stage.transform(ds)
        return ds

    def transform_batch(self, batch):
        for stage in self.stages:
            batch = stage.transform_batch(batch)
        return batch
