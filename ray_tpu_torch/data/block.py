"""Blocks — the unit of data movement (the counterpart of
``ray_tpu/data/block.py``; ref: python/ray/data/block.py: a Block holds
columns, BlockAccessor wraps format-specific access).

The reference's block is a ``pyarrow.Table``. Here a block is a
:class:`Block`: named numpy columns of one length, so a pipeline runs with
numpy alone (the GPU host has no pyarrow). A column holds what the
reference's ``column_to_numpy`` gives back for the same values after the
Arrow round trip: strings and bytes as object arrays, integers with missing
values as float64 with NaN, ragged lists as object arrays of arrays, and an
``(N, ...)`` tensor column as one ``(N, ...)`` array. Arrow tables and
pandas frames convert at the edges (readers, writers, the ``"pyarrow"`` and
``"pandas"`` batch formats), with pyarrow and pandas imported there.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

Batch = Union[Dict[str, np.ndarray], Any]


class Schema:
    """Column names and numpy dtypes of a block (the reference returns a
    ``pyarrow.Schema``; ``names`` is common to both)."""

    def __init__(self, names: List[str], types: List[np.dtype]):
        self.names = list(names)
        self.types = list(types)

    def __repr__(self) -> str:
        return "\n".join(f"{n}: {t}" for n, t in zip(self.names, self.types))


class Block:
    """Named numpy columns of equal length."""

    __slots__ = ("_cols", "num_rows")

    def __init__(self, columns: Optional[Dict[str, np.ndarray]] = None):
        self._cols: Dict[str, np.ndarray] = dict(columns or {})
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"block columns differ in length: "
                f"{ {k: len(v) for k, v in self._cols.items()} }")
        self.num_rows = lengths.pop() if lengths else 0

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    def column(self, name: str) -> np.ndarray:
        return self._cols[name]

    @property
    def schema(self) -> Schema:
        return Schema(list(self._cols), [v.dtype for v in self._cols.values()])

    @property
    def nbytes(self) -> int:
        return sum(_column_nbytes(v) for v in self._cols.values())

    def __reduce__(self):
        return (Block, (self._cols,))

    def __repr__(self) -> str:
        return f"Block(num_rows={self.num_rows}, columns={self.column_names})"


def _column_nbytes(arr: np.ndarray) -> int:
    if arr.dtype != object:
        return int(arr.nbytes)
    total = 8 * len(arr)
    for v in arr:
        if isinstance(v, (str, bytes)):
            total += len(v)
        elif isinstance(v, np.ndarray):
            total += int(v.nbytes)
    return total


def block_from_rows(rows: List[Dict[str, Any]]) -> Block:
    if not rows:
        return Block()
    # Schema = union of keys across ALL rows (first-seen order); rows missing
    # a column contribute nulls.  Deriving it from rows[0] alone silently
    # drops late-appearing columns.
    cols: Dict[str, list] = {}
    for row in rows:
        for k in row:
            if k not in cols:
                cols[k] = []
    for row in rows:
        for k in cols:
            cols[k].append(row.get(k))

    def to_column(vals: list):
        # Ragged/variable-length cells (or None mixed with lists) become a
        # list column — np.asarray would raise on inhomogeneous rows.
        if any(isinstance(v, (list, tuple)) for v in vals):
            try:
                arr = np.asarray(vals)
                if arr.dtype != object:
                    return arr  # rectangular: keep the tensor-column path
            except ValueError:
                pass
            return _list_column([None if v is None else list(v)
                                 if isinstance(v, (list, tuple)) else [v]
                                 for v in vals])
        return np.asarray(vals)

    return block_from_batch({k: to_column(v) for k, v in cols.items()})


def block_from_batch(batch: Batch) -> Block:
    if isinstance(batch, Block):
        return batch
    module = type(batch).__module__
    if module.startswith("pyarrow"):
        return _from_arrow(batch)
    if hasattr(batch, "to_dict") and module.startswith("pandas"):
        return Block({str(k): _to_column(batch[k].to_numpy())
                      for k in batch.columns})
    if isinstance(batch, dict):
        return Block({k: _to_column(v) for k, v in batch.items()})
    raise TypeError(f"Cannot make a block from {type(batch)}")


def _object_array(vals: list) -> np.ndarray:
    out = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):  # cell by cell: equal-length arrays
        out[i] = v                # must not broadcast into a 2-D column
    return out


def _list_column(cells: list) -> np.ndarray:
    """A list column as the reference reads one back: each cell an array,
    None kept."""
    return _object_array([None if c is None else np.asarray(c)
                          for c in cells])


def _to_column(values) -> np.ndarray:
    """One column as the reference stores it and reads it back."""
    if type(values).__module__.startswith("pyarrow"):
        return _arrow_column_to_numpy(values, None)
    arr = np.asarray(values)
    if arr.ndim == 0:
        raise ValueError("a column must have one value per row")
    if arr.dtype.kind in "US":
        return arr.astype(object)
    if arr.dtype == object and arr.ndim == 1:
        return _infer_object_column(arr)
    return arr


def _infer_object_column(arr: np.ndarray) -> np.ndarray:
    """Arrow's type inference for a python-object column, then its
    ``to_numpy``: whole ints stay int64 (float64 with NaN for missing
    values), numbers become float64, strings, bytes and booleans with
    missing values stay objects, lists and arrays become a list column."""
    vals = [None if v is None or v is np.ma.masked else v for v in arr]
    present = [v for v in vals if v is not None]
    if not present:
        return _object_array(vals)
    if any(isinstance(v, (list, tuple, np.ndarray)) for v in present):
        return _list_column([None if v is None else v for v in vals])
    missing = len(present) < len(vals)
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return _object_array(vals) if missing else np.asarray(vals, bool)
    if all(isinstance(v, (int, np.integer)) and not isinstance(
            v, (bool, np.bool_)) for v in present):
        if not missing:
            return np.asarray(vals, np.int64)
        return np.asarray([np.nan if v is None else v for v in vals],
                          np.float64)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in present):
        return np.asarray([np.nan if v is None else v for v in vals],
                          np.float64)
    return _object_array(vals)


#: Extension name of the port's Arrow tensor type, and those it reads.
_TENSOR_EXT = "ray_tpu_torch.tensor"
_READ_TENSOR_EXTS = (_TENSOR_EXT, "ray_tpu.tensor")
#: Field metadata key holding the per-row tensor shape (the reference's
#: legacy encoding, read for files written before its extension type).
_SHAPE_META = b"ray_tpu.tensor_shape"

_ARROW_TENSOR_TYPE = None


def _arrow_tensor_type():
    """The Arrow extension type of a fixed-shape tensor column (ref:
    python/ray/air/util/tensor_extensions/arrow.py ArrowTensorType): the
    shape rides in the type and survives parquet, IPC and exchange. Built
    and registered on first use, since pyarrow is optional."""
    global _ARROW_TENSOR_TYPE
    if _ARROW_TENSOR_TYPE is not None:
        return _ARROW_TENSOR_TYPE
    import json

    import pyarrow as pa

    class ArrowTensorType(pa.ExtensionType):
        """Fixed-shape tensor column type: each row is an ndarray of
        ``shape``; storage is a fixed-size list of the flattened values."""

        EXT_NAME = _TENSOR_EXT

        def __init__(self, shape: Tuple[int, ...], value_type):
            self._shape = tuple(int(s) for s in shape)
            size = 1
            for s in self._shape:
                size *= s
            super().__init__(pa.list_(value_type, size), self.EXT_NAME)

        @property
        def shape(self) -> Tuple[int, ...]:
            return self._shape

        @property
        def value_type(self):
            return self.storage_type.value_type

        def __arrow_ext_serialize__(self) -> bytes:
            return json.dumps(list(self._shape)).encode()

        @classmethod
        def __arrow_ext_deserialize__(cls, storage_type, serialized):
            return cls(tuple(json.loads(serialized.decode())),
                       storage_type.value_type)

        @classmethod
        def from_numpy(cls, arr: np.ndarray):
            # Explicit row width: reshape(len, -1) fails on zero rows.
            width = int(np.prod(arr.shape[1:], dtype=np.int64))
            flat = np.ascontiguousarray(arr).reshape(len(arr), width)
            storage = pa.FixedSizeListArray.from_arrays(
                pa.array(flat.ravel()), width)
            return pa.ExtensionArray.from_storage(
                cls(arr.shape[1:], storage.type.value_type), storage)

    try:
        pa.register_extension_type(ArrowTensorType((1,), pa.int64()))
    except pa.ArrowKeyError:
        pass  # registered by an earlier copy of this module
    _ARROW_TENSOR_TYPE = ArrowTensorType
    return ArrowTensorType


def __getattr__(name: str):
    if name == "ArrowTensorType":
        return _arrow_tensor_type()
    raise AttributeError(name)


def _arrow_column_to_numpy(col, field) -> np.ndarray:
    """An Arrow column as the reference's ``column_to_numpy`` gives it."""
    import json

    import pyarrow as pa

    typ = col.type
    if isinstance(typ, pa.ExtensionType) and \
            typ.extension_name in _READ_TENSOR_EXTS:
        combined = col.combine_chunks() if hasattr(col, "combine_chunks") \
            else col
        flat = combined.storage.values.to_numpy(zero_copy_only=False)
        return flat.reshape((len(col),) + tuple(typ.shape))
    if isinstance(typ, pa.FixedSizeListType):
        combined = col.combine_chunks() if hasattr(col, "combine_chunks") \
            else col
        flat = combined.values.to_numpy(zero_copy_only=False)
        shape: Tuple[int, ...] = (typ.list_size,)
        meta = (field.metadata or {}) if field is not None else {}
        if meta.get(b"ARROW:extension:name", b"").decode() in \
                _READ_TENSOR_EXTS:
            # A tensor column whose extension type is not registered here.
            shape = tuple(json.loads(meta[b"ARROW:extension:metadata"]))
        elif _SHAPE_META in meta:
            shape = tuple(int(s) for s in meta[_SHAPE_META].decode()
                          .split(","))
        return flat.reshape((len(col),) + shape)
    out = col.to_numpy(zero_copy_only=False)
    return out.astype(object) if out.dtype.kind in "US" else out


def _from_arrow(table) -> Block:
    _arrow_tensor_type()  # reads of the port's tensor columns need it
    return Block({name: _arrow_column_to_numpy(table.column(name),
                                               table.schema.field(name))
                  for name in table.column_names})


def block_to_arrow(block: Block):
    """The block as a ``pyarrow.Table`` (writers, ``batch_format=
    "pyarrow"``): tensor columns as the extension type."""
    import pyarrow as pa

    arrays, fields = [], []
    for name in block.column_names:
        arr = block.column(name)
        if arr.ndim > 1:
            pa_arr = _arrow_tensor_type().from_numpy(arr)
        elif arr.dtype == object:
            pa_arr = pa.array([v.tolist() if isinstance(v, np.ndarray) else v
                               for v in arr])
        else:
            pa_arr = pa.array(arr)
        arrays.append(pa_arr)
        fields.append(pa.field(name, pa_arr.type))
    return pa.table(arrays, schema=pa.schema(fields))


def _readonly(arr: np.ndarray) -> np.ndarray:
    # The reference's batches are zero-copy views of Arrow buffers, which
    # numpy marks read-only: a batch function cannot write into a stored
    # block.
    view = arr.view()
    view.flags.writeable = False
    return view


class BlockAccessor:
    """(ref: data/block.py BlockAccessor)"""

    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        return self.block.num_rows

    def size_bytes(self) -> int:
        return self.block.nbytes

    def schema(self):
        return self.block.schema

    def slice(self, start: int, end: int) -> Block:
        return Block({k: v[start:end] for k, v in self.block._cols.items()})

    def to_batch(self, batch_format: str = "numpy") -> Batch:
        if batch_format in ("numpy", "default"):
            return {name: _readonly(col)
                    for name, col in self.block._cols.items()}
        if batch_format == "pandas":
            import pandas as pd

            return pd.DataFrame({
                name: list(col) if col.ndim > 1 else col
                for name, col in self.block._cols.items()})
        if batch_format == "pyarrow":
            return block_to_arrow(self.block)
        raise ValueError(f"Unknown batch_format: {batch_format}")

    def iter_rows(self) -> Iterable[Dict[str, Any]]:
        cols = self.block._cols
        for i in range(self.block.num_rows):
            yield {k: v[i] for k, v in cols.items()}

    def take(self, indices: List[int]) -> Block:
        idx = np.asarray(indices, dtype=np.int64)
        return Block({k: v[idx] for k, v in self.block._cols.items()})


def column_to_numpy(block: Block, name: str) -> np.ndarray:
    return block.column(name)


def rebatch(block_iter: Iterable[Block], batch_size: Optional[int],
            batch_format: str = "numpy") -> Iterable[Batch]:
    """Re-slice a stream of blocks into exact-size batches (shared by
    Dataset.iter_batches and DataIterator.iter_batches)."""
    carry: List[Block] = []
    carry_rows = 0
    for block in block_iter:
        if block.num_rows == 0:
            continue
        if batch_size is None:
            yield BlockAccessor(block).to_batch(batch_format)
            continue
        carry.append(block)
        carry_rows += block.num_rows
        while carry_rows >= batch_size:
            merged = concat_blocks(carry)
            acc = BlockAccessor(merged)
            yield BlockAccessor(acc.slice(0, batch_size)).to_batch(batch_format)
            rest = acc.slice(batch_size, acc.num_rows())
            carry = [rest] if rest.num_rows > 0 else []
            carry_rows = acc.num_rows() - batch_size
    if carry_rows:
        yield BlockAccessor(concat_blocks(carry)).to_batch(batch_format)


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if b.num_rows > 0]
    if not blocks:
        return Block()
    if len(blocks) == 1:
        return blocks[0]
    names = blocks[0].column_names
    for b in blocks[1:]:
        if b.column_names != names:
            raise ValueError(
                f"cannot concatenate blocks with columns {names} and "
                f"{b.column_names}")
    return Block({n: _concat_column([b.column(n) for b in blocks])
                  for n in names})


def _concat_column(parts: List[np.ndarray]) -> np.ndarray:
    if any(p.dtype == object for p in parts):
        return _object_array([v for p in parts for v in p])
    return np.concatenate(parts)
