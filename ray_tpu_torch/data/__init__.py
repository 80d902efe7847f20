"""ray_tpu_torch.data — streaming datasets (the counterpart of
``ray_tpu/data``; ref: python/ray/data/read_api.py).

Blocks are numpy columns (``block.py``); the Parquet, CSV and JSON readers
and writers, ``from_arrow``, ``from_pandas`` and the ``"pyarrow"`` and
``"pandas"`` batch formats import pyarrow or pandas where they run.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, block_from_batch, block_from_rows
from ray_tpu_torch.data.dataset import DataIterator, Dataset
from ray_tpu_torch.data.plan import ActorPoolStrategy, InputData, Read

DEFAULT_BLOCK_ROWS = 1000
_builtin_range = range  # captured before the read API shadows the name


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001
    """(ref: read_api.py:226 range) — column 'id'."""
    if parallelism <= 0:
        parallelism = max(1, min(8, n // DEFAULT_BLOCK_ROWS or 1))
    size = (n + parallelism - 1) // parallelism if n else 0

    def make_task(start: int, end: int):
        def read():
            return Block({"id": np.arange(start, end, dtype=np.int64)})

        return read

    tasks = [make_task(i * size, min((i + 1) * size, n))
             for i in _builtin_range(parallelism) if i * size < n]
    if not tasks:
        tasks = [make_task(0, 0)]
    return Dataset(Read(tasks))


def from_items(items: List[Any]) -> Dataset:
    """(ref: read_api.py from_items)"""
    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    blocks = []
    for start in _builtin_range(0, max(len(rows), 1), DEFAULT_BLOCK_ROWS):
        chunk = rows[start:start + DEFAULT_BLOCK_ROWS]
        if chunk or not blocks:
            blocks.append(block_from_rows(chunk))
    return Dataset(InputData(blocks))


def from_numpy(arr: np.ndarray, column: str = "data") -> Dataset:
    return Dataset(InputData([block_from_batch({column: arr})]))


def from_pandas(df) -> Dataset:
    return Dataset(InputData([block_from_batch(df)]))


def from_arrow(table) -> Dataset:
    return Dataset(InputData([block_from_batch(table)]))


def _expand_paths(paths, suffix: str) -> List[str]:
    """Expand dirs/globs/files into one globally sorted, deduplicated
    list.  Sorting the final list (not per input) makes the read-task
    order — and with it block order, splits and shard claims — a pure
    function of the matched file set: glob order is filesystem-dependent,
    and overlapping inputs (a dir plus a glob into it) must not read a
    file twice."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                f for f in _glob.glob(os.path.join(p, f"*{suffix}"))
                if os.path.isfile(f))
        elif "*" in p:
            out.extend(f for f in _glob.glob(p) if os.path.isfile(f))
        else:
            if not os.path.exists(p):
                raise FileNotFoundError(f"Path does not exist: {p}")
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No files matched {paths}")
    return sorted(dict.fromkeys(out))


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 shards_per_file: int = 1) -> Dataset:
    """(ref: read_api.py:602 read_parquet)

    ``shards_per_file > 1`` splits each file into that many row-group
    ranges (data/ingest/readers.py) — reader parallelism beyond file
    count, clamped to each file's actual row-group count."""
    import pyarrow.parquet as pq

    files = _expand_paths(paths, ".parquet")
    if shards_per_file > 1:
        from ray_tpu_torch.data.ingest.readers import parquet_range_tasks

        tasks = [t for f in files
                 for t in parquet_range_tasks(f, shards_per_file,
                                              columns=columns)]
        return Dataset(Read(tasks))

    def make_task(f: str):
        def read():
            return block_from_batch(pq.read_table(f, columns=columns))

        return read

    return Dataset(Read([make_task(f) for f in files]))


def read_csv(paths) -> Dataset:
    import pyarrow.csv as pacsv

    files = _expand_paths(paths, ".csv")

    def make_task(f: str):
        def read():
            return block_from_batch(pacsv.read_csv(f))

        return read

    return Dataset(Read([make_task(f) for f in files]))


def read_json(paths) -> Dataset:
    import pyarrow.json as pajson

    files = _expand_paths(paths, ".json")

    def make_task(f: str):
        def read():
            return block_from_batch(pajson.read_json(f))

        return read

    return Dataset(Read([make_task(f) for f in files]))


def read_numpy(paths) -> Dataset:
    files = _expand_paths(paths, ".npy")

    def make_task(f: str):
        def read():
            return block_from_batch({"data": np.load(f)})

        return read

    return Dataset(Read([make_task(f) for f in files]))


def _looks_like_tfrecord(path: str) -> bool:
    """Cheap framing sanity check: the first 12-byte header's masked
    length-crc must verify (ref framing in data/tfrecords.py).  A 0-byte
    file is a valid EMPTY TFRecord shard (partitioned writers emit them)."""
    import struct

    from ray_tpu_torch.data.tfrecords import _masked_crc

    try:
        with open(path, "rb") as f:
            header = f.read(12)
    except OSError:
        return False
    if len(header) == 0:
        return True
    if len(header) < 12:
        return False
    (length,) = struct.unpack("<Q", header[:8])
    (len_crc,) = struct.unpack("<I", header[8:])
    return _masked_crc(header[:8]) == len_crc and length < (1 << 40)


def read_tfrecords(paths, *, shards_per_file: int = 1) -> Dataset:
    """tf.train.Example TFRecord files -> one row per example (ref:
    read_api.py read_tfrecords; framing + protos in data/tfrecords.py,
    no TensorFlow dependency).  Directories match ``*.tfrecords`` AND
    TensorFlow's ``*.tfrecord`` convention, falling back to every file in
    the directory (TF shard names often have no extension at all — the
    reference reads all files regardless of suffix).

    ``shards_per_file > 1`` splits each file into that many byte ranges
    resynced at CRC-verified record boundaries (data/ingest/readers.py) —
    one giant shard no longer serializes the pipeline."""
    files: List[str] = []
    for p in ([paths] if isinstance(paths, str) else list(paths)):
        if os.path.isdir(p):
            matched = sorted(
                f for suffix in (".tfrecords", ".tfrecord")
                for f in _glob.glob(os.path.join(p, f"*{suffix}"))
                if os.path.isfile(f))
            if not matched:
                # Extensionless TF shard names: accept only files whose
                # first record header frames correctly — a stray README or
                # _SUCCESS marker otherwise surfaces later as a confusing
                # 'corrupt TFRecord length crc'.
                candidates = sorted(
                    os.path.join(p, f) for f in os.listdir(p)
                    if os.path.isfile(os.path.join(p, f)))
                matched = [f for f in candidates if _looks_like_tfrecord(f)]
                if candidates and not matched:
                    raise FileNotFoundError(
                        f"No *.tfrecord(s) files in {p} and none of its "
                        f"{len(candidates)} files frame as TFRecords "
                        f"(checked first-record length crc)")
                skipped = sorted(set(candidates) - set(matched))
                if skipped:
                    # Surface the skips: a junk marker (_SUCCESS/README) is
                    # expected, but a CORRUPT shard silently dropped here
                    # would be silent data loss.
                    import warnings

                    warnings.warn(
                        f"read_tfrecords: skipping {len(skipped)} file(s) in "
                        f"{p} that don't frame as TFRecords: "
                        f"{[os.path.basename(s) for s in skipped[:5]]}",
                        RuntimeWarning, stacklevel=2)
            files.extend(matched)
        else:
            files.extend(_expand_paths(p, ".tfrecords"))
    files = sorted(dict.fromkeys(files))  # same determinism as _expand_paths
    if not files:
        raise FileNotFoundError(f"No TFRecord files matched: {paths}")

    def make_task(f: str):
        def read():
            from ray_tpu_torch.data.tfrecords import examples_to_block, read_records

            return examples_to_block(read_records(f))

        return read

    if shards_per_file > 1:
        from ray_tpu_torch.data.ingest.readers import tfrecord_range_tasks

        return Dataset(Read([t for f in files
                             for t in tfrecord_range_tasks(
                                 f, shards_per_file)]))
    return Dataset(Read([make_task(f) for f in files]))


def read_text(paths) -> Dataset:
    """One row per line, column 'text' (ref: read_api.py read_text)."""
    files = _expand_paths(paths, ".txt")

    def make_task(f: str):
        def read():
            with open(f, "r", errors="replace") as fh:
                lines = [ln.rstrip("\n") for ln in fh]
            # An object column even when empty: an empty file's block must
            # concatenate with the others.
            return Block({"text": np.asarray(lines, dtype=object)})

        return read

    return Dataset(Read([make_task(f) for f in files]))


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """Column 'bytes' (+ 'path') (ref: read_api.py read_binary_files)."""
    files = _expand_paths(paths, "")

    def make_task(f: str):
        def read():
            with open(f, "rb") as fh:
                data = fh.read()
            cols = {"bytes": np.asarray([data], dtype=object)}
            if include_paths:
                cols["path"] = np.asarray([f], dtype=object)
            return Block(cols)

        return read

    return Dataset(Read([make_task(f) for f in files]))


def read_images(paths, *, size: Optional[tuple] = None,
                mode: str = "RGB",
                include_paths: bool = False) -> Dataset:
    """Column 'image' as HWC uint8 arrays (ref: read_api.py:781 read_images).

    All images are decoded to a single uniform (H, W, C): `mode` (default
    RGB) fixes C; `size=(H, W)` fixes H/W — when omitted, the first file's
    size is the target and other files are resized to it.  Uniformity is
    required for blocks to share a schema (fixed-size tensors batch
    cleanly onto the GPU anyway)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif")
    if isinstance(paths, str) and os.path.isdir(paths):
        files: List[str] = []
        for ext in exts:
            files.extend(sorted(
                f for f in _glob.glob(os.path.join(paths, f"*{ext}"))
                if os.path.isfile(f)))
        if not files:
            raise FileNotFoundError(f"No images under {paths}")
    else:
        files = _expand_paths(paths, "")

    if size is None:
        from PIL import Image

        with Image.open(files[0]) as probe:
            size = (probe.height, probe.width)

    def make_task(f: str):
        def read():
            from PIL import Image

            img = Image.open(f).convert(mode)
            if (img.height, img.width) != size:
                img = img.resize((size[1], size[0]))
            arr = np.asarray(img)
            if arr.ndim == 2:  # single-channel modes ("L"): keep HWC
                arr = arr[..., None]
            batch = {"image": arr[None, ...]}
            if include_paths:
                batch["path"] = np.asarray([f])
            return block_from_batch(batch)

        return read

    return Dataset(Read([make_task(f) for f in files]))


__all__ = [
    "ActorPoolStrategy", "DataIterator", "Dataset", "aggregate", "from_arrow",
    "from_items", "from_numpy", "from_pandas", "preprocessors", "range",
    "read_binary_files", "read_csv", "read_images", "read_json", "read_numpy",
    "read_parquet", "read_text", "read_tfrecords",
]

from ray_tpu_torch.data import aggregate  # noqa: E402  (public submodule)
from ray_tpu_torch.data import preprocessors  # noqa: E402  (public submodule)
