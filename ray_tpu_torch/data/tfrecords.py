"""TFRecord datasource — read/write tf.Example files without TensorFlow
(the counterpart of ``ray_tpu/data/tfrecords.py``).

(ref: python/ray/data/read_api.py read_tfrecords + _internal/datasource/
tfrecords_datasource.py — the reference parses tf.train.Example protos out
of TFRecord framing.)  This image has neither tensorflow nor compiled
example protos, so both layers are implemented directly:

* TFRecord framing: ``u64le length | u32le masked-crc32c(length) | data |
  u32le masked-crc32c(data)`` with a table-driven CRC32-Castagnoli —
  files written here are readable by TensorFlow and vice versa.
* tf.train.Example: message classes built at import from the public
  schema (Example/Features/Feature/BytesList/FloatList/Int64List) with
  protobuf dynamic descriptors — wire-compatible with TF's.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

# --------------------------------------------------------------- crc32c
_CRC_TABLE: Optional[List[int]] = None


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


_CRC32C = None


def crc32c(data: bytes) -> int:
    """CRC32-Castagnoli of ``data``: the google_crc32c C extension where the
    host has it (a pure-Python per-byte loop would bottleneck multi-GB
    record I/O), else the table-driven loop above."""
    global _CRC32C
    if _CRC32C is None:
        try:
            import google_crc32c as gcrc

            _CRC32C = lambda b: int(gcrc.value(b))  # noqa: E731
        except ImportError:
            _CRC32C = _crc32c_py
    return _CRC32C(data)


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC (ref: tensorflow record_writer.cc)."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -------------------------------------------------------------- framing
def read_records(path: str, *, verify: bool = True) -> Iterable[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if verify and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"truncated TFRecord data in {path}")
            (data_crc,) = struct.unpack("<I", footer)
            if verify and _masked_crc(data) != data_crc:
                raise ValueError(f"corrupt TFRecord data crc in {path}")
            yield data


def read_records_range(path: str, start: int, end: int, *,
                       verify: bool = True) -> Iterable[bytes]:
    """Records whose HEADER offset lies in ``[start, end)`` — the
    offset-shard read unit (data/ingest/readers.py): disjoint byte ranges
    covering a file read disjoint, exactly-covering record sets, because a
    record belongs to whichever range holds its header byte (its data may
    extend past ``end``; that is fine, the next shard skips it while
    scanning for its own first boundary).

    TFRecord has no index, so a range starting mid-record resyncs by
    scanning forward one byte at a time until a candidate 12-byte header's
    masked length-crc verifies AND the record body's data-crc verifies —
    the double check makes a false sync on record payload bytes a ~2^-64
    event rather than a plausible one."""
    size = os.path.getsize(path)
    end = min(end, size)
    if start >= end:
        return
    with open(path, "rb") as f:
        pos = 0 if start == 0 else _next_frame_offset(f, start, end, size)
        if pos is None:
            return
        f.seek(pos)
        while pos < end:
            header = f.read(12)
            if len(header) < 12:
                if header and pos + len(header) < size:
                    raise ValueError(f"truncated TFRecord header in {path}")
                return
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if verify and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            footer = f.read(4)
            if len(data) < length or len(footer) < 4:
                raise ValueError(f"truncated TFRecord data in {path}")
            (data_crc,) = struct.unpack("<I", footer)
            if verify and _masked_crc(data) != data_crc:
                raise ValueError(f"corrupt TFRecord data crc in {path}")
            yield data
            pos = f.tell()


def _next_frame_offset(f, start: int, limit: int,
                       size: int) -> Optional[int]:
    """First CRC-verified record-header offset in ``[start, limit)``, or
    None when the range holds no header (it was entirely inside a record
    owned by the previous shard).  The scan buffers the candidate range in
    one read — ranges are shard-sized (file/shards_per_file), i.e. already
    chosen to be memory-friendly."""
    f.seek(start)
    buf = f.read(limit - start + 12)
    span = len(buf) - 12
    for off in range(max(span, 0) + 1):
        if start + off >= limit:
            break
        header = buf[off:off + 12]
        if len(header) < 12:
            break
        (length,) = struct.unpack("<Q", header[:8])
        (len_crc,) = struct.unpack("<I", header[8:])
        if _masked_crc(header[:8]) != len_crc:
            continue
        body_end = start + off + 12 + length + 4
        if body_end > size:
            continue
        f.seek(start + off + 12)
        data = f.read(length)
        footer = f.read(4)
        if len(data) < length or len(footer) < 4:
            continue
        (data_crc,) = struct.unpack("<I", footer)
        if _masked_crc(data) == data_crc:
            return start + off
    return None


def write_records(path: str, records: Iterable[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            header = struct.pack("<Q", len(rec))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


# ------------------------------------------------------------ tf.Example
_MSGS: Optional[Dict[str, Any]] = None


def example_messages() -> Dict[str, Any]:
    """tf.train message classes built from the public schema (the same
    dynamic-descriptor route the serve proto interop uses)."""
    global _MSGS
    if _MSGS is not None:
        return _MSGS
    from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

    pool = descriptor_pool.DescriptorPool()
    f = descriptor_pb2.FileDescriptorProto()
    f.name = "ray_tpu_tf_example.proto"
    f.package = "tensorflow"
    f.syntax = "proto3"
    FT = descriptor_pb2.FieldDescriptorProto

    bl = f.message_type.add()
    bl.name = "BytesList"
    fl = bl.field.add()
    fl.name, fl.number, fl.type, fl.label = "value", 1, FT.TYPE_BYTES, 3
    fll = f.message_type.add()
    fll.name = "FloatList"
    fl = fll.field.add()
    fl.name, fl.number, fl.type, fl.label = "value", 1, FT.TYPE_FLOAT, 3
    il = f.message_type.add()
    il.name = "Int64List"
    fl = il.field.add()
    fl.name, fl.number, fl.type, fl.label = "value", 1, FT.TYPE_INT64, 3

    feat = f.message_type.add()
    feat.name = "Feature"
    for fname, num, tname in (("bytes_list", 1, "BytesList"),
                              ("float_list", 2, "FloatList"),
                              ("int64_list", 3, "Int64List")):
        fl = feat.field.add()
        fl.name, fl.number, fl.label = fname, num, 1
        fl.type = FT.TYPE_MESSAGE
        fl.type_name = f".tensorflow.{tname}"
        fl.oneof_index = 0
    feat.oneof_decl.add().name = "kind"

    feats = f.message_type.add()
    feats.name = "Features"
    entry = feats.nested_type.add()  # map<string, Feature> wire form
    entry.name = "FeatureEntry"
    entry.options.map_entry = True
    k = entry.field.add()
    k.name, k.number, k.type, k.label = "key", 1, FT.TYPE_STRING, 1
    v = entry.field.add()
    v.name, v.number, v.label = "value", 2, 1
    v.type = FT.TYPE_MESSAGE
    v.type_name = ".tensorflow.Feature"
    fl = feats.field.add()
    fl.name, fl.number, fl.label = "feature", 1, 3
    fl.type = FT.TYPE_MESSAGE
    fl.type_name = ".tensorflow.Features.FeatureEntry"

    ex = f.message_type.add()
    ex.name = "Example"
    fl = ex.field.add()
    fl.name, fl.number, fl.label = "features", 1, 1
    fl.type = FT.TYPE_MESSAGE
    fl.type_name = ".tensorflow.Features"

    pool.Add(f)

    def cls(name):
        return message_factory.GetMessageClass(
            pool.FindMessageTypeByName(f"tensorflow.{name}"))

    _MSGS = {n: cls(n) for n in ("Example", "Features", "Feature",
                                 "BytesList", "FloatList", "Int64List")}
    return _MSGS


def example_to_row(data: bytes) -> Dict[str, Any]:
    ex = example_messages()["Example"].FromString(data)
    row: Dict[str, Any] = {}
    for key, feature in ex.features.feature.items():
        kind = feature.WhichOneof("kind")
        if kind == "bytes_list":
            vals: List[Any] = list(feature.bytes_list.value)
        elif kind == "float_list":
            vals = list(feature.float_list.value)
        elif kind == "int64_list":
            vals = list(feature.int64_list.value)
        else:
            vals = []
        # Scalar unwrap, like the reference's datasource.
        row[key] = vals[0] if len(vals) == 1 else vals
    return row


def examples_to_block(records: Iterable[bytes]):
    """Parsed examples -> a block.  Columns where any example holds a
    multi-valued (or absent) feature become list columns — variable-
    length features are standard TFRecord usage and must not be funneled
    through a ragged np.asarray (which raises)."""
    from ray_tpu_torch.data.block import (
        Block,
        _infer_object_column,
        _list_column,
        _object_array,
        block_from_rows,
    )

    rows = [example_to_row(rec) for rec in records]
    if not rows:
        return block_from_rows([])
    keys = sorted({k for r in rows for k in r})
    cols = {}
    for key in keys:
        vals = [r.get(key) for r in rows]
        if any(isinstance(v, list) for v in vals):
            cols[key] = _list_column([v if isinstance(v, list)
                                      else ([] if v is None else [v])
                                      for v in vals])
        else:
            cols[key] = _infer_object_column(_object_array(vals))
    return Block(cols)


def row_to_example(row: Dict[str, Any]) -> bytes:
    msgs = example_messages()
    ex = msgs["Example"]()
    for key, value in row.items():
        feature = ex.features.feature[key]
        if value is None:
            # Null cell (e.g. a missing column filled by block_from_rows):
            # an EMPTY feature — reads back as [] (tf.Example has no null).
            feature.SetInParent()
            continue
        vals = value if isinstance(value, (list, tuple, np.ndarray)) \
            else [value]
        vals = list(np.asarray(vals).ravel()) if len(vals) and not isinstance(
            vals[0], (bytes, str)) else list(vals)
        if len(vals) == 0:
            feature.float_list.SetInParent()
        elif isinstance(vals[0], bytes):
            feature.bytes_list.value.extend(vals)
        elif isinstance(vals[0], str):
            feature.bytes_list.value.extend(v.encode() for v in vals)
        elif all(float(v).is_integer() for v in vals) and not any(
                isinstance(v, (float, np.floating)) for v in vals):
            feature.int64_list.value.extend(int(v) for v in vals)
        else:
            feature.float_list.value.extend(float(v) for v in vals)
    return ex.SerializeToString()
