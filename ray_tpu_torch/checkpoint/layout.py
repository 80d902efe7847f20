"""On-disk layout + shard format for the distributed checkpoint subsystem
(the counterpart of ``ray_tpu/checkpoint/layout.py``; the same files,
fields and names).

Layout of one checkpoint step under a storage root::

    root/
      checkpoint_000042.tmp/            # phase 1: shards write here
        shard_00000/
          leaves.npz                    # this shard's leaf slices
          skeleton.json | skeleton.pkl  # tree structure (shard 0 only)
          MANIFEST.json                 # per-shard manifest
        shard_00001/ ...
      checkpoint_000042/                # phase 2: atomic rename = commit
        ... same files ...
        MANIFEST.json                   # global manifest (coordinator)
        COMMIT                          # commit marker (written pre-rename)

The *commit point* is the directory rename: the coordinator writes the
global manifest and the ``COMMIT`` marker inside the ``.tmp`` directory,
fsyncs, then ``os.replace``s it to the final name.  A reader therefore
never sees a partially written checkpoint under a committed name, and a
crash at any point leaves either the previous committed step intact or a
``.tmp`` directory that restore ignores.  ``is_committed_dir`` requires
BOTH the final name and the marker.

Leaf partitioning is deterministic from (tree, world_size): leaves whose
axis-0 extent divides evenly across the world are split along axis 0, one
slice per shard; everything else is "replicated" and written by shard 0
only.  The skeleton records the choice, so restore reassembles full host
arrays from any number of shard files — restore at another world size.

A plain dict's keys are stored sorted, as JAX orders them (restore
returns them so; ``restore_pytree`` with a template gives the template's
order). Leaves: a tensor leaf must already be on the host (``writer.
snapshot_to_host`` puts it there) and is written as its numpy array; a
bfloat16 leaf, which numpy has no type for, as its 16-bit patterns
(``uint16``) under ``"dtype": "bfloat16"`` — the reference writes the
same bytes (as ``|V2``). ``assemble_tree`` returns torch tensors on the
host and views bfloat16 leaves back bit for bit, whichever of the two
wrote them, so a checkpoint of numpy-native dtypes reads in either
package. Plain dict/list/tuple trees take the JSON skeleton; other nodes
(namedtuples, registered dataclasses) go through ``torch.utils._pytree``,
and ``skeleton.pkl`` holds the tree pickled with its leaves replaced by
markers (the reference pickles a JAX treedef there).
"""

from __future__ import annotations

import json
import os
import pickle
import re
import struct
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

COMMIT_MARKER = "COMMIT"
GLOBAL_MANIFEST = "MANIFEST.json"
SHARD_MANIFEST = "MANIFEST.json"
TMP_SUFFIX = ".tmp"
#: The leaf dtype numpy lacks; stored as its bits.
BF16 = "bfloat16"

_STEP_RE = re.compile(r"^checkpoint_(\d{6,})$")


def step_dirname(step: int) -> str:
    return f"checkpoint_{step:06d}"


def shard_dirname(shard_id: int) -> str:
    return f"shard_{shard_id:05d}"


def tmp_dir(root: str, step: int) -> str:
    return os.path.join(root, step_dirname(step) + TMP_SUFFIX)


def final_dir(root: str, step: int) -> str:
    return os.path.join(root, step_dirname(step))


def parse_step(dirname: str) -> Optional[int]:
    m = _STEP_RE.match(dirname)
    return int(m.group(1)) if m else None


def is_committed_dir(path: str) -> bool:
    """Committed = final (non-.tmp) name AND the COMMIT marker exists."""
    name = os.path.basename(os.path.normpath(path))
    if parse_step(name) is None:
        return False
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def list_committed_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        step = parse_step(name)
        if step is None:
            continue
        if os.path.exists(os.path.join(root, name, COMMIT_MARKER)):
            steps.append(step)
    return sorted(steps)


def latest_committed_step(root: str) -> Optional[int]:
    steps = list_committed_steps(root)
    return steps[-1] if steps else None


def list_stale_tmp_dirs(root: str) -> List[str]:
    """Leftover ``checkpoint_*.tmp`` dirs (crashed/aborted saves)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.endswith(TMP_SUFFIX) and parse_step(name[: -len(TMP_SUFFIX)]) is not None:
            out.append(os.path.join(root, name))
    return sorted(out)


def fsync_dir(path: str) -> None:
    """fsync a directory entry so a rename survives power loss (best
    effort — some filesystems refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# --------------------------------------------------------------- skeleton

def _encode_json(node: Any, leaves: List[Any]):
    """JSON skeleton for plain containers; raises TypeError on anything
    fancier (namedtuples, dataclasses, custom pytree nodes) so the caller
    falls back to the pickle skeleton."""
    if isinstance(node, dict):
        if type(node) is not dict or not all(isinstance(k, str) for k in node):
            raise TypeError("non-plain dict")
        # Sorted, as JAX flattens a dict (the reference's snapshot returns
        # its dicts so): the same tree gives the same skeleton and leaf
        # order in either package.
        keys = sorted(node)
        return {"t": "d", "k": keys,
                "v": [_encode_json(node[k], leaves) for k in keys]}
    if type(node) is list:
        return {"t": "l", "v": [_encode_json(v, leaves) for v in node]}
    if type(node) is tuple:
        return {"t": "t", "v": [_encode_json(v, leaves) for v in node]}
    if isinstance(node, (list, tuple)):
        # Container *subclass* (namedtuple and the like): not a leaf —
        # force the pickle path.
        raise TypeError("container subclass")
    i = len(leaves)
    leaves.append(node)
    return {"t": "x", "i": i}


def _decode_json(node: dict, leaves: List[Any]):
    t = node["t"]
    if t == "d":
        return {k: _decode_json(v, leaves) for k, v in zip(node["k"], node["v"])}
    if t == "l":
        return [_decode_json(v, leaves) for v in node["v"]]
    if t == "t":
        return tuple(_decode_json(v, leaves) for v in node["v"])
    return leaves[node["i"]]


class _LeafMarker:
    """Placeholder leaf inside the pickle-fallback skeleton."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def flatten_tree(tree: Any) -> Tuple[Any, List[Any], str]:
    """-> (skeleton_obj, leaves, kind) where kind is 'json' or 'pkl'.

    The json path covers plain dict/list/tuple trees; everything else
    goes through torch's pytree registry: the pickled skeleton is the tree
    with each leaf replaced by a ``_LeafMarker``."""
    leaves: List[Any] = []
    try:
        skeleton = _encode_json(tree, leaves)
        return skeleton, leaves, "json"
    except TypeError:
        pass
    from torch.utils import _pytree

    leaves, spec = _pytree.tree_flatten(tree)
    marked = _pytree.tree_unflatten(
        [_LeafMarker(i) for i in range(len(leaves))], spec)
    return pickle.dumps(marked), leaves, "pkl"


def unflatten_tree(skeleton: Any, kind: str, leaves: List[Any]) -> Any:
    if kind == "json":
        return _decode_json(skeleton, leaves)
    from torch.utils import _pytree

    return _pytree.tree_map(lambda m: leaves[m.i], pickle.loads(skeleton))


# ------------------------------------------------------------------ leaves

def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """-> (numpy array to store, dtype name for the leaf's meta). A tensor
    must be on the host; a bfloat16 one is stored as its bits."""
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise ValueError(
                f"checkpoint leaf on {leaf.device}: snapshot the tree to "
                "the host first (writer.snapshot_to_host)")
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _leaf_out(a: np.ndarray, meta: dict, fresh: bool) -> Any:
    """A stored array as the restored leaf: a torch tensor on the host
    (bfloat16 from its bits, ``uint16`` or the reference's ``|V2``); a
    dtype torch has no type for (strings) stays numpy. ``fresh``: ``a``
    was made for this restore; else (a replica payload's array) the leaf
    gets its own copy, so that updating it in place leaves the replica
    whole."""
    import torch

    if not fresh or not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
    if meta["dtype"] == BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(a)
    except TypeError:
        return a


# ----------------------------------------------------------- partitioning

def partition_for(shape: Tuple[int, ...], world_size: int) -> Dict[str, Any]:
    """Deterministic leaf partition: split axis 0 across shards when it
    divides evenly, else replicate (shard 0 owns the write)."""
    if world_size > 1 and len(shape) >= 1 and shape[0] >= world_size \
            and shape[0] % world_size == 0:
        return {"kind": "sharded", "axis": 0, "count": world_size}
    return {"kind": "replicated", "owner": 0}


def build_shard(host_tree: Any, shard_id: int, world_size: int):
    """Split a *host* tree into this shard's piece.

    Returns (skeleton_doc, skeleton, kind, arrays) where arrays maps
    ``leaf_<i>`` to the numpy slice this shard owns (possibly none for
    replicated leaves on shard_id > 0), and skeleton_doc fully describes
    the tree + global leaf metadata (identical on every shard — only
    shard 0 writes it).
    """
    skeleton, leaves, kind = flatten_tree(host_tree)
    leaf_meta = []
    arrays: Dict[str, np.ndarray] = {}
    for i, leaf in enumerate(leaves):
        if leaf is None:
            # np.asarray(None) is an object array that npz would *pickle*
            # — the save would commit but allow_pickle=False restore could
            # never load it. Inline it in the skeleton doc instead.
            leaf_meta.append({"dtype": "none", "shape": [],
                              "partition": {"kind": "inline", "value": None}})
            continue
        a, dtype = _host_array(leaf)
        if a.dtype == object:
            raise TypeError(
                f"checkpoint leaf {i} ({type(leaf).__name__}) is not "
                "numeric/string data: saving it would pickle an object "
                "array that restore (allow_pickle=False) can never load — "
                "a committed-but-unrestorable checkpoint. Convert the leaf "
                "to an array or drop it from the checkpointed tree.")
        part = partition_for(a.shape, world_size)
        leaf_meta.append({"dtype": dtype, "shape": list(a.shape),
                          "partition": part})
        if part["kind"] == "sharded":
            rows = a.shape[0] // part["count"]
            arrays[f"leaf_{i}"] = a[shard_id * rows:(shard_id + 1) * rows]
        elif shard_id == part["owner"]:
            arrays[f"leaf_{i}"] = a
    doc = {"format": 1, "world_size": world_size, "kind": kind,
           "num_leaves": len(leaves), "leaves": leaf_meta}
    if kind == "json":
        doc["skeleton"] = skeleton
    return doc, skeleton, kind, arrays


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> int:
    """``np.savez``'s file, made durable: a stored zip with one ``.npy``
    entry per array, each array's bytes written straight from its own
    memory (the reference builds the whole file in memory first). The
    writes and their checksums run outside the interpreter lock, so the
    training thread beside a persist keeps it. Returns the file's CRC-32
    (the manifest's ``crc32``), built from the entries' CRCs that the zip
    writer computed as it wrote: the data is not read twice."""
    from numpy.lib import format as npy

    with open(path, "w+b") as f:
        with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for key, a in arrays.items():
                a = np.asarray(a)
                if not (a.flags.c_contiguous or a.flags.f_contiguous):
                    a = a.copy(order="C")
                with zf.open(key + ".npy", mode="w", force_zip64=True) as fid:
                    header = npy.header_data_from_array_1_0(a)
                    npy.write_array_header_1_0(fid, header)
                    if a.size:  # in the order the header names, as numpy
                        flat = a.T if header["fortran_order"] else a
                        fid.write(flat.reshape(-1).view(np.uint8))
            infos = zf.infolist()
        f.flush()
        crc = _stored_zip_crc32(f.fileno(), infos)
        os.fsync(f.fileno())
    return crc


def _stored_zip_crc32(fd: int, infos: List[zipfile.ZipInfo]) -> int:
    """The CRC-32 of a whole stored zip file: the bytes around the entries'
    data (local headers, the central directory) are read and checksummed,
    and each entry's data comes in through its own CRC by
    ``_crc32_combine``."""
    crc, pos = 0, 0
    for info in sorted(infos, key=lambda i: i.header_offset):
        names, extra = struct.unpack(
            "<HH", os.pread(fd, 4, info.header_offset + 26))
        start = info.header_offset + 30 + names + extra
        crc = zlib.crc32(os.pread(fd, start - pos, pos), crc)
        crc = _crc32_combine(crc, info.CRC, info.compress_size)
        pos = start + info.compress_size
    tail = os.fstat(fd).st_size - pos
    return zlib.crc32(os.pread(fd, tail, pos), crc) & 0xFFFFFFFF


# zlib's ``crc32_combine``, which Python's zlib does not expose.
#: CRC-32's polynomial, bit-reflected.
_POLY = 0xEDB88320


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the CRC polynomial (bit 31 is x^0); a is not 0."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1


#: x^(2^k) modulo the polynomial, for k = 0..31.
_X2N = [1 << 30]
for _ in range(31):
    _X2N.append(_multmodp(_X2N[-1], _X2N[-1]))


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC-32 of A + B from crc1 = crc(A), crc2 = crc(B) and len(B)."""
    p, k = 1 << 31, 3  # x^(8 len2): each byte shifts crc1 by x^8
    while len2:
        if len2 & 1:
            p = _multmodp(_X2N[k & 31], p)
        len2 >>= 1
        k += 1
    return _multmodp(p, crc1) ^ crc2


def write_shard(step_dir: str, shard_id: int, doc: dict, skeleton: Any,
                kind: str, arrays: Dict[str, np.ndarray], step: int,
                extra_manifest: Optional[dict] = None) -> dict:
    """Write one shard's files under ``step_dir`` and return its manifest."""
    sdir = os.path.join(step_dir, shard_dirname(shard_id))
    os.makedirs(sdir, exist_ok=True)
    npz_path = os.path.join(sdir, "leaves.npz")
    crc = _write_npz(npz_path + ".tmp", arrays)
    os.replace(npz_path + ".tmp", npz_path)
    total = os.path.getsize(npz_path)
    if shard_id == 0:
        if kind == "json":
            atomic_write_json(os.path.join(sdir, "skeleton.json"), doc)
        else:
            with open(os.path.join(sdir, "skeleton.pkl"), "wb") as f:
                pickle.dump({"doc": dict(doc), "treedef": skeleton}, f)
                f.flush()
                os.fsync(f.fileno())
            total += os.path.getsize(os.path.join(sdir, "skeleton.pkl"))
    manifest = {
        "step": step,
        "shard_id": shard_id,
        "world_size": doc["world_size"],
        "arrays": sorted(arrays.keys()),
        "bytes": total,
        "crc32": crc,
    }
    if extra_manifest:
        manifest.update(extra_manifest)
    atomic_write_json(os.path.join(sdir, SHARD_MANIFEST), manifest)
    return manifest


def commit_step_dir(root: str, step: int, shard_manifests: Dict[int, dict],
                    extra: Optional[dict] = None) -> str:
    """Phase 2: global manifest + COMMIT marker inside the tmp dir, fsync,
    then the atomic rename that IS the commit point.  Returns the final
    committed path."""
    import time as _time

    tmp = tmp_dir(root, step)
    final = final_dir(root, step)
    manifest = {
        "step": step,
        "num_shards": len(shard_manifests),
        "shards": {str(sid): m for sid, m in sorted(shard_manifests.items())},
        "total_bytes": sum(m.get("bytes", 0) for m in shard_manifests.values()),
        "time": _time.time(),
    }
    if extra:
        manifest.update(extra)
    atomic_write_json(os.path.join(tmp, GLOBAL_MANIFEST), manifest)
    atomic_write_json(os.path.join(tmp, COMMIT_MARKER), {
        "step": step, "num_shards": len(shard_manifests),
        "time": manifest["time"]})
    fsync_dir(tmp)
    if os.path.isdir(final):
        # A same-step committed dir already exists (re-commit after a
        # partial retention race); replace it via a sibling swap.
        import shutil

        trash = final + ".old"
        shutil.rmtree(trash, ignore_errors=True)
        os.replace(final, trash)
        os.replace(tmp, final)
        shutil.rmtree(trash, ignore_errors=True)
    else:
        os.replace(tmp, final)
    fsync_dir(root)
    return final


def write_committed_from_payloads(root: str, step: int,
                                  payloads: Dict[int, dict]) -> str:
    """Materialize a committed checkpoint dir from in-memory replica
    payloads (peers hand back their shard payloads and a committed step
    is rebuilt locally without touching the original storage)."""
    import shutil

    tmp = tmp_dir(root, step)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    manifests = {}
    for sid, p in payloads.items():
        manifests[sid] = write_shard(tmp, sid, p["doc"], p["skeleton"],
                                     p["kind"], p["arrays"], step)
    return commit_step_dir(root, step, manifests, extra={"source": "replica"})


def _assemble(doc: dict, skeleton: Any, kind: str, shard_data,
              fresh) -> Any:
    """``fresh(sid)``: shard ``sid``'s arrays are read anew (from disk)."""
    leaves: List[Any] = []
    for i, meta in enumerate(doc["leaves"]):
        key = f"leaf_{i}"
        part = meta["partition"]
        if part["kind"] == "inline":
            leaves.append(part.get("value"))
            continue
        if part["kind"] == "sharded":
            a = np.concatenate([np.asarray(shard_data(s)[key])
                                for s in range(part["count"])],
                               axis=part["axis"])
            new = True
        else:
            owner = part.get("owner", 0)
            a, new = np.asarray(shard_data(owner)[key]), fresh(owner)
        leaves.append(_leaf_out(a, meta, new))
    return unflatten_tree(skeleton, kind, leaves)


def assemble_from_payloads(payloads: Dict[int, dict]) -> Any:
    """Reassemble the full host tree purely from in-memory replica
    payloads — no disk involved."""
    p0 = payloads[0]
    return _assemble(p0["doc"], p0["skeleton"], p0["kind"],
                     lambda sid: payloads[sid]["arrays"], lambda sid: False)


def read_skeleton(step_dir: str) -> Tuple[dict, Any, str]:
    """-> (doc, skeleton, kind) from shard 0."""
    sdir = os.path.join(step_dir, shard_dirname(0))
    jpath = os.path.join(sdir, "skeleton.json")
    if os.path.exists(jpath):
        with open(jpath) as f:
            doc = json.load(f)
        return doc, doc["skeleton"], "json"
    with open(os.path.join(sdir, "skeleton.pkl"), "rb") as f:
        payload = pickle.load(f)
    return payload["doc"], payload["treedef"], "pkl"


def assemble_tree(step_dir: str,
                  shard_arrays: Optional[Dict[int, Dict[str, np.ndarray]]] = None) -> Any:
    """Reassemble the full host tree from a checkpoint step directory.

    ``shard_arrays`` (shard_id -> {leaf_i: array}) lets the in-memory
    replica tier bypass disk: any shard present there is used as-is and
    its files are never opened.
    """
    doc, skeleton, kind = read_skeleton(step_dir)
    shard_arrays = shard_arrays or {}
    opened: Dict[int, Any] = {}

    def shard_data(sid: int):
        if sid in shard_arrays:
            return shard_arrays[sid]
        if sid not in opened:
            opened[sid] = np.load(
                os.path.join(step_dir, shard_dirname(sid), "leaves.npz"))
        return opened[sid]

    try:
        return _assemble(doc, skeleton, kind, shard_data,
                         lambda sid: sid not in shard_arrays)
    finally:
        for z in opened.values():
            try:
                z.close()
            except Exception:
                pass
