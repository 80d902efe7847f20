"""Checkpoints: directory handles and torch-backed tree persistence (the
counterpart of ``ray_tpu/train/checkpoint.py``).

(ref: python/ray/train/_checkpoint.py:56 Checkpoint — a directory handle
uploaded via pyarrow fs; python/ray/train/_internal/checkpoint_manager.py —
top-K retention.)  Where the reference saves a JAX pytree with orbax, the
port saves a tree of nested dicts, lists and tuples with ``torch.save``:
every tensor leaf is moved to host memory first (a pickled CUDA tensor
would name its device, and a checkpoint saved on ``cuda:0`` could not load
on the CPU), numpy leaves become tensors, and ``torch.load(weights_only=
True)`` reads it back. ``load_pytree(path, template)`` puts each leaf back
on its template leaf's device and dtype.

A committed sharded checkpoint (a ``checkpoint_NNNNNN`` directory with a
``COMMIT`` marker, written by ``ray_tpu_torch.checkpoint``) restores
through that package: one handle type serves both layouts, which is what
lets the Trainer's restarts hand either kind to ``train.get_checkpoint()``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.checkpoint.layout import COMMIT_MARKER, parse_step

#: The file of a saved tree inside its directory.
TREE_FILE = "tree.pt"
#: Temp directories of from_pytree (single-use: register() moves them).
TMP_PREFIX = "ray_tpu_torch_ckpt_"

class Checkpoint:
    """A handle to a checkpoint directory (ref: _checkpoint.py:56)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_pytree(cls, tree: Any, path: Optional[str] = None) -> "Checkpoint":
        """Persist a tree of tensors (and numpy arrays and Python values)."""
        path = path or tempfile.mkdtemp(prefix=TMP_PREFIX)
        save_pytree(tree, os.path.join(path, "pytree"))
        return cls(path)

    def to_pytree(self, template: Optional[Any] = None) -> Any:
        from ray_tpu_torch.checkpoint import is_committed_dir, restore_pytree

        if is_committed_dir(self.path):
            return restore_pytree(self.path, template)
        return load_pytree(os.path.join(self.path, "pytree"), template)

    def as_directory(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            yield self.path

        return ctx()

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, "metadata.json"), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, "metadata.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"


class ReplicaCheckpoint(Checkpoint):
    """A committed step held by its in-memory replicas: ``path`` names the
    step's committed dir on storage (the same bytes), and ``to_pytree``
    assembles the tree from the replica payloads without touching it."""

    def __init__(self, path: str, payloads: Dict[int, dict]):
        super().__init__(path)
        self._payloads = payloads

    def to_pytree(self, template: Optional[Any] = None) -> Any:
        from ray_tpu_torch.checkpoint import restore_from_payloads

        return restore_from_payloads(self._payloads, template)


def _to_host(tree: Any) -> Any:
    import torch

    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray) or isinstance(tree, np.generic):
        return torch.from_numpy(np.array(tree))
    return tree


def _torch_save(tree: Any, path: str) -> None:
    """The raw write (factored out so tests can fail it mid-save)."""
    import torch

    os.makedirs(path)
    torch.save(tree, os.path.join(path, TREE_FILE))


def save_pytree(tree: Any, path: str) -> None:
    """Atomic tree save: write a ``*.tmp`` sibling, then rename into place,
    so a crash mid-save leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):  # stale leftover from a crashed save
        shutil.rmtree(tmp)
    _torch_save(_to_host(tree), tmp)
    if os.path.exists(path):
        # os.replace cannot clobber a non-empty dir: swap via a sibling so
        # there is never a moment with no complete checkpoint on disk.
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)


def _like(loaded: Any, template: Any) -> Any:
    import torch

    if isinstance(template, dict):
        return {k: _like(loaded[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(a, b) for a, b in zip(loaded, template))
    if isinstance(template, torch.Tensor):
        return loaded.to(device=template.device, dtype=template.dtype)
    return loaded


def load_pytree(path: str, template: Optional[Any] = None) -> Any:
    """The saved tree, its tensors on the host; with ``template``, each
    tensor on its template leaf's device and dtype."""
    import torch

    tree = torch.load(os.path.join(os.path.abspath(path), TREE_FILE),
                      map_location="cpu", weights_only=True)
    return tree if template is None else _like(tree, template)


def pack_checkpoint(checkpoint: Optional[Checkpoint]) -> Optional[bytes]:
    """Checkpoint directory -> tar bytes, for shipping by value.

    A process-tier worker reports its checkpoint through the report queue
    (ref: the reference syncs checkpoint dirs through storage_path/pyarrow
    fs — train/_internal/storage.py; an in-band copy is the storage-less
    equivalent). The reference gzips the tar; here it is left
    uncompressed: float weights hardly compress, and gzip would take tens
    of seconds over GPT-2 124M's 1.2 GB of weights and moments."""
    if checkpoint is None:
        return None
    import io
    import tarfile

    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        tar.add(checkpoint.path, arcname=".")
    return buf.getvalue()


def unpack_checkpoint(blob: Optional[bytes],
                      path: Optional[str] = None) -> Optional[Checkpoint]:
    """Inverse of pack_checkpoint: extract into a fresh local directory."""
    if blob is None:
        return None
    import io
    import tarfile

    path = path or tempfile.mkdtemp(prefix=TMP_PREFIX)
    with tarfile.open(fileobj=io.BytesIO(blob), mode="r") as tar:
        tar.extractall(path, filter="data")
    return Checkpoint(path)


class CheckpointManager:
    """Top-K checkpoint retention (ref: _internal/checkpoint_manager.py)."""

    def __init__(self, storage_path: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None, score_order: str = "max"):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._checkpoints: List[Tuple[float, Checkpoint, Dict]] = []
        self._counter = 0
        self._lock = threading.Lock()
        os.makedirs(storage_path, exist_ok=True)
        # Restart-safe: rebuild the registry from what is already on disk,
        # so latest_checkpoint()/best_checkpoint() survive a driver restart.
        self._rescan()

    def _rescan(self) -> None:
        for name in sorted(os.listdir(self.storage_path)):
            path = os.path.join(self.storage_path, name)
            if not os.path.isdir(path) or not name.startswith("checkpoint_") \
                    or name.endswith(".tmp") or name.endswith(".old"):
                continue
            has_shards = any(e.startswith("shard_") for e in os.listdir(path))
            if has_shards and not os.path.exists(os.path.join(path,
                                                              COMMIT_MARKER)):
                continue  # torn sharded save — never register it
            ckpt = Checkpoint(path)
            meta = ckpt.get_metadata()
            idx = meta.get("index")
            if idx is None:
                idx = parse_step(name)
            if idx is None:
                continue
            metrics = meta.get("metrics", {})
            self._checkpoints.append((self._score(metrics, idx), ckpt,
                                      metrics))
            self._counter = max(self._counter, int(idx))

    def _score(self, metrics: Dict[str, Any], index: int) -> float:
        if self.score_attribute and self.score_attribute in metrics:
            return float(metrics[self.score_attribute])
        return float(index)  # recency

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> Checkpoint:
        """Move/copy the checkpoint into managed storage and apply retention."""
        with self._lock:
            while True:
                self._counter += 1
                dest = os.path.join(self.storage_path,
                                    f"checkpoint_{self._counter:06d}")
                # Never clobber a coordinator-committed sharded step that
                # landed after the rescan (the two sides number dirs from
                # independent counters): move the counter past it.
                if not os.path.exists(os.path.join(dest, COMMIT_MARKER)):
                    break
            if os.path.abspath(checkpoint.path) != dest:
                if os.path.exists(dest):
                    shutil.rmtree(dest)
                src = checkpoint.path
                if os.path.basename(src).startswith(TMP_PREFIX) and \
                        src.startswith(tempfile.gettempdir()):
                    # from_pytree tempdirs are single-use: move, don't leak
                    # a model-sized copy in the temp dir per report.
                    shutil.move(src, dest)
                else:
                    shutil.copytree(src, dest)
            managed = Checkpoint(dest)
            managed.update_metadata({"metrics": _json_safe(metrics),
                                     "index": self._counter,
                                     "time": time.time()})
            self._checkpoints.append((self._score(metrics, self._counter),
                                      managed, metrics))
            self._apply_retention()
            return managed

    def _apply_retention(self) -> None:
        if self.num_to_keep is None or len(self._checkpoints) <= self.num_to_keep:
            return
        reverse = self.score_order == "max"
        self._checkpoints.sort(key=lambda t: t[0], reverse=reverse)
        for _, ckpt, _ in self._checkpoints[self.num_to_keep:]:
            # Coordinator-committed sharded dirs are the coordinator's to
            # retire (its own keep= policy): evict from this registry but
            # leave the directory alone.
            if os.path.exists(os.path.join(ckpt.path, COMMIT_MARKER)):
                continue
            shutil.rmtree(ckpt.path, ignore_errors=True)
        self._checkpoints = self._checkpoints[: self.num_to_keep]

    def best_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._checkpoints:
                return None
            reverse = self.score_order == "max"
            return sorted(self._checkpoints, key=lambda t: t[0], reverse=reverse)[0][1]

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._checkpoints:
                return None
            return max(self._checkpoints, key=lambda t: _ckpt_index(t[1]))[1]


def _ckpt_index(ckpt: Checkpoint) -> int:
    """Recency index: metadata wins, else the checkpoint_NNNNNN name."""
    idx = ckpt.get_metadata().get("index")
    if idx is not None:
        return int(idx)
    return parse_step(os.path.basename(os.path.normpath(ckpt.path))) or 0


def _json_safe(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out
