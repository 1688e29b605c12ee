"""Checkpoints, the port of :mod:`raytpu.train.checkpoint`: directory
handles, top-K retention, and a tree of tensors saved with
``torch.distributed.checkpoint`` (DCP) where the JAX package uses orbax.

- :class:`Checkpoint` is a directory handle; ``from_dict``/``to_dict``
  use the standard ``pickle`` (the JAX package's ``cloudpickle`` is not
  on the card's machine), so what they hold is plain data or objects
  importable by name.
- :class:`CheckpointManager` is the JAX package's, as it is: the same
  directory names, ``_metrics.json``, ``best()`` and ``latest()``.
- :func:`save_pytree` and :func:`restore_pytree` take a nested dict (or
  list) of tensors and plain values. Under a process group every rank
  calls them, as every host calls orbax: DCP writes each rank's own part
  (a tensor every rank holds the same is written once), and at world
  size 1, or with no group, one process writes all of it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch


class Checkpoint:
    """A handle to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="raytpu-ckpt-")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def as_directory(self) -> str:
        return self.path

    def __repr__(self):
        return f"Checkpoint({self.path})"


def _group_rank() -> Optional[int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return None


def save_pytree(tree, path: str) -> Checkpoint:
    """Save a nested dict of tensors (and plain values) with DCP; a
    directory already at ``path`` is replaced."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    rank = _group_rank()
    if rank in (None, 0) and os.path.exists(path):
        shutil.rmtree(path)
    if rank is not None:
        dist.barrier()  # no rank writes before the old directory is gone
    dcp.save(tree, checkpoint_id=path)
    return Checkpoint(path)


def restore_pytree(path_or_ckpt, target=None, device=None):
    """Restore a tree saved by :func:`save_pytree`. With ``target`` (a
    tree of the same structure) the tensors load in place and ``target``
    is returned; without it the tree is built from the checkpoint's
    metadata, its tensors on ``device`` (the CPU by default), and a list
    comes back as a dict keyed by index."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = (path_or_ckpt.path if isinstance(path_or_ckpt, Checkpoint)
            else os.path.abspath(path_or_ckpt))
    if target is not None:
        dcp.load(target, checkpoint_id=path)
        return target
    meta = FileSystemReader(path).read_metadata()
    flat = {}
    for fqn, item in meta.state_dict_metadata.items():
        flat[fqn] = (torch.empty(item.size, dtype=item.properties.dtype,
                                 device=device)
                     if isinstance(item, TensorStorageMetadata) else None)
    dcp.load(flat, checkpoint_id=path)
    tree: Dict[Any, Any] = {}
    for fqn, keys in meta.planner_data.items():
        _set_path(tree, keys, flat[fqn])
    return tree


def _set_path(tree: dict, keys, value) -> None:
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


class CheckpointManager:
    """Top-K checkpoint retention (reference:
    ``_internal/checkpoint_manager.py``)."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._entries: List[Tuple[float, int, str]] = []  # (score, idx, path)
        # Continue numbering past any pre-existing checkpoint_NNNNNN dirs
        # (restored experiments): restarting at 0 would overwrite dirs a
        # saved experiment state still references.
        self._counter = 0
        try:
            for name in os.listdir(self.root):
                if name.startswith("checkpoint_"):
                    try:
                        self._counter = max(self._counter,
                                            int(name.split("_")[1]))
                    except (IndexError, ValueError):
                        pass
        except OSError:
            pass

    def register(self, checkpoint: Checkpoint,
                 metrics: Dict[str, Any]) -> Checkpoint:
        """Move the checkpoint into managed storage; evict beyond top-K."""
        self._counter += 1
        dst = os.path.join(self.root, f"checkpoint_{self._counter:06d}")
        src = os.path.abspath(checkpoint.path)
        if src != dst:
            if os.path.exists(dst):
                shutil.rmtree(dst)
            if f"{os.sep}.staged_ckpts{os.sep}" in src:
                # Session-staged snapshot: single-owner, safe to move
                # (avoids a second copy and cleans the staging area).
                shutil.move(src, dst)
            else:
                shutil.copytree(src, dst)
        with open(os.path.join(dst, "_metrics.json"), "w") as f:
            json.dump(_jsonable(metrics), f)
        score = self._score(metrics)
        self._entries.append((score, self._counter, dst))
        self._evict()
        return Checkpoint(dst)

    def best(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        reverse = self.score_order == "max"
        entries = sorted(self._entries, key=lambda e: e[0], reverse=reverse)
        return Checkpoint(entries[0][2])

    def latest(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        return Checkpoint(max(self._entries, key=lambda e: e[1])[2])

    def _score(self, metrics: Dict[str, Any]) -> float:
        if self.score_attribute and self.score_attribute in metrics:
            return float(metrics[self.score_attribute])
        # Recency fallback, sign-adjusted so "more recent ranks better"
        # holds under BOTH score orders.
        return float(self._counter if self.score_order == "max"
                     else -self._counter)

    def _evict(self):
        if self.num_to_keep is None or len(self._entries) <= self.num_to_keep:
            return
        reverse = self.score_order == "max"
        ranked = sorted(self._entries, key=lambda e: e[0], reverse=reverse)
        keep = set(id(e) for e in ranked[: self.num_to_keep])
        # Always keep the latest for resume.
        latest = max(self._entries, key=lambda e: e[1])
        keep.add(id(latest))
        survivors = []
        for e in self._entries:
            if id(e) in keep:
                survivors.append(e)
            else:
                shutil.rmtree(e[2], ignore_errors=True)
        self._entries = survivors


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out
