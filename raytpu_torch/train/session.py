"""Per-worker training session, the port of :mod:`raytpu.train.session`.

The user loop calls :func:`report` each step or epoch; metrics and an
optional checkpoint flow back to the trainer, which persists checkpoints.
The context carries the worker's ``device`` (``cuda:<local rank>`` or
the CPU) where the JAX one carries its chips' coordinates.

Unlike the JAX session, a report that carries a checkpoint is also
written beside its staged snapshot (:func:`staged_reports` reads them
back), so a trainer whose worker died before it drained the report still
registers that checkpoint and its metrics.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from raytpu_torch.util.profiler import profiling_enabled
from raytpu_torch.util.stepprof import step_profiler


@dataclass
class TrainContext:
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    experiment_name: str = ""
    storage_path: Optional[str] = None
    # The worker's device; None outside a session.
    device: Optional[torch.device] = None

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank


class _Session:
    def __init__(self, context: TrainContext, dataset_shards=None):
        self.context = context
        # Each entry is (metrics, checkpoint-or-None): pairing is preserved
        # so every checkpoint is registered with ITS metrics, and none are
        # lost between polls.
        self.reports: List[tuple] = []
        self.latest_checkpoint = None  # resume-from slot (read at startup)
        self.lock = threading.Lock()
        # Long-poll support: signaled on every report so the trainer's
        # poll blocks instead of spinning.
        self.news = threading.Condition(self.lock)
        self.closed = False  # loop finished/failed: pollers must not block
        self.dataset_shards = dataset_shards or {}

    def report(self, metrics: Dict[str, Any], checkpoint=None):
        # Step attribution: consecutive report() calls bound one step.
        # MFU needs the loop to pass its per-step FLOPs (key "flops" or
        # "step_flops"); without it only the step-time histogram moves.
        if profiling_enabled():
            prof = step_profiler("train")
            dt = prof.mark()
            if dt is not None:
                f = metrics.get("flops") or metrics.get("step_flops")
                prof.observe_step(dt, flops=float(f) if f else None)
                if self.context.device is not None:
                    prof.observe_hbm(self.context.device)
        # Only rank 0's checkpoint is persisted by the trainer (single-
        # controller design) — dropping the others here avoids staging a
        # full copy per worker per report that nobody ever drains.
        if checkpoint is not None and self.context.rank != 0:
            checkpoint = None
        # Snapshot the checkpoint dir SYNCHRONOUSLY before returning:
        # the reference's report() blocks until the checkpoint is
        # persisted, which is what makes the canonical
        # ``with TemporaryDirectory() as d: report(..., Checkpoint(d))``
        # idiom safe. Draining happens later, possibly after `d` is gone.
        if checkpoint is not None and getattr(checkpoint, "path", None):
            import shutil
            import tempfile
            import uuid

            base = self.context.storage_path or tempfile.gettempdir()
            staged = os.path.join(base, ".staged_ckpts", uuid.uuid4().hex)
            os.makedirs(os.path.dirname(staged), exist_ok=True)
            shutil.copytree(checkpoint.path, staged)
            # The report beside its snapshot, written whole (os.replace)
            # after it: a process that dies from here on leaves both.
            with open(staged + ".tmp", "wb") as f:
                pickle.dump((time.monotonic_ns(), dict(metrics)), f)
            os.replace(staged + ".tmp", staged + REPORT_SUFFIX)
            checkpoint = type(checkpoint)(staged)
        with self.lock:
            self.reports.append((dict(metrics), checkpoint))
            self.news.notify_all()

    def wake(self) -> None:
        """The loop finished or failed: mark closed and release pollers.
        The flag is read inside the condition's predicate, so a finish
        landing between a poller's done-check and its wait cannot strand
        the poll for the full timeout (lost-wakeup race)."""
        with self.lock:
            self.closed = True
            self.news.notify_all()

    def drain(self) -> List[tuple]:
        with self.lock:
            out = self.reports
            self.reports = []
            return out

    def wait_for_news(self, timeout: float) -> None:
        """Block until a report lands or the loop closes (or timeout)."""
        with self.lock:
            self.news.wait_for(
                lambda: bool(self.reports) or self.closed, timeout)


REPORT_SUFFIX = ".report"


def staged_reports(storage_path: str) -> List[tuple]:
    """``(metrics, snapshot path)`` of each report whose staged snapshot
    under ``storage_path`` is still there (registering one moves it
    away), oldest first."""
    root = os.path.join(storage_path, ".staged_ckpts")
    found = []
    for name in os.listdir(root) if os.path.isdir(root) else ():
        path = os.path.join(root, name[:-len(REPORT_SUFFIX)])
        if not name.endswith(REPORT_SUFFIX) or not os.path.isdir(path):
            continue
        with open(os.path.join(root, name), "rb") as f:
            stamp, metrics = pickle.load(f)
        found.append((stamp, metrics, path))
    return [(m, path) for _, m, path in sorted(found, key=lambda e: e[0])]


_tls = threading.local()


def _set_session(s: Optional[_Session]):
    _tls.session = s


def _get_session() -> Optional[_Session]:
    return getattr(_tls, "session", None)


def report(metrics: Dict[str, Any], checkpoint=None) -> None:
    """Report metrics (+ optional checkpoint) from inside the training loop
    (reference: ``train.report``). The metrics cross to the trainer by
    pickle: plain values and numpy arrays, not CUDA tensors."""
    s = _get_session()
    if s is None:
        raise RuntimeError("report() called outside a training session")
    s.report(metrics, checkpoint)


def get_context() -> TrainContext:
    s = _get_session()
    if s is None:
        return TrainContext()
    return s.context


def get_checkpoint():
    """Checkpoint to resume from, if the trainer restored one."""
    s = _get_session()
    return s.latest_checkpoint if s else None


def get_dataset_shard(name: str = "train"):
    """This worker's data shard (reference: ``session.get_dataset_shard``
    backed by ``streaming_split``): for a :class:`raytpu_torch.data.Dataset`,
    the :class:`~raytpu_torch.data.DataIterator` of this rank's split
    (``iter_batches``, ``iter_rows``, ``iter_torch_batches``), which pulls
    its blocks from the coordinator process."""
    s = _get_session()
    if s is None or name not in s.dataset_shards:
        raise KeyError(
            f"no dataset shard {name!r}; pass datasets={{'{name}': ds}} to "
            "the trainer")
    return s.dataset_shards[name]
