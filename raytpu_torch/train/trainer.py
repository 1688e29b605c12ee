"""DataParallelTrainer, the port of :mod:`raytpu.train.trainer`: a gang
of worker processes on :mod:`raytpu_torch.runtime`, one process group
over them, the user's loop in each.

``fit`` keeps the JAX loop: the run directory, the
:class:`CheckpointManager`, gang attempts under
``FailureConfig.max_failures``, each restarting the whole gang from the
latest registered checkpoint, and ``datasets`` split per worker by a
duck-typed ``streaming_split``. Each gang is torn down in ``finally``: no
worker process outlives ``fit``.

The gang:

- **Workers.** One :class:`TrainWorker` process a rank, on ``cuda:<rank>``
  (one card each; the ranks are local) or on the CPU.
- **Rendezvous.** The port's runtime has no named actors, so there is no
  ``_RendezvousStore``: rank 0's worker binds a free port on this host
  and returns ``host:port`` from a call, and the driver hands it to every
  rank's ``setup_distributed``. Each gang incarnation takes a fresh
  address. ``setup_distributed`` forms the group as the JAX package's
  ``_init_torch_pg`` does (``init_process_group`` over ``tcp://``, with
  rank, world size and a 1800 s timeout), on NCCL on the card (after
  ``torch.cuda.set_device``) and gloo on the CPU, then runs one
  all-reduce so that a group that cannot form fails here. It never falls
  back from NCCL to gloo.
- **The loop** runs in a thread of the worker; ``start`` returns at once,
  and the driver long-polls rank 0 (``poll(0.5)``) and polls the others
  (``poll(0.0)``), each call in order on its handle.
- **Failure.** A :class:`TaskError` from the loop, or any error of the
  runtime from a call (:class:`ActorDiedError` when a worker process
  died, :class:`GetTimeoutError` when it stopped answering), fails the
  gang; ``fit`` restarts it while attempts remain. Reports with a
  checkpoint that the dead gang made but the trainer had not drained are
  read back from their staged snapshots and registered first (the JAX
  trainer loses them, so a restart resumed from an older checkpoint).

The loop crosses to the workers by pickle, by name: it must be a
module-level function (a closure or lambda does not pickle; ``fit``
refuses one at once, naming it), and a script that calls ``fit`` keeps
its entry point under ``if __name__ == "__main__"``. The same holds for
``train_loop_config`` and the datasets.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import socket
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import torch

from raytpu_torch import resolve_device, runtime
from raytpu_torch.cluster import constants
from raytpu_torch.core.errors import RayTpuError, TaskError
from raytpu_torch.train import session as session_mod
from raytpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from raytpu_torch.train.config import (Result, RunConfig, ScalingConfig,
                                       check_cards)

# How long the driver waits for any one call on the gang (a worker's
# start-up and the rendezvous included) before the gang counts as failed.
GANG_CALL_TIMEOUT_S = 300.0
# Rank 0's long poll, and the pause between poll rounds (a loop reporting
# hundreds of times a second must not drive a round a report).
POLL_WAIT_S = 0.5
POLL_PACE_S = 0.05


class TrainWorker:
    """One gang member: hosts the user loop in a thread, and a session."""

    def __init__(self, rank: int, world_size: int, context_kwargs: dict,
                 device: str):
        self.rank = rank
        self.world_size = world_size
        dev = resolve_device("cpu" if device == "cpu" else f"cuda:{rank}")
        self.context = session_mod.TrainContext(
            rank=rank, world_size=world_size, local_rank=rank, device=dev,
            **context_kwargs)
        self.session = None
        self.thread = None
        self.error = None
        self.done = False

    @staticmethod
    def rendezvous_address() -> str:
        """A free port on this host, for rank 0 to serve the group's
        store on."""
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return f"127.0.0.1:{s.getsockname()[1]}"

    def setup_distributed(self, address: str, backend: str) -> bool:
        import torch.distributed as dist

        dev = self.context.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://{address}", rank=self.rank,
            world_size=self.world_size,
            timeout=datetime.timedelta(
                seconds=constants.TORCH_PG_TIMEOUT_S))
        dist.all_reduce(torch.ones(1, device=dev))
        return True

    def start(self, train_fn: Callable[[dict], None], config: dict,
              dataset_shards=None, resume_path=None) -> bool:
        self.session = session_mod._Session(self.context, dataset_shards)
        if resume_path:
            self.session.latest_checkpoint = Checkpoint(resume_path)

        def run():
            session_mod._set_session(self.session)
            try:
                train_fn(config)
            except BaseException as e:  # noqa: BLE001  reported by poll
                self.error = e
            finally:
                self.done = True
                session_mod._set_session(None)
                self.session.wake()  # unblock any in-flight long-poll

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        return True

    def poll(self, max_wait: float = 0.0):
        """Returns ([(metrics, ckpt_path_or_None), ...], done, error_repr).

        ``max_wait > 0`` long-polls: blocks until a report lands, the
        loop finishes, or the timeout passes.

        `done` is read BEFORE draining: if the loop finishes between the
        drain and the flag read, the final reports are still picked up on
        the trainer's next (guaranteed, because done was False) poll."""
        if max_wait > 0 and self.session and not self.done \
                and self.error is None:
            self.session.wait_for_news(max_wait)
        done = self.done
        pairs = self.session.drain() if self.session else []
        out = [(m, (c.path if c is not None else None)) for m, c in pairs]
        err = None
        if self.error is not None:
            err = "".join(traceback.format_exception(
                type(self.error), self.error, self.error.__traceback__))
        return out, done, err


class BaseTrainer:
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        raise NotImplementedError


def _check_pickles(fn) -> None:
    try:
        pickle.dumps(fn)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        raise ValueError(
            f"train_loop_per_worker {getattr(fn, '__qualname__', fn)!r} "
            f"does not pickle, so the worker processes cannot load it; "
            f"define it at a module's top level (not as a closure or "
            f"lambda)") from exc


class DataParallelTrainer(BaseTrainer):
    """Data-parallel trainer over a gang of worker processes.

    ``train_loop_per_worker(config)`` runs on every gang member; inside
    it use :func:`raytpu_torch.train.report`, ``get_context`` (its
    ``device``), ``get_checkpoint``, ``get_dataset_shard`` and
    :func:`raytpu_torch.train.prepare_model`.
    """

    def __init__(self, train_loop_per_worker: Callable[[dict], None], *,
                 train_loop_config: Optional[dict] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.datasets = datasets or {}

    def fit(self) -> Result:
        sc = self.scaling_config
        rc = self.run_config
        check_cards(sc)
        _check_pickles(self.train_loop_per_worker)
        name = rc.name or f"raytpu-train-{int(time.time())}"
        storage = rc.storage_path or os.path.join(
            tempfile.gettempdir(), "raytpu_results")
        run_dir = os.path.join(storage, name)
        os.makedirs(run_dir, exist_ok=True)
        manager = CheckpointManager(
            os.path.join(run_dir, "checkpoints"),
            num_to_keep=rc.checkpoint_config.num_to_keep,
            score_attribute=rc.checkpoint_config.checkpoint_score_attribute,
            score_order=rc.checkpoint_config.checkpoint_score_order,
        )
        attempts = rc.failure_config.max_failures + 1
        last_error = None
        failures = 0
        history: list = []
        try:
            while True:
                result = self._run_gang(sc, name, run_dir, manager)
                # Continuous history across gang incarnations: a resumed
                # run is ONE experiment, not N.
                history.extend(result.metrics_history)
                if result.error is None:
                    return Result(
                        metrics=history[-1] if history else {},
                        metrics_history=history,
                        checkpoint=result.checkpoint,
                        path=run_dir, error=None)
                last_error = result.error
                failures += 1
                if failures >= attempts:
                    break
                # Gang restart from the latest checkpoint; with none
                # registered yet, from where this fit() started.
                self.resume_from_checkpoint = (manager.latest()
                                               or self.resume_from_checkpoint)
            return Result(metrics=history[-1] if history else {},
                          metrics_history=history, checkpoint=None,
                          path=run_dir, error=last_error)
        finally:
            # Staged snapshots that were never registered (failed gangs,
            # undrained reports) are garbage once fit() returns.
            shutil.rmtree(os.path.join(run_dir, ".staged_ckpts"),
                          ignore_errors=True)

    # -- internals ------------------------------------------------------------

    def _run_gang(self, sc: ScalingConfig, name: str, run_dir: str,
                  manager: CheckpointManager) -> Result:
        n = sc.num_workers
        workers = []
        history = []
        last_ckpt = None
        try:
            shards = _split_datasets(self.datasets, n)
            worker_cls = runtime.remote(TrainWorker).options(
                num_cpus=sc.cpus_per_worker)
            ctx_kwargs = {"experiment_name": name, "storage_path": run_dir}
            workers = [worker_cls.remote(rank, n, ctx_kwargs, sc.device)
                       for rank in range(n)]
            address = runtime.get(workers[0].rendezvous_address.remote(),
                                  timeout=GANG_CALL_TIMEOUT_S)
            runtime.get([w.setup_distributed.remote(address, sc.backend)
                         for w in workers], timeout=GANG_CALL_TIMEOUT_S)
            resume = (self.resume_from_checkpoint.path
                      if self.resume_from_checkpoint is not None else None)
            runtime.get([
                w.start.remote(self.train_loop_per_worker,
                               self.train_loop_config, shards[i], resume)
                for i, w in enumerate(workers)], timeout=GANG_CALL_TIMEOUT_S)

            error = None
            while True:
                # Long-poll rank 0 (it drives metrics/checkpoints); other
                # ranks answer at once.
                polls = runtime.get(
                    [w.poll.remote(POLL_WAIT_S if i == 0 else 0.0)
                     for i, w in enumerate(workers)],
                    timeout=GANG_CALL_TIMEOUT_S)
                for metrics, ckpt_path in polls[0][0]:  # rank 0 drives
                    history.append(metrics)
                    if ckpt_path:
                        last_ckpt = manager.register(
                            Checkpoint(ckpt_path), metrics)
                errs = [p[2] for p in polls if p[2]]
                if errs:
                    error = TaskError("train_loop_per_worker", errs[0])
                    break
                if all(p[1] for p in polls):
                    break
                time.sleep(POLL_PACE_S)
            return Result(
                metrics=history[-1] if history else {},
                metrics_history=history,
                checkpoint=last_ckpt or manager.latest(),
                path=run_dir,
                error=error,
            )
        except RayTpuError as e:
            # Gang-shaped failure: a member died, stopped answering, or a
            # call on it raised. Surface it as a failed Result so fit()'s
            # FailureConfig loop restarts the whole gang from the latest
            # checkpoint instead of crashing the driver.
            for w in workers:
                runtime.kill(w)  # no worker writes a report from here on
            for metrics, path in session_mod.staged_reports(run_dir):
                history.append(metrics)
                last_ckpt = manager.register(Checkpoint(path), metrics)
            return Result(
                metrics=history[-1] if history else {},
                metrics_history=history,
                checkpoint=last_ckpt or manager.latest(),
                path=run_dir,
                error=e if isinstance(e, TaskError) else TaskError(
                    "train_gang", f"gang failure: {type(e).__name__}: {e}"),
            )
        finally:
            for w in workers:
                runtime.kill(w)


def _split_datasets(datasets: Dict[str, Any], n: int):
    """Per-worker dataset shards via streaming_split (reference:
    ``DataConfig.configure_ingest``)."""
    shards = [dict() for _ in range(n)]
    for key, ds in datasets.items():
        if hasattr(ds, "streaming_split"):
            its = ds.streaming_split(n)
            for i in range(n):
                shards[i][key] = its[i]
        else:
            for i in range(n):
                shards[i][key] = ds
    return shards


# The JAX package's name for its data-parallel trainer.
JaxTrainer = DataParallelTrainer
