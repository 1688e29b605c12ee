"""Tuner + trial controller, the port of :mod:`raytpu.tune.tuner`.

Reference analogue: ``python/ray/tune/tuner.py:46`` (Tuner),
``tune/execution/tune_controller.py:69`` (the central event loop driving
trial actors), ``tune/trainable/``. Each trial is one
:class:`~raytpu_torch.train.trainer.TrainWorker` process of the port's
runtime (rank 0, world size 1) hosting the user function in Train's
session; the controller polls its reports, feeds the scheduler,
stops/exploits trials, and collects Results. The loop is the JAX
package's, decision for decision: the PBT clone's pinned checkpoint, a
:class:`CheckpointManager` a trial, counters and history rolled back to
the checkpoint on a retry and on :meth:`Tuner.restore`, the sweep of
staged checkpoints after the run, and the throttled experiment state.

What changed:

- **Device.** Trials run on ``cuda:0`` (so every trial shares the one
  card) unless the caller asks for the CPU with
  ``TuneConfig(device="cpu")``. A trial on ``"cuda"`` raises at ``fit``
  when there is no card; the port never moves to the CPU on its own.
  When the trainable is a :class:`DataParallelTrainer`, the trials run
  where its ``ScalingConfig.device`` says (a ``TuneConfig.device`` that
  disagrees raises).
- **Resources.** ``resources_per_trial`` takes ``{"CPU": n}`` only: the
  trial process's torch threads (the runtime's ``num_cpus``). Any other
  key raises ``ValueError`` naming it.
- **Concurrency.** The port has no ``cluster_resources()``; the default
  ``max_concurrent_trials`` is the host's CPU count (``os.cpu_count()``),
  the number of CPUs the JAX package's default ``init`` registers.
- **Pickling.** The trainable crosses to the trial processes, and into
  the experiment state, by the standard ``pickle`` (no ``cloudpickle``),
  so it is a module-level function (or an object that pickles); ``fit``
  refuses one that does not pickle, as ``DataParallelTrainer.fit`` does.
  A searcher or scheduler that does not pickle (one holding closures)
  still runs; its experiment state is written without them, and
  :meth:`Tuner.restore` refuses it, naming why.
- **A trial process that dies** (killed, or out of memory) counts as a
  crashed trial: retried under ``FailureConfig.max_failures`` like one
  that raised, else an error. A script that calls ``fit`` keeps its
  entry point under ``if __name__ == "__main__"``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import shutil
import tempfile
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from raytpu_torch import resolve_device, runtime
from raytpu_torch.core.errors import RayTpuError, TaskError
from raytpu_torch.train import session as session_mod
from raytpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from raytpu_torch.train.config import Result, RunConfig, check_cards
from raytpu_torch.train.trainer import TrainWorker, _check_pickles
from raytpu_torch.tune.schedulers import (
    CONTINUE,
    STOP,
    FIFOScheduler,
    PopulationBasedTraining,
    TrialScheduler,
)
from raytpu_torch.tune.search import BasicVariantGenerator, Searcher

# How long the controller waits for any one call on a trial process (its
# start-up included) before the trial counts as crashed.
TRIAL_CALL_TIMEOUT_S = 300.0
# The pause between poll rounds, and the experiment state's throttle.
POLL_PACE_S = 0.05
SAVE_EVERY_S = 2.0
# What resources_per_trial may set: the runtime's num_cpus.
TRIAL_RESOURCES = ("CPU",)
DEVICES = ("cuda", "cpu")


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Searcher] = None
    resources_per_trial: Optional[Dict[str, float]] = None
    # Where the trials run: None means "cuda" (cuda:0, shared by every
    # trial), or the device of a DataParallelTrainer trainable.
    device: Optional[str] = None


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    state: str = "PENDING"  # PENDING/RUNNING/TERMINATED/ERROR/STOPPED
    last_result: Dict[str, Any] = dataclasses.field(default_factory=dict)
    history: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    actor: Any = None
    error: Optional[str] = None
    checkpoint: Optional[Checkpoint] = None
    iterations: int = 0
    # Iteration count at the latest registered checkpoint — a restored
    # trial resumes THERE, so counters/history roll back to it (reports
    # since the checkpoint will be replayed by the relaunched trial).
    ckpt_iterations: int = 0
    # True when the config came from the searcher (PBT clones don't —
    # the searcher must only see completions for ids it issued).
    from_searcher: bool = False
    # Crash-retry count (reference: FailureConfig.max_failures — a failed
    # trial restarts from its latest checkpoint instead of erroring out).
    failures: int = 0


class ResultGrid:
    def __init__(self, results: List[Result], trials: List[Trial],
                 metric: Optional[str], mode: str):
        self._results = results
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set in TuneConfig or here)")
        best, best_v = None, None
        for r in self._results:
            if r.error is not None or metric not in r.metrics:
                continue
            v = float(r.metrics[metric])
            if best_v is None or (v > best_v if mode == "max" else v < best_v):
                best, best_v = r, v
        if best is None:
            raise RuntimeError("no successful trial reported the metric")
        return best

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for t in self._trials:
            row = dict(t.last_result)
            row["trial_id"] = t.trial_id
            row.update({f"config/{k}": v for k, v in t.config.items()
                        if isinstance(v, (int, float, str, bool))})
            rows.append(row)
        return pd.DataFrame(rows)


class _TrainerTrainable:
    """A DataParallelTrainer as a trial's function, tuning over its
    ``train_loop_config`` (reference: BaseTrainer.fit wraps itself as a
    trainable, ``base_trainer.py:724`` — the trial runs the FULL trainer,
    gang + datasets included, not just the bare loop). A class at module
    level, where the JAX package uses a closure, so that it pickles."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __call__(self, config):
        trainer = self.trainer
        merged = {**trainer.train_loop_config, **config}
        single = (trainer.scaling_config.num_workers <= 1
                  and not trainer.datasets)
        if single:
            # Fast path: run the loop inline so per-iteration
            # reports stream to the trial session (ASHA/PBT see
            # every result). Honor a user-supplied resume
            # checkpoint when the trial isn't resuming (PBT).
            if (trainer.resume_from_checkpoint is not None
                    and session_mod.get_checkpoint() is None):
                s = session_mod._get_session()
                if s is not None:
                    s.latest_checkpoint = trainer.resume_from_checkpoint
            trainer.train_loop_per_worker(merged)
            return
        # A nested gang started from this trial's process. Unique nested
        # run name: concurrent trials must not share a run_dir (their
        # CheckpointManagers would evict each other's checkpoint_NNNNNN
        # dirs).
        rc = trainer.run_config
        nested_name = f"{rc.name or 'nested'}-{uuid.uuid4().hex[:8]}"
        nested = type(trainer)(
            trainer.train_loop_per_worker,
            train_loop_config=merged,
            datasets=trainer.datasets,
            scaling_config=trainer.scaling_config,
            run_config=dataclasses.replace(rc, name=nested_name),
            resume_from_checkpoint=(session_mod.get_checkpoint()
                                    or trainer.resume_from_checkpoint),
        )
        result = nested.fit()
        if result.error is not None:
            raise result.error
        # report() stages a synchronous copy, so the nested run
        # dir (manager-owned checkpoints included) can be removed
        # — otherwise every trial orphans a full run tree.
        session_mod.report(result.metrics, checkpoint=result.checkpoint)
        storage = rc.storage_path or os.path.join(tempfile.gettempdir(),
                                                  "raytpu_results")
        shutil.rmtree(os.path.join(storage, nested_name), ignore_errors=True)


def _trial_device(tc: TuneConfig, trainable) -> str:
    """Where the trials run: the trainer's device for a trainer
    trainable, else ``tc.device`` (``"cuda"`` unless set)."""
    if tc.device not in (None,) + DEVICES:
        raise ValueError(f"TuneConfig.device={tc.device!r}: use 'cuda' (the "
                         f"trials share cuda:0) or 'cpu'")
    if isinstance(trainable, _TrainerTrainable):
        want = trainable.trainer.scaling_config.device
        if tc.device not in (None, want):
            raise ValueError(
                f"TuneConfig.device={tc.device!r}, but the trainer's "
                f"ScalingConfig.device is {want!r}")
        return want
    return tc.device or "cuda"


def _trial_cpus(resources: Optional[Dict[str, float]]) -> int:
    unknown = sorted(set(resources or {}) - set(TRIAL_RESOURCES))
    if unknown:
        raise ValueError(
            f"resources_per_trial {unknown}: a trial process of the port's "
            f"runtime takes only {list(TRIAL_RESOURCES)} (its torch "
            f"threads)")
    return int((resources or {}).get("CPU", 1))


def _state_blob(state: dict) -> bytes:
    """The experiment state, pickled; where the searcher or scheduler do
    not pickle, without them, marked so that ``restore`` refuses it."""
    try:
        return pickle.dumps(state)
    except (pickle.PicklingError, AttributeError, TypeError) as exc:
        tc = dataclasses.replace(state["tune_config"], search_alg=None,
                                 scheduler=None)
        return pickle.dumps({
            **state, "searcher": None, "tune_config": tc,
            "unpicklable": f"{type(exc).__name__}: {exc}"})


class Tuner:
    def __init__(self, trainable: Callable[[dict], None], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        if hasattr(trainable, "train_loop_per_worker"):
            # A DataParallelTrainer instance: tune over its
            # train_loop_config.
            trainable = _TrainerTrainable(trainable)
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self._restored: Optional[dict] = None

    @classmethod
    def restore(cls, path: str, trainable: Optional[Callable] = None
                ) -> "Tuner":
        """Resume an interrupted run from its directory (reference:
        ``Tuner.restore``, ``python/ray/tune/tuner.py:173``): finished
        trials keep their results, unfinished ones relaunch from their
        latest checkpoint, and the (pickled) searcher + scheduler continue
        from their saved state — the experiment converges to the same
        outcome as an uninterrupted run."""
        with open(os.path.join(path, "tuner_state.pkl"), "rb") as f:
            state = pickle.loads(f.read())
        if state.get("unpicklable"):
            raise ValueError(
                f"the experiment at {path} cannot be restored: its searcher "
                f"or scheduler did not pickle ({state['unpicklable']}); "
                f"build them from module-level functions")
        rc = state["run_config"]
        rc.name = os.path.basename(os.path.normpath(path))
        rc.storage_path = os.path.dirname(os.path.normpath(path))
        tc = state["tune_config"]
        tc.search_alg = state["searcher"]
        # Through __init__ so a re-passed trainer gets the same
        # trainable-wrapping as a fresh Tuner.
        tuner = cls(
            (trainable if trainable is not None
             else pickle.loads(state["fn_blob"])),
            param_space=state.get("param_space") or {},
            tune_config=tc,
            run_config=rc,
        )
        tuner._restored = state
        return tuner

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        rc = self.run_config
        device = _trial_device(tc, self.trainable)
        # No card: raise here, not in each trial (cuda:0, which the trials
        # share, starts no CUDA context in this process).
        resolve_device("cpu" if device == "cpu" else "cuda:0")
        if isinstance(self.trainable, _TrainerTrainable):
            check_cards(self.trainable.trainer.scaling_config)
        cpus = _trial_cpus(tc.resources_per_trial)
        _check_pickles(self.trainable)
        name = rc.name or f"raytpu-tune-{int(time.time())}"
        storage = rc.storage_path or os.path.join(
            tempfile.gettempdir(), "raytpu_results")
        run_dir = os.path.join(storage, name)
        os.makedirs(run_dir, exist_ok=True)

        searcher = tc.search_alg or BasicVariantGenerator(
            self.param_space, num_samples=tc.num_samples)
        scheduler = tc.scheduler or FIFOScheduler()
        if isinstance(scheduler, PopulationBasedTraining) and tc.metric:
            scheduler.metric = scheduler.metric or tc.metric

        fn_blob = pickle.dumps(self.trainable)
        max_conc = tc.max_concurrent_trials or self._default_concurrency()

        trials: List[Trial] = []
        ckpt_managers: Dict[str, CheckpointManager] = {}
        worker_cls = runtime.remote(TrainWorker).options(num_cpus=cpus)

        # A trial's start call, not waited for where it is sent: the
        # processes of a wave start together, and the trial's first poll
        # (which its process answers after the start) waits for it.
        starts: Dict[str, runtime.ObjectRef] = {}

        def spawn_actor(tid: str, config: Dict[str, Any],
                        resume: Optional[Checkpoint] = None):
            ctx_kwargs = {"experiment_name": name, "storage_path": run_dir}
            actor = worker_cls.remote(0, 1, ctx_kwargs, device)
            starts[tid] = actor.start.remote(
                self.trainable, config, None,
                resume.path if resume else None)
            return actor

        def kill_actor(trial: Trial) -> None:
            starts.pop(trial.trial_id, None)
            if trial.actor is not None:
                runtime.kill(trial.actor)
                trial.actor = None

        def launch(tid: str, config: Dict[str, Any],
                   resume: Optional[Checkpoint] = None) -> Trial:
            trial = Trial(tid, config)
            # Record the launch checkpoint: a crash BEFORE the trial's
            # first own checkpoint must retry from here (PBT exploit
            # clones would otherwise silently restart from random init).
            trial.checkpoint = resume
            trial.actor = spawn_actor(tid, config, resume)
            trial.state = "RUNNING"
            trials.append(trial)
            return trial

        def retry_trial(trial: Trial, err: Optional[str] = None) -> None:
            """Crash retry from the latest checkpoint (reference:
            FailureConfig.max_failures): same trial identity, so
            scheduler rung statistics and the searcher's bookkeeping
            carry over; counters roll back to the checkpoint exactly as
            Tuner.restore does."""
            kill_actor(trial)
            trial.failures += 1
            from raytpu_torch.util.events import record_event

            record_event(
                "WARNING", "TRIAL_RETRY",
                f"trial {trial.trial_id} crashed "
                f"(attempt {trial.failures}/"
                f"{rc.failure_config.max_failures}); restarting from "
                f"{'checkpoint' if trial.checkpoint else 'scratch'}: "
                f"{str(err)[-300:]}",
                trial_id=trial.trial_id, failures=trial.failures)
            trial.error = None
            it = trial.ckpt_iterations if trial.checkpoint else 0
            trial.iterations = it
            trial.history = list(trial.history)[:it]
            trial.last_result = (trial.history[-1] if trial.history
                                 else {})
            trial.actor = spawn_actor(trial.trial_id, trial.config,
                                      trial.checkpoint)
            trial.state = "RUNNING"

        # Open-ended searchers (TPE etc.) suggest forever; num_samples is
        # the experiment budget (reference: same num_samples semantics).
        # BasicVariantGenerator embeds its own grid x samples budget.
        budget = (searcher.total() if hasattr(searcher, "total")
                  else tc.num_samples)
        suggested = sum(1 for t in trials if t.from_searcher)

        def suggest_and_launch() -> Optional[Trial]:
            nonlocal suggested
            if budget is not None and suggested >= budget:
                return None
            tid = f"trial_{uuid.uuid4().hex[:8]}"
            cfg = searcher.suggest(tid)
            if cfg is None:
                return None
            suggested += 1
            t = launch(tid, cfg)
            t.from_searcher = True
            return t

        state_path = os.path.join(run_dir, "tuner_state.pkl")
        last_save = [0.0]

        def save_state(force: bool = False) -> None:
            """Durable experiment state (reference: experiment-state file
            the reference controller writes for Tuner.restore). Written
            atomically, throttled — the snapshot is O(total history) and
            must not dominate the 50ms polling loop."""
            now = time.monotonic()
            if not force and now - last_save[0] < SAVE_EVERY_S:
                return
            last_save[0] = now
            blob = _state_blob({
                "fn_blob": fn_blob,
                "param_space": self.param_space,
                "tune_config": tc,
                "run_config": rc,
                "searcher": searcher,
                "trials": [{
                    "trial_id": t.trial_id,
                    "config": t.config,
                    "state": t.state,
                    "last_result": t.last_result,
                    "history": t.history,
                    "iterations": t.iterations,
                    "ckpt_iterations": t.ckpt_iterations,
                    "error": t.error,
                    "failures": t.failures,
                    "checkpoint": (t.checkpoint.path
                                   if t.checkpoint else None),
                    "from_searcher": t.from_searcher,
                } for t in trials],
            })
            tmp = state_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, state_path)

        def finish(trial: Trial, state: str, error: Optional[str] = None):
            """Completion paths share one exit: state, the trial's process
            killed (frees its card memory and threads), searcher +
            scheduler notification."""
            trial.state = state
            trial.error = error
            kill_actor(trial)
            if getattr(trial, "from_searcher", False):
                searcher.on_trial_complete(trial.trial_id, trial.last_result)
            scheduler.on_trial_remove(trial)

        def polled(trial: Trial, ref):
            """The trial's ``(pairs, finished, error)`` from its poll
            ``ref``; a process that died or stopped answering is a
            crash."""
            try:
                start = starts.pop(trial.trial_id, None)
                if start is not None:
                    runtime.get(start, timeout=TRIAL_CALL_TIMEOUT_S)
                return runtime.get(ref, timeout=TRIAL_CALL_TIMEOUT_S)
            except RayTpuError as e:
                return [], False, (f"trial process failed: "
                                   f"{type(e).__name__}: {e}")

        try:
            # Restore path: re-seat finished trials, relaunch unfinished
            # ones from their latest checkpoint.
            if self._restored is not None:
                for tr in self._restored["trials"]:
                    ckpt = (Checkpoint(tr["checkpoint"])
                            if tr["checkpoint"] else None)
                    if tr["state"] in ("TERMINATED", "ERROR", "STOPPED"):
                        trials.append(Trial(
                            tr["trial_id"], tr["config"], state=tr["state"],
                            last_result=tr["last_result"],
                            history=tr["history"], error=tr["error"],
                            iterations=tr["iterations"], checkpoint=ckpt,
                            from_searcher=tr["from_searcher"],
                            failures=tr.get("failures", 0)))
                    else:
                        t = launch(tr["trial_id"], tr["config"],
                                   resume=ckpt)
                        # max_failures is a per-TRIAL budget; it survives
                        # experiment restores.
                        t.failures = tr.get("failures", 0)
                        # Roll back to the checkpoint point: the
                        # relaunched trial replays everything after it, so
                        # counters and history must not double-count those
                        # reports.
                        it = (tr.get("ckpt_iterations", 0) if ckpt
                              else 0)
                        t.iterations = it
                        t.ckpt_iterations = it
                        t.history = list(tr["history"])[:it]
                        t.last_result = (t.history[-1] if t.history
                                         else dict(tr["last_result"]))
                        # launch() already recorded the resume checkpoint.
                        t.from_searcher = tr["from_searcher"]
                self._restored = None
                suggested = sum(1 for t in trials if t.from_searcher)

            # Prime the first wave.
            while sum(t.state == "RUNNING" for t in trials) < max_conc:
                if suggest_and_launch() is None:
                    break
            save_state(force=True)

            live = [t for t in trials if t.state == "RUNNING"]
            while live:
                refs = [t.actor.poll.remote() for t in live]
                polls = [polled(t, ref) for t, ref in zip(live, refs)]
                for trial, (pairs, finished, err) in zip(live, polls):
                    decision = CONTINUE
                    for metrics, ckpt_path in pairs:
                        trial.iterations += 1
                        metrics.setdefault("training_iteration",
                                           trial.iterations)
                        trial.last_result = metrics
                        trial.history.append(metrics)
                        if ckpt_path:
                            trial.checkpoint = self._persist_ckpt(
                                ckpt_managers, run_dir, trial, ckpt_path,
                                metrics)
                            trial.ckpt_iterations = trial.iterations
                        # Model-based searchers that learn from
                        # INTERMEDIATE fidelities (BOHB) get every result,
                        # not just completions.
                        if trial.from_searcher and hasattr(
                                searcher, "on_trial_result"):
                            searcher.on_trial_result(trial.trial_id,
                                                     metrics)
                        d = scheduler.on_result(trial, metrics)
                        if d == STOP:
                            # Later buffered results from a to-be-stopped
                            # trial must not enter rung statistics.
                            decision = STOP
                            break
                    if err:
                        max_f = rc.failure_config.max_failures
                        if decision == STOP:
                            # The scheduler already cut this trial at a
                            # rung in this same poll; its decision stands
                            # (a retry could never be re-stopped — rungs
                            # are judged once).
                            finish(trial, "STOPPED")
                        elif max_f < 0 or trial.failures < max_f:
                            retry_trial(trial, err)
                        else:
                            finish(trial, "ERROR", error=err)
                        continue
                    if finished:
                        finish(trial, "TERMINATED")
                        continue
                    if decision == STOP:
                        finish(trial, "STOPPED")
                        continue
                    # PBT exploit/explore.
                    target = scheduler.exploit_target(trial)
                    if target is not None and target.checkpoint is not None:
                        finish(trial, "STOPPED")
                        new_cfg = scheduler.perturb(target.config)
                        # Pin a private copy: the target's
                        # CheckpointManager may evict (rmtree) the
                        # exploited dir before the clone's lazy restore
                        # reads it.
                        pinned = self._pin_ckpt(run_dir, target.checkpoint)
                        launch(f"trial_{uuid.uuid4().hex[:8]}", new_cfg,
                               resume=pinned)
                # Rebuild from `trials` (not the poll set) so PBT clones
                # launched mid-poll stay tracked; then backfill free slots.
                live = [t for t in trials if t.state == "RUNNING"]
                while len(live) < max_conc:
                    if suggest_and_launch() is None:
                        break
                    live = [t for t in trials if t.state == "RUNNING"]
                save_state(force=not live)  # final snapshot never skipped
                if live:
                    time.sleep(POLL_PACE_S)
        finally:
            # No trial process outlives fit, whatever ended it.
            for t in trials:
                kill_actor(t)

        # Staged-but-unregistered checkpoint snapshots (killed trials,
        # post-STOP reports) are garbage once the run ends — EXCEPT ones a
        # trial still references as its only checkpoint (a PBT clone that
        # finished before registering its own): deleting those would hand
        # the caller a Result.checkpoint pointing at nothing. The port's
        # session writes each checkpointed report beside its snapshot;
        # those files go with it.
        referenced = {t.checkpoint.path for t in trials
                      if t.checkpoint is not None}
        for staged in glob.glob(os.path.join(run_dir, ".staged_ckpts", "*")):
            suffix = session_mod.REPORT_SUFFIX
            snapshot = (staged[:-len(suffix)] if staged.endswith(suffix)
                        else staged)
            if snapshot in referenced:
                continue
            if os.path.isdir(staged):
                shutil.rmtree(staged, ignore_errors=True)
            else:
                os.remove(staged)

        results = []
        for t in trials:
            err = TaskError(t.trial_id, t.error) if t.error else None
            results.append(Result(
                metrics=t.last_result, metrics_history=t.history,
                checkpoint=t.checkpoint, path=run_dir, error=err,
                config=dict(t.config or {})))
        return ResultGrid(results, trials, tc.metric, tc.mode)

    def _pin_ckpt(self, run_dir: str, ckpt: Checkpoint) -> Checkpoint:
        dst = os.path.join(run_dir, ".staged_ckpts", uuid.uuid4().hex)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copytree(ckpt.path, dst)
        return Checkpoint(dst)

    def _persist_ckpt(self, managers: Dict[str, CheckpointManager],
                      run_dir: str, trial: Trial, ckpt_path: str,
                      metrics: Dict[str, Any]) -> Checkpoint:
        """Per-trial CheckpointManager so RunConfig.checkpoint_config
        (num_to_keep / score retention) is honored for tune runs the same
        way DataParallelTrainer.fit honors it."""
        cc = self.run_config.checkpoint_config
        mgr = managers.get(trial.trial_id)
        if mgr is None:
            mgr = managers[trial.trial_id] = CheckpointManager(
                os.path.join(run_dir, trial.trial_id),
                num_to_keep=cc.num_to_keep,
                score_attribute=cc.checkpoint_score_attribute,
                score_order=cc.checkpoint_score_order,
            )
        return mgr.register(Checkpoint(ckpt_path), metrics)

    def _default_concurrency(self) -> int:
        # The JAX package reads cluster_resources()["CPU"], which its
        # default init sets to os.cpu_count().
        return max(1, os.cpu_count() or 1)


def run(trainable, *, param_space=None, tune_config=None, run_config=None):
    """Functional entry (reference: ``tune.run``, ``tune/tune.py:277``)."""
    return Tuner(trainable, param_space=param_space, tune_config=tune_config,
                 run_config=run_config).fit()
