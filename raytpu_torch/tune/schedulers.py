"""Trial schedulers — early stopping and population-based training; the
port of :mod:`raytpu.tune.schedulers`, decision for decision (plain
Python: the same rungs, brackets, quantiles and draws from the same
seeds).

Reference analogue: ``python/ray/tune/schedulers/`` (ASHA/HyperBand/PBT).
Decisions are made on every reported result: CONTINUE, STOP, or (PBT)
EXPLOIT another trial's config+checkpoint.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_remove(self, trial) -> None:
        """Trial left the live set (terminated/errored/stopped/exploited)."""

    def exploit_target(self, trial):
        """PBT hook: trial to clone from (None = keep going)."""
        return None


class FIFOScheduler(TrialScheduler):
    pass


def _judge_at_rungs(rungs: List[int], rung_results: Dict[Any, List[float]],
                    rung_key, seen: set, t, value: float, rf: int,
                    max_t: int) -> str:
    """Shared successive-halving core (ASHA rung walk, HyperBand
    per-bracket rung walk): a trial reaching a rung stops unless in the
    top 1/rf of results completed there. A trial whose time_attr skips
    past a rung value is still judged at that rung — exact equality would
    silently degrade the scheduler to FIFO for trials that report every k
    iterations."""
    for rung in rungs:
        if t >= rung and rung not in seen:
            seen.add(rung)
            peers = rung_results[rung_key(rung)]
            peers.append(value)
            k = max(1, math.ceil(len(peers) / rf))
            top_k = sorted(peers, reverse=True)[:k]
            if value < top_k[-1]:
                return STOP
    if t >= max_t:
        return STOP
    return CONTINUE


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference:
    ``tune/schedulers/async_hyperband.py``): rungs at
    grace_period * reduction_factor^k; a trial reaching a rung stops
    unless in the top 1/reduction_factor of completed results there."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, reduction_factor: int = 3,
                 max_t: int = 100):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_results: Dict[int, List[float]] = defaultdict(list)
        self._completed: Dict[str, set] = defaultdict(set)

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        value = float(metric) if self.mode == "max" else -float(metric)
        return _judge_at_rungs(
            self.rungs, self.rung_results, lambda r: r,
            self._completed[trial.trial_id], t, value, self.rf, self.max_t)

    def on_trial_remove(self, trial) -> None:
        self._completed.pop(trial.trial_id, None)


class HyperBandScheduler(TrialScheduler):
    """HyperBand (reference: ``tune/schedulers/hyperband.py``): multiple
    successive-halving brackets trading off number-of-configs against
    per-config budget. Trials are assigned to brackets round-robin; each
    bracket s starts its rung ladder at ``max_t / eta^s`` and halves with
    factor eta, judged asynchronously like ASHA within the bracket (the
    reference's HB also fills brackets as trials arrive)."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: int = 3):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        # Integer arithmetic: float log truncation would silently drop the
        # cheapest bracket (e.g. log(243)/log(3) = 4.9999... -> 4).
        self.s_max = 0
        r = 1
        while r * reduction_factor <= max_t:
            r *= reduction_factor
            self.s_max += 1
        # Bracket s: rungs at max_t/eta^s, max_t/eta^(s-1), ..., max_t.
        self.brackets: List[List[int]] = []
        for s in range(self.s_max, -1, -1):
            r = max(1, max_t // (reduction_factor ** s))
            rungs = []
            while r < max_t:
                rungs.append(r)
                r *= reduction_factor
            self.brackets.append(rungs)
        self._next_bracket = 0
        self._trial_bracket: Dict[str, int] = {}
        # (bracket, rung) -> completed metric values
        self.rung_results: Dict[tuple, List[float]] = defaultdict(list)
        self._completed: Dict[str, set] = defaultdict(set)

    def _bracket_of(self, trial_id: str) -> int:
        b = self._trial_bracket.get(trial_id)
        if b is None:
            b = self._trial_bracket[trial_id] = self._next_bracket
            self._next_bracket = (self._next_bracket + 1) % len(self.brackets)
        return b

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        metric = result.get(self.metric)
        if t is None or metric is None:
            return CONTINUE
        value = float(metric) if self.mode == "max" else -float(metric)
        b = self._bracket_of(trial.trial_id)
        return _judge_at_rungs(
            self.brackets[b], self.rung_results, lambda r: (b, r),
            self._completed[trial.trial_id], t, value, self.eta,
            self.max_t)

    def on_trial_remove(self, trial) -> None:
        self._completed.pop(trial.trial_id, None)
        self._trial_bracket.pop(trial.trial_id, None)


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: ``tune/schedulers/pbt.py``): every
    ``perturbation_interval`` results, bottom-quantile trials exploit a
    top-quantile trial (config + checkpoint) and explore by perturbing
    hyperparams."""

    def __init__(self, metric: str, mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.rng = random.Random(seed)
        self.latest: Dict[str, float] = {}
        self._trials: Dict[str, Any] = {}

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        sign = 1.0 if self.mode == "max" else -1.0
        self.latest[trial.trial_id] = sign * float(metric)
        self._trials[trial.trial_id] = trial
        return CONTINUE

    def on_trial_remove(self, trial) -> None:
        # Quantiles must rank LIVE trials only — a dead trial left in
        # `latest` would occupy a bottom slot and shield a struggling live
        # trial from exploitation.
        self.latest.pop(trial.trial_id, None)
        self._trials.pop(trial.trial_id, None)

    def exploit_target(self, trial):
        t = trial.last_result.get(self.time_attr, 0)
        if not t or t % self.interval != 0 or len(self.latest) < 2:
            return None
        ranked = sorted(self.latest.items(), key=lambda kv: kv[1],
                        reverse=True)
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom_ids = {tid for tid, _ in ranked[-k:]}
        if trial.trial_id not in bottom_ids:
            return None
        top_ids = [tid for tid, _ in ranked[:k] if tid != trial.trial_id]
        if not top_ids:
            return None
        return self._trials[self.rng.choice(top_ids)]

    def perturb(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from raytpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                out[key] = self.rng.choice(spec)
            elif isinstance(spec, Domain):
                out[key] = spec.sample(self.rng)
            elif callable(spec):
                out[key] = spec()
            elif key in out and isinstance(out[key], (int, float)):
                out[key] = out[key] * self.rng.choice([0.8, 1.2])
        return out
