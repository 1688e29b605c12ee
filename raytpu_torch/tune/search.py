"""Search spaces and suggestion algorithms, the port of
:mod:`raytpu.tune.search`.

Reference analogue: ``python/ray/tune/search/`` — the sample-space API
(``tune.choice/uniform/loguniform/randint/grid_search``), the
BasicVariantGenerator (grid x random expansion), and the Searcher plugin
interface the Optuna/Ax/HEBO wrappers implement.

What changed: the JAX package's :class:`Domain` keeps a lambda as its
sampler, and ``Tuner.restore`` reads it back through ``cloudpickle``.
The port pickles its experiment state with the standard ``pickle`` (the
card's machine has no ``cloudpickle``), so a :class:`Domain` samples from
its ``kind``/``low``/``high``/``q``/``options`` fields, which pickle. The
draws are the JAX package's: for one seed, the same numbers in the same
order from :class:`random.Random`. A custom domain's ``sampler`` must be
a module-level function (it pickles by name).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class Domain:
    # A module-level function of the rng, for kind "custom"; the other
    # kinds sample from the fields below.
    sampler: Optional[Callable[[random.Random], Any]] = None
    # Structural metadata so external searcher adapters (Optuna etc.) can
    # translate the space instead of treating it as an opaque closure.
    kind: str = "custom"
    low: Optional[float] = None
    high: Optional[float] = None
    q: Optional[int] = None
    options: Optional[List[Any]] = None

    def sample(self, rng: random.Random) -> Any:
        if self.kind == "choice":
            return rng.choice(self.options)
        if self.kind == "uniform":
            return rng.uniform(self.low, self.high)
        if self.kind == "loguniform":
            return math.exp(rng.uniform(math.log(self.low),
                                        math.log(self.high)))
        if self.kind == "randint":
            return rng.randrange(self.low, self.high)
        if self.kind == "qrandint":
            return rng.randrange(self.low, self.high, self.q)
        return self.sampler(rng)


def choice(options: List[Any]) -> Domain:
    return Domain(kind="choice", options=list(options))


def uniform(low: float, high: float) -> Domain:
    return Domain(kind="uniform", low=low, high=high)


def loguniform(low: float, high: float) -> Domain:
    return Domain(kind="loguniform", low=low, high=high)


def randint(low: int, high: int) -> Domain:
    return Domain(kind="randint", low=low, high=high)


def qrandint(low: int, high: int, q: int) -> Domain:
    return Domain(kind="qrandint", low=low, high=high, q=q)


@dataclass
class GridSearch:
    values: List[Any]


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


class Searcher:
    """Suggestion interface (reference: ``tune/search/searcher.py``)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Dict[str, Any]) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid axes fully expanded x num_samples random draws of the rest
    (reference semantics: grid_search multiplies num_samples)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._variants = self._expand()
        self._idx = 0

    def _expand(self) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grids = [self.param_space[k].values for k in grid_keys]
        out = []
        for _ in range(self.num_samples):
            for combo in itertools.product(*grids) if grids else [()]:
                cfg = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                out.append(cfg)
        return out

    def total(self) -> int:
        return len(self._variants)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._idx >= len(self._variants):
            return None
        cfg = self._variants[self._idx]
        self._idx += 1
        return cfg


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator search — a real model-based
    Searcher plugin (reference plugin surface: ``tune/search/searcher.py``;
    algorithm per Bergstra et al. 2011, the estimator behind the
    reference's HyperOpt integration — implemented natively, no external
    dependency).

    Observations split into a good quantile and the rest; numeric
    dimensions are scored by a kernel-density ratio l(x)/g(x) over
    ``n_candidates`` draws; categorical dimensions by smoothed frequency
    ratios. The first ``n_startup`` suggestions are random.
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "max", n_startup: int = 8,
                 n_candidates: int = 24, gamma: float = 0.25,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.rng = random.Random(seed)
        self._live: Dict[str, Dict[str, Any]] = {}
        self._history: List[tuple] = []  # (config, score)

    def _model_ready(self) -> bool:
        return len(self._history) >= self.n_startup

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if not self._model_ready():
            cfg = sample_config(self.param_space, self.rng)
        else:
            cfg = self._tpe_suggest()
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Dict[str, Any]) -> None:
        cfg = self._live.pop(trial_id, None)
        if cfg is None or self.metric not in (result or {}):
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._history.append((cfg, score))

    # -- internals ---------------------------------------------------------

    def _split(self):
        ranked = sorted(self._history, key=lambda cs: cs[1], reverse=True)
        n_good = max(1, int(len(ranked) * self.gamma))
        return ranked[:n_good], ranked[n_good:]

    def _tpe_suggest(self) -> Dict[str, Any]:
        good, bad = self._split()
        best_cfg, best_score = None, None
        for _ in range(self.n_candidates):
            cand = sample_config(self.param_space, self.rng)
            s = self._log_ratio(cand, good, bad)
            if best_score is None or s > best_score:
                best_cfg, best_score = cand, s
        return best_cfg

    def _log_ratio(self, cand, good, bad) -> float:
        total = 0.0
        for k, spec in self.param_space.items():
            x = cand[k]
            gv = [c[k] for c, _ in good if k in c]
            bv = [c[k] for c, _ in bad if k in c]
            if isinstance(x, (int, float)) and not isinstance(x, bool):
                total += math.log(self._kde(float(x), gv) + 1e-12) \
                    - math.log(self._kde(float(x), bv) + 1e-12)
            else:  # categorical: smoothed frequency ratio
                pg = (sum(1 for v in gv if v == x) + 1) / (len(gv) + 2)
                pb = (sum(1 for v in bv if v == x) + 1) / (len(bv) + 2)
                total += math.log(pg / pb)
        return total

    @staticmethod
    def _kde(x: float, values) -> float:
        vals = [float(v) for v in values
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
        if not vals:
            return 1e-12
        spread = max(vals) - min(vals)
        bw = max(spread / max(1, len(vals)) if spread else abs(x) * 0.1,
                 1e-6)
        return sum(
            math.exp(-0.5 * ((x - v) / bw) ** 2) / (bw * math.sqrt(2 * math.pi))
            for v in vals) / len(vals)


def sample_config(param_space: Dict[str, Any],
                  rng: random.Random) -> Dict[str, Any]:
    cfg = {}
    for k, v in param_space.items():
        if isinstance(v, Domain):
            cfg[k] = v.sample(rng)
        elif isinstance(v, GridSearch):
            cfg[k] = rng.choice(v.values)
        else:
            cfg[k] = v
    return cfg


class BOHBSearcher(TPESearcher):
    """BOHB's model-based half (reference: ``TuneBOHB`` paired with
    ``HyperBandForBOHB``; Falkner et al. 2018): a TPE model fitted on the
    HIGHEST fidelity rung (``training_iteration``) that has enough
    observations, fed by intermediate results — the model learns from
    partial budgets long before any trial completes. Pair it with
    :class:`raytpu_torch.tune.HyperBandScheduler`, which supplies the
    successive-halving budgets.
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "max", n_startup: int = 8,
                 n_candidates: int = 24, gamma: float = 0.25,
                 min_points_per_rung: int = 6,
                 seed: Optional[int] = None):
        super().__init__(param_space, metric, mode, n_startup,
                         n_candidates, gamma, seed)
        self.min_points_per_rung = min_points_per_rung
        # rung (iteration) -> trial_id -> (config, score)
        self._rung_obs: Dict[int, Dict[str, tuple]] = {}

    def on_trial_result(self, trial_id: str,
                        result: Dict[str, Any]) -> None:
        if self.metric not in (result or {}):
            return
        cfg = self._live.get(trial_id)
        if cfg is None:
            return
        rung = int(result.get("training_iteration", 0) or 0)
        if rung <= 0:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        self._rung_obs.setdefault(rung, {})[trial_id] = (cfg, score)

    def _model_ready(self) -> bool:
        return (super()._model_ready()
                or any(len(v) >= self.min_points_per_rung
                       for v in self._rung_obs.values()))

    def _split(self):
        # Highest fidelity first: scores at bigger budgets dominate
        # (BOHB's core trick); pooled completions are the fallback.
        for rung in sorted(self._rung_obs, reverse=True):
            obs = list(self._rung_obs[rung].values())
            if len(obs) >= self.min_points_per_rung:
                ranked = sorted(obs, key=lambda cs: cs[1], reverse=True)
                n_good = max(1, int(len(ranked) * self.gamma))
                return ranked[:n_good], ranked[n_good:]
        return super()._split()
