"""External searcher adapters — third-party ask/tell optimizers as Tune
searchers; the port of :mod:`raytpu.tune.external`.

Reference analogue: ``python/ray/tune/search/optuna/optuna_search.py`` (and
the Ax/HEBO siblings) — the reference wraps external optimizers behind its
``Searcher`` interface so ``TuneConfig(search_alg=...)`` accepts them
unchanged. Same shape here: :class:`AskTellSearcher` adapts any object
with ``ask() -> (token, config)`` / ``tell(token, score)``;
:class:`OptunaSearcher` binds an ``optuna`` study through it (optional
import — raises with guidance when optuna isn't installed).

The port pickles the experiment state that ``Tuner.restore`` reads with
the standard ``pickle``, so an :class:`AskTellSearcher` whose ``ask`` and
``tell`` are closures (an :class:`OptunaSearcher`'s are) runs, and its
experiment cannot be restored; one built from module-level functions
can.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from raytpu_torch.tune.search import Domain, GridSearch, Searcher


class AskTellSearcher(Searcher):
    """Adapter for generic ask/tell optimizers.

    ``ask`` returns an opaque token plus the suggested config; ``tell``
    receives that token and the (sign-normalized: larger is better)
    score. Tune drives it through the standard Searcher surface, so
    schedulers, ``Tuner.restore`` and crash retries work unchanged.
    """

    def __init__(self, ask: Callable[[], Tuple[Any, Dict[str, Any]]],
                 tell: Callable[[Any, float], None],
                 metric: str, mode: str = "max",
                 raw_score: bool = False,
                 tell_failure: Optional[Callable[[Any], None]] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self._ask = ask
        self._tell = tell
        # Crashed/metric-less trials: the optimizer must learn the trial
        # ended (optuna would otherwise consider it running forever).
        self._tell_failure = tell_failure
        self.metric = metric
        self.mode = mode
        # raw_score: the external optimizer already knows the direction
        # (e.g. an optuna study created with direction=minimize) — hand
        # it the unnormalized metric value.
        self.raw_score = raw_score
        self._tokens: Dict[str, Any] = {}  # trial_id -> optimizer token

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        token, cfg = self._ask()
        if cfg is None:
            return None
        self._tokens[trial_id] = token
        return dict(cfg)

    def on_trial_complete(self, trial_id: str,
                          result: Dict[str, Any]) -> None:
        token = self._tokens.pop(trial_id, None)
        if token is None:
            return
        try:
            if self.metric in (result or {}):
                score = float(result[self.metric])
                if self.mode == "min" and not self.raw_score:
                    score = -score
                self._tell(token, score)
            elif self._tell_failure is not None:
                self._tell_failure(token)
        except Exception:
            pass  # a broken external model must not fail the run


def _optuna_distributions(param_space: Dict[str, Any], optuna) -> Dict:
    """Translate our structural Domains into optuna distributions;
    constants and custom Domains stay Tune-side."""
    dist = optuna.distributions
    out: Dict[str, Any] = {}
    for name, spec in param_space.items():
        if isinstance(spec, GridSearch):
            out[name] = dist.CategoricalDistribution(list(spec.values))
        elif isinstance(spec, Domain):
            if spec.kind == "choice":
                out[name] = dist.CategoricalDistribution(list(spec.options))
            elif spec.kind == "uniform":
                out[name] = dist.FloatDistribution(spec.low, spec.high)
            elif spec.kind == "loguniform":
                out[name] = dist.FloatDistribution(spec.low, spec.high,
                                                   log=True)
            elif spec.kind == "randint":
                out[name] = dist.IntDistribution(int(spec.low),
                                                 int(spec.high) - 1)
            elif spec.kind == "qrandint":
                lo, q = int(spec.low), int(spec.q)
                # optuna requires high to be low + k*step; randrange's
                # last reachable value is exactly that.
                hi = lo + ((int(spec.high) - 1 - lo) // q) * q
                out[name] = dist.IntDistribution(lo, hi, step=q)
            # kind == "custom": sampled Tune-side below
    return out


class OptunaSearcher(AskTellSearcher):
    """Optuna-backed searcher (reference: ``OptunaSearch``).

    Optional dependency: imports ``optuna`` at construction and raises a
    clear ImportError when absent. The study's direction follows
    ``mode``; sampler/pruner come from the caller's ``study`` (or a
    default TPE study is created).
    """

    def __init__(self, param_space: Dict[str, Any], metric: str,
                 mode: str = "max", study=None,
                 seed: Optional[int] = None):
        try:
            import optuna
        except ImportError as e:  # pragma: no cover - env without optuna
            raise ImportError(
                "OptunaSearcher requires the 'optuna' package "
                "(pip install optuna), or use the native TPESearcher/"
                "BOHBSearcher which need no extra dependency") from e
        self._optuna = optuna
        if study is None:
            sampler = optuna.samplers.TPESampler(seed=seed)
            study = optuna.create_study(
                direction="maximize" if mode == "max" else "minimize",
                sampler=sampler)
        self._study = study
        self.param_space = dict(param_space)
        self._distributions = _optuna_distributions(param_space, optuna)
        import random as _random

        self._rng = _random.Random(seed)

        def ask():
            trial = self._study.ask(self._distributions)
            cfg = {}
            for name, spec in self.param_space.items():
                if name in self._distributions:
                    cfg[name] = trial.params[name]
                elif isinstance(spec, Domain):  # custom closure domain
                    cfg[name] = spec.sample(self._rng)
                else:  # constant
                    cfg[name] = spec
            return trial, cfg

        def tell(trial, score: float):
            self._study.tell(trial, score)

        def tell_failure(trial):
            # Reference parity: OptunaSearch reports TrialState.FAIL so
            # the sampler stops treating the trial as running.
            self._study.tell(trial, None,
                             state=optuna.trial.TrialState.FAIL)

        # raw_score: the study's direction already encodes min/max.
        super().__init__(ask, tell, metric, mode, raw_score=True,
                         tell_failure=tell_failure)
