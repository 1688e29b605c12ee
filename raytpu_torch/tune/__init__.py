"""raytpu_torch.tune — experiment runner, the port of :mod:`raytpu.tune`
(reference: ``python/ray/tune/``): the same names and ``__all__``, with
``report`` from the port's Train session. Each trial is a worker process
of :mod:`raytpu_torch.runtime`; trials run on the card (``cuda:0``, shared)
unless ``TuneConfig(device="cpu")`` asks for the CPU.

The JAX package records its use through ``usage_stats`` on import; the
port has no ``util/usage_stats`` yet (ROADMAP.md), so it records nothing.
"""

from raytpu_torch.train.session import report  # same report API as Train
from raytpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    PopulationBasedTraining,
    TrialScheduler,
)
from raytpu_torch.tune.search import (
    BasicVariantGenerator,
    Searcher,
    BOHBSearcher,
    TPESearcher,
    choice,
    grid_search,
    loguniform,
    qrandint,
    randint,
    uniform,
)
from raytpu_torch.tune.external import AskTellSearcher, OptunaSearcher
from raytpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, run

__all__ = [
    "AskTellSearcher",
    "OptunaSearcher",
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "run",
    "report",
    "choice",
    "uniform",
    "loguniform",
    "randint",
    "qrandint",
    "grid_search",
    "Searcher",
    "BasicVariantGenerator",
    "TrialScheduler",
    "FIFOScheduler",
    "ASHAScheduler",
    "HyperBandScheduler",
    "BOHBSearcher",
    "TPESearcher",
    "PopulationBasedTraining",
]
