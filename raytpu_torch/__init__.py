"""raytpu_torch: the PyTorch + CUDA port of raytpu, for an NVIDIA H100.

Ported so far: serving Llama and GPT-2 through the paged inference
engine and ``LLMDeployment``, training GPT-2 (with its dropout), Llama
and Mixtral on one card, RLlib, the Train library, Tune, serve, the
runtime's tasks and object store, and the Data library:

- :mod:`raytpu_torch.ops` — flash attention (forward, and a backward of
  two kernels, dQ and dK/dV), paged attention and RMSNorm, each a CUDA
  kernel written by hand for Hopper beside a plain PyTorch version;
- :mod:`raytpu_torch.models` — the Llama decoder and GPT-2 (each with
  its inference forwards, training forward, loss and train step),
  Mixtral (training forward, loss and train step), and the converters
  that carry JAX weights across. The top-level ``make_train_step`` is
  GPT-2's; Llama's and Mixtral's are in ``raytpu_torch.models.llama``
  and ``raytpu_torch.models.mixtral``, as in the JAX package;
- :mod:`raytpu_torch.inference` — paged KV cache, prefix cache,
  continuous-batching scheduler, sampling, :class:`InferenceEngine`, and
  the replica body that serves through it, :class:`LLMDeployment`
  (stepping loop, streamed tokens, aborts, the prefill-to-decode KV
  handoff);
- :mod:`raytpu_torch.util` — the serving plane's observability, in
  process: metrics (``raytpu_infer_*`` and the serve SLO ledger), spans
  and ``profile`` over ``torch.profiler``, the request lifecycle
  recorder, and the decode step profiler (step times, MFU, device
  memory);
- :mod:`raytpu_torch.rllib` — RL modules, learners, env runners (in
  process, or in runner processes) and PPO, IMPALA, APPO (asynchronous
  with runner processes), DQN, SAC, CQL and BC/MARWIL, through the JAX
  package's entry points (``PPOConfig()...build().train()``), with a
  converter of the JAX package's RL weights. No kernel: RLlib reaches
  no TPU kernel;
- the core API at the top level, the JAX package's 37 names
  (``raytpu_torch.init``, ``remote``, ``get``, ``placement_group``,
  ``get_runtime_context``, the ids and the errors ...), from
  :mod:`raytpu_torch.runtime`;
- :mod:`raytpu_torch.runtime` — a worker-process layer with the shape
  of the JAX package's calls: the driver's ledger of CPUs, the card
  (``num_gpus``: the child is bound to its card through
  ``CUDA_VISIBLE_DEVICES``) and custom resources, placement groups,
  actor restarts (``max_restarts``), actors in processes of their own, tasks
  on one pool of worker processes for the whole tree, all forked from a
  server that imported torch once
  (``remote(fn)``, ``num_returns``, streaming, retries), refs that
  cross processes and are counted and freed, an object store of sealed
  shared-memory segments that readers map without a copy, by-value
  pickling of lambdas, closures and local classes (no ``cloudpickle``),
  ``put``/``get``/``wait``/``cancel``/``kill``/``init``/``shutdown``;
  :mod:`raytpu_torch.core.errors`, the errors it raises, and
  :mod:`raytpu_torch.perf`, its microbenchmarks;
- :mod:`raytpu_torch.data` — the Data library: lazy datasets whose
  transforms and exchanges (shuffle, sort, groupby, zip, split) run as
  tasks, the readers and writers of the JAX package (``pyarrow``,
  ``pandas`` and ``PIL`` imported where needed), ``streaming_split`` for
  the trainer's workers and ``iter_torch_batches`` onto the card.
- :mod:`raytpu_torch.train` — the Train library: a gang of worker
  processes of that layer with one ``torch.distributed`` group (NCCL on
  the card, gloo on the CPU), sessions and ``report``, checkpoints
  through ``torch.distributed.checkpoint``, gang restarts; its models,
  the fashion-MNIST MLP and ResNet, are in :mod:`raytpu_torch.models`;
- :mod:`raytpu_torch.tune` — the Tune library: searchers (grid, random,
  TPE, BOHB, ask/tell), schedulers (FIFO, ASHA, HyperBand, PBT), trials
  as Train worker processes (on the card, sharing it, or on the CPU),
  crash retries from checkpoints, and ``Tuner.restore``;
- :mod:`raytpu_torch.parallel` and :mod:`raytpu_torch.collective` —
  meshes of ranks (one process a rank, one ``torch.distributed`` group
  an axis), the sharding rules for the port's parameter names, ring
  attention, Ulysses, the pipeline loop and MoE dispatch over
  ``mesh_ops.group_call`` (``shard_map``'s counterpart, with its
  gradients), Mixtral's experts over ``ep``, and host collectives
  between tasks and actors through a coordinator actor;
- :mod:`raytpu_torch.state`, :mod:`raytpu_torch.dashboard`,
  :mod:`raytpu_torch.job` and ``python -m raytpu_torch`` — the
  operator's surface: every process's records at the driver, the web
  dashboard (stacks and CPU and memory profiles of every process), job
  submission, and the command line, reaching a driver from another
  process by its address (``runtime.init(address=...)``).

The port imports nothing from ``raytpu`` or JAX; the host-side modules it
needs are its own copies. Every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``, and raises when there is no card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` (the current card)
    unless the caller asks for ``cpu``. Raises when CUDA is asked for,
    explicitly or by default, and no card is available: the port never
    moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"raytpu_torch runs on 'cuda' or 'cpu', not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "raytpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


from raytpu_torch._version import __version__  # noqa: E402
from raytpu_torch.core.errors import (ActorDiedError,  # noqa: E402
                                      ActorError, GetTimeoutError,
                                      ObjectLostError, RayTpuError,
                                      RuntimeEnvError, TaskError,
                                      WorkerCrashedError)
from raytpu_torch.core.ids import (ActorID, JobID, NodeID,  # noqa: E402
                                   ObjectID, PlacementGroupID, TaskID)
from raytpu_torch.runtime.api import (available_resources,  # noqa: E402
                                      cancel, cluster_resources, get,
                                      get_actor, get_runtime_context, init,
                                      is_initialized, kill, method, nodes,
                                      put, remote, shutdown, timeline, wait)
from raytpu_torch.runtime.generator import ObjectRefGenerator  # noqa: E402
from raytpu_torch.runtime.object_ref import ObjectRef  # noqa: E402
from raytpu_torch.runtime.placement_group import (  # noqa: E402
    PlacementGroup, get_current_placement_group, placement_group,
    remove_placement_group)
from raytpu_torch.inference import (InferenceEngine,  # noqa: E402
                                    LLMDeployment, PagedKVCache,
                                    PrefixCache, SamplingParams, Scheduler,
                                    Sequence, StepOutput)
from raytpu_torch.models.gpt2 import (GPT2, GPT2Config,  # noqa: E402
                                      make_train_step)
from raytpu_torch.models.llama import (Llama, LlamaConfig,  # noqa: E402
                                       llama_loss_fn)
from raytpu_torch.models.mixtral import (Mixtral,  # noqa: E402
                                         MixtralConfig, mixtral_loss_fn)

__all__ = [
    # The core API, the JAX package's names (``raytpu.__all__``).
    "__version__", "init", "shutdown", "is_initialized", "remote", "get",
    "put", "wait", "cancel", "kill", "get_actor", "method",
    "get_runtime_context", "available_resources", "cluster_resources",
    "nodes", "timeline", "ObjectRef", "ObjectRefGenerator",
    "placement_group", "PlacementGroup", "remove_placement_group",
    "get_current_placement_group", "RayTpuError", "TaskError", "ActorError",
    "ActorDiedError", "ObjectLostError", "WorkerCrashedError",
    "GetTimeoutError", "RuntimeEnvError", "ObjectID", "TaskID", "ActorID",
    "NodeID", "JobID", "PlacementGroupID",
    # The models and the engine.
    "GPT2", "GPT2Config", "InferenceEngine", "LLMDeployment", "Llama",
    "LlamaConfig", "Mixtral", "MixtralConfig", "PagedKVCache",
    "PrefixCache", "SamplingParams", "Scheduler", "Sequence", "StepOutput",
    "llama_loss_fn", "make_train_step", "mixtral_loss_fn", "resolve_device"]
