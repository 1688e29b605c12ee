"""raytpu_torch: the PyTorch + CUDA port of raytpu, for an NVIDIA H100.

Ported so far: serving Llama and GPT-2 through the paged inference
engine and ``LLMDeployment``, training GPT-2 (with its dropout), Llama
and Mixtral on one card, RLlib, the Train library and Tune:

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
- :mod:`raytpu_torch.runtime` — a small worker-process layer (actors in
  spawned processes, futures, ``put``/``get``/``wait``/``kill``, CPU
  tensors through shared memory) with the shape of the JAX package's
  calls, and :mod:`raytpu_torch.core.errors`, the errors it raises.
- :mod:`raytpu_torch.train` — the Train library: a gang of worker
  processes of that layer with one ``torch.distributed`` group (NCCL on
  the card, gloo on the CPU), sessions and ``report``, checkpoints
  through ``torch.distributed.checkpoint``, gang restarts; its models,
  the fashion-MNIST MLP and ResNet, are in :mod:`raytpu_torch.models`;
- :mod:`raytpu_torch.tune` — the Tune library: searchers (grid, random,
  TPE, BOHB, ask/tell), schedulers (FIFO, ASHA, HyperBand, PBT), trials
  as Train worker processes (on the card, sharing it, or on the CPU),
  crash retries from checkpoints, and ``Tuner.restore``.

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

__all__ = ["GPT2", "GPT2Config", "InferenceEngine", "LLMDeployment", "Llama",
           "LlamaConfig", "Mixtral", "MixtralConfig", "PagedKVCache",
           "PrefixCache", "SamplingParams", "Scheduler", "Sequence",
           "StepOutput", "llama_loss_fn", "make_train_step",
           "mixtral_loss_fn", "resolve_device"]
