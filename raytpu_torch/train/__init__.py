"""raytpu_torch.train — distributed training orchestration, the port of
:mod:`raytpu.train`: a gang of worker processes with one
``torch.distributed`` group (NCCL on the card, gloo on the CPU),
sessions, ``report``, and checkpoints through
``torch.distributed.checkpoint``. The JAX package's exports, less
``cost_analysis_flops`` (XLA's cost analysis; not ported)."""

from raytpu_torch.train.checkpoint import (Checkpoint, CheckpointManager,
                                           restore_pytree, save_pytree)
from raytpu_torch.train.config import (CheckpointConfig, FailureConfig,
                                       Result, RunConfig, ScalingConfig)
from raytpu_torch.train.session import (get_checkpoint, get_context,
                                        get_dataset_shard, report)
from raytpu_torch.train.torch_trainer import (TorchTrainer,
                                              prepare_data_loader,
                                              prepare_model)
from raytpu_torch.train.trainer import (BaseTrainer, DataParallelTrainer,
                                        JaxTrainer)
from raytpu_torch.util.stepprof import StepProfiler

__all__ = [
    "BaseTrainer",
    "JaxTrainer",
    "DataParallelTrainer",
    "TorchTrainer",
    "prepare_model",
    "prepare_data_loader",
    "ScalingConfig",
    "RunConfig",
    "FailureConfig",
    "CheckpointConfig",
    "Result",
    "Checkpoint",
    "CheckpointManager",
    "save_pytree",
    "restore_pytree",
    "report",
    "get_context",
    "get_checkpoint",
    "get_dataset_shard",
    "StepProfiler",
]

from raytpu_torch.util import usage_stats as _usage_stats

_usage_stats.record_library_usage("train")
