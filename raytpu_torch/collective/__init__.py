"""raytpu_torch.collective — collectives on two planes, the port of
:mod:`raytpu.collective`.

Host plane (orchestration-scale, numpy over the runtime's actors;
reference: ``ray.util.collective`` gloo backend) and device plane
(``torch.distributed`` collectives over a mesh's axes, NCCL on the card
and gloo on the CPU, :mod:`raytpu_torch.collective.mesh_ops`).
"""

from raytpu_torch.collective.collective import (
    ReduceOp,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reducescatter,
    send,
)
from raytpu_torch.collective import mesh_ops

__all__ = [
    "ReduceOp", "init_collective_group", "destroy_collective_group",
    "is_group_initialized", "get_rank", "get_collective_group_size",
    "allreduce", "allgather", "reducescatter", "broadcast", "barrier",
    "send", "recv", "mesh_ops",
]
