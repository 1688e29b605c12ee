"""Parallelism strategies over the named axes of a mesh of ranks: the port
of :mod:`raytpu.parallel`.

In the JAX package every strategy is a sharding over a named
``jax.sharding.Mesh`` axis and the collectives are XLA programs in one
process. Here a rank is a process (one a card), the mesh
(:class:`~raytpu_torch.parallel.mesh.Mesh`) holds one
``torch.distributed`` process group per axis, and what stands in for
``shard_map`` is :func:`raytpu_torch.collective.mesh_ops.group_call`:

- **dp**    data parallel (batch sharding)
- **fsdp**  fully-sharded data parallel (the rule table's placements)
- **tp**    tensor parallel (Megatron-style column/row splits, in the
            rule table; the products that run on them are not ported)
- **pp**    pipeline parallel (stage loop with ppermute)
- **sp**    sequence/context parallel (ring attention / Ulysses all_to_all)
- **ep**    expert parallel (MoE dispatch via all_to_all; Mixtral's
            experts, :func:`raytpu_torch.models.mixtral.shard_experts`)
"""

from raytpu_torch.parallel.mesh import MeshSpec, build_mesh, mesh_from_devices
from raytpu_torch.parallel.sharding import (
    ShardingRules,
    TRANSFORMER_RULES,
    logical_sharding,
    shard_params,
    shard_batch,
)
from raytpu_torch.parallel.ring_attention import ring_attention
from raytpu_torch.parallel.ulysses import ulysses_attention
from raytpu_torch.parallel.pipeline import pipeline_stage_loop
from raytpu_torch.parallel.moe import MoELayer, moe_dispatch

__all__ = [
    "MeshSpec",
    "build_mesh",
    "mesh_from_devices",
    "ShardingRules",
    "TRANSFORMER_RULES",
    "logical_sharding",
    "shard_params",
    "shard_batch",
    "ring_attention",
    "ulysses_attention",
    "pipeline_stage_loop",
    "MoELayer",
    "moe_dispatch",
]
