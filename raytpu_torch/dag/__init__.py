"""raytpu_torch.dag — lazy DAGs of ``.bind()`` calls and compiled
channel pipelines across actor processes (the port of
:mod:`raytpu.dag`)."""

from raytpu_torch.dag.node import (ActorMethodNode, ClassNode, DAGNode,
                                   FunctionNode, InputNode)
from raytpu_torch.dag.compiled import (CompiledDAG, CompiledDAGRef,
                                       MultiOutputNode)

__all__ = [
    "ActorMethodNode", "ClassNode", "CompiledDAG", "CompiledDAGRef",
    "DAGNode", "FunctionNode", "InputNode", "MultiOutputNode",
]
