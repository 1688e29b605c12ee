"""Workflow executor: DAG walk with per-step checkpointing, the port of
:mod:`raytpu.workflow.executor`.

Each step runs as a task of the port's pool; its output is checkpointed
before the workflow ends; resume loads checkpoints instead of
re-executing (exactly-once per completed step, at-least-once overall).
Two phases, as in the JAX package: submit bottom-up (checkpointed steps
load as values), then gather and checkpoint in topological order.

Step identity: the DAG position path and the step's function's
``__qualname__`` (the JAX package's ``_rf._name``, which is always the
qualified name there; the port's ``_name`` takes ``.options(name=...)``
first, so the port reads the function's own), so the same DAG gives the
same step ids in both packages, a named ``wait_for_event`` step
included, and a resume maps checkpoints back to the same nodes.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict

from raytpu_torch.dag.node import (ActorMethodNode, DAGNode, FunctionNode,
                                   InputNode)
from raytpu_torch.workflow.storage import WorkflowStorage


class WorkflowExecutionError(Exception):
    pass


def _step_name(node: FunctionNode) -> str:
    """The step's function's qualified name (the JAX ``_rf._name``)."""
    fn = getattr(getattr(node, "_rf", None), "_function", None)
    return getattr(fn, "__qualname__", None) or "step"


def _step_id(node: FunctionNode, path: str) -> str:
    name = _step_name(node)
    return hashlib.sha1(f"{path}::{name}".encode()).hexdigest()[:16] \
        + "-" + name.split(".")[-1][:32]


class WorkflowExecutor:
    def __init__(self, storage: WorkflowStorage):
        self.storage = storage

    def execute(self, workflow_id: str, dag: DAGNode,
                workflow_input: Any = None) -> Any:
        """Run (or resume) the DAG; returns the final output."""
        from raytpu_torch.runtime import api

        # Two phases so independent branches run CONCURRENTLY: first submit
        # the whole DAG bottom-up (checkpointed steps become inline values,
        # live steps become ObjectRefs the runtime resolves in parallel),
        # then gather + checkpoint in submission (topological) order.
        memo: Dict[int, Any] = {}          # node -> value | ObjectRef
        submitted: list = []               # (node, step_id, ref) topo order

        def submit(node: Any, path: str) -> Any:
            if isinstance(node, InputNode):
                return workflow_input
            if not isinstance(node, DAGNode):
                return node
            if isinstance(node, ActorMethodNode):
                raise WorkflowExecutionError(
                    "workflows checkpoint pure task steps; actor-method "
                    "nodes are not durable (reference: workflow steps are "
                    "tasks)"
                )
            if not isinstance(node, FunctionNode):
                raise WorkflowExecutionError(
                    f"unsupported workflow node: {type(node).__name__}")
            if id(node) in memo:
                return memo[id(node)]
            sid = _step_id(node, path)
            if self.storage.has_step(workflow_id, sid):
                value = self.storage.load_step(workflow_id, sid)
                memo[id(node)] = value
                return value
            args = [submit(a, f"{path}.a{i}")
                    for i, a in enumerate(node._bound_args)]
            kwargs = {k: submit(v, f"{path}.k{k}")
                      for k, v in node._bound_kwargs.items()}
            ref = node._rf.remote(*args, **kwargs)
            memo[id(node)] = ref
            submitted.append((node, sid, ref))
            return ref

        try:
            root = submit(dag, "r")
        except BaseException:
            self.storage.set_status(workflow_id, "FAILED")
            raise

        first_error: BaseException = None
        output = root
        for node, sid, ref in submitted:
            try:
                value = api.get(ref)
            except BaseException as e:  # checkpoint the successes anyway
                if first_error is None:
                    first_error = e
                continue
            self.storage.save_step(workflow_id, sid, _step_name(node),
                                   value)
            if ref is root:
                output = value
        if first_error is not None:
            self.storage.set_status(workflow_id, "FAILED")
            raise first_error
        self.storage.save_output(workflow_id, output)
        self.storage.set_status(workflow_id, "SUCCESSFUL")
        return output
