"""Lazy DAG of ``.bind()`` calls, the port of :mod:`raytpu.dag.node`.

``remote_function.bind(...)`` gives a :class:`FunctionNode`,
``RemoteClass.bind(...)`` a :class:`ClassNode` and
``handle.method.bind(...)`` (or ``class_node.method.bind(...)``) an
:class:`ActorMethodNode`. Classic execution, ``node.execute(x)``,
submits as the JAX package does: a function node submits a task, a class
node creates its actor once, a method node calls the method; the result
is an :class:`~raytpu_torch.runtime.object_ref.ObjectRef` of the port.
Compiled execution (channels between actor processes) is
:mod:`raytpu_torch.dag.compiled`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple


class DAGNode:
    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _resolve(self, value, input_value):
        if isinstance(value, InputNode):
            return input_value
        if isinstance(value, DAGNode):
            return value.execute(input_value)
        if isinstance(value, (list, tuple)):
            return type(value)(self._resolve(v, input_value) for v in value)
        return value

    def _resolved_args(self, input_value):
        args = [self._resolve(a, input_value) for a in self._bound_args]
        kwargs = {k: self._resolve(v, input_value)
                  for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def execute(self, input_value: Any = None):
        raise NotImplementedError

    def experimental_compile(self, buffer_size: int = 16):
        """Compile into a pre-allocated channel pipeline across the
        stages' actor processes (:class:`raytpu_torch.dag.compiled.
        CompiledDAG`)."""
        from raytpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, buffer_size=buffer_size)


class InputNode(DAGNode):
    """Placeholder for the value passed to ``dag.execute(x)``."""

    def __init__(self):
        super().__init__((), {})

    def execute(self, input_value: Any = None):
        return input_value

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self._rf = remote_function

    def execute(self, input_value: Any = None):
        args, kwargs = self._resolved_args(input_value)
        return self._rf.remote(*args, **kwargs)


class ClassNode(DAGNode):
    def __init__(self, actor_class, args, kwargs):
        super().__init__(args, kwargs)
        self._ac = actor_class
        self._handle = None

    def execute(self, input_value: Any = None):
        if self._handle is None:
            args, kwargs = self._resolved_args(input_value)
            self._handle = self._ac.remote(*args, **kwargs)
        return self._handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _UnboundMethodNode(self, name)


class _UnboundMethodNode:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs):
        return ActorMethodNode(self._class_node, self._method_name, args, kwargs)


class ActorMethodNode(DAGNode):
    def __init__(self, handle_or_class_node, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._target = handle_or_class_node
        self._method_name = method_name

    def execute(self, input_value: Any = None):
        args, kwargs = self._resolved_args(input_value)
        target = self._target
        if isinstance(target, ClassNode):
            target = target.execute(input_value)
        return getattr(target, self._method_name).remote(*args, **kwargs)
