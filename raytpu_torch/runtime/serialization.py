"""Pickling for the port's runtime, the role of
:mod:`raytpu.runtime.serialization` without ``cloudpickle`` (the card's
machine has none).

It is the standard pickler with ``multiprocessing``'s reductions (those
of ``torch.multiprocessing`` included: a CUDA tensor crosses by CUDA IPC
as before) and two additions:

- **by value, what cannot be found by name**: lambdas, closures,
  functions and classes defined inside functions, and those of a
  ``__main__`` that the children cannot import (``python -c``, stdin, or
  any ``__main__`` of a process that joined another driver's tree).
  A function goes as its code object through :mod:`marshal`, its
  closure cells, defaults, keyword defaults, ``__dict__`` and the
  globals its code names (modules by name, everything else by value,
  recursively); a class as its name, bases, metaclass and ``__dict__``.
  Both are rebuilt as a skeleton first and filled after (pickle's
  ``state_setter``), so cycles (a recursive function, a method whose
  ``super()`` cell holds its class) resolve through the memo. ``marshal``
  is safe here because both ends are the same interpreter: every
  process of the tree runs the executable of the driver that spawned
  it. What a module-level name finds goes by name, as before.
- **CPU tensors out of band**: a CPU tensor (or ``nn.Parameter``) is
  reduced to its raw bytes as a pickle-5 buffer, which the object store
  (:mod:`raytpu_torch.runtime.object_store`) always puts into the sealed
  shared-memory segment of the value, with the value's numpy arrays (and
  any other pickle-5 buffer) of 64 KiB or more. Rebuilt inside a
  segment, a tensor is a view of the segment's storage (``is_shared()``,
  no copy); elsewhere it is a copy of the bytes.

Only bytes that this tree's processes wrote are unpickled.
"""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import sys
import threading
import types
from multiprocessing.reduction import ForkingPickler

import numpy as np
import torch

PROTOCOL = 5


class _TensorBytes(np.ndarray):
    """A CPU tensor's bytes as a pickle buffer: the store always puts it
    out of band."""


class _Empty:
    """An unbound closure cell."""


def _lookup(module: str, qualname: str):
    found = sys.modules.get(module)
    if found is None:
        try:
            found = importlib.import_module(module)
        except Exception:  # not importable here: the object goes by value
            return None
    for part in qualname.split("."):
        found = getattr(found, part, None)
        if found is None:
            return None
    return found


# Set in a process that joined another driver's tree: what it sends may
# run in processes that driver started, which import the driver's
# ``__main__``, not this one's.
_MAIN_BY_VALUE = [False]


def main_by_value() -> None:
    """Send this process's ``__main__`` functions and classes by value."""
    _MAIN_BY_VALUE[0] = True


def _main_importable() -> bool:
    """Whether the children re-import ``__main__`` (spawn and forkserver
    do, as ``__mp_main__``, when it is a file, unless this process joined
    another driver's tree)."""
    if _MAIN_BY_VALUE[0]:
        return False
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    return bool(path) and not path.startswith("<")


def by_name(obj) -> bool:
    """Whether ``obj`` (a function or class) is found by its module and
    qualified name, as pickle looks it up."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if module is None or qualname is None or "<" in qualname:
        return False
    if module == "__main__" and not _main_importable():
        return False
    return _lookup(module, qualname) is obj


def _names_of(code: types.CodeType, out: set) -> set:
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _names_of(const, out)
    return out


def _cell_value(cell):
    try:
        return cell.cell_contents
    except ValueError:  # not bound yet
        return _Empty


def _make_function(code: bytes, name: str, module: str, n_cells: int):
    code = marshal.loads(code)
    scope = {"__builtins__": builtins, "__name__": module}
    cells = (tuple(types.CellType() for _ in range(n_cells))
             if n_cells else None)
    return types.FunctionType(code, scope, name, None, cells)


def _set_function_state(fn, state: dict) -> None:
    fn.__globals__.update(state["globals"])
    for cell, value in zip(fn.__closure__ or (), state["closure"] or ()):
        if value is not _Empty:
            cell.cell_contents = value
    fn.__defaults__ = state["defaults"]
    fn.__kwdefaults__ = state["kwdefaults"]
    fn.__qualname__ = state["qualname"]
    fn.__module__ = state["module"]
    fn.__doc__ = state["doc"]
    if state["dict"]:
        fn.__dict__.update(state["dict"])


def _function_reduce(fn: types.FunctionType):
    scope = fn.__globals__
    names = _names_of(fn.__code__, set())
    closure = fn.__closure__
    state = {
        "globals": {n: scope[n] for n in sorted(names) if n in scope},
        "closure": None if closure is None else [_cell_value(c)
                                                 for c in closure],
        "defaults": fn.__defaults__, "kwdefaults": fn.__kwdefaults__,
        "qualname": fn.__qualname__, "module": fn.__module__,
        "doc": fn.__doc__, "dict": fn.__dict__ or None,
    }
    return (_make_function,
            (marshal.dumps(fn.__code__), fn.__name__, fn.__module__,
             0 if closure is None else len(closure)),
            state, None, None, _set_function_state)


# Entries of a class's __dict__ that its creation makes anew.
_CLASS_SKIP = {"__dict__", "__weakref__", "_abc_impl", "__abstractmethods__"}


def _make_class(meta, name: str, bases: tuple, namespace: dict):
    return types.new_class(name, bases, {"metaclass": meta},
                           lambda ns: ns.update(namespace))


def _set_class_state(cls, state: dict) -> None:
    for key, value in state.items():
        setattr(cls, key, value)


def _class_reduce(cls: type):
    namespace = {"__module__": cls.__module__,
                 "__qualname__": cls.__qualname__}
    if "__slots__" in cls.__dict__:
        namespace["__slots__"] = cls.__dict__["__slots__"]
    state = {k: v for k, v in cls.__dict__.items()
             if k not in _CLASS_SKIP and k not in namespace
             and not isinstance(v, (types.MemberDescriptorType,
                                    types.GetSetDescriptorType))}
    return (_make_class, (type(cls), cls.__name__, cls.__bases__, namespace),
            state, None, None, _set_class_state)


# In a thread that unseals a value: (the segment's uint8 tensor, its
# address), so that a tensor rebuilt from a buffer inside it is a view.
_UNSEALING = threading.local()


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool,
                    parameter: bool):
    dtype = getattr(torch, dtype)
    view = memoryview(buf)
    n = view.nbytes
    flat = None
    seg = getattr(_UNSEALING, "segment", None)
    if n == 0:
        t = torch.empty(shape, dtype=dtype)
    else:
        if seg is not None:
            address = np.frombuffer(view, np.uint8).ctypes.data
            offset = address - seg[1]
            if 0 <= offset and offset + n <= seg[0].numel():
                flat = seg[0][offset:offset + n]
        if flat is None:
            flat = torch.frombuffer(bytearray(view), dtype=torch.uint8)
        t = flat.view(dtype).view(shape)
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _tensor_reduce(t: torch.Tensor):
    data = t.detach()
    if not data.is_contiguous():
        data = data.contiguous()
    raw = data.reshape(-1).view(torch.uint8).numpy().view(_TensorBytes)
    return (_rebuild_tensor,
            (pickle.PickleBuffer(raw), str(t.dtype).split(".")[1],
             tuple(t.shape), t.requires_grad,
             type(t) is torch.nn.Parameter))


class Pickler(pickle.Pickler):
    """The standard pickler with ``multiprocessing``'s reductions, the
    by-value reductions above and CPU tensors as pickle-5 buffers."""

    def __init__(self, file, buffer_callback=None):
        super().__init__(file, PROTOCOL, buffer_callback=buffer_callback)
        self.dispatch_table = ForkingPickler._copyreg_dispatch_table.copy()
        self.dispatch_table.update(ForkingPickler._extra_reducers)

    def reducer_override(self, obj):
        kind = type(obj)
        if kind is types.FunctionType:
            return NotImplemented if by_name(obj) else _function_reduce(obj)
        if kind is torch.Tensor or kind is torch.nn.Parameter:
            if obj.device.type == "cpu" and obj.layout == torch.strided:
                return _tensor_reduce(obj)
            return NotImplemented
        if isinstance(obj, type):
            return NotImplemented if by_name(obj) else _class_reduce(obj)
        if kind is types.ModuleType:
            return importlib.import_module, (obj.__name__,)
        if kind is classmethod or kind is staticmethod:
            return kind, (obj.__func__,)
        if kind is property:
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        return NotImplemented


def dumps(obj, buffer_callback=None) -> bytes:
    buf = io.BytesIO()
    Pickler(buf, buffer_callback=buffer_callback).dump(obj)
    return buf.getvalue()


def loads(data, buffers=None):
    return pickle.loads(data, buffers=buffers)
