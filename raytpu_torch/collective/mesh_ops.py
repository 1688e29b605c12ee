"""Device-plane collectives over a mesh's axes: the port of
:mod:`raytpu.collective.mesh_ops`.

In the JAX package these are ops inside one ``shard_map`` program over
the local devices. Here a rank is a process and each op is a
``torch.distributed`` call on the process group of this rank's line
along the named axis of a :class:`~raytpu_torch.parallel.mesh.Mesh`
(NCCL on the card, gloo on the CPU). What stands in for ``shard_map`` is
:func:`group_call`: every rank of the mesh calls it with the same global
arguments; each takes its shard of them by ``in_specs``, runs ``fn`` with
the mesh bound (so the ops below find it by axis name), and assembles the
global result by ``out_specs``, gathering over the sharded dims. Every
rank must make the same calls in the same order, as every device runs
the same program in JAX.

Gradients. The ops that carry gradients are ``torch.autograd.Function``
s with the transposes ``shard_map`` gives them in JAX (its unchecked
form, ``check_vma=False``, as the JAX ``group_call``): ``allreduce``'s
is an all-reduce of the cotangent, ``allgather``'s a reduce-scatter and
``reducescatter``'s an all-gather, ``ppermute``'s the inverse permutation,
``all_to_all``'s the inverse exchange, ``broadcast``'s an all-reduce kept
on the source. At :func:`group_call`'s boundary, each rank holds the same
global output and computes the same loss from it: an output's cotangent
is sliced to the rank's shard and divided by the ranks that hold the
same shard (the axes its spec leaves out), and an input's gradient is
gathered over the axes its spec shards and summed over the others, so
that every rank ends with the gradient of the one global function, equal
to the unsharded computation's. The backward's collectives run in the
same order on every rank only if every rank builds the same graph: branch
on a rank's index with ``torch.where``, not with ``if``.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Sequence

import torch

from raytpu_torch.parallel.mesh import Mesh, PartitionSpec

P = PartitionSpec

_BOUND = threading.local()


@contextlib.contextmanager
def _bind(mesh: Mesh):
    """Bind ``mesh`` for the ops below in this thread, around
    :func:`group_call`'s ``fn``."""
    prev = getattr(_BOUND, "mesh", None)
    _BOUND.mesh = mesh
    try:
        yield mesh
    finally:
        _BOUND.mesh = prev


def _bound() -> Mesh:
    """The mesh bound in this thread by :func:`group_call`."""
    mesh = getattr(_BOUND, "mesh", None)
    if mesh is None:
        raise RuntimeError("no mesh bound: call inside group_call")
    return mesh


def axis_index(axis_name: str) -> int:
    """This rank's index along the axis (``lax.axis_index``)."""
    return _bound().axis_index(axis_name)


def axis_size(axis_name: str) -> int:
    """The axis's size (``lax.psum(1, axis_name)``)."""
    return _bound().shape[axis_name]


# ---- the collectives, forward only -------------------------------------

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "mean": "SUM"}


def _all_reduce(x, mesh: Mesh, axis: str, op: str):
    import torch.distributed as dist

    if op not in _OPS:
        raise ValueError(f"unsupported in-mesh reduce op {op!r}")
    y = x.contiguous().clone()
    dist.all_reduce(y, op=getattr(dist.ReduceOp, _OPS[op]),
                    group=mesh.group(axis))
    return y / mesh.shape[axis] if op == "mean" else y


def _all_gather(x, mesh: Mesh, axis: str, dim: int):
    import torch.distributed as dist

    n = mesh.shape[axis]
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((n * front.shape[0],) + front.shape[1:])
    dist.all_gather_into_tensor(out, front, group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x, mesh: Mesh, axis: str, dim: int):
    import torch.distributed as dist

    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"reducescatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide over {axis}={n}")
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // n,) + front.shape[1:])
    dist.reduce_scatter_tensor(out, front, group=mesh.group(axis))
    return out.movedim(0, dim).contiguous()


def _permute(x, mesh: Mesh, axis: str, perm):
    """``lax.ppermute``: this rank sends to the ``dst`` of its pair and
    takes the ``src`` of its pair; a rank that takes from none gets
    zeros."""
    import torch.distributed as dist

    me = mesh.axis_index(axis)
    ranks = mesh.axis_ranks(axis)
    group = mesh.group(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _all_to_all(x, mesh: Mesh, axis: str, split_axis: int, concat_axis: int):
    """Tiled ``lax.all_to_all``: chunk j of ``split_axis`` goes to rank j;
    the chunks taken are concatenated along ``concat_axis`` in source
    order."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not divide over {axis}={n}")
    front = x.movedim(split_axis, 0)
    chunks = front.reshape((n, front.shape[0] // n) + front.shape[1:])
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.group(axis))
    return torch.cat([piece.movedim(0, split_axis) for piece in out.unbind(0)],
                     dim=concat_axis)


# ---- the autograd Functions --------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, op):
        ctx.mesh, ctx.axis, ctx.op = mesh, axis, op
        return _all_reduce(x, mesh, axis, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.op in ("max", "min"):
            raise NotImplementedError(
                f"allreduce {ctx.op!r} has no transpose (as lax.p{ctx.op})")
        return _all_reduce(g, ctx.mesh, ctx.axis, ctx.op), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None,
                None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        import torch.distributed as dist

        ctx.mesh, ctx.axis, ctx.src = mesh, axis, src
        y = x.contiguous().clone()
        dist.broadcast(y, mesh.axis_ranks(axis)[src], group=mesh.group(axis))
        return y

    @staticmethod
    def backward(ctx, g):
        # The masked psum's transpose: the sum of the cotangents, on the
        # source only.
        out = _all_reduce(g, ctx.mesh, ctx.axis, "sum")
        if ctx.mesh.axis_index(ctx.axis) != ctx.src:
            out = torch.zeros_like(out)
        return out, None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((dst, src) for src, dst in ctx.perm)
        return _permute(g, ctx.mesh, ctx.axis, inverse), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return _all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all(g, mesh, axis, concat_axis, split_axis), None,
                None, None, None)


# ---- the JAX package's names -------------------------------------------


def allreduce(x, axis_name: str, op: str = "sum"):
    """psum/pmax/pmin/pmean over a mesh axis (NCCL or gloo all-reduce)."""
    if op not in _OPS:
        raise ValueError(f"unsupported in-mesh reduce op {op!r}")
    return _AllReduce.apply(x, _bound(), axis_name, op)


def allgather(x, axis_name: str, axis: int = 0, tiled: bool = True):
    """The shards concatenated along ``axis`` (``tiled``), or stacked on
    a new ``axis``."""
    if not tiled:
        axis = axis % (x.dim() + 1)
        x = x.unsqueeze(axis)
    return _AllGather.apply(x, _bound(), axis_name, axis % x.dim())


def reducescatter(x, axis_name: str, axis: int = 0):
    return _ReduceScatter.apply(x, _bound(), axis_name,
                                axis % x.dim())


def broadcast(x, axis_name: str, src_rank: int = 0):
    """Every shard gets the value of the shard at ``src_rank`` along the
    axis (JAX: a masked psum; here a broadcast, the same values)."""
    return _Broadcast.apply(x, _bound(), axis_name, src_rank)


def ppermute(x, axis_name: str, perm: Sequence[tuple]):
    return _Permute.apply(x, _bound(), axis_name,
                          tuple((int(s), int(d)) for s, d in perm))


def send_next(x, axis_name: str, world: int):
    """Ring shift by +1 along the axis (the ring-attention building block)."""
    perm = [(i, (i + 1) % world) for i in range(world)]
    return ppermute(x, axis_name, perm)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int):
    """The Ulysses primitive: resharding between sequence- and head-sharded
    layouts is one all-to-all (tiled)."""
    return _AllToAll.apply(x, _bound(), axis_name,
                           split_axis % x.dim(), concat_axis % x.dim())


def barrier(axis_name: str):
    """A cheap synchronization point: the all-reduce of a unit scalar."""
    m = _bound()
    return _all_reduce(torch.ones((), dtype=torch.int32, device=m.device), m,
                       axis_name, "sum")


# ---- group_call: the port's shard_map ----------------------------------


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _sharded_axes(spec: PartitionSpec) -> set:
    return {a for entry in spec for a in _axes(entry)}


def _slice(x, mesh: Mesh, spec: PartitionSpec):
    """This rank's shard of the global ``x``."""
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        index = 0
        for a in axes:  # major first
            index = index * mesh.shape[a] + mesh.axis_index(a)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide over {axes} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, index * step, step)
    return x


def _assemble(x, mesh: Mesh, spec: PartitionSpec):
    """The global value from this rank's shard: gathered over each
    sharded dim's axes, minor first."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if mesh.shape[a] > 1:
                x = _all_gather(x, mesh, a, dim)
    return x


def _unmentioned(mesh: Mesh, spec: PartitionSpec) -> list:
    named = _sharded_axes(spec)
    return [a for a in mesh.axis_names if a not in named
            and mesh.shape[a] > 1]


class _Shard(torch.autograd.Function):
    """Take this rank's shard of a global input. Transpose: the global
    gradient, gathered over the sharded axes and summed over the
    others."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        local = _slice(x, mesh, spec)
        return x.view_as(x) if local is x else local

    @staticmethod
    def backward(ctx, g):
        g = _assemble(g, ctx.mesh, ctx.spec)
        for a in _unmentioned(ctx.mesh, ctx.spec):
            g = _all_reduce(g, ctx.mesh, a, "sum")
        return g, None, None


class _Unshard(torch.autograd.Function):
    """Assemble a global output from the shards. Transpose: this rank's
    shard of the cotangent, divided by the ranks that hold the same
    shard."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        out = _assemble(x, mesh, spec)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        copies = math.prod(ctx.mesh.shape[a]
                           for a in _unmentioned(ctx.mesh, ctx.spec))
        g = _slice(g, ctx.mesh, ctx.spec)
        return (g / copies if copies > 1 else g), None, None


def _check_spec(spec, mesh: Mesh, x) -> PartitionSpec:
    spec = PartitionSpec(*spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a tensor of {x.dim()} dims")
    for a in _sharded_axes(spec):
        if a not in mesh.shape:
            raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                             f"{mesh}")
    return spec


def _tree_map(fn, spec, value):
    """Apply ``fn(spec, leaf)`` to each tensor leaf of ``value``, ``spec``
    a prefix of its structure (dicts, lists, tuples), as ``shard_map``
    reads ``in_specs`` and ``out_specs``."""
    if isinstance(spec, PartitionSpec) or spec is None:
        spec = spec if spec is not None else PartitionSpec()
        if isinstance(value, torch.Tensor):
            return fn(spec, value)
        if isinstance(value, dict):
            return {k: _tree_map(fn, spec, v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(_tree_map(fn, spec, v) for v in value)
        return value
    if isinstance(spec, dict):
        return {k: _tree_map(fn, spec[k], v) for k, v in value.items()}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(value):
            raise ValueError(f"{len(spec)} specs for {len(value)} values")
        return type(value)(_tree_map(fn, s, v) for s, v in zip(spec, value))
    raise TypeError(f"not a spec: {spec!r}")


def group_call(mesh: Mesh, fn: Callable, *args, in_specs=None,
               out_specs=None):
    """Run ``fn`` SPMD over ``mesh`` with the ops above bound to the
    mesh's axis names: the counterpart of ``shard_map``. Every rank of
    the mesh calls it with the same global ``args``; it returns the same
    global result on every rank. ``in_specs`` and ``out_specs`` are
    :class:`~raytpu_torch.parallel.mesh.PartitionSpec` s (or trees of
    them, prefixes of the arguments' and the result's structure); a
    spec's default names every mesh axis, in order, on the leading dims.
    A shard is a view of its global input, and an output no axis gathers
    a view of ``fn``'s: neither is copied."""
    if in_specs is None:
        in_specs = PartitionSpec(*mesh.axis_names)
    if out_specs is None:
        out_specs = PartitionSpec(*mesh.axis_names)
    if isinstance(in_specs, PartitionSpec):
        in_specs = (in_specs,) * len(args)
    local = _tree_map(
        lambda s, x: _Shard.apply(x, mesh, _check_spec(s, mesh, x)),
        tuple(in_specs), tuple(args))
    with _bind(mesh):
        out = fn(*local)
    return _tree_map(
        lambda s, y: _Unshard.apply(y, mesh, _check_spec(s, mesh, y)),
        out_specs, out)
