"""Meshes of ranks: the port of :mod:`raytpu.parallel.mesh`.

In the JAX package a mesh is a ``jax.sharding.Mesh`` of the local
devices, and every strategy is one ``shard_map`` program over it, in one
process. PyTorch has no such program: a rank is a process, and a
collective is a ``torch.distributed`` call on a process group. What
stands in for ``jax.sharding.Mesh`` here is :class:`Mesh`: an array of
the default process group's ranks with named axes (in the JAX axis
order, the slowest-varying axis first), the ``DeviceMesh`` over them with
one process group per axis, and this rank's coordinate in it.

The port forms no process group on its own: the default group comes
from the user's ``torch.distributed.init_process_group``, or from a
Train gang (:class:`raytpu_torch.train.DataParallelTrainer`, one rank a
worker process). A mesh on ``cuda`` (the default, as everywhere in the
port) needs an NCCL group, one on ``cpu`` a gloo group; neither moves to
the other. Building a mesh creates process groups, a collective of the
default group: every rank builds every mesh, in the same order, ranks
outside a mesh's ``ranks`` included.

:class:`AbstractMesh` has the axis sizes by name and no process group,
so that the sharding rules (:mod:`raytpu_torch.parallel.sharding`) can
be read without one. :class:`PartitionSpec` is the counterpart of
``jax.sharding.PartitionSpec``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

STANDARD_AXES = ("dp", "fsdp", "pp", "sp", "tp", "ep")


class PartitionSpec(tuple):
    """For each tensor dim, the mesh axis it is sharded over (a name, a
    tuple of names, major first), or None where it is replicated: the
    counterpart of ``jax.sharding.PartitionSpec``, a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


@dataclass
class MeshSpec:
    """Named axes → sizes. Size -1 means "absorb remaining ranks"."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolved(self, n_devices: int) -> Dict[str, int]:
        axes = {k: v for k, v in self.axes.items() if v != 1 or k in ("dp",)}
        if not axes:
            axes = {"dp": -1}
        wild = [k for k, v in axes.items() if v == -1]
        fixed = math.prod(v for v in axes.values() if v != -1)
        if n_devices % fixed != 0:
            raise ValueError(
                f"mesh axes {axes} do not divide {n_devices} devices"
            )
        if len(wild) > 1:
            raise ValueError("at most one axis may be -1")
        if wild:
            axes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh axes {axes} use {fixed} devices, have {n_devices}"
            )
        return axes

    def build(self, ranks: Optional[Sequence[int]] = None, *, device=None):
        return build_mesh(self.axes, ranks, device=device)


class AbstractMesh:
    """Axis names and sizes, with no ranks or process groups."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def _check_group(device: torch.device) -> None:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh is built over the default process group and none is "
            "initialized: call torch.distributed.init_process_group (one "
            "process a rank), or build it inside a Train gang's loop")
    backend = str(dist.get_backend()).lower()
    want = "nccl" if device.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(
            f"a mesh on {device.type} needs a {want} process group; the "
            f"default group's backend is {backend!r}")


class Mesh(AbstractMesh):
    """Ranks of the default process group on named axes: the counterpart
    of ``jax.sharding.Mesh(devices, axis_names)``, with ``ranks`` in
    place of the devices.

    ``device``: ``cuda`` (this process's card, NCCL) unless the caller
    asks for ``cpu`` (gloo), as :func:`raytpu_torch.resolve_device`.
    Every rank of the default group constructs every mesh, in the same
    order; on a rank outside ``ranks`` the mesh exists but has no
    coordinate, and its collectives raise."""

    def __init__(self, ranks, axis_names: Sequence[str], *, device=None):
        from torch.distributed.device_mesh import DeviceMesh

        from raytpu_torch import resolve_device

        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"ranks of shape {ranks.shape} for axes "
                             f"{tuple(axis_names)}")
        super().__init__(dict(zip(axis_names, ranks.shape)))
        self.ranks = ranks
        self.device = resolve_device(device)
        _check_group(self.device)
        self.device_mesh = DeviceMesh(
            self.device.type, torch.from_numpy(ranks),
            mesh_dim_names=self.axis_names)
        coordinate = self.device_mesh.get_coordinate()
        self.coordinate: Optional[Dict[str, int]] = (
            None if coordinate is None
            else dict(zip(self.axis_names, coordinate)))

    def _mine(self) -> Dict[str, int]:
        if self.coordinate is None:
            import torch.distributed as dist

            raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh "
                               f"of ranks {self.ranks.tolist()}")
        return self.coordinate

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        return self._mine()[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        self._mine()
        return self.device_mesh.get_group(axis)

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        coord = self._mine()
        index = tuple(slice(None) if name == axis else coord[name]
                      for name in self.axis_names)
        return self.ranks[index].tolist()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device.type})"


def build_mesh(axes: Dict[str, int], ranks: Optional[Sequence[int]] = None,
               *, device=None) -> Mesh:
    """A :class:`Mesh` with named axes over ``ranks`` (default: every rank
    of the default process group, in order).

    Axis order follows insertion order; put the slowest-varying axis
    first — ranks are assigned contiguously, and consecutive ranks share
    a host (and NVLink) where a job spans hosts, so the *innermost* axes
    get the fastest links (where tp/fsdp collectives live).
    """
    import torch.distributed as dist

    from raytpu_torch import resolve_device

    _check_group(resolve_device(device))
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    resolved = MeshSpec(dict(axes)).resolved(len(ranks))
    shape = tuple(resolved.values())
    return Mesh(np.asarray(ranks).reshape(shape), tuple(resolved),
                device=device)


def mesh_from_devices(ranks: Optional[Sequence[int]] = None, *,
                      dp: int = -1, fsdp: int = 1, pp: int = 1, sp: int = 1,
                      tp: int = 1, ep: int = 1, device=None) -> Mesh:
    """Convenience: standard axis order dp → fsdp → pp → sp → tp → ep."""
    axes = {}
    for name, size in (("dp", dp), ("fsdp", fsdp), ("pp", pp), ("sp", sp),
                       ("tp", tp), ("ep", ep)):
        if size != 1 or name == "dp":
            axes[name] = size
    return build_mesh(axes, ranks, device=device)


def mesh_from_chip_coords(coords: List[Tuple[int, ...]],
                          axes: Dict[str, int], ranks: Sequence[int], *,
                          device=None) -> Mesh:
    """Build a mesh over the ranks standing at the given physical chip
    coordinates (from a placement-group bundle), ordered so that mesh-axis
    neighbors are link neighbors (coordinates sorted lexicographically)."""
    order = sorted(range(len(coords)), key=lambda i: coords[i])
    ordered = [ranks[i] for i in order]
    return build_mesh(axes, ordered, device=device)
