"""The port's collectives (raytpu_torch/collective/) held to the JAX
package's (raytpu/collective/).

- The host plane: every case of tests/test_collective.py's
  ``TestHostCollectives`` as tasks of the port's runtime and as tasks of
  the JAX local backend, whose results must be equal, and equal to the JAX
  test's; the thread-reuse case as a task-reuse case (a task that reuses a
  worker process sees no group of an earlier task, through the runtime
  context's task-scope resets); the port's own cases: ranks racing to
  start one coordinator, in-place updates, a timeout, the backends.
- The device plane: every case of ``TestMeshOps`` on one gang of 8 rank
  processes of the port's runtime in one gloo world (a timeout of 60 s),
  each equal to the JAX ``shard_map`` result on the 8 virtual devices to
  the bit; and each op's gradient through ``group_call`` equal to
  ``jax.grad`` through the JAX ``group_call``.

This module imports nothing of JAX at its top: the port's processes
import it by name.
"""

import datetime
import importlib
import os
import socket
import time

import numpy as np
import pytest
import torch

import raytpu_torch as rt

WORLD = 8
T = 120.0  # any one get
PG_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def port():
    """The port's runtime: four task workers (the largest group of one
    case), and the gang's actors."""
    rt.init(num_cpus=4)
    yield rt
    rt.shutdown()


@pytest.fixture
def jax_local(port):
    """The JAX local backend, fresh for each case (the JAX test's
    fixture), beside the port's runtime."""
    import raytpu

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    yield raytpu
    raytpu.shutdown()


def _col(pkg: str):
    return importlib.import_module(f"{pkg}.collective")


def _spawn_ranks(mod, world, fn, *args):
    """Run fn(rank, world, *args) in `world` parallel tasks of ``mod``'s
    runtime; return the results."""
    remote_fn = mod.remote(fn)
    return mod.get([remote_fn.remote(r, world, *args) for r in range(world)],
                   timeout=T)


def _both(jax_local, fn, world, *args):
    """The same case through both packages: (JAX's results, the port's)."""
    return (_spawn_ranks(jax_local, world, fn, "raytpu", *args),
            _spawn_ranks(rt, world, fn, "raytpu_torch", *args))


# ---- the host plane --------------------------------------------------


def allreduce_sum(rank, world, pkg):
    col = _col(pkg)
    col.init_collective_group(world, rank, group_name=f"ar-{pkg}")
    return col.allreduce(np.full((4,), float(rank + 1)),
                         group_name=f"ar-{pkg}")


def allgather_and_broadcast(rank, world, pkg):
    col = _col(pkg)
    col.init_collective_group(world, rank, group_name=f"ag-{pkg}")
    gathered = col.allgather(np.array([rank]), group_name=f"ag-{pkg}")
    bcast = col.broadcast(np.array([rank * 10.0]), src_rank=2,
                          group_name=f"ag-{pkg}")
    return [g.item() for g in gathered], bcast.item()


def reducescatter(rank, world, pkg):
    col = _col(pkg)
    col.init_collective_group(world, rank, group_name=f"rs-{pkg}")
    # Each rank contributes ones(4); sum = world, rank r gets rows
    # [2r, 2r+2).
    return col.reducescatter(np.ones((4, 2)), group_name=f"rs-{pkg}")


def send_recv_and_barrier(rank, world, pkg):
    col = _col(pkg)
    col.init_collective_group(world, rank, group_name=f"p2p-{pkg}")
    col.barrier(group_name=f"p2p-{pkg}", timeout=30)
    if rank == 0:
        col.send(np.array([42.0]), dst_rank=1, group_name=f"p2p-{pkg}")
        return None
    return col.recv(0, group_name=f"p2p-{pkg}", timeout=30).item()


def rank_and_size_queries(rank, world, pkg):
    col = _col(pkg)
    name = f"q-{pkg}"
    assert col.get_rank(name) == -1
    col.init_collective_group(world, rank, group_name=name)
    assert col.is_group_initialized(name)
    r, s = col.get_rank(name), col.get_collective_group_size(name)
    col.destroy_collective_group(name)
    assert not col.is_group_initialized(name)
    return r, s


def op_order_mismatch(rank, world, pkg):
    col = _col(pkg)
    col.init_collective_group(world, rank, group_name=f"mm-{pkg}")
    try:
        if rank == 0:
            col.allreduce(np.ones(2), group_name=f"mm-{pkg}")
        else:
            col.allgather(np.ones(2), group_name=f"mm-{pkg}")
    except Exception as e:  # noqa: BLE001
        return type(e).__name__
    return "ok"


def test_allreduce_sum(jax_local):
    want, got = _both(jax_local, allreduce_sum, 4)
    expected = np.full((4,), 1.0 + 2 + 3 + 4)
    for r in want + got:
        np.testing.assert_array_equal(r, expected)


def test_allgather_and_broadcast(jax_local):
    want, got = _both(jax_local, allgather_and_broadcast, 3)
    assert got == want == [([0, 1, 2], 20.0)] * 3


def test_reducescatter(jax_local):
    want, got = _both(jax_local, reducescatter, 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.full((2, 2), 2.0))


def test_send_recv_and_barrier(jax_local):
    want, got = _both(jax_local, send_recv_and_barrier, 2)
    assert got == want and got[1] == 42.0


def test_rank_and_size_queries(jax_local):
    want, got = _both(jax_local, rank_and_size_queries, 2)
    assert sorted(got) == sorted(want) == [(0, 2), (1, 2)]


def test_op_order_mismatch_raises(jax_local):
    want, got = _both(jax_local, op_order_mismatch, 2)
    # At least one rank must observe the mismatch error, in both.
    assert any(r != "ok" for r in want) and any(r != "ok" for r in got)


def join_group(sleep_s):
    from raytpu_torch import collective

    collective.init_collective_group(1, 0, group_name="leaky")
    time.sleep(sleep_s)  # hold the worker, so that every worker joins
    return os.getpid(), collective.is_group_initialized("leaky")


def check_group():
    from raytpu_torch import collective

    return os.getpid(), collective.is_group_initialized("leaky")


def test_reused_worker_does_not_leak_group_state(port):
    """Task workers are reused across tasks; collective membership is the
    task's and must reset when it ends (a stale rank would make the next
    task skip init and reduce with wrong membership)."""
    joined = rt.get([rt.remote(join_group).remote(0.5) for _ in range(4)],
                    timeout=T)
    assert all(ok for _, ok in joined)
    checked = [rt.get(rt.remote(check_group).remote(), timeout=T)
               for _ in range(6)]
    assert {pid for pid, _ in checked} <= {pid for pid, _ in joined}
    assert not any(ok for _, ok in checked)


def in_place_and_timeout(rank, world, pkg):
    col = _col(pkg)
    name = f"ip-{pkg}"
    col.init_collective_group(world, rank, group_name=name)
    buf = np.full((3,), float(rank + 1))
    out = col.allreduce(buf, group_name=name, op=col.ReduceOp.MAX)
    src = np.array([rank * 1.5])
    col.broadcast(src, src_rank=1, group_name=name)
    frozen = np.full((2,), float(rank))
    frozen.flags.writeable = False
    col.allreduce(frozen, group_name=name)
    col.barrier(group_name=name, timeout=30)
    timed_out = None
    if rank == 0:  # rank 1 never joins this barrier
        try:
            col.barrier(group_name=name, timeout=0.5)
        except TimeoutError:
            timed_out = "TimeoutError"
    return buf.tolist(), out.tolist(), src.tolist(), frozen.tolist(), \
        timed_out


def test_in_place_updates_and_timeout(jax_local):
    want, got = _both(jax_local, in_place_and_timeout, 2)
    assert got == want
    assert got[0] == ([2.0] * 3, [2.0] * 3, [1.5], [0.0, 0.0],
                      "TimeoutError")


def test_backends_and_ranks_refused(port):
    from raytpu_torch import collective as col

    with pytest.raises(ValueError, match="unsupported"):
        col.init_collective_group(2, 0, backend="nccl", group_name="nb")
    with pytest.raises(ValueError, match="out of range"):
        col.init_collective_group(2, 2, group_name="nb")
    with pytest.raises(RuntimeError, match="not initialized"):
        col.allreduce(np.ones(2), group_name="never")


def tensor_contribution(rank, world, pkg):
    col = _col(pkg)
    col.init_collective_group(world, rank, group_name="tc")
    return col.allreduce(torch.full((2,), float(rank)), group_name="tc")


def test_tensors_are_contributed_as_numpy(port):
    for out in _spawn_ranks(rt, 2, tensor_contribution, "raytpu_torch"):
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, [1.0, 1.0])


# ---- the device plane ------------------------------------------------


class Rank:
    """One rank of the gang: an actor process of the port's runtime in
    one gloo world."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def free_port(self) -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def join(self, port_: int) -> int:
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port_}", rank=self.rank,
            world_size=self.world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        return self.rank

    def run(self, fn, *args):
        return fn(self.rank, *args)


@pytest.fixture(scope="module")
def gang(port):
    actors = [rt.remote(Rank).remote(r, WORLD) for r in range(WORLD)]
    addr = rt.get(actors[0].free_port.remote(), timeout=T)
    assert rt.get([a.join.remote(addr) for a in actors],
                  timeout=T) == list(range(WORLD))

    def run(fn, *args):
        return rt.get([a.run.remote(fn, *args) for a in actors], timeout=T)

    yield run
    for a in actors:
        rt.kill(a)


def _jax_call(n, axis, fn, x, in_specs, out_specs, grad_of=None):
    """The JAX ``group_call`` of ``fn`` on ``n`` virtual devices (and the
    gradient of ``sum(out * w)`` against x where ``grad_of`` is w)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from raytpu.collective import mesh_ops

    mesh = Mesh(np.array(jax.devices()[:n]), (axis,))

    def call(x):
        return mesh_ops.group_call(mesh, fn, x, in_specs=in_specs,
                                   out_specs=out_specs)

    out = jax.jit(call)(jnp.asarray(x))
    if grad_of is None:
        return out
    g = jax.jit(jax.grad(lambda x: (call(x) * grad_of).sum()))(
        jnp.asarray(x))
    return out, g


def _port_call(rank, n, axis, fn, x, in_specs, out_specs, w=None):
    """The port's ``group_call`` of ``fn`` on the first ``n`` ranks (every
    rank builds the mesh; the others return None)."""
    from raytpu_torch.collective import mesh_ops
    from raytpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({axis: n}, range(n), device="cpu")
    if rank >= n:
        return None
    x = torch.from_numpy(np.asarray(x)).requires_grad_(w is not None)
    out = mesh_ops.group_call(mesh, fn, x, in_specs=in_specs,
                              out_specs=out_specs)
    if w is None:
        return out
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), x.grad


def _specs(pkg, *entries):
    if pkg == "raytpu":
        from jax.sharding import PartitionSpec as P
    else:
        from raytpu_torch.parallel.mesh import PartitionSpec as P
    return P(*entries)


def _in_mesh(pkg):
    if pkg == "raytpu":
        from raytpu.collective import mesh_ops
    else:
        from raytpu_torch.collective import mesh_ops
    return mesh_ops


def reduce_gather_scatter(pkg):
    mo = _in_mesh(pkg)

    def f(x):
        s = mo.allreduce(x, "x")
        g = mo.allgather(x, "x")
        rs = mo.reducescatter(g, "x")
        return s, g, rs

    return f


def broadcast_and_ring(pkg):
    mo = _in_mesh(pkg)

    def f(x):
        return mo.broadcast(x, "x", src_rank=1), mo.send_next(x, "x", 4)

    return f


def ulysses_reshard(pkg):
    mo = _in_mesh(pkg)

    def f(x):  # x local: (seq/4, heads)
        return mo.all_to_all(x, "sp", split_axis=1, concat_axis=0)

    return f


def max_min_mean_barrier(pkg):
    mo = _in_mesh(pkg)

    def f(x):
        b = mo.barrier("x")
        return (mo.allreduce(x, "x", "max"), mo.allreduce(x, "x", "min"),
                mo.allreduce(x, "x", "mean"), x * 0 + b)

    return f


def partial_permute(pkg):
    mo = _in_mesh(pkg)

    def f(x):  # ranks 1 and 3 receive nothing: zeros
        return mo.ppermute(x, "x", [(0, 2), (2, 0), (1, 1)])

    return f


def _run_case(gang, case, n, axis, x, in_entries, out_entries, ulps=()):
    """The case through both packages, each output equal to the bit, but
    those listed in ``ulps``: sums of floats, whose order of addition is
    the backend's (XLA's on the virtual devices, gloo's here), within one
    float32 rounding a term."""
    want = _jax_call(n, axis, case("raytpu"), x,
                     _specs("raytpu", *in_entries),
                     tuple(_specs("raytpu", *e) for e in out_entries))
    got = gang(_port_call_case, case, n, axis, x, in_entries, out_entries)
    for rank, out in enumerate(got):
        if rank >= n:
            assert out is None
            continue
        for i, (g, w) in enumerate(zip(out, want)):
            assert tuple(g.shape) == tuple(w.shape)
            if i in ulps:
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=n * 2 ** -24, atol=0)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got[0]


def _port_call_case(rank, case, n, axis, x, in_entries, out_entries):
    return _port_call(rank, n, axis, case("raytpu_torch"), x,
                      _specs("raytpu_torch", *in_entries),
                      tuple(_specs("raytpu_torch", *e)
                            for e in out_entries))


def test_allreduce_allgather_in_mesh(gang):
    x = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    s, g, rs = _run_case(gang, reduce_gather_scatter, 8, "x", x, ("x",),
                         [("x",)] * 3)
    np.testing.assert_array_equal(s.numpy(), np.full((8, 1), 28.0))
    # all_gather tiled: every shard holds all 8 rows -> global (64, 1)
    assert tuple(g.shape) == (64, 1)
    # reduce_scatter of the gathered copy sums 8 copies then scatters:
    np.testing.assert_array_equal(rs.numpy().ravel(), np.arange(8.0) * 8)


def test_broadcast_and_ring(gang):
    x = np.arange(4.0, dtype=np.float32).reshape(4, 1)
    b, nxt = _run_case(gang, broadcast_and_ring, 4, "x", x, ("x",),
                       [("x",)] * 2)
    np.testing.assert_array_equal(b.numpy().ravel(), np.ones(4))
    np.testing.assert_array_equal(nxt.numpy().ravel(), [3.0, 0.0, 1.0, 2.0])


def test_all_to_all_ulysses_reshard(gang):
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    [out] = _run_case(gang, lambda pkg: (lambda f: lambda x: (f(x),))(
        ulysses_reshard(pkg)), 4, "sp", x, ("sp", None), [(None, "sp")])
    # Resharded: seq now full per shard, heads sharded.
    np.testing.assert_array_equal(out.numpy(), x)


def test_max_min_mean_and_barrier(gang):
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    mx, mn, mean, b = _run_case(gang, max_min_mean_barrier, 8, "x", x,
                                ("x",), [("x",)] * 4, ulps=(2,))
    np.testing.assert_array_equal(b.numpy(), np.full((8, 3), 8.0))


def test_partial_permutation_gives_zeros(gang):
    x = np.arange(1.0, 5.0, dtype=np.float32).reshape(4, 1)
    [out] = _run_case(gang, lambda pkg: (lambda f: lambda x: (f(x),))(
        partial_permute(pkg)), 4, "x", x, ("x",), [("x",)])
    np.testing.assert_array_equal(out.numpy().ravel(), [3.0, 2.0, 1.0, 0.0])


GRAD_CASES = {
    # name: (the op as fn(mesh_ops) -> f, x's shape, in spec, out spec)
    "allreduce": (lambda mo: lambda x: mo.allreduce(x, "x"), (8, 3),
                  ("x",), ("x",)),
    "allreduce_to_replicated": (lambda mo: lambda x: mo.allreduce(x, "x"),
                                (8, 3), ("x",), ()),
    "mean": (lambda mo: lambda x: mo.allreduce(x, "x", "mean"), (8, 3),
             ("x",), ("x",)),
    "allgather": (lambda mo: lambda x: mo.allgather(x, "x", axis=1),
                  (8, 2), ("x",), ("x",)),
    "allgather_untiled": (lambda mo: lambda x: mo.allgather(
        x, "x", axis=1, tiled=False), (8, 2), ("x",), ("x",)),
    "reducescatter": (lambda mo: lambda x: mo.reducescatter(x, "x"),
                      (64, 2), ("x",), ("x",)),
    "broadcast": (lambda mo: lambda x: mo.broadcast(x, "x", src_rank=3),
                  (8, 3), ("x",), ("x",)),
    "ppermute": (lambda mo: lambda x: mo.ppermute(
        x, "x", [(i, (3 * i + 1) % 8) for i in range(8)]), (8, 3), ("x",),
        ("x",)),
    "all_to_all": (lambda mo: lambda x: mo.all_to_all(
        x, "x", split_axis=1, concat_axis=0), (16, 8), ("x", None),
        (None, "x")),
    "replicated_input": (lambda mo: lambda x: x * (mo.allreduce(
        x, "x") + 1.0), (8, 3), (), ("x",)),
}


def _grad_case(rank, name, x, w):
    case = GRAD_CASES[name]
    return _port_call(rank, 8, "x", case[0](_in_mesh("raytpu_torch")), x,
                      _specs("raytpu_torch", *case[2]),
                      _specs("raytpu_torch", *case[3]), w)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_through_group_call_match_jax(gang, name):
    fn, shape, ins, outs = GRAD_CASES[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(shape).astype(np.float32)
    out_shape = _jax_call(8, "x", fn(_in_mesh("raytpu")), x,
                          _specs("raytpu", *ins),
                          _specs("raytpu", *outs)).shape
    w = rng.standard_normal(out_shape).astype(np.float32)
    want, want_g = _jax_call(8, "x", fn(_in_mesh("raytpu")), x,
                             _specs("raytpu", *ins), _specs("raytpu", *outs),
                             grad_of=w)
    for out, g in gang(_grad_case, name, x, w):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6,
                                   atol=1e-6)


def _shard_views(rank):
    """``group_call`` on 8 ranks: whether each shard is a view of its
    global input, whether an output no axis gathers is a view of ``fn``'s,
    and the gradients through both."""
    from raytpu_torch.collective import mesh_ops
    from raytpu_torch.parallel.mesh import PartitionSpec as P, build_mesh

    mesh = build_mesh({"x": 8}, device="cpu")
    x = torch.arange(48, dtype=torch.float32).reshape(16, 3)
    x.requires_grad_()
    seen = {}

    def sharded(xl):
        seen["shard"] = (xl.untyped_storage().data_ptr()
                         == x.untyped_storage().data_ptr())
        return xl * 2.0

    def replicated(xl):
        seen["whole"] = (xl.untyped_storage().data_ptr()
                         == x.untyped_storage().data_ptr())
        seen["y"] = xl * 3.0
        return seen["y"]

    out = mesh_ops.group_call(mesh, sharded, x, in_specs=P("x"),
                              out_specs=P("x"))
    whole = mesh_ops.group_call(mesh, replicated, x, in_specs=P(),
                                out_specs=P())
    seen["out"] = (whole.untyped_storage().data_ptr()
                   == seen.pop("y").untyped_storage().data_ptr())
    (out.sum() + whole.sum()).backward()
    return seen, out.detach(), whole.detach(), x.grad


def test_group_call_shards_and_outputs_are_views(gang):
    """A shard is a view of its global input and an output that no axis
    gathers a view of ``fn``'s: group_call copies neither. The gradients
    are still those of the one global function (2 + 3 everywhere)."""
    x = np.arange(48, dtype=np.float32).reshape(16, 3)
    for seen, out, whole, g in gang(_shard_views):
        assert seen == {"shard": True, "whole": True, "out": True}
        np.testing.assert_array_equal(out.numpy(), 2.0 * x)
        np.testing.assert_array_equal(whole.numpy(), 3.0 * x)
        np.testing.assert_array_equal(g.numpy(), np.full_like(x, 5.0))
