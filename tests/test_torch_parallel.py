"""The port's parallel package (raytpu_torch/parallel/) held to the JAX
package's (raytpu/parallel/), in fp32 on the CPU.

The JAX side runs in this process on its 8 virtual devices, as
tests/test_parallel.py runs it. The port's side runs on one gang of 8
rank processes of the port's runtime, started once for the module, in one
gloo world (a timeout of 60 s: an op-order or shape mismatch fails the
test instead of hanging it); every test ships its function to all 8
ranks, and sub-meshes come from the same world. The same inputs, made
from a seed with numpy, go through both.

- Meshes: ``MeshSpec.resolved`` over a table of cases, ``build_mesh`` and
  ``mesh_from_devices`` shapes, ``mesh_from_chip_coords``' order, and the
  refusals (no process group, a backend that does not fit).
- Sharding rules: every parameter of tiny GPT-2, Llama and Mixtral, its
  spec on three meshes equal to the JAX spec of the leaf it is converted
  from (raytpu_torch/models/convert.py), transposed where the port stores
  ``weight [out, in]``; ``shard_params`` and ``shard_batch`` placements.
- Ring attention, Ulysses, the pipeline and MoE dispatch, forward and
  gradients, at the JAX tests' meshes and tolerances.
- Mixtral with its experts over ``ep=2``: logits, loss, every gradient and
  three AdamW steps against the unsharded port model, and the loss
  against the JAX model on the same weights.

This module imports nothing of JAX at its top: the rank processes import
it by name.
"""

import dataclasses
import datetime
import functools
import socket

import numpy as np
import pytest
import torch

import raytpu_torch as rt

WORLD = 8
T = 120.0  # any one get of a gang call
PG_TIMEOUT_S = 60
# fp32 bounds of the JAX tests (tests/test_parallel.py).
TOL = 2e-5           # ring attention and Ulysses against the reference
GRAD_TOL = 1e-4      # ring and pipeline gradients
PIPE_TOL = 1e-5      # the pipeline against the sequential stages
MOE_TOL = 1e-5       # MoE dispatch, output and gradients
MIXTRAL_TOL = 1e-5   # Mixtral over ep against the unsharded model
BF16_MAX, BF16_MEAN, LONG_TOL = 4e-2, 4e-3, 2e-4  # the 8k case


class Rank:
    """One rank of the gang: an actor process of the port's runtime in
    one gloo world."""

    def __init__(self, rank: int, world: int):
        self.rank, self.world = rank, world

    def free_port(self) -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def join(self, port: int) -> int:
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=self.rank,
            world_size=self.world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        return self.rank

    def run(self, fn, *args):
        return fn(self.rank, *args)


class Gang:
    def __init__(self, actors):
        self.actors = actors

    def run(self, fn, *args):
        """``fn(rank, *args)`` on every rank; the ranks' results in order."""
        return rt.get([a.run.remote(fn, *args) for a in self.actors],
                      timeout=T)


@pytest.fixture(scope="module")
def gang():
    rt.init(num_cpus=1)
    actors = [rt.remote(Rank).remote(r, WORLD) for r in range(WORLD)]
    port = rt.get(actors[0].free_port.remote(), timeout=T)
    assert rt.get([a.join.remote(port) for a in actors],
                  timeout=T) == list(range(WORLD))
    yield Gang(actors)
    for a in actors:
        rt.kill(a)
    rt.shutdown()


def _jax_mesh(axes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(axes.values())))
    devs = np.array(jax.devices()[:n]).reshape(tuple(axes.values()))
    return Mesh(devs, tuple(axes))


def _mesh(axes, ranks=None):
    """A port mesh on the CPU (gloo), over the gang's ranks."""
    from raytpu_torch.parallel.mesh import build_mesh

    return build_mesh(axes, ranks, device="cpu")


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=tol)


# ---- meshes ----------------------------------------------------------

MESH_CASES = [({"dp": 2, "tp": 4}, 8), ({"dp": -1, "tp": 2}, 8),
              ({"dp": 3, "tp": 2}, 8), ({"dp": -1, "tp": -1}, 8),
              ({"fsdp": 2, "tp": 2}, 8), ({"sp": 1}, 8), ({}, 4),
              ({"tp": 1, "ep": 4}, 8), ({"dp": 1, "fsdp": -1}, 6),
              ({"pp": 4, "dp": 2}, 8)]


@pytest.mark.parametrize("axes,n", MESH_CASES)
def test_meshspec_resolved_matches_jax(axes, n):
    from raytpu.parallel.mesh import MeshSpec as JaxMeshSpec

    from raytpu_torch.parallel.mesh import MeshSpec

    try:
        want = JaxMeshSpec(dict(axes)).resolved(n)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split(" ")[0]):
            MeshSpec(dict(axes)).resolved(n)
        return
    got = MeshSpec(dict(axes)).resolved(n)
    assert got == want and list(got) == list(want)


def _mesh_shapes(rank):
    from raytpu_torch.parallel.mesh import (build_mesh, mesh_from_chip_coords,
                                            mesh_from_devices)

    out = {}
    for name, axes in (("dp2_tp4", {"dp": 2, "tp": 4}),
                       ("wild", {"dp": -1, "tp": 2})):
        out[name] = build_mesh(axes, device="cpu").shape
    out["convenience"] = mesh_from_devices(fsdp=2, tp=2, device="cpu").shape
    try:
        build_mesh({"dp": 3, "tp": 2}, device="cpu")
        out["bad"] = None
    except ValueError as exc:
        out["bad"] = type(exc).__name__
    coords = [(1, 1), (0, 0), (1, 0), (0, 1), (3, 0), (2, 1), (2, 0), (3, 1)]
    ranks = [5, 2, 7, 0, 1, 3, 6, 4]
    m = mesh_from_chip_coords(coords, {"dp": 2, "tp": 4}, ranks, device="cpu")
    out["coords"] = m.ranks.tolist()
    out["coordinate"] = m.coordinate
    out["tp_line"] = m.axis_ranks("tp")
    return out


def test_build_mesh_matches_jax(gang):
    from raytpu.parallel.mesh import (build_mesh, mesh_from_chip_coords,
                                      mesh_from_devices)

    import jax

    got = gang.run(_mesh_shapes)
    want = {"dp2_tp4": dict(build_mesh({"dp": 2, "tp": 4}).shape),
            "wild": dict(build_mesh({"dp": -1, "tp": 2}).shape),
            "convenience": dict(mesh_from_devices(fsdp=2, tp=2).shape)}
    coords = [(1, 1), (0, 0), (1, 0), (0, 1), (3, 0), (2, 1), (2, 0), (3, 1)]
    ranks = [5, 2, 7, 0, 1, 3, 6, 4]
    devs = jax.devices()[:8]
    jm = mesh_from_chip_coords(coords, {"dp": 2, "tp": 4},
                               [devs[r] for r in ranks])
    want_coords = [[d.id for d in row] for row in jm.devices]
    for rank, out in enumerate(got):
        for key, shape in want.items():
            assert out[key] == shape and list(out[key]) == list(shape)
        assert out["bad"] == "ValueError"
        assert out["coords"] == want_coords
        at = np.argwhere(np.asarray(want_coords) == rank)[0]
        assert out["coordinate"] == {"dp": int(at[0]), "tp": int(at[1])}
        assert out["tp_line"] == want_coords[int(at[0])]


def _refusals(rank):
    from raytpu_torch.parallel import mesh

    out = {}
    try:
        mesh._check_group(torch.device("cuda", 0))
    except ValueError as exc:
        out["cuda_on_gloo"] = str(exc)
    try:
        mesh.build_mesh({"dp": -1})  # the default device: the card
    except RuntimeError as exc:
        out["default_device"] = str(exc)
    return out


def test_mesh_refuses_what_does_not_fit(gang):
    from raytpu_torch.parallel.mesh import build_mesh

    # No process group in this process: the port forms none on its own.
    with pytest.raises(RuntimeError, match="init_process_group"):
        build_mesh({"dp": -1}, device="cpu")
    for out in gang.run(_refusals):
        # A mesh on the card needs NCCL; gloo does not do instead.
        assert "nccl" in out["cuda_on_gloo"]
        # With no card, the default (cuda) raises: no move to the CPU.
        assert "CUDA" in out["default_device"]


# ---- the sharding rules ----------------------------------------------

RULE_MESHES = {"fsdp2_tp4": {"fsdp": 2, "tp": 4}, "dp8": {"dp": 8},
               "ep2_tp2": {"ep": 2, "tp": 2}}


def _patterned(shapes):
    """A numpy tree of the JAX shapes, each leaf id * 2**20 + its element
    index (float64, exact): what a port tensor holds names its leaf."""
    import jax

    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    out = [(i + 1) * 2.0 ** 20 + np.arange(int(np.prod(leaf.shape)),
                                           dtype=np.float64).reshape(
        leaf.shape) for i, leaf in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, out)


def _model(name):
    """(JAX param tree of numpy leaves, port converter, port config) of a
    tiny model."""
    import jax

    from raytpu_torch.models import convert

    if name == "gpt2":
        from raytpu.models.gpt2 import GPT2, GPT2Config, init_params

        from raytpu_torch.models.gpt2 import GPT2Config as PortConfig

        cfg = GPT2Config.tiny()
        model, pcfg, conv = GPT2(cfg), PortConfig.tiny(), \
            convert.gpt2_state_from_jax
    elif name == "llama":
        from raytpu.models.llama import Llama, LlamaConfig, init_params

        from raytpu_torch.models.llama import LlamaConfig as PortConfig

        cfg = LlamaConfig.tiny()
        model, pcfg, conv = Llama(cfg), PortConfig.tiny(), \
            convert.llama_state_from_jax
    else:
        from raytpu.models.mixtral import Mixtral, MixtralConfig, init_params

        from raytpu_torch.models.mixtral import MixtralConfig as PortConfig

        cfg = MixtralConfig.tiny()
        model, pcfg, conv = Mixtral(cfg), PortConfig.tiny(), \
            convert.mixtral_state_from_jax
    shapes = jax.eval_shape(lambda: init_params(model, cfg, batch=1))
    return _patterned(shapes), conv, pcfg


def _origin(t, flat):
    """(JAX path, layer index or None, transposed) of the port tensor
    ``t``: the leaf its values come from."""
    v = float(t.reshape(-1)[0])
    path, leaf = flat[int(v // 2 ** 20) - 1]
    a = t.numpy()
    for i, part in ([(None, leaf)] if leaf.ndim == a.ndim else
                    enumerate(leaf)):
        if part.shape == a.shape and np.array_equal(part, a):
            return path, i, False
        if part.ndim == 2 and part.T.shape == a.shape \
                and np.array_equal(part.T, a):
            return path, i, True
    raise AssertionError(f"no JAX leaf holds the values of {path}")


@pytest.mark.parametrize("mesh_name", sorted(RULE_MESHES))
@pytest.mark.parametrize("model_name", ["gpt2", "llama", "mixtral"])
def test_every_parameter_spec_matches_jax(model_name, mesh_name):
    import jax

    from raytpu.parallel.sharding import tree_shardings
    from raytpu.parallel.sharding import _path_str

    from raytpu_torch.parallel.mesh import AbstractMesh
    from raytpu_torch.parallel.sharding import TRANSFORMER_RULES

    axes = RULE_MESHES[mesh_name]
    params, conv, pcfg = _model(model_name)
    jspecs = {"/".join(_path_str(p) for p in path): s.spec for path, s in
              jax.tree_util.tree_leaves_with_path(
                  tree_shardings(params, _jax_mesh(axes)))}
    flat = [("/".join(_path_str(p) for p in path), leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)]
    state = conv(params, pcfg)
    mesh = AbstractMesh(axes)
    assert len(state) >= len(flat)
    seen = set()
    for name, t in state.items():
        path, layer, transposed = _origin(t, flat)
        seen.add(path)
        jspec = tuple(jspecs[path]) + (None,) * (np.ndim(dict(flat)[path])
                                                 - len(jspecs[path]))
        if layer is not None:
            jspec = jspec[1:]  # the scan's leading layer dim
        if transposed:
            jspec = jspec[::-1]
        got = TRANSFORMER_RULES.spec_for(name, t.dim(), mesh)
        got = tuple(got) + (None,) * (t.dim() - len(got))
        assert got == jspec, (name, path, got, jspec)
    assert seen == {p for p, _ in flat}


def test_transformer_rules_on_the_port_s_names():
    from raytpu_torch.parallel.mesh import AbstractMesh, PartitionSpec as P
    from raytpu_torch.parallel.sharding import TRANSFORMER_RULES

    mesh = AbstractMesh({"fsdp": 2, "tp": 4})
    # The JAX test's kernels [in, out] are weights [out, in] here.
    assert TRANSFORMER_RULES.spec_for(
        "h.0.attn.c_attn.weight", 2, mesh) == P("tp", "fsdp")
    assert TRANSFORMER_RULES.spec_for(
        "h.0.attn.c_proj.weight", 2, mesh) == P("fsdp", "tp")
    assert TRANSFORMER_RULES.spec_for("ln_f.scale", 1, mesh) == P(None)
    # Missing axes dropped.
    assert TRANSFORMER_RULES.spec_for(
        "h.0.attn.c_attn.weight", 2, AbstractMesh({"dp": 8})) == P(None, None)
    # The experts keep the JAX layout.
    assert TRANSFORMER_RULES.spec_for(
        "layers.0.moe.wi", 3, AbstractMesh({"ep": 2, "tp": 2})) == \
        P("ep", None, "tp")


def _shard_state(rank, state):
    from torch.distributed.tensor import Shard

    from raytpu_torch.parallel.sharding import shard_batch, shard_params

    out = {}
    mesh = _mesh({"fsdp": 4, "tp": 2})
    placed = shard_params({"mlp.c_fc.weight": torch.ones(256, 64)}, mesh)
    out["c_fc"] = [repr(p) for p in placed["mlp.c_fc.weight"].placements]
    out["c_fc_local"] = tuple(placed["mlp.c_fc.weight"].to_local().shape)
    sharded = shard_params(state, _mesh({"fsdp": 2, "tp": 4}))
    out["full_equal"] = all(torch.equal(sharded[k].full_tensor(), v)
                            for k, v in state.items())
    out["placements"] = {k: [repr(p) for p in v.placements]
                         for k, v in sharded.items()}
    dp = _mesh({"dp": 8})
    batch = shard_batch({"x": torch.ones(16, 32), "y": torch.ones(16)}, dp)
    out["x"] = [p == Shard(0) for p in batch["x"].placements]
    out["x_local"] = tuple(batch["x"].to_local().shape)
    sp = _mesh({"dp": 2, "sp": 4})
    seq = shard_batch(torch.arange(4 * 8.).reshape(4, 8), sp)
    out["seq"] = [repr(p) for p in seq.placements]
    out["seq_local"] = seq.to_local().tolist()
    return out


def test_shard_params_and_shard_batch_place_as_jax(gang):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from raytpu.parallel.sharding import shard_batch, shard_params

    from raytpu_torch.models.llama import Llama, LlamaConfig
    from raytpu_torch.parallel.mesh import AbstractMesh
    from raytpu_torch.parallel.sharding import tree_shardings

    jm = _jax_mesh({"fsdp": 4, "tp": 2})
    j = shard_params({"mlp": {"c_fc": {"kernel": jnp.ones((64, 256))}}}, jm)
    assert j["mlp"]["c_fc"]["kernel"].sharding.spec == JP("fsdp", "tp")
    jb = shard_batch({"x": jnp.ones((16, 32)), "y": jnp.ones((16,))},
                     _jax_mesh({"dp": 8}))
    assert jb["x"].sharding.spec == JP("dp", None)
    state = Llama(LlamaConfig.tiny(), device="cpu", seed=0,
                  param_dtype=torch.float32).state_dict()
    want = {k: [repr(p) for p in v] for k, v in tree_shardings(
        state, AbstractMesh({"fsdp": 2, "tp": 4})).items()}
    for rank, out in enumerate(gang.run(_shard_state, state)):
        # kernel [64, 256] P("fsdp", "tp") is weight [256, 64] here:
        # mesh dim fsdp splits dim 1, tp dim 0.
        assert out["c_fc"] == ["Shard(dim=1)", "Shard(dim=0)"]
        assert out["c_fc_local"] == (128, 16)
        assert out["full_equal"] and out["placements"] == want
        assert out["x"] == [True] and out["x_local"] == (2, 32)
        assert out["seq"] == ["Shard(dim=0)", "Shard(dim=1)"]
        dp, sp = divmod(rank, 4)
        want_seq = np.arange(32.).reshape(4, 8)[2 * dp:2 * dp + 2,
                                                  2 * sp:2 * sp + 2]
        assert out["seq_local"] == want_seq.tolist()


# ---- ring attention and Ulysses --------------------------------------


def _ring(rank, axes, q, k, v, causal, dtype=None):
    from raytpu_torch.parallel.ring_attention import ring_attention_sharded

    mesh = _mesh(axes)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    if dtype is not None:
        q, k, v = (x.to(dtype) for x in (q, k, v))
    return ring_attention_sharded(q, k, v, mesh, causal=causal).float()


def _jax_ring(axes, q, k, v, causal, dtype=None):
    import jax
    import jax.numpy as jnp

    from raytpu.parallel.ring_attention import ring_attention_sharded

    q, k, v = (jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)
               for x in (q, k, v))
    fn = jax.jit(functools.partial(ring_attention_sharded,
                                   mesh=_jax_mesh(axes), causal=causal))
    return np.asarray(fn(q, k, v), np.float32)


@pytest.mark.parametrize("axes,shape,causal", [
    ({"sp": 8}, (2, 4, 64, 16), True),
    ({"sp": 4, "dp": 2}, (2, 2, 32, 8), False)])
def test_ring_attention_matches_jax(gang, axes, shape, causal):
    import jax

    from raytpu.parallel.ring_attention import reference_attention

    q, k, v = (_normal(s, shape) for s in (0, 1, 2))
    want = _jax_ring(axes, q, k, v, causal)
    ref = np.asarray(jax.jit(functools.partial(
        reference_attention, causal=causal))(q, k, v))
    for got in gang.run(_ring, axes, q, k, v, causal):
        _close(got, want, TOL)
        _close(got, ref, TOL)


def test_ring_attention_at_8k(gang):
    """The JAX 8k case: bf16 inputs against an fp32 reference at the bf16
    bounds, and the fp32 path at 2e-4, each also against JAX's ring."""
    import jax
    import jax.numpy as jnp

    from raytpu.parallel.ring_attention import reference_attention

    shape = (1, 1, 8192, 64)
    q, k, v = (_normal(s, shape) for s in (7, 8, 9))
    ref = np.asarray(jax.jit(reference_attention)(q, k, v))
    want16 = _jax_ring({"sp": 8}, q, k, v, True, jnp.bfloat16)
    got16 = gang.run(_ring, {"sp": 8}, q, k, v, True, torch.bfloat16)
    want32 = _jax_ring({"sp": 8}, q, k, v, True)
    got32 = gang.run(_ring, {"sp": 8}, q, k, v, True)
    for g16, g32 in zip(got16, got32):
        err = np.abs(g16.numpy() - ref)
        assert err.max() < BF16_MAX and err.mean() < BF16_MEAN
        # bf16 results one rounding apart at most from JAX's.
        _close(g16, want16, 2 ** -7)
        _close(g32, ref, LONG_TOL)
        _close(g32, want32, LONG_TOL)


def _ring_grads(rank, q, k, v):
    from raytpu_torch.parallel.ring_attention import ring_attention_sharded

    mesh = _mesh({"sp": 8})
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ring_attention_sharded(q, k, v, mesh).sum().backward()
    return [x.grad for x in (q, k, v)]


def test_ring_attention_gradients_match_jax(gang):
    import jax
    import jax.numpy as jnp

    from raytpu.parallel.ring_attention import (reference_attention,
                                                ring_attention_sharded)

    shape = (1, 2, 32, 8)
    q, k, v = (_normal(s, shape) for s in (3, 4, 5))
    mesh = _jax_mesh({"sp": 8})
    want = jax.jit(jax.grad(lambda *a: ring_attention_sharded(*a, mesh).sum(),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ref = jax.jit(jax.grad(lambda *a: reference_attention(*a).sum(),
                           argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for grads in gang.run(_ring_grads, q, k, v):
        for g, w, r in zip(grads, want, ref):
            _close(g, w, GRAD_TOL)
            _close(g, r, GRAD_TOL)


def _ulysses(rank, q, k, v):
    from raytpu_torch.parallel.ulysses import ulysses_attention_sharded

    mesh = _mesh({"sp": 8})
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ulysses_attention_sharded(q, k, v, mesh, causal=True)
    (out * torch.arange(out.numel()).reshape(out.shape).sin()).sum() \
        .backward()
    return out.detach(), [x.grad for x in (q, k, v)]


def test_ulysses_matches_jax(gang):
    import jax
    import jax.numpy as jnp

    from raytpu.parallel.ring_attention import reference_attention
    from raytpu.parallel.ulysses import ulysses_attention_sharded

    shape = (2, 8, 64, 16)  # h divisible by sp
    q, k, v = (_normal(s, shape) for s in (10, 11, 12))
    mesh = _jax_mesh({"sp": 8})
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax.jit(functools.partial(ulysses_attention_sharded, mesh=mesh,
                                     causal=True))(jq, jk, jv)
    ref = jax.jit(reference_attention)(jq, jk, jv)
    w = jnp.sin(jnp.arange(want.size, dtype=jnp.float32)).reshape(want.shape)
    want_g = jax.jit(jax.grad(lambda *a: (ulysses_attention_sharded(
        *a, mesh, causal=True) * w).sum(), argnums=(0, 1, 2)))(jq, jk, jv)
    for out, grads in gang.run(_ulysses, q, k, v):
        _close(out, want, TOL)
        _close(out, ref, TOL)
        for g, wg in zip(grads, want_g):
            _close(g, wg, GRAD_TOL)


# ---- the pipeline ----------------------------------------------------


def _stage(p, h):
    return torch.tanh(h @ p["w"])


def _pipeline(rank, axes, ws, x, n_micro, grads):
    from raytpu_torch.parallel.pipeline import pipelined_apply

    mesh = _mesh(axes)
    ws = torch.from_numpy(ws).requires_grad_(grads)
    out = pipelined_apply(_stage, {"w": ws}, torch.from_numpy(x), mesh,
                          n_micro=n_micro)
    if not grads:
        return out
    (out ** 2).mean().backward()
    return out.detach(), ws.grad


def test_pipeline_matches_jax_and_the_sequential_stages(gang):
    import jax
    import jax.numpy as jnp

    from raytpu.parallel.pipeline import pipelined_apply

    n_stages, b, dim = 8, 16, 32
    ws = _normal(4, (n_stages, dim, dim), dim ** -0.5)
    x = _normal(5, (b, dim))
    want = jax.jit(lambda w, h: pipelined_apply(
        lambda p, a: jnp.tanh(a @ p["w"]), {"w": w}, h, _jax_mesh({"pp": 8}),
        n_micro=4))(ws, x)
    seq = torch.from_numpy(x)
    for i in range(n_stages):
        seq = torch.tanh(seq @ torch.from_numpy(ws[i]))
    for got in gang.run(_pipeline, {"pp": 8}, ws, x, 4, False):
        _close(got, want, PIPE_TOL)
        _close(got, seq, PIPE_TOL)


def test_pipeline_gradients_match_jax(gang):
    import jax
    import jax.numpy as jnp

    from raytpu.parallel.pipeline import pipelined_apply

    n_stages, b, dim = 4, 8, 16
    ws = _normal(6, (n_stages, dim, dim), dim ** -0.5)
    x = _normal(7, (b, dim))
    mesh = _jax_mesh({"pp": 4, "dp": 2})

    def loss(w):
        out = pipelined_apply(lambda p, h: jnp.tanh(h @ p["w"]), {"w": w},
                              jnp.asarray(x), mesh, n_micro=2)
        return (out ** 2).mean()

    want = jax.jit(jax.grad(loss))(jnp.asarray(ws))

    def unsharded(w):
        h = torch.from_numpy(x)
        for i in range(n_stages):
            h = torch.tanh(h @ w[i])
        return (h ** 2).mean()

    w = torch.from_numpy(ws).requires_grad_()
    unsharded(w).backward()
    for _, g in gang.run(_pipeline, {"pp": 4, "dp": 2}, ws, x, 2, True):
        _close(g, want, GRAD_TOL)
        _close(g, w.grad, GRAD_TOL)


# ---- MoE dispatch ----------------------------------------------------


def _moe(rank, params, x, r):
    from raytpu_torch.collective.mesh_ops import group_call
    from raytpu_torch.parallel.mesh import PartitionSpec as P
    from raytpu_torch.parallel.moe import MoELayer

    mesh = _mesh({"ep": 8})
    layer = MoELayer(num_experts=8, capacity_factor=2.0)
    params = {k: torch.from_numpy(v).requires_grad_()
              for k, v in params.items()}
    out = group_call(mesh, lambda p, xl: layer(p, xl), params,
                     torch.from_numpy(x),
                     in_specs=({"gate": P(), "wi": P("ep"), "wo": P("ep")},
                               P("ep")),
                     out_specs=P("ep"))
    (out * torch.from_numpy(r)).sum().backward()
    return out.detach(), {k: v.grad for k, v in params.items()}


def test_moe_matches_jax_forward_and_gradients(gang):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP

    from raytpu.parallel.moe import MoELayer

    layer = MoELayer(num_experts=8, capacity_factor=2.0)
    d_model, d_ff, t = 16, 32, 64
    params = {"gate": _normal(8, (d_model, 8), d_model ** -0.5),
              "wi": _normal(9, (8, d_model, d_ff), d_model ** -0.5),
              "wo": _normal(10, (8, d_ff, d_model), d_ff ** -0.5)}
    x = _normal(11, (8 * t, d_model))
    r = _normal(12, (8 * t, d_model))
    fn = shard_map(lambda p, xl: layer(p, xl), mesh=_jax_mesh({"ep": 8}),
                   in_specs=({"gate": JP(), "wi": JP("ep"), "wo": JP("ep")},
                             JP("ep")), out_specs=JP("ep"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = jax.jit(fn)(jp, x)
    want_g = jax.jit(jax.grad(lambda p: (fn(p, x) * r).sum()))(jp)
    assert float(jnp.abs(want).mean()) > 1e-4  # routing transforms tokens
    for out, grads in gang.run(_moe, params, x, r):
        _close(out, want, MOE_TOL)
        for k in ("gate", "wi", "wo"):
            _close(grads[k], want_g[k], MOE_TOL)


# ---- Mixtral with its experts over ep --------------------------------

MIXTRAL_STEPS = 3
LR, WD = 3e-4, 0.1


def _mixtral_cfg():
    from raytpu_torch.models.mixtral import MixtralConfig

    return dataclasses.replace(MixtralConfig.tiny(), dtype=torch.float32,
                               remat=False)


def _mixtral_run(state, tokens, mesh=None):
    """(logits, loss, grads, experts after the AdamW steps) of the port's
    Mixtral from ``state``, its experts over ``mesh``'s ep if given."""
    from raytpu_torch.models.mixtral import (Mixtral, make_train_step,
                                             mixtral_loss_fn, shard_experts)

    model = Mixtral(_mixtral_cfg(), device="cpu", seed=0)
    model.load_state_dict(state)
    if mesh is not None:
        shard_experts(model, mesh)
    tokens = torch.from_numpy(tokens)
    logits, _ = model(tokens)
    loss = mixtral_loss_fn(model, tokens)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=LR, weight_decay=WD))
    losses = [step(tokens).item() for _ in range(MIXTRAL_STEPS)]
    experts = {n: p.detach().clone() for n, p in model.named_parameters()
               if n.endswith((".wi", ".wg", ".wo"))}
    return logits.detach(), loss.item(), grads, experts, losses


def _mixtral_ep(rank, state, tokens):
    from raytpu_torch.models.mixtral import Mixtral, shard_experts
    from raytpu_torch.parallel.mesh import Mesh

    # Every rank builds every mesh; ranks 0 and 1 hold the experts.
    mesh = _mesh({"ep": 2}, ranks=[0, 1])
    tp = Mesh(np.arange(8).reshape(2, 4), ("ep", "tp"), device="cpu")
    out = {}
    try:
        shard_experts(Mixtral(_mixtral_cfg(), device="cpu", seed=0), tp)
    except NotImplementedError as exc:
        out["tp"] = str(exc)
    if rank < 2:
        out["run"] = _mixtral_run(state, tokens, mesh)
    return out


def test_mixtral_experts_over_ep_match_the_unsharded_model(gang):
    import jax
    import jax.numpy as jnp

    from raytpu.models.mixtral import Mixtral as JaxMixtral
    from raytpu.models.mixtral import MixtralConfig as JaxConfig
    from raytpu.models.mixtral import init_params
    from raytpu.models.mixtral import mixtral_loss_fn as jax_loss_fn

    from raytpu_torch.models.convert import mixtral_state_from_jax

    jcfg = dataclasses.replace(JaxConfig.tiny(), dtype=jnp.float32,
                               attn_impl="reference", remat=False)
    jmodel = JaxMixtral(jcfg)
    params = jax.tree_util.tree_map(np.array, jax.jit(
        lambda: init_params(jmodel, jcfg, seed=3))())
    state = mixtral_state_from_jax(params, _mixtral_cfg())
    tokens = np.random.default_rng(13).integers(
        0, jcfg.vocab_size, (2, 32))
    jloss = float(jax.jit(functools.partial(jax_loss_fn, jmodel))(
        params, jnp.asarray(tokens)))
    logits, loss, grads, experts, losses = _mixtral_run(state, tokens)
    assert abs(loss - jloss) <= MIXTRAL_TOL * max(1.0, abs(jloss))
    outs = gang.run(_mixtral_ep, state, tokens)
    for rank, out in enumerate(outs):
        assert "ROADMAP" in out["tp"] and "tp" in out["tp"]
        if rank >= 2:
            continue
        s_logits, s_loss, s_grads, s_experts, s_losses = out["run"]
        _close(s_logits, logits, MIXTRAL_TOL)
        assert abs(s_loss - loss) <= MIXTRAL_TOL * max(1.0, abs(loss))
        assert abs(s_loss - jloss) <= MIXTRAL_TOL * max(1.0, abs(jloss))
        _close(s_losses, losses, MIXTRAL_TOL)
        assert set(s_grads) == set(grads)
        for name, g in grads.items():
            if name.endswith((".wi", ".wg", ".wo")):
                rows = g.shape[0] // 2
                g = g[rank * rows:(rank + 1) * rows]
                assert s_grads[name].shape == g.shape
            _close(s_grads[name], g, MIXTRAL_TOL)
    # The experts gathered from both ranks after the steps.
    for name, e in experts.items():
        gathered = torch.cat([outs[r]["run"][3][name] for r in (0, 1)])
        _close(gathered, e, MIXTRAL_TOL)
