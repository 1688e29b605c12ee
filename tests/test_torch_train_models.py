"""The Train library's models in the port (raytpu_torch/models/mlp.py and
resnet.py) against the JAX package's (raytpu/models/mlp.py and
resnet.py), on the CPU in fp32, with the JAX variables carried across by
raytpu_torch/models/convert.py: the fashion-MNIST MLP at its shapes, and
ResNet's eval logits, train logits, updated batch statistics and loss
gradients for basic blocks at an even and an odd input size (the odd one
changes every SAME padding total), for a bottleneck net (its last BN
starts at scale 0), and ResNet-50's parameter count and forward.

JAX is imported inside the tests only, as in tests/test_torch_train.py."""

import dataclasses

import numpy as np
import pytest
import torch

from raytpu_torch.models import convert
from raytpu_torch.models.mlp import MLPClassifier, xent_loss
from raytpu_torch.models.resnet import ResNet, ResNetConfig

# The JAX package's fp32 tolerances: results 1e-5, gradients 1e-4.
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _close_state(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name], w, tol)


# ---- the MLP --------------------------------------------------------


def _mlp_batch(rng, b=16):
    return {"x": rng.standard_normal((b, 28, 28, 1)).astype(np.float32),
            "y": rng.integers(0, 10, b).astype(np.int32)}


def test_mlp_forward_loss_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp

    from raytpu.models import mlp as jax_mlp

    batch = _mlp_batch(np.random.default_rng(0))
    jm = jax_mlp.MLPClassifier(hidden=(128, 128), n_classes=10)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["x"]))["params"]
    model = MLPClassifier(device="cpu")
    model.load_state_dict(convert.mlp_state_from_jax(_np(params)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    _close(model(tb["x"]), jm.apply({"params": params}, batch["x"]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_mlp.xent_loss(jm, p, jbatch))(params)
    loss = xent_loss(model, tb)
    _close(loss, jloss)
    loss.backward()
    _close_state({n: p.grad for n, p in model.named_parameters()},
                 convert.mlp_state_from_jax(_np(jgrads)), GRAD_TOL)


def test_mlp_flattens_nhwc_in_the_jax_order():
    # Channels > 1: a flatten in NCHW order would feed the first Dense's
    # rows in another order and miss the JAX logits.
    import jax

    from raytpu.models import mlp as jax_mlp

    x = np.random.default_rng(1).standard_normal((4, 5, 3, 2)).astype(
        np.float32)
    jm = jax_mlp.MLPClassifier(hidden=(16,), n_classes=3)
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    model = MLPClassifier(hidden=(16,), n_classes=3, in_features=30,
                          device="cpu")
    model.load_state_dict(convert.mlp_state_from_jax(_np(params)))
    _close(model(torch.from_numpy(x)), jm.apply({"params": params}, x))


# ---- ResNet ---------------------------------------------------------


def _jax_resnet(cfg, x):
    import jax
    import jax.numpy as jnp

    from raytpu.models import resnet as jax_resnet

    cfg = dataclasses.replace(cfg, dtype=jnp.float32)
    model = jax_resnet.ResNet(cfg)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return model, variables


def _port_resnet(cfg, variables):
    model = ResNet(dataclasses.replace(cfg, dtype=torch.float32),
                   device="cpu")
    model.load_state_dict(convert.resnet_state_from_jax(_np(variables)))
    return model


def _perturbed(variables, seed):
    """The init's variables with every leaf moved at random, so BatchNorm
    scales (a bottleneck's last is 0), biases and running statistics are
    away from their init values and every path reaches the output."""
    import jax

    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(
            np.shape(v)).astype(np.float32), _np(variables))
    out["batch_stats"] = jax.tree_util.tree_map(np.abs, out["batch_stats"])
    return out


def _labels(rng, b, n):
    return rng.integers(0, n, b).astype(np.int32)


def _check_resnet(cfg, size, seed=0):
    """Eval logits, train logits and the updated batch statistics, and
    the loss gradients (train mode), against the JAX model."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    y = _labels(rng, 4, cfg.n_classes)
    jmodel, variables = _jax_resnet(cfg, x)
    variables = _perturbed(variables, seed + 1)
    model = _port_resnet(cfg, variables)
    tx = torch.from_numpy(x)

    _close(model(tx), jmodel.apply(variables, x))

    jlogits, updated = jmodel.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
    with torch.no_grad():
        logits = model(tx, train=True)
    _close(logits, jlogits)
    buffers = dict(model.named_buffers())
    want = convert.resnet_state_from_jax(
        {"params": variables["params"], **_np(updated)})
    _close_state({n: buffers[n] for n in want if n in buffers},
                 {n: w for n, w in want.items() if n in buffers})

    def jloss(params):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], -1).mean()

    jl, jgrads = jax.value_and_grad(jloss)(variables["params"])
    model = _port_resnet(cfg, variables)  # the running stats as they were
    logp = torch.log_softmax(model(tx, train=True), -1)
    loss = -logp.gather(-1, torch.from_numpy(y)[:, None].long()).mean()
    _close(loss, jl)
    loss.backward()
    _close_state({n: p.grad for n, p in model.named_parameters()},
                 convert.resnet_state_from_jax({"params": _np(jgrads)}),
                 GRAD_TOL)


@pytest.mark.parametrize("size", [32, 33])
def test_tiny_resnet_matches_jax(size):
    _check_resnet(ResNetConfig.tiny(), size)


@pytest.mark.parametrize("size", [32, 33])
def test_bottleneck_resnet_matches_jax(size):
    _check_resnet(ResNetConfig((1, 1), 8, 10, bottleneck=True), size,
                  seed=2)


def test_bottleneck_last_bn_starts_at_zero_scale():
    model = ResNet(ResNetConfig((1, 1), 8, 10, bottleneck=True),
                   device="cpu")
    for blk in model.blocks:
        assert torch.all(blk.bn_2.scale == 0)
        assert torch.all(blk.bn_0.scale == 1)
    # ... as the JAX init has it, name for name through the converter.
    import jax
    import jax.numpy as jnp

    from raytpu.models import resnet as jax_resnet

    variables = jax_resnet.ResNet(jax_resnet.ResNetConfig(
        (1, 1), 8, 10, dtype=jnp.float32, bottleneck=True)).init(
        jax.random.PRNGKey(0), jnp.ones((1, 16, 16, 3)))
    state = convert.resnet_state_from_jax(_np(variables))
    ours = model.state_dict()
    for name, v in state.items():
        if name.endswith((".scale", ".bias", ".mean", ".var")):
            torch.testing.assert_close(ours[name], v, rtol=0, atol=0)


def test_resnet50_parameter_count_and_forward_match_jax():
    import jax

    cfg = ResNetConfig.resnet50()
    assert cfg.bottleneck
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel, variables = _jax_resnet(cfg, x)
    n_jax = sum(np.size(v) for v in
                jax.tree_util.tree_leaves(variables["params"]))
    assert 25.4e6 < n_jax < 25.7e6
    model = _port_resnet(cfg, variables)
    state = convert.resnet_state_from_jax(_np(variables))
    params = dict(model.named_parameters())
    # Tensor by tensor through the converter: every parameter, no more.
    assert {n for n in state if n in params} == set(params)
    for name, p in params.items():
        assert tuple(p.shape) == tuple(state[name].shape), name
    assert sum(p.numel() for p in params.values()) == n_jax
    _close(model(torch.from_numpy(x)), jmodel.apply(variables, x), 1e-4)


def test_resnet_weights_are_channels_last_and_input_is_nhwc():
    model = ResNet(ResNetConfig.tiny(), device="cpu")
    for name, p in model.named_parameters():
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), name
    out = model(torch.zeros(2, 33, 31, 3))
    assert out.shape == (2, 10) and out.dtype == torch.float32


def test_same_padding_splits_as_xla():
    from raytpu_torch.models.common import same_padding

    assert same_padding(224, 7, 2) == (2, 3)
    assert same_padding(56, 3, 2) == (0, 1)
    assert same_padding(112, 3, 2) == (0, 1)
    assert same_padding(57, 3, 2) == (1, 1)
    assert same_padding(56, 1, 2) == (0, 0)
    assert same_padding(56, 3, 1) == (1, 1)
