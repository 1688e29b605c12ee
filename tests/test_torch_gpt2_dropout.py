"""GPT-2's dropout in the port (raytpu_torch/models/gpt2.py), on the CPU in
fp32. The JAX package drops with Flax's ``nn.Dropout`` after attention's
``c_proj`` and after the MLP. Torch's draws are not JAX's, so the rule is
checked on its own: at rate 0 (or deterministic) the training forward is
the forward of today to the bit, at rate p the masks keep each element
with probability 1 - p and the survivors are divided by 1 - p, remat
"full", "dots" and "none" give the same gradients under one generator
seed, and the loss and the inference forwards never drop. And the site
and order against the JAX package: its masks, read from its unrolled
model's dropped outputs, fed to the port's blocks, give its logits and
gradients."""

import dataclasses

import numpy as np
import pytest
import torch

import raytpu_torch.models.gpt2 as port_gpt2
from raytpu_torch.models.convert import gpt2_state_from_jax
from raytpu_torch.models.gpt2 import (GPT2, GPT2Config, dropout, dropout_keep,
                                      gpt2_loss_fn, gpt2_prefill, mean_nll)

# fp32 on both sides, summed in different orders; two layers of the tiny
# model stay within 1e-5 of the JAX package's logits and gradients.
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the nets here are tiny, and the test runner's
    parallel workers would otherwise each start a thread a core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CFG = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32)


def _model(**kw):
    return GPT2(dataclasses.replace(CFG, **kw), device="cpu", seed=0)


def _tokens(seed=0, b=2, t=32):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (b, t)))


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_rate_zero_and_deterministic_are_today_s_forward(remat):
    tokens = _tokens()
    plain = _model(remat=remat)
    want = plain(tokens)
    got = plain(tokens, deterministic=False, generator=_gen())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    dropping = _model(remat=remat, dropout=0.1)
    torch.testing.assert_close(dropping(tokens), want, rtol=0, atol=0)
    torch.testing.assert_close(dropping(tokens, deterministic=True,
                                        generator=_gen()), want,
                               rtol=0, atol=0)
    assert not torch.equal(dropping(tokens, deterministic=False,
                                    generator=_gen()), want)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_is_binomial_and_survivors_are_scaled(rate):
    n = 200_000
    keep = dropout_keep(rate, (n,), _gen(), "cpu")
    kept = int(keep.sum())
    # Within five standard deviations of n (1 - p).
    assert abs(kept - n * (1 - rate)) < 5 * np.sqrt(n * rate * (1 - rate))
    y = torch.randn(n, generator=_gen(1))
    out = dropout(y, keep, rate)
    torch.testing.assert_close(out[keep], y[keep] / (1 - rate), rtol=0,
                               atol=0)
    assert not out[~keep].any()
    assert dropout(y, None, rate) is y


def test_the_blocks_drop_after_attention_and_after_the_mlp():
    rate = 0.3
    model = _model(remat=False, dropout=rate)
    tokens = _tokens()
    seen = {}
    block = model.h[0]
    block.attn.register_forward_hook(
        lambda m, a, out: seen.__setitem__("attn", out))
    block.mlp.register_forward_hook(
        lambda m, a, out: seen.__setitem__("mlp", out))
    block.ln_1.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("x0", a[0]))
    block.ln_2.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("x1", a[0]))
    model.h[1].ln_1.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("x2", a[0]))
    model(tokens, deterministic=False, generator=_gen(3))
    # The masks the forward drew: two a layer, attention's first.
    g = _gen(3)
    shape = seen["x0"].shape
    attn_keep, mlp_keep = (dropout_keep(rate, shape, g, "cpu")
                           for _ in range(2))
    torch.testing.assert_close(
        seen["x1"], seen["x0"] + dropout(seen["attn"], attn_keep, rate),
        rtol=0, atol=0)
    torch.testing.assert_close(
        seen["x2"], seen["x1"] + dropout(seen["mlp"], mlp_keep, rate),
        rtol=0, atol=0)
    assert not torch.equal(attn_keep, mlp_keep)


def test_remat_modes_give_equal_gradients_under_one_seed():
    tokens = _tokens(1)
    grads = {}
    for remat in (False, True, "dots"):
        model = _model(remat=remat, dropout=0.2)
        logits = model(tokens, deterministic=False, generator=_gen(11))
        loss = logits.logsumexp(-1).mean()
        loss.backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for remat in (True, "dots"):
        for n, g in grads[False].items():
            torch.testing.assert_close(grads[remat][n], g, rtol=0, atol=0)


def test_loss_and_inference_never_drop():
    tokens = _tokens(2)
    model = _model(dropout=0.5)
    plain = _model()
    torch.testing.assert_close(gpt2_loss_fn(model, tokens),
                               gpt2_loss_fn(plain, tokens), rtol=0, atol=0)
    torch.testing.assert_close(gpt2_prefill(model, tokens)[0],
                               gpt2_prefill(plain, tokens)[0], rtol=0, atol=0)


def test_dropout_needs_a_generator_and_a_rate_in_range():
    with pytest.raises(ValueError, match="Generator"):
        _model(dropout=0.1)(_tokens(), deterministic=False)
    for rate in (-0.1, 1.0):
        with pytest.raises(ValueError, match="dropout"):
            dataclasses.replace(CFG, dropout=rate)


def test_where_the_jax_package_can_drop():
    # The reference drops only with remat off and unrolled layers: nn.remat
    # traces ``deterministic`` (init fails), and the layer scan splits only
    # the ``params`` RNG, so no ``dropout`` RNG reaches a scanned block.
    import flax.errors
    import jax
    import jax.numpy as jnp

    from raytpu.models.gpt2 import GPT2 as JaxGPT2
    from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from raytpu.models.gpt2 import init_params

    tokens = jnp.zeros((1, 8), jnp.int32)
    rngs = {"dropout": jax.random.PRNGKey(1)}

    def cfg(**kw):
        return dataclasses.replace(JaxGPT2Config.tiny(), dropout=0.1,
                                   dtype=jnp.float32, attn_impl="reference",
                                   **kw)

    with pytest.raises(jax.errors.TracerBoolConversionError):
        init_params(JaxGPT2(cfg(remat=True)), cfg(remat=True), batch=1)
    scanned = cfg(remat=False, scan_layers=True)
    params = init_params(JaxGPT2(scanned), scanned, batch=1)
    with pytest.raises(flax.errors.InvalidRngError):
        JaxGPT2(scanned).apply({"params": params}, tokens,
                               deterministic=False, rngs=rngs)
    unrolled = cfg(remat=False, scan_layers=False)
    model = JaxGPT2(unrolled)
    params = init_params(model, unrolled, batch=1)
    dropped = model.apply({"params": params}, tokens, deterministic=False,
                          rngs=rngs)
    assert not jnp.array_equal(dropped, model.apply({"params": params},
                                                    tokens))


def _jax_dropping_run(rate, tokens):
    """The JAX package's unrolled GPT-2 (remat off, its only dropping
    layout) at ``rate``, fp32, reference attention: numpy parameters, the
    logits and the loss's gradients under one dropout key, and each
    layer's two masks (attention's, then the MLP's), read as the nonzeros
    of its ``nn.Dropout`` outputs."""
    import jax
    import jax.numpy as jnp

    from raytpu.models.gpt2 import GPT2 as JaxGPT2
    from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
    from raytpu.models.gpt2 import init_params

    cfg = dataclasses.replace(JaxGPT2Config.tiny(), dropout=rate,
                              dtype=jnp.float32, attn_impl="reference",
                              remat=False, scan_layers=False)
    model = JaxGPT2(cfg)
    params = init_params(model, cfg, seed=0, batch=1)
    rngs = {"dropout": jax.random.PRNGKey(5)}
    tokens = jnp.asarray(tokens)

    def loss_fn(p):
        logits = model.apply({"params": p}, tokens, deterministic=False,
                             rngs=rngs)[:, :-1]
        label = jnp.take_along_axis(logits, tokens[:, 1:, None], -1)[..., 0]
        return (jax.scipy.special.logsumexp(logits, -1) - label).mean()

    grads = jax.grad(loss_fn)(params)
    logits, state = model.apply({"params": params}, tokens,
                                deterministic=False, rngs=rngs,
                                capture_intermediates=True,
                                mutable=["intermediates"])
    seen = state["intermediates"]
    masks = []
    for i in range(cfg.n_layer):
        layer = seen[f"h_{i}"]
        for out in (layer["attn"]["drop"]["__call__"][0],
                    layer["mlp"]["Dropout_0"]["__call__"][0]):
            masks.append(torch.from_numpy(np.asarray(out) != 0))
    as_np = jax.tree_util.tree_map(np.asarray, (params, grads))
    return as_np[0], np.asarray(logits), as_np[1], masks


@pytest.mark.parametrize("remat", [False, True, "dots"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_jax_masks_give_jax_logits_and_gradients(monkeypatch, rate, remat):
    tokens = _tokens(4).numpy()
    params, logits, grads, masks = _jax_dropping_run(rate, tokens)
    keep_share = float(torch.stack(masks).float().mean())
    assert abs(keep_share - (1 - rate)) < 0.02, keep_share
    cfg = dataclasses.replace(CFG, dropout=rate, remat=remat)
    model = GPT2(cfg, device="cpu", seed=1)
    model.load_state_dict(gpt2_state_from_jax(params, cfg))
    given = iter(masks)

    def jax_mask(r, shape, generator, device):
        keep = next(given)
        assert r == rate and tuple(shape) == tuple(keep.shape)
        return keep

    monkeypatch.setattr(port_gpt2, "dropout_keep", jax_mask)
    tokens = torch.from_numpy(tokens)
    got = model(tokens, deterministic=False, generator=_gen())
    # Two masks a layer, each drawn once: a rematerialized block reuses its.
    assert next(given, None) is None
    np.testing.assert_allclose(got.detach().numpy(), logits, rtol=TOL,
                               atol=TOL)
    mean_nll(got[:, :-1], tokens[:, 1:]).backward()
    want = gpt2_state_from_jax(grads, cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
