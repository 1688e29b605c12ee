"""The port's GPT-2 training path (raytpu_torch/models/gpt2.py) against the
JAX package's (raytpu/models/gpt2.py), with the JAX weights carried across
by raytpu_torch/models/convert.py in both parameter layouts (scanned and
unrolled): logits, loss and every parameter's gradient, the chunked
loss, and three AdamW steps against optax, in fp32 on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytpu.models.gpt2 import GPT2 as JaxGPT2
from raytpu.models.gpt2 import GPT2Config as JaxGPT2Config
from raytpu.models.gpt2 import gpt2_loss_fn as jax_loss_fn
from raytpu.models.gpt2 import init_params
from raytpu.models.gpt2 import make_train_step as jax_make_train_step
from raytpu_torch.models.convert import gpt2_state_from_jax
from raytpu_torch.models.gpt2 import (GPT2, GPT2Config, gpt2_loss_fn,
                                      make_train_step)

# fp32 on both sides. The two libraries sum the matmuls in different
# orders, so results after two layers agree to about 1e-6 relative; 1e-4
# is the bound the JAX package uses for fp32 results that pass through
# several matmuls and for fp32 attention gradients (tests/test_ops.py).
TOL = 1e-4
LR, WD = 3e-4, 0.1  # optax.adamw(3e-4, weight_decay=0.1), as bench.py

JCFG = dataclasses.replace(JaxGPT2Config.tiny(), dtype=jnp.float32,
                           attn_impl="reference", remat=False)
PCFG = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32,
                           remat=False)


def _tokens(seed, b=2, t=32):
    return np.random.default_rng(seed).integers(0, PCFG.vocab_size, (b, t))


def _jcfg(scanned, **kw):
    return dataclasses.replace(JCFG, scan_layers=scanned, **kw)


@pytest.fixture(scope="module", params=["scanned", "unrolled"])
def layout(request):
    """(scanned, JAX params, numpy params) of one tiny GPT-2."""
    scanned = request.param == "scanned"
    cfg = _jcfg(scanned)
    params = init_params(JaxGPT2(cfg), cfg, seed=0, batch=1)
    return scanned, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_base(layout):
    """JAX's (loss, grads) of the layout's model on ``_tokens(0)``."""
    scanned, params, _ = layout
    return _jax_loss_and_grads(_jcfg(scanned), params, _tokens(0))


def _port(np_params, **kw):
    cfg = dataclasses.replace(PCFG, **kw)
    model = GPT2(cfg, device="cpu", seed=1)
    model.load_state_dict(gpt2_state_from_jax(np_params, cfg))
    return model


def _jax_loss_and_grads(cfg, params, tokens):
    model = JaxGPT2(cfg)
    return jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, p, jnp.asarray(tokens))))(params)


def _port_loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    loss = gpt2_loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _grads_close(port_grads, jax_grads):
    want = gpt2_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads),
                               PCFG)
    assert set(want) == set(port_grads)
    for name, g in port_grads.items():
        _close(g, want[name])


def test_converter_covers_every_parameter(layout):
    _, _, np_params = layout
    model = GPT2(PCFG, device="cpu")
    state = gpt2_state_from_jax(np_params, PCFG)
    assert set(state) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert tuple(state[name].shape) == tuple(p.shape), name
        assert state[name].dtype == p.dtype == torch.float32, name


def test_logits_loss_and_gradients_match_jax(layout, jax_base):
    scanned, params, np_params = layout
    cfg = _jcfg(scanned)
    tokens = _tokens(0)
    model = _port(np_params)
    logits = JaxGPT2(cfg).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        p_logits = model(torch.from_numpy(tokens))
    assert p_logits.dtype == torch.float32
    _close(p_logits, logits)
    loss, grads = jax_base
    p_loss, p_grads = _port_loss_and_grads(model, tokens)
    _close(p_loss, loss)
    _grads_close(p_grads, grads)


@pytest.mark.parametrize("chunk", [16, 24])
def test_chunked_loss_matches_jax(layout, chunk):
    # 2 x 31 = 62 rows: 16 and 24 leave 2 and 10 rows of padding.
    scanned, params, np_params = layout
    tokens = _tokens(1)
    loss, grads = _jax_loss_and_grads(_jcfg(scanned, loss_chunk=chunk),
                                      params, tokens)
    p_loss, p_grads = _port_loss_and_grads(
        _port(np_params, loss_chunk=chunk), tokens)
    _close(p_loss, loss)
    _grads_close(p_grads, grads)


def test_pallas_interpret_attention_in_the_jax_model(layout):
    # JAX's GPT-2 with its own attention kernels (forward, dQ, dK/dV) run
    # by the Pallas interpreter, against the port on the CPU.
    scanned, params, np_params = layout
    tokens = _tokens(2)
    loss, grads = _jax_loss_and_grads(_jcfg(scanned, attn_impl="interpret"),
                                      params, tokens)
    p_loss, p_grads = _port_loss_and_grads(_port(np_params), tokens)
    _close(p_loss, loss)
    _grads_close(p_grads, grads)


@pytest.mark.parametrize("remat", [True, "full", "dots"])
def test_remat_gives_the_same_gradients(layout, remat):
    _, _, np_params = layout
    tokens = _tokens(3)
    loss, grads = _port_loss_and_grads(_port(np_params, remat=False), tokens)
    r_loss, r_grads = _port_loss_and_grads(_port(np_params, remat=remat),
                                           tokens)
    assert r_loss == loss
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WD)


def test_adamw_update_matches_optax_on_the_same_gradients(layout, jax_base):
    # The optimizers alone: both get JAX's gradients. Same formula, summed
    # in another order: the updated parameters agree to fp32 rounding.
    _, params, np_params = layout
    _, grads = jax_base
    opt = optax.adamw(LR, weight_decay=WD)
    updates, _ = opt.update(grads, opt.init(params), params)
    want = gpt2_state_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)), PCFG)
    model = _port(np_params)
    torch_grads = gpt2_state_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), PCFG)
    for name, p in model.named_parameters():
        p.grad = torch_grads[name]
    _adamw(model).step()
    for name, p in model.named_parameters():
        _close(p.detach(), want[name], tol=1e-6)


def test_three_train_steps_match_optax(layout):
    scanned, params, np_params = layout
    cfg = _jcfg(scanned)
    tokens = _tokens(5)
    opt = optax.adamw(LR, weight_decay=WD)
    step = jax.jit(jax_make_train_step(JaxGPT2(cfg), opt))
    state, jp = opt.init(params), params
    losses = []
    for _ in range(3):
        jp, state, loss = step(jp, state, jnp.asarray(tokens))
        losses.append(float(loss))
    model = _port(np_params)
    train_step = make_train_step(model, _adamw(model))
    p_losses = [train_step(torch.from_numpy(tokens)).item() for _ in range(3)]
    _close(p_losses, losses)
    assert p_losses[-1] < p_losses[0]
    # Each step moves a parameter by about lr * sign(gradient); where a
    # gradient is near zero the two sides' signs can differ, moving it by
    # up to 2 * lr apart, so after three steps the parameters agree to
    # 3 * 2 * lr (while the losses above agree to 1e-4).
    want = gpt2_state_from_jax(jax.tree_util.tree_map(np.asarray, jp), PCFG)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=6 * LR, rtol=0)


def test_bf16_compute_keeps_fp32_parameters_and_logits(layout):
    # bf16 compute on the CPU: the parameters, their gradients and the
    # logits stay fp32; against JAX in bf16 the loss agrees to bf16's
    # precision (both frameworks round activations at different places).
    scanned, params, np_params = layout
    tokens = _tokens(6)
    loss, _ = _jax_loss_and_grads(_jcfg(scanned, dtype=jnp.bfloat16),
                                  params, tokens)
    model = _port(np_params, dtype=torch.bfloat16)
    with torch.no_grad():
        assert model(torch.from_numpy(tokens)).dtype == torch.float32
    p_loss, p_grads = _port_loss_and_grads(model, tokens)
    assert {g.dtype for g in p_grads.values()} == {torch.float32}
    _close(p_loss, loss, tol=2e-2)


def test_init_follows_the_jax_scheme():
    model = GPT2(PCFG, device="cpu", seed=0)
    e = PCFG.n_embd
    for name, p in model.named_parameters():
        p = p.detach()
        if name.endswith(".scale"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif name.endswith(".bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
        elif name.startswith(("wte", "wpe")):
            assert abs(p.std().item() - e ** -0.5) < 0.05 * e ** -0.5, name
        else:  # lecun normal, truncated at two standard deviations
            std = p.shape[1] ** -0.5
            assert abs(p.std().item() - std) < 0.05 * std, name
            assert p.abs().max().item() <= 2 * std / 0.87962566103423978
    again = GPT2(PCFG, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("change, error", [
    # No such field: the port's layers are a loop, not a scan.
    ({"scan_layers": False}, TypeError),
    ({"remat": "some"}, ValueError),  # no such remat mode
])
def test_unported_options_raise(change, error):
    with pytest.raises(error):
        dataclasses.replace(PCFG, **change)
