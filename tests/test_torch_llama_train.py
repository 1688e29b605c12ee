"""The port's Llama training path (raytpu_torch/models/llama.py) against
the JAX package's (raytpu/models/llama.py), with the JAX weights carried
across by raytpu_torch/models/convert.py in both parameter layouts
(scanned and unrolled) into fp32 parameters: logits, the dense and the
chunked loss, every parameter's gradient, the Pallas attention kernels in
interpret mode inside the JAX model, the three remat modes, and three
AdamW steps against optax, in fp32 on the CPU; then bf16 compute over
fp32 parameters, the init scheme, and what "dots" saves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from raytpu.models.llama import Llama as JaxLlama
from raytpu.models.llama import LlamaConfig as JaxLlamaConfig
from raytpu.models.llama import init_params
from raytpu.models.llama import llama_loss_fn as jax_loss_fn
from raytpu.models.llama import make_train_step as jax_make_train_step
from raytpu_torch.models import common
from raytpu_torch.models.convert import llama_state_from_jax
from raytpu_torch.models.llama import (Llama, LlamaConfig, llama_loss_fn,
                                       make_train_step)

# fp32 on both sides. The two libraries sum the matmuls in different
# orders, so results after two layers agree to about 1e-6 relative; 1e-4
# is the bound the JAX package uses for fp32 results that pass through
# several matmuls and for fp32 attention gradients (tests/test_ops.py).
TOL = 1e-4
LR, WD = 3e-4, 0.1  # optax.adamw(3e-4, weight_decay=0.1), as bench.py

# The tiny config has grouped-query attention (2 kv heads of 4), which
# the chip's Llama-2-7B config does not: the CPU tests carry that case.
JCFG = dataclasses.replace(JaxLlamaConfig.tiny(), dtype=jnp.float32,
                           attn_impl="reference", remat=False)
PCFG = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32,
                           remat=False)
F32 = torch.float32


def _tokens(seed, b=2, t=32):
    return np.random.default_rng(seed).integers(0, PCFG.vocab_size, (b, t))


def _jcfg(scanned, **kw):
    return dataclasses.replace(JCFG, scan_layers=scanned, **kw)


@pytest.fixture(scope="module", params=["scanned", "unrolled"])
def layout(request):
    """(scanned, JAX params, numpy params) of one tiny Llama."""
    scanned = request.param == "scanned"
    cfg = _jcfg(scanned)
    params = init_params(JaxLlama(cfg), cfg, seed=0, batch=1)
    return scanned, params, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_base(layout):
    """JAX's (loss, grads) of the layout's model on ``_tokens(0)``."""
    scanned, params, _ = layout
    return _jax_loss_and_grads(_jcfg(scanned), params, _tokens(0))


def _port(np_params, **kw):
    cfg = dataclasses.replace(PCFG, **kw)
    model = Llama(cfg, device="cpu", seed=1, param_dtype=F32)
    model.load_state_dict(llama_state_from_jax(np_params, cfg))
    return model


def _jax_loss_and_grads(cfg, params, tokens):
    model = JaxLlama(cfg)
    return jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, p, jnp.asarray(tokens))))(params)


def _port_loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    loss = llama_loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


def _grads_close(port_grads, jax_grads):
    want = llama_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_grads),
                                PCFG)
    assert set(want) == set(port_grads)
    for name, g in port_grads.items():
        _close(g, want[name])


def test_converter_loads_fp32_parameters_unchanged(layout):
    _, _, np_params = layout
    model = _port(np_params)
    state = llama_state_from_jax(np_params, PCFG)
    assert set(state) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert p.dtype == F32, name
        assert torch.equal(p, state[name]), name


def test_logits_loss_and_gradients_match_jax(layout, jax_base):
    scanned, params, np_params = layout
    cfg = _jcfg(scanned)
    tokens = _tokens(0)
    model = _port(np_params)
    logits = JaxLlama(cfg).apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        p_logits = model(torch.from_numpy(tokens))
    assert p_logits.dtype == F32
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
    # JAX's Llama with its own attention kernels (forward, dQ, dK/dV) run
    # by the Pallas interpreter, under its default remat "dots", against
    # the port on the CPU.
    scanned, params, np_params = layout
    tokens = _tokens(2)
    loss, grads = _jax_loss_and_grads(
        _jcfg(scanned, attn_impl="interpret", remat="dots"), params, tokens)
    p_loss, p_grads = _port_loss_and_grads(_port(np_params, remat="dots"),
                                           tokens)
    _close(p_loss, loss)
    _grads_close(p_grads, grads)


@pytest.mark.parametrize("remat", [True, "full", "dots", "none"])
def test_remat_gives_the_same_gradients(layout, remat):
    _, _, np_params = layout
    tokens = _tokens(3)
    loss, grads = _port_loss_and_grads(_port(np_params, remat=False), tokens)
    r_loss, r_grads = _port_loss_and_grads(_port(np_params, remat=remat),
                                           tokens)
    assert r_loss == loss
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name


class _CountMatmuls(TorchDispatchMode):
    """Counts the 2-D matrix products that run while it is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in common.SAVED_PRODUCTS
        return func(*args, **(kwargs or {}))


def _backward_matmuls(remat):
    model = Llama(dataclasses.replace(PCFG, remat=remat), device="cpu",
                  seed=0, param_dtype=F32)
    loss = llama_loss_fn(model, torch.from_numpy(_tokens(4)))
    with _CountMatmuls() as counter:
        loss.backward()
    return counter.count


def test_dots_saves_the_matmul_outputs_and_recomputes_the_rest(monkeypatch):
    # Under "dots" each block saves the outputs of its seven projections
    # (F.linear reaches aten.mm below autograd, where the policy sees it)
    # and nothing else ...
    decisions = []
    dots_policy = common.dots_policy

    def counting_policy(ctx, op, *args, **kwargs):
        policy = dots_policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, policy))
        return policy

    monkeypatch.setattr(common, "dots_policy", counting_policy)
    model = Llama(dataclasses.replace(PCFG, remat="dots"), device="cpu",
                  seed=0, param_dtype=F32)
    llama_loss_fn(model, torch.from_numpy(_tokens(4)))
    saved = [op for op, p in decisions if p == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (7 * PCFG.n_layer)
    assert len(decisions) > len(saved)  # the rest runs again
    # ... so its backward runs no product beyond the gradients' own, as
    # with "none"; "full" runs each block's products again (all but the
    # last, after which checkpointing has every tensor it needs).
    n_dots = _backward_matmuls("dots")
    assert n_dots == _backward_matmuls("none")
    assert _backward_matmuls("full") - n_dots == 6 * PCFG.n_layer


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WD)


def test_three_train_steps_match_optax(layout):
    scanned, params, np_params = layout
    cfg = _jcfg(scanned, remat="dots")
    tokens = _tokens(5)
    opt = optax.adamw(LR, weight_decay=WD)
    step = jax.jit(jax_make_train_step(JaxLlama(cfg), opt))
    state, jp = opt.init(params), params
    losses = []
    for _ in range(3):
        jp, state, loss = step(jp, state, jnp.asarray(tokens))
        losses.append(float(loss))
    model = _port(np_params, remat="dots")
    train_step = make_train_step(model, _adamw(model))
    p_losses = [train_step(torch.from_numpy(tokens)).item() for _ in range(3)]
    _close(p_losses, losses)
    assert p_losses[-1] < p_losses[0]
    # Each step moves a parameter by about lr * sign(gradient); where a
    # gradient is near zero the two sides' signs can differ, moving it by
    # up to 2 * lr apart, so after three steps the parameters agree to
    # 3 * 2 * lr (while the losses above agree to 1e-4).
    want = llama_state_from_jax(jax.tree_util.tree_map(np.asarray, jp), PCFG)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=6 * LR, rtol=0)


def test_bf16_compute_keeps_fp32_parameters(layout):
    # bf16 compute on the CPU: the parameters, their gradients and the
    # logits stay fp32; against JAX in bf16 the loss agrees to bf16's
    # precision (both frameworks round activations at different places).
    scanned, params, np_params = layout
    tokens = _tokens(6)
    loss, _ = _jax_loss_and_grads(_jcfg(scanned, dtype=jnp.bfloat16),
                                  params, tokens)
    model = _port(np_params, dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {F32}
    with torch.no_grad():
        assert model(torch.from_numpy(tokens)).dtype == F32
    p_loss, p_grads = _port_loss_and_grads(model, tokens)
    assert {g.dtype for g in p_grads.values()} == {F32}
    _close(p_loss, loss, tol=2e-2)


@pytest.mark.parametrize("param_dtype", [None, F32])
def test_init_follows_the_jax_scheme(param_dtype):
    cfg = LlamaConfig.tiny()  # bf16 compute
    model = Llama(cfg, device="cpu", seed=0, param_dtype=param_dtype)
    e = cfg.n_embd
    for name, p in model.named_parameters():
        p = p.detach().float()
        if name.endswith(".scale"):
            assert model.get_parameter(name).dtype == F32, name
            assert torch.equal(p, torch.ones_like(p)), name
            continue
        # Serving keeps the weights in the compute dtype by default.
        assert model.get_parameter(name).dtype == (param_dtype
                                                   or cfg.dtype), name
        if name.startswith("embed_tokens"):  # normal, std n_embd**-0.5
            assert abs(p.std().item() - e ** -0.5) < 0.05 * e ** -0.5, name
        else:  # lecun normal, truncated at two standard deviations
            std = p.shape[1] ** -0.5
            assert abs(p.std().item() - std) < 0.05 * std, name
            assert p.abs().max().item() <= 2 * std / 0.87962566103423978 \
                * (1 + 2 ** -8), name
    again = Llama(cfg, device="cpu", seed=0, param_dtype=param_dtype)
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_init_matches_the_jax_init_statistics():
    # The JAX init of the same config, as the issue's reading: embedding
    # std n_embd**-0.5, projections truncated at 2/0.8796 std-units.
    cfg = dataclasses.replace(JCFG, scan_layers=False)
    params = init_params(JaxLlama(cfg), cfg, seed=0, batch=1)
    model = Llama(PCFG, device="cpu", seed=0, param_dtype=F32)
    state = llama_state_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                 PCFG)
    for name, p in model.named_parameters():
        want = state[name]
        got = p.detach()
        assert abs(got.std().item() - want.std().item()) \
            <= 0.1 * want.std().item() + 1e-6, name
        assert abs(got.abs().max().item() - want.abs().max().item()) \
            <= 0.2 * want.abs().max().item() + 1e-6, name


@pytest.mark.parametrize("change, error", [
    ({"remat": "some"}, ValueError),
    ({"scan_layers": True}, TypeError),  # the port loops over its layers
])
def test_unported_options_raise(change, error):
    with pytest.raises(error):
        dataclasses.replace(PCFG, **change)
