"""The port's Mixtral (raytpu_torch/models/mixtral.py) against the JAX
package's (raytpu/models/mixtral.py), with the JAX weights carried across
by raytpu_torch/models/convert.py in both parameter layouts (scanned and
unrolled), in fp32 on the CPU: the MoE layer's output and aux loss
(capacity that drops slots, and router ties that JAX's top-k order must
win), the model's logits, the loss with its aux term, every parameter's
gradient, the Pallas attention kernels in interpret mode inside the JAX
model, three AdamW steps against optax, the three remat modes and what
"dots" saves; and the engine's refusal of a Mixtral."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from raytpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from raytpu.models.mixtral import Mixtral as JaxMixtral
from raytpu.models.mixtral import MoEFFN as JaxMoEFFN
from raytpu.models.mixtral import init_params
from raytpu.models.mixtral import make_train_step as jax_make_train_step
from raytpu.models.mixtral import mixtral_loss_fn as jax_loss_fn
from raytpu_torch.models import common
from raytpu_torch.models.convert import mixtral_state_from_jax
from raytpu_torch.models.mixtral import (Mixtral, MixtralConfig, MoEFFN,
                                         dispatch_masks, expert_capacity,
                                         make_train_step, mixtral_loss_fn)

# fp32 on both sides. One MoE layer is a few matmuls and sums: 1e-5, the
# JAX package's bound for fp32 attention outputs (tests/test_ops.py); the
# model after two layers, its loss and gradients: 1e-4, the bound for
# fp32 results through several matmuls and for fp32 gradients.
MOE_TOL = 1e-5
TOL = 1e-4
LR, WD = 3e-4, 0.1  # optax.adamw(3e-4, weight_decay=0.1), as bench.py
F32 = torch.float32

JCFG = dataclasses.replace(JaxMixtralConfig.tiny(), dtype=jnp.float32,
                           attn_impl="reference", remat=False)
PCFG = dataclasses.replace(MixtralConfig.tiny(), dtype=torch.float32,
                           remat=False)


def _tokens(seed, b=2, t=32):
    return np.random.default_rng(seed).integers(0, PCFG.vocab_size, (b, t))


def _jcfg(scanned, **kw):
    return dataclasses.replace(JCFG, scan_layers=scanned, **kw)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=tol)


# ---- the MoE layer ---------------------------------------------------


def _moe_case(case):
    """(JAX config, port config, numpy params, x [2, 24, D]) of one MoE
    layer. "dropping" has a capacity far below the routed slots;
    "router_tie" two experts with the same router column, which tie for
    every token; "uniform_router" a zero router, where all experts tie."""
    cf = 0.3 if case == "dropping" else 1.25
    jcfg = dataclasses.replace(JCFG, capacity_factor=cf)
    pcfg = dataclasses.replace(PCFG, capacity_factor=cf)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, PCFG.n_embd)).astype(np.float32)
    params = jax.tree_util.tree_map(np.array, JaxMoEFFN(jcfg).init(
        jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    router = params["router"]["kernel"]
    if case == "router_tie":
        router[:, 2] = router[:, 1]
    elif case == "uniform_router":
        router[:] = 0.0
    return jcfg, pcfg, params, x


def _port_moe(pcfg, params):
    moe = MoEFFN(pcfg)
    moe.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T.copy()),
        **{n: torch.from_numpy(params[n]) for n in ("wi", "wg", "wo")}})
    return moe


@pytest.mark.parametrize("case", ["default", "dropping", "router_tie",
                                  "uniform_router"])
def test_moe_output_and_aux_match_jax(case):
    jcfg, pcfg, params, x = _moe_case(case)
    y, state = JaxMoEFFN(jcfg).apply({"params": params}, jnp.asarray(x),
                                     mutable=["intermediates"])
    aux = state["intermediates"]["moe_aux"][0]
    moe = _port_moe(pcfg, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        p_y, p_aux = moe(xt)
        probs, topw, topi = moe.route(xt.reshape(-1, pcfg.n_embd))
    _close(p_y, y, MOE_TOL)
    _close(p_aux, aux, MOE_TOL)
    # The routes themselves, in JAX's order (ties to the lower expert).
    j_topw, j_topi = jax.lax.top_k(jnp.asarray(probs.numpy()),
                                   pcfg.n_expert_per_tok)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(j_topi))
    n = xt.shape[0] * xt.shape[1]
    dispatch, _ = dispatch_masks(topi, topw, pcfg.n_expert,
                                 expert_capacity(pcfg, n))
    kept = dispatch.sum().item()
    if case == "router_tie":
        tied = (probs[:, 1] == probs[:, 2]).all()
        assert tied and (topi == 1).any() and (topi == 2).any()
    elif case == "uniform_router":
        assert (topi == torch.tensor([0, 1])).all()
    if case == "dropping":
        # 48 tokens x 2 routes, 7 slots an expert: most routes drop.
        assert kept < 0.5 * pcfg.n_expert_per_tok * n
    else:
        assert 0 < kept <= pcfg.n_expert_per_tok * n


@pytest.mark.parametrize("n", [1, 7, 48, 4096])
def test_capacity_is_the_jax_formula(n):
    c = dataclasses.replace(PCFG, capacity_factor=1.25, n_expert=8)
    assert expert_capacity(c, n) == max(1, int(1.25 * n * 2 / 8))


# ---- the model -------------------------------------------------------


@pytest.fixture(scope="module", params=["scanned", "unrolled"])
def layout(request):
    """(scanned, JAX params, numpy params) of one tiny Mixtral."""
    scanned = request.param == "scanned"
    cfg = _jcfg(scanned)
    params = init_params(JaxMixtral(cfg), cfg, seed=0, batch=1)
    return scanned, params, jax.tree_util.tree_map(np.asarray, params)


def _port(np_params, **kw):
    cfg = dataclasses.replace(PCFG, **kw)
    model = Mixtral(cfg, device="cpu", seed=1)
    model.load_state_dict(mixtral_state_from_jax(np_params, cfg))
    return model


def _jax_loss_and_grads(cfg, params, tokens):
    model = JaxMixtral(cfg)
    return jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(model, p, jnp.asarray(tokens))))(params)


def _port_loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    loss = mixtral_loss_fn(model, torch.from_numpy(tokens))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _grads_close(port_grads, jax_grads):
    want = mixtral_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads), PCFG)
    assert set(want) == set(port_grads)
    for name, g in port_grads.items():
        _close(g, want[name])


def test_converter_loads_fp32_parameters_unchanged(layout):
    _, _, np_params = layout
    model = _port(np_params)
    state = mixtral_state_from_jax(np_params, PCFG)
    assert set(state) == set(model.state_dict())
    for name, p in model.state_dict().items():
        assert p.dtype == F32, name
        assert torch.equal(p, state[name]), name


def test_logits_loss_and_gradients_match_jax(layout):
    scanned, params, np_params = layout
    cfg = _jcfg(scanned)
    tokens = _tokens(0)
    logits = JaxMixtral(cfg).apply({"params": params}, jnp.asarray(tokens))
    model = _port(np_params)
    with torch.no_grad():
        p_logits, p_aux = model(torch.from_numpy(tokens))
    assert p_logits.dtype == F32
    _close(p_logits, logits)
    assert p_aux.item() > 0
    loss, grads = _jax_loss_and_grads(cfg, params, tokens)
    p_loss, p_grads = _port_loss_and_grads(model, tokens)
    _close(p_loss, loss)
    _grads_close(p_grads, grads)
    # The aux term is large enough for the comparison to see it.
    assert PCFG.router_aux_coef * p_aux.item() > 10 * TOL * abs(p_loss)


def test_pallas_interpret_attention_in_the_jax_model(layout):
    # JAX's Mixtral with its own attention kernels (forward, dQ, dK/dV)
    # run by the Pallas interpreter, under its default remat "dots",
    # against the port's "dots" on the CPU.
    scanned, params, np_params = layout
    tokens = _tokens(2)
    loss, grads = _jax_loss_and_grads(
        _jcfg(scanned, attn_impl="interpret", remat="dots"), params, tokens)
    p_loss, p_grads = _port_loss_and_grads(_port(np_params, remat="dots"),
                                           tokens)
    _close(p_loss, loss)
    _grads_close(p_grads, grads)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_gives_the_same_gradients(layout, remat):
    _, _, np_params = layout
    tokens = _tokens(3)
    loss, grads = _port_loss_and_grads(_port(np_params, remat=False), tokens)
    r_loss, r_grads = _port_loss_and_grads(_port(np_params, remat=remat),
                                           tokens)
    assert r_loss == loss
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name


def test_dots_saves_what_the_jax_policy_saves(monkeypatch):
    # JAX's dots_with_no_batch_dims_saveable saves the products without a
    # batch dimension: per layer the four attention projections, the
    # router, the dispatch and the combine product (aten.mm here), and
    # not the three expert products, which are batched over the experts
    # (aten.bmm, run again in the backward pass).
    decisions = []
    dots_policy = common.dots_policy

    def counting_policy(ctx, op, *args, **kwargs):
        policy = dots_policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            decisions.append((op, policy))
        return policy

    monkeypatch.setattr(common, "dots_policy", counting_policy)
    model = Mixtral(dataclasses.replace(PCFG, remat="dots"), device="cpu",
                    seed=0)
    mixtral_loss_fn(model, torch.from_numpy(_tokens(4)))
    saved = [op for op, p in decisions if p == CheckpointPolicy.MUST_SAVE]
    assert saved == [torch.ops.aten.mm.default] * (7 * PCFG.n_layer)
    # Per layer: the three expert products and, on the CPU, the plain
    # attention's two (scores and P V), all batched and all run again.
    bmm = [p for op, p in decisions if op == torch.ops.aten.bmm.default]
    assert bmm == [CheckpointPolicy.PREFER_RECOMPUTE] * (5 * PCFG.n_layer)


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WD)


def test_three_train_steps_match_optax(layout):
    scanned, params, np_params = layout
    cfg = _jcfg(scanned, remat="dots")
    tokens = _tokens(5)
    opt = optax.adamw(LR, weight_decay=WD)
    step = jax.jit(jax_make_train_step(JaxMixtral(cfg), opt))
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
    # As in tests/test_torch_llama_train.py: a parameter whose gradient is
    # near zero can move by up to 2 * lr apart a step.
    want = mixtral_state_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                  PCFG)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   atol=6 * LR, rtol=0)


def test_init_follows_the_jax_scheme():
    cfg = dataclasses.replace(MixtralConfig.tiny(), n_embd=256, n_inter=512)
    model = Mixtral(cfg, device="cpu", seed=0)
    d, f = cfg.n_embd, cfg.n_inter
    for name, p in model.named_parameters():
        assert p.dtype == F32, name
        p = p.detach()
        if name.endswith(".scale"):
            assert torch.equal(p, torch.ones_like(p)), name
            continue
        if name.endswith((".wi", ".wg", ".wo")):  # normal, not truncated
            std = (f if name.endswith(".wo") else d) ** -0.5
            assert abs(p.std().item() - std) < 0.02 * std, name
            assert p.abs().max().item() > 3 * std, name
        elif name.startswith("embed_tokens"):
            assert abs(p.std().item() - d ** -0.5) < 0.05 * d ** -0.5, name
        else:  # lecun normal, truncated at two standard deviations
            std = p.shape[1] ** -0.5
            assert abs(p.std().item() - std) < 0.1 * std, name
            assert p.abs().max().item() <= 2 * std / common.TRUNC_STD \
                * (1 + 1e-6), name
    again = Mixtral(cfg, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))


def test_engine_refuses_a_mixtral():
    # The JAX engine cannot serve one either: its Llama branch would take
    # the config and then miss the "mlp" parameters.
    from raytpu_torch.inference import InferenceEngine

    model = Mixtral(PCFG, device="cpu")
    with pytest.raises(TypeError, match="Mixtral"):
        InferenceEngine(model, device="cpu")
