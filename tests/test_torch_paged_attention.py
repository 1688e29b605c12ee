"""The port's paged attention (raytpu_torch/ops/paged_attention.py)
against the JAX package's, on the shapes the JAX tests use: ragged
contexts, GQA ratios, page sizes, decode (T=1) and a chunk (B=1). The
plain PyTorch version is held against the JAX reference and against the
Pallas kernel run by the interpreter, in fp32. The CUDA kernel itself
runs only on the card (chip_smoke.py holds it against the plain version
there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.ops.paged_attention import _paged_pallas
from raytpu.ops.paged_attention import paged_attention as jax_paged
from raytpu.ops.paged_attention import \
    paged_attention_reference as jax_paged_reference
from raytpu_torch.ops.paged_attention import (
    LAUNCHES, SPLIT_MIN_SLOTS, gather_kv_pages, paged_attention,
    paged_attention_reference, paged_decode_split_reference, plan_splits)

# The JAX package's own bound (tests/test_paged_attention.py).
TOL = 1e-5


def _setup(rng, b, t, heads, kv, d, page_size, pages_per_seq, ctx=None):
    """Numpy pool + block tables + positions for ``b`` sequences whose
    query tokens end at ragged context lengths (the JAX test's setup)."""
    num_pages = b * pages_per_seq + 1
    q = rng.standard_normal((b, t, heads, d)).astype(np.float32)
    k = rng.standard_normal((num_pages, page_size, kv, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, page_size, kv, d)).astype(np.float32)
    bt = np.arange(1, num_pages, dtype=np.int32).reshape(b, pages_per_seq)
    if ctx is None:
        ctx = rng.integers(t, pages_per_seq * page_size, size=(b,))
    pos = np.maximum(ctx[:, None] - (t - 1) + np.arange(t)[None], 0)
    return q, k, v, bt, pos.astype(np.int32)


def _port(args, d):
    return paged_attention(*(torch.from_numpy(x) for x in args),
                           sm_scale=d ** -0.5).numpy()


def _jax(args, d, force=None):
    jargs = [jnp.asarray(x) for x in args]
    if force is None:
        return np.asarray(jax_paged_reference(*jargs, sm_scale=d ** -0.5))
    return np.asarray(jax_paged(*jargs, force=force))


@pytest.mark.parametrize("heads,kv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("page_size", [4, 8, 16])
def test_decode_matches_jax_reference_ragged(heads, kv, page_size):
    rng = np.random.default_rng(heads * 100 + page_size)
    args = _setup(rng, b=4, t=1, heads=heads, kv=kv, d=16,
                  page_size=page_size, pages_per_seq=6)
    np.testing.assert_allclose(_port(args, 16), _jax(args, 16),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("heads,kv,page_size", [(4, 4, 4), (8, 2, 8),
                                                (4, 1, 16)])
def test_decode_matches_pallas_interpret(heads, kv, page_size):
    rng = np.random.default_rng(heads * 10 + page_size)
    args = _setup(rng, b=4, t=1, heads=heads, kv=kv, d=16,
                  page_size=page_size, pages_per_seq=6)
    np.testing.assert_allclose(_port(args, 16), _jax(args, 16, "interpret"),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("force", [None, "interpret"])
def test_chunk_matches_jax(force):
    # Chunked prefill: B=1, many query tokens at consecutive positions.
    rng = np.random.default_rng(7)
    args = _setup(rng, b=1, t=24, heads=6, kv=3, d=16, page_size=8,
                  pages_per_seq=8)
    np.testing.assert_allclose(_port(args, 16), _jax(args, 16, force),
                               atol=TOL, rtol=TOL)


def test_padded_chunk_real_rows_match_kernel():
    # The engine pads a chunk of 20 tokens to a bucket of 32 with
    # position 0. The kernel reads positions[:, 0] and treats rows as
    # consecutive, so padding rows are garbage by contract: only the
    # real rows are compared.
    rng = np.random.default_rng(9)
    q, k, v, bt, _ = _setup(rng, b=1, t=32, heads=4, kv=2, d=16,
                            page_size=8, pages_per_seq=8)
    take, start = 20, 17
    pos = np.zeros((1, 32), np.int32)
    pos[0, :take] = np.arange(start, start + take)
    args = (q, k, v, bt, pos)
    np.testing.assert_allclose(_port(args, 16)[:, :take],
                               _jax(args, 16, "interpret")[:, :take],
                               atol=TOL, rtol=TOL)


def test_single_token_context():
    rng = np.random.default_rng(3)
    args = _setup(rng, b=2, t=1, heads=4, kv=2, d=8, page_size=4,
                  pages_per_seq=3, ctx=np.array([1, 1]))
    np.testing.assert_allclose(_port(args, 8), _jax(args, 8),
                               atol=TOL, rtol=TOL)


def test_gather_helper_layout():
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((9, 4, 2, 8)).astype(np.float32))
    bt = torch.tensor([[3, 1], [2, 2]], dtype=torch.int32)
    out = gather_kv_pages(k, bt)
    assert out.shape == (2, 8, 2, 8)
    assert torch.equal(out[0, :4], k[3]) and torch.equal(out[1, 4:], k[2])


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(x) for x in _setup(
        rng, b=2, t=1, heads=4, kv=2, d=16, page_size=4, pages_per_seq=3)]
    before = LAUNCHES.count
    out = paged_attention(*args)
    assert out.shape == args[0].shape and LAUNCHES.count == before
    with pytest.raises(ValueError):
        paged_attention(*args, force="interpret")
    with pytest.raises(ValueError):  # positions not [B, T]
        paged_attention(*args[:4], args[4][:, :0])


@pytest.mark.parametrize("b,t,heads,kv,page_size", [
    (4, 1, 4, 4, 8),     # decode
    (4, 1, 8, 2, 16),    # GQA decode
    (1, 48, 4, 4, 8),    # chunk
    (1, 40, 8, 2, 16),   # GQA chunk
], ids=["decode", "gqa-decode", "chunk", "gqa-chunk"])
def test_bf16_rounded_mirror_matches_pallas_interpret(b, t, heads, kv,
                                                      page_size):
    # The mirror (gathered slots walked a page at a time, the TPU kernel's
    # block; P rounded to bf16 before P V, l summed from the fp32 P)
    # against the interpreted Pallas kernel on the same bf16 inputs. They
    # differ only in the order of their fp32 sums, so the output must lie
    # under a quarter of the unrounded plain version's relative norm
    # distance, which carries the rounding of P (as in
    # test_torch_flash_attention.py); a mirror that forgot to round lands
    # there and fails.
    d = 32
    rng = np.random.default_rng(b * 100 + t + heads)
    args = _setup(rng, b=b, t=t, heads=heads, kv=kv, d=d,
                  page_size=page_size, pages_per_seq=12)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in args[:3]] + [
        jnp.asarray(x) for x in args[3:]]
    want = np.asarray(_paged_pallas(*jargs, sm_scale=d ** -0.5,
                                    interpret=True), np.float32)
    targs = [torch.from_numpy(np.array(x, np.float32)).bfloat16()
             for x in jargs[:3]] + [torch.from_numpy(x) for x in args[3:]]

    def distance(**kw):
        o = paged_attention_reference(*targs, sm_scale=d ** -0.5, **kw)
        return np.linalg.norm(o.float().numpy() - want) / np.linalg.norm(want)

    mirror = distance(round_operands=True, block_k=page_size)
    plain = distance()
    assert mirror < plain / 4, (mirror, plain)


def test_rounded_mirror_in_fp32_is_the_dense_plain_version():
    rng = np.random.default_rng(21)
    args = [torch.from_numpy(x) for x in _setup(
        rng, b=3, t=1, heads=8, kv=2, d=16, page_size=4, pages_per_seq=9)]
    dense = paged_attention_reference(*args, sm_scale=0.25)
    mirror = paged_attention_reference(*args, sm_scale=0.25,
                                       round_operands=True, block_k=4)
    np.testing.assert_allclose(mirror.numpy(), dense.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_split_plan_puts_every_page_in_one_split(seed, monkeypatch):
    # The planner is plain host arithmetic: it must not touch the device
    # (a read would stall the host-bound decode step), so here every CUDA
    # query raises.
    def no_device(*_a, **_k):
        raise AssertionError("plan_splits read the device")

    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    monkeypatch.setattr(torch.cuda, "is_available", no_device)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n_pg = int(rng.integers(0, 600))
        page_size = int(rng.choice([1, 4, 8, 16, 32]))
        b, kv = int(rng.integers(1, 65)), int(rng.choice([1, 2, 8, 32]))
        n_sm = int(rng.choice([1, 16, 132]))
        n_split, pages = plan_splits(n_pg, page_size, b, kv, n_sm)
        assert type(n_split) is int and type(pages) is int
        assert n_split >= 1 and pages >= 1
        owner = [p // pages for p in range(n_pg)]
        assert all(0 <= s < n_split for s in owner)
        assert sorted(set(owner)) == list(range(n_split)) or n_pg == 0
        if n_split > 1:
            assert pages * page_size >= SPLIT_MIN_SLOTS
    # One split where batch x kv heads fill the card; several where not.
    assert plan_splits(128, 16, 64, 32, 132)[0] == 1
    assert plan_splits(128, 16, 1, 32, 132)[0] > 1


@pytest.mark.parametrize("n_split,pages", [(1, 8), (3, 3), (4, 2), (8, 1)])
@pytest.mark.parametrize("heads,kv,t", [(4, 4, 1), (8, 2, 1), (4, 1, 3)])
def test_split_walk_and_combine_match_dense(n_split, pages, heads, kv, t):
    # Ragged contexts shorter than the table, so that the last splits of
    # every sequence start past its last visible slot and are dropped.
    rng = np.random.default_rng(n_split * 10 + heads + t)
    args = _setup(rng, b=4, t=t, heads=heads, kv=kv, d=16, page_size=4,
                  pages_per_seq=8, ctx=np.array([1, 5, 17, 19]))
    targs = [torch.from_numpy(x) for x in args]
    got = paged_decode_split_reference(*targs, sm_scale=0.25,
                                       n_split=n_split, pages_per_split=pages)
    want = paged_attention_reference(*targs, sm_scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)
