#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raytpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: the card's name and power limit; no card, no run;
2. build: both CUDA kernels, from ``raytpu_torch/ops/csrc``;
3. kernels: each kernel against its plain PyTorch version, in bf16, at
   Llama-2-7B widths and the serve phase's shapes (plus one GQA case),
   with the kernel's, the plain version's and (flash only) the
   ``scaled_dot_product_attention`` yardstick's times and the bound;
4. serve: Llama-2-7B at full width and depth (random weights from a
   seed) behind ``InferenceEngine``, eight greedy requests with a shared
   prefix, a prompt longer than the prefill chunk and late arrivals;
   the kernels' launch counters must move during this run; then a
   decode batch of eight 1024-token sequences is timed and profiled
   (kernel time by name, device busy share);
5. end to end: prefill logits with the kernels against the plain
   versions at full width, and greedy-token agreement over a short run.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error, times and bound.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# bf16 inputs and outputs; both versions accumulate in fp32, so they
# differ by the output's rounding and the order of the sums
# (tests/test_ops.py uses the same bound for bf16 attention).
KERNEL_TOL = 3e-2
# Prefill logits after 32 bf16 layers: each layer rounds its activations
# to bf16 (relative step 2**-8 = 3.9e-3), and the kernel and the plain
# version round a few attention outputs differently; independent
# roundings over 32 layers grow as sqrt(32) * 3.9e-3 = 2.2e-2 of the
# logits' scale. The bound is that with a margin of about two.
E2E_TOL = 5e-2
SERVE_NEW_TOKENS = 32


def log(*args) -> None:
    print(*args, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---- phase 1: device ------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        sys.exit(1)
    line = card()
    log(f"[device] nvidia-smi: {line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return line


# ---- phase 2: build -------------------------------------------------


def phase_build() -> None:
    from raytpu_torch.ops import _native

    t0 = time.perf_counter()
    seconds = _native.build()
    log(f"[build] {json.dumps(seconds)} total "
        f"{time.perf_counter() - t0:.2f} s")
    for name in _native.KERNELS:
        report = _native.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")


# ---- phase 3: kernels against their plain versions ------------------


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def flash_case(t: int, gen, h: int = 32, d: int = 128) -> dict:
    import torch.nn.functional as F

    from raytpu_torch.ops.flash_attention import flash_attention

    q, k, v = (_randn((1, h, t, d), gen) for _ in range(3))
    o_k, lse_k = flash_attention(q, k, v, causal=True)
    o_p, lse_p = flash_attention(q, k, v, causal=True, force="reference")
    torch.cuda.synchronize()
    err = (o_k.float() - o_p.float()).abs().max().item()
    lse_err = (lse_k - lse_p).abs().max().item()
    nbytes = 4 * q.numel() * q.element_size() + lse_k.numel() * 4
    flops = 4.0 * h * d * t * (t + 1) / 2  # visible (query, key) pairs
    bound, by = bound_ms(nbytes, flops)
    return {
        "case": f"flash B=1 H={h} T={t} D={d} causal",
        "max_abs_err": max(err, lse_err),
        "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: flash_attention(
            q, k, v, causal=True, force="reference")),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        "bound_ms": bound, "bound_by": by,
    }


def paged_case(b: int, t: int, h: int, kv: int, gen, rng, q_start=None,
               d: int = 128, page_size: int = 16, n_pg: int = 128) -> dict:
    from raytpu_torch.ops.paged_attention import paged_attention

    num_pages = b * n_pg + 1
    k_pages = _randn((num_pages, page_size, kv, d), gen)
    v_pages = _randn((num_pages, page_size, kv, d), gen)
    # Distinct pages per sequence in shuffled order (page 0 is scratch).
    tables = rng.permutation(np.arange(1, num_pages)).reshape(b, n_pg)
    if q_start is None:  # ragged contexts, as in the serve phase
        q_start = rng.integers(64, n_pg * page_size - t, size=b)
    q_start = np.broadcast_to(np.asarray(q_start), (b,))
    positions = q_start[:, None] + np.arange(t)[None, :]
    q = _randn((b, t, h, d), gen)
    bt = torch.from_numpy(tables.astype(np.int32)).cuda()
    pos = torch.from_numpy(positions.astype(np.int32)).cuda()
    o_k = paged_attention(q, k_pages, v_pages, bt, pos)
    o_p = paged_attention(q, k_pages, v_pages, bt, pos, force="reference")
    # Page ids outside the pool are clamped into it, never read past it.
    wild = bt.clone()
    wild[:, -1] = num_pages + 7
    wild[:, 0] = -3
    clamped = wild.clamp(0, num_pages - 1)
    same = torch.equal(paged_attention(q, k_pages, v_pages, wild, pos),
                       paged_attention(q, k_pages, v_pages, clamped, pos))
    torch.cuda.synchronize()
    if not same:
        raise AssertionError("paged attention: out-of-pool page ids are "
                             "not clamped into the pool")
    err = (o_k.float() - o_p.float()).abs().max().item()
    # Slots each sequence reads, and (query, slot) pairs its rows see.
    live = np.minimum(q_start + t, n_pg * page_size)
    seen = np.minimum(positions + 1, n_pg * page_size).sum()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * int(live.sum()) * kv * d * k_pages.element_size()
              + bt.numel() * 4 + pos.numel() * 4)
    flops = 4.0 * h * d * float(seen)
    bound, by = bound_ms(nbytes, flops)
    return {
        "case": f"paged B={b} T={t} H={h} KV={kv} D={d} page={page_size} "
                f"P={n_pg} context<={int(live.max())}",
        "max_abs_err": err,
        "ms": time_ms(lambda: paged_attention(q, k_pages, v_pages, bt, pos)),
        "plain_ms": time_ms(lambda: paged_attention(
            q, k_pages, v_pages, bt, pos, force="reference")),
        "library_ms": None,
        "bound_ms": bound, "bound_by": by,
    }


def phase_kernels(card_line: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    cases = {
        "flash_forward": [flash_case(t, gen) for t in (128, 512, 1024)],
        "paged_attention": [
            paged_case(8, 1, 32, 32, gen, rng),                 # decode
            paged_case(1, 512, 32, 32, gen, rng, q_start=1024),  # chunk
            paged_case(8, 1, 32, 8, gen, rng),                  # GQA decode
            paged_case(1, 512, 32, 8, gen, rng, q_start=512),   # GQA chunk
        ],
    }
    for name, rows in cases.items():
        for row in rows:
            log(f"[kernels] {name}: {json.dumps(row)} | {card_line}")
            if not row["max_abs_err"] <= KERNEL_TOL:
                raise AssertionError(
                    f"{name} {row['case']}: kernel differs from its plain "
                    f"version by {row['max_abs_err']} > {KERNEL_TOL}")
    return cases


# ---- phase 4: serve -------------------------------------------------


def serve_prompts(rng, vocab: int):
    """Eight prompts of 64..1500 tokens; p1 and p4 share a 512-token
    prefix, p0, p1, p4, p5 and p7 are longer than the 512-token chunk."""
    prefix = rng.integers(0, vocab, 512).tolist()

    def fresh(n):
        return rng.integers(0, vocab, n).tolist()

    return {"p0": fresh(1500), "p1": prefix + fresh(180), "p2": fresh(64),
            "p3": fresh(300), "p4": prefix + fresh(90), "p5": fresh(900),
            "p6": fresh(200), "p7": fresh(1200)}


def phase_serve(model, card_line: str) -> dict:
    from raytpu_torch.inference import InferenceEngine, SamplingParams
    from raytpu_torch.ops.flash_attention import LAUNCHES as FLASH
    from raytpu_torch.ops.paged_attention import LAUNCHES as PAGED

    prompts = serve_prompts(np.random.default_rng(1), model.config.vocab_size)
    # p4 arrives after p1's first chunk has registered the shared prefix.
    arrivals = {0: ["p0", "p1", "p2", "p3"], 2: ["p4", "p5"], 4: ["p6", "p7"]}
    sampling = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    eng = InferenceEngine(model, page_size=16, max_num_seqs=8,
                          max_model_len=2048, prefill_chunk=512)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FLASH.reset()
    PAGED.reset()
    tokens = {rid: [] for rid in prompts}
    steps = 0
    t0 = time.perf_counter()
    while steps == 0 or eng.has_unfinished() or steps <= max(arrivals):
        for rid in arrivals.get(steps, []):
            eng.add_request(rid, prompts[rid], sampling)
        for o in eng.step():
            tokens[o.request_id].append(o.token_id)
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_forward": FLASH.count, "paged_attention": PAGED.count}
    stats = eng.stats()
    pc = stats["prefix_cache"]
    result = {
        "steps": steps, "wall_s": wall,
        "prompt_tokens": sum(len(p) for p in prompts.values()),
        "launches": launches,
        "ttft_p50_s": stats["ttft_p50_s"], "ttft_p95_s": stats["ttft_p95_s"],
        "prefill_tokens": stats["prefill_tokens"],
        "prefill_tokens_per_s": stats["prefill_tokens"]
        / stats["prefill_seconds"],
        "decode_tokens": stats["decode_tokens"],
        "decode_tokens_per_s": stats["decode_tokens"]
        / stats["decode_seconds"],
        "decode_steps": len(stats["decode_batch_hist"]),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "prefix_hit_tokens": pc["hit_tokens"],
        "prefill_calls": stats["prefill_calls"],
        "chunk_prefill_calls": stats["chunk_prefill_calls"],
        "decode_calls": stats["decode_calls"],
    }
    log(f"[serve] {json.dumps(result)} | {card_line}")
    short = {rid: len(t) for rid, t in tokens.items()
             if len(t) != SERVE_NEW_TOKENS}
    if short:
        raise AssertionError(f"requests without {SERVE_NEW_TOKENS} "
                             f"tokens: {short}")
    if not (launches["flash_forward"] > 0 and launches["paged_attention"] > 0):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if pc["hit_tokens"] <= 0:
        raise AssertionError("the shared prefix never hit the prefix cache")
    if not stats["chunk_prefill_calls"]:
        raise AssertionError("the chunked-prefill path never ran")
    del eng
    torch.cuda.empty_cache()
    return result


def phase_profile(model, card_line: str) -> dict:
    """Where a decode step's time goes: eight sequences with 1024-token
    prompts decoding together, timed over eight steps, then profiled
    over eight more (kernel time by name, device busy share)."""
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.inference import InferenceEngine, SamplingParams

    rng = np.random.default_rng(3)
    eng = InferenceEngine(model, page_size=16, max_num_seqs=8,
                          max_model_len=2048, prefill_chunk=512)
    for i in range(8):
        eng.add_request(f"d{i}", rng.integers(
            0, model.config.vocab_size, 1024).tolist(),
            SamplingParams(max_new_tokens=40))
    while eng.stats()["decode_batch_hist"][-3:] != [8, 8, 8]:
        eng.step()  # both prefill chunks, then warm decode steps
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if "CUDA" in str(e.device_type) and e.self_device_time_total]
    busy_us = sum(t for _, t in kernels)
    attn_us = sum(t for k, t in kernels if "attention_kernel" in k)
    top = sorted(kernels, key=lambda kt: -kt[1])[:8]
    result = {
        "batch": 8, "context": "1024+", "decode_step_ms": step_ms,
        "profiled_step_ms": window_us / n / 1e3,
        "device_busy_share": busy_us / window_us if busy_us else
        "not measured",
        "paged_attention_ms_per_step": attn_us / n / 1e3,
        "top_kernels": [{"kernel": k[:90], "ms_per_step": t / n / 1e3,
                         "share_of_busy": t / busy_us} for k, t in top],
    }
    log(f"[profile] {json.dumps(result)} | {card_line}")
    del eng
    torch.cuda.empty_cache()
    return result


# ---- phase 5: end to end against the plain path ---------------------


def phase_e2e(model, card_line: str) -> dict:
    from raytpu_torch.inference import InferenceEngine, SamplingParams
    from raytpu_torch.models.llama import llama_prefill

    cfg = model.config
    # Same weights, plain attention chosen through the config fields.
    plain = copy.copy(model)
    plain.config = dataclasses.replace(cfg, attn_impl="reference",
                                       paged_attn="reference")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))).cuda()
    with torch.no_grad():
        lk = llama_prefill(model, tokens)[0]
        lp = llama_prefill(plain, tokens)[0]
    scale = lp.abs().max().item()
    rel = (lk - lp).abs().max().item() / scale
    argmax_agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()

    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (700, 90)]
    sampling = SamplingParams(max_new_tokens=16)
    outs = []
    for m in (model, plain):
        eng = InferenceEngine(m, page_size=16, max_num_seqs=2,
                              max_model_len=1024, prefill_chunk=512)
        outs.append(eng.generate(prompts, sampling))
        del eng
    same = sum(a == b for ka, pa in zip(*outs) for a, b in zip(ka, pa))
    total = sum(len(x) for x in outs[0])
    result = {"prefill_T": 256, "logits_max_abs_diff_over_scale": rel,
              "logit_scale": scale, "prefill_argmax_agreement": argmax_agree,
              "greedy_token_agreement": same / total,
              "greedy_tokens_compared": total}
    log(f"[e2e] {json.dumps(result)} | {card_line}")
    if not rel <= E2E_TOL:
        raise AssertionError(f"prefill logits: kernel path differs from the "
                             f"plain path by {rel} of scale > {E2E_TOL}")
    return result


def kernel_line(cases: dict, launches: dict) -> dict:
    """One entry per kernel at the shape the serve phase runs most:
    flash at the 512-token prefill bucket, paged attention at decode
    with a batch of eight."""
    meta = {
        "flash_forward": ("raytpu_torch/ops/csrc/flash_attention.cu",
                          "raytpu/ops/flash_attention.py:159", 1),
        "paged_attention": ("raytpu_torch/ops/csrc/paged_attention.cu",
                            "raytpu/ops/paged_attention.py:175", 0),
    }
    out = []
    for name, (source, replaces, pick) in meta.items():
        row = cases[name][pick]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cases[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["case"],
        })
    return {"kernels": out}


def main() -> int:
    card_line = phase_device()
    from raytpu_torch.models.llama import Llama, LlamaConfig

    phase_build()
    cases = phase_kernels(card_line)
    t0 = time.perf_counter()
    model = Llama(LlamaConfig.llama2_7b(), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[serve] Llama-2-7B random weights: "
        f"{sum(p.numel() for p in model.parameters())} parameters in "
        f"{time.perf_counter() - t0:.2f} s")
    serve = phase_serve(model, card_line)
    phase_profile(model, card_line)
    phase_e2e(model, card_line)
    log(json.dumps(kernel_line(cases, serve["launches"])))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
