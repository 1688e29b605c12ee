#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``raytpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. device: the card's name and power limit; no card, no run;
2. build: every CUDA kernel, from ``raytpu_torch/ops/csrc``, one ``nvcc``
   per source, all at once; each kernel's registers and spills, the
   tensor-core (HMMA) instructions of every bf16 instance that must have
   them, and the bulk copies (UBLKCP) of every instance of the RMSNorm
   ring;
3. accumulation: the tensor cores' fp32 sums of bf16 products, through
   the kernels' own mma.sync helpers, against exact sums: the rounding
   model that the limits below rest on (``FP32_DOT_REL``);
4. kernels: each kernel against its plain PyTorch version, in bf16, at
   Llama-2-7B widths and the serve phase's shapes (plus GQA, one-split
   and many-split decode cases), at the GPT-2 train shape (plus a
   full-attention, a D=128 and a cross-length case for the backward
   kernels), at the Llama train shape, at GPT-2 serving's (D = 64, one
   query head a KV head) and at the Mixtral train shape, with the
   kernel's (CUDA events, device time from the profiler, and the
   wrapper's host time a call), the plain version's and the library
   yardstick's times (``scaled_dot_product_attention``, ``F.rms_norm``)
   and the bound; the bf16 flash kernels also against their rounding
   mirrors; RMSNorm also in fp32 and at a D that is not a multiple of 8
   (its element path); six faults planted in
   the kernels' output, which the limits must see; and gradients through
   the autograd Functions against the plain ones;
5. serve: Llama-2-7B at full width and depth (random weights from a
   seed) behind ``InferenceEngine``, eight greedy requests with a shared
   prefix, a prompt longer than the prefill chunk and late arrivals;
   the serving kernels' launch counters must move during this run, and
   the RMSNorm kernel's by 65 a forward; then a decode batch of eight
   1024-token sequences is timed and profiled (kernel time by name,
   device busy share);
6. end to end: prefill logits with the kernels against the plain
   versions at full width, and greedy-token agreement over a short run;
7. GPT-2 serve: GPT-2 124M at full width and depth (random fp32 weights
   from a seed, bf16 compute) behind ``InferenceEngine``, eight greedy
   requests with a shared prefix, prompts longer than the 256-token
   chunk and late arrivals; the flash forward's and the paged kernel's
   (D = 64) launch counters must move during this run;
8. GPT-2 serve end to end: as phase 6, for GPT-2;
9. train: GPT-2 124M at full width and depth (random weights from a
   seed, fp32 parameters, bf16 compute, full remat) takes AdamW steps on
   one fixed batch of 8 x 1024 random tokens; the three flash kernels'
   launch counters must move, the loss must be finite and fall; the tied
   LM head's logits and gradients on the card's route are held against
   JAX's function; one step is profiled;
10. train end to end: one step's loss and gradients with the kernels
    against the plain attention, from the same weights and tokens;
11. Llama train: Llama-2-7B at full width cut to 8 layers (fp32
    parameters, bf16 compute, remat "dots") takes AdamW steps on one
    fixed batch of 2 x 4096 random tokens; the flash and RMSNorm kernels
    must launch the counts a step that the path implies, the loss must
    be finite and fall; one step is profiled;
12. Llama train end to end: one step's loss and gradients with the
    kernels against the plain attention and RMSNorm, and with remat
    "full" against "dots", from the same weights and tokens;
13. Mixtral train: Mixtral-8x7B's widths cut to 2 layers (fp32
    parameters, bf16 compute, remat "dots", top 2 of 8 experts with a
    capacity factor of 1.25) takes AdamW steps on one fixed batch of
    4096 random tokens; the flash and RMSNorm kernels must launch the
    counts a step that the path implies, the loss must be finite and
    fall; the share of routed slots dropped, and one step profiled with
    the bf16 GEMMs and the fp32 routing products apart;
14. Mixtral train end to end: as phase 12, on the training batch and on
    a second one, at the kernel path's routes and at free routes (how
    far the gradients move with the tokens routed otherwise, also with
    tokens rerouted on purpose), with remat "full" and "dots" equal to
    the bit;
15. GPT-2 dropout: GPT-2 124M's training forward and backward at
    dropout 0.1: rate 0 and the deterministic forward equal to the bit,
    the keep share within five standard deviations, survivors divided by
    1 - p exactly, remat "full" against "none" under one generator seed;
16. RL PPO: ``raytpu_torch.rllib`` PPO at benchmarks/bench_ppo.py's
    config (CartPole-v1-vec, 64 envs x 64 steps, minibatch 512, the
    (256, 256) fcnet): env-steps/s and learner samples/s as bench_ppo
    counts them, an iteration's split (env step, sampling forward with
    its copies, update, the rest) and the device's busy share; one
    rollout update on the card against the same update on the CPU; the
    same rates with device="cpu" as a CPU reading;
17. RL pixel PPO: the conv module on Catch-v0 with FrameStack(2), 16
    envs x 40 steps: iteration times, a greedy evaluation, the card
    against the CPU;
18. RL algorithms: IMPALA, APPO, DQN (CartPole), SAC (Pendulum), BC,
    MARWIL and CQL (offline rows of a hand controller) take three
    train() calls each; every metric finite, every parameter on the
    card. The five kernels' counters, set to 0 before phase 16, must
    read 0 after phase 18;
19. deployment (run after phase 6, once phase 5's model is freed):
    Llama-2-7B behind ``LLMDeployment`` with phase 5's engine, phase 5's
    eight prompts on client threads arriving by events, a stream closed
    after 4 tokens and one aborted from outside: every stream's tokens,
    the kernels' launches (RMSNorm 65 a forward), an idle snapshot with
    no page held, the loop's thread joined at shutdown; TTFT at the
    client and in the engine, the decode rate, the share of the run the
    loop held the engine lock and a request thread's waits for it, and
    token agreement with phase 5; then the same streams with the JAX
    package's lock under the engine condition;
20. disagg: a prefill and a decode replica of Llama-2-7B (both seed 0,
    bit-equal weights) on the card: a 1500-token prompt whose 93 full
    pages the decode replica pulls, prefilling only the 12-token tail,
    the grafted pages equal to the source's, the decode replica's tokens
    equal to the prefill replica's for the same prompt asked again; a
    prompt under a page never pulls; a pull from a peer lost halfway
    falls back to a local prefill and leaves nothing pinned. Readings:
    the handoff's bytes, seconds and GB/s against one pinned copy of
    the same bytes, page reads a second, TTFT against the colocated
    replica's, peak memory;
21. observability (run after phase 6, on phase 5's model): phase 5's
    engine and traffic plus a request aborted while it decodes, with
    request events, tracing and the step profiler on: every request's
    events in the JAX package's order with none dropped; the
    ``raytpu_infer_*`` counters against the engine's and the prefix
    cache's own counts, the gauges against the scheduler and the cache
    and after ``note_idle``; one ``infer.*`` span a forward by kind and
    bucket; one step time a decode step, the MFU gauge equal to the
    analytic FLOPs over the step time over the card's peak (by its name),
    the device-memory gauges equal to the allocator's; the same traffic
    with everything off giving the same tokens to the bit and the same
    launches of all five kernels; two decode steps inside
    ``tracing.profile`` whose trace names the paged and RMSNorm kernels.
    Readings: the per-token cost of all hooks and of each alone, each
    run beside a run with everything off, over ten rounds in turns; the
    same for single decode steps of eight in one engine; and the hooks'
    host µs a decode step.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is the card's name and power limit, and the one before that lists every
kernel with its launches, error, times and bound.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
# on the tensor cores, fp32 outside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# The paged kernel against its plain version, elementwise: bf16 inputs
# and outputs, both accumulating in fp32, so they differ by the output's
# rounding, the order of the sums and the kernel's rounding of P
# (tests/test_ops.py uses the same bound for bf16 attention, whose Pallas
# kernels round P too).
KERNEL_TOL = 3e-2
# Prefill logits after 32 bf16 layers: each layer rounds its activations
# to bf16 (relative step 2**-8 = 3.9e-3), and the kernel and the plain
# version round a few attention outputs differently; independent
# roundings over 32 layers grow as sqrt(32) * 3.9e-3 = 2.2e-2 of the
# logits' scale. The bound is that with a margin of about two.
E2E_TOL = 5e-2
# Attention gradients in bf16, the kernels against the mirror backward
# (flash_attention_backward_reference with round_operands: P rounded to
# bf16 before the dV product, dS before the dQ and dK products, where the
# TPU kernels and the tensor-core kernels round them). Both multiply the
# same bf16 operands exactly, sum the products in fp32 in another order
# (tensor cores against cuBLAS's fp32 GEMM) and round each gradient once
# to bf16, so an element may differ by one bf16 step (2**-8 to 2**-7 of
# it) where its sum lies near a rounding boundary. One term is new: a P
# or dS element whose two fp32 values (scores from the tensor cores and
# from the fp32 GEMM, about 1e-7 apart) straddle a bf16 rounding boundary
# rounds to neighbouring values on the two sides, about one element in
# 4e4 (2e-7 over a step of 2**-7). Such a flip moves one term of a sum
# over up to 4096 keys or queries by one step of that term: about 1e-5
# of the norm limit, and far below one step of the sum unless that term
# is most of the sum: in the first rows of a causal dQ and the first keys
# of dK and dV, where a few large P and dS terms make most of a sum, or
# where larger terms cancel. There it adds up to a step of the term to
# the one step of the final rounding (on an H100 the cases here read up
# to 1.39 of the one-step limit, at rows 1 to 108). So each
# gradient tensor is held elementwise to one step, 2**-7 |mirror|, plus
# 1e-3 for elements near zero (a typical element at the train shape is
# 0.05-0.07), plus what flips can move it, flip_allowance(); and in norm,
# ||kernel - mirror|| / ||mirror||, to GRAD_NORM_TOL. The one-step and
# norm limits are PR 3's, set then for the same comparison with P and dS
# unrounded on both sides (0 at D=64, at most 8.8e-5 in norm and 0.78 of
# one step at D=128).
GRAD_ELT_REL = 2 ** -7
GRAD_ELT_ABS = 1e-3
GRAD_NORM_TOL = 1e-3
# How far the kernels' fp32 sums may lie from the mirrors', for
# flip_allowance() and forward_limits(). The mirrors sum in cuBLAS's fp32
# GEMM, rounding each addition to nearest: a dot product of D terms errs
# by at most gamma_D = D 2**-24 of the sum of the terms' magnitudes
# (Higham). The tensor cores' fp32 accumulation keeps the same bound with
# the unit of its rounding, 2**-24 to nearest, 2**-23 toward zero (Fasi,
# Higham, Mikaitis and Pranesh, PeerJ CS 2021); phase_accumulation
# measures which one this card's mma.sync does and fails unless it is
# TC_ROUNDING. On an H100 it reads toward zero: 1 + 3/4 of an fp32 ulp
# sums to 1 (to nearest would give 1 + 1 ulp), and sums of positive terms
# err low on average. So the two sides of a D-term dot product differ by
# at most D FP32_DOT_REL = D 3 2**-24 of that sum. The few fp32 roundings
# and the 2-ulp expf after the products move a value by at most
# FP32_OPS_REL of it.
TC_UNITS = {"to nearest": 2 ** -24, "toward zero": 2 ** -23}
TC_ROUNDING = "toward zero"
FP32_DOT_REL = TC_UNITS[TC_ROUNDING] + 2 ** -24
FP32_OPS_REL = 2 ** -21
# The same gradients against the unrounded plain backward, in norm only.
# The kernels round P and dS to bf16 once each before a product; one
# rounding moves a value by up to half a step, 2**-8 of it, uniformly, so
# by at most 2**-8 / sqrt(3) = 2.3e-3 of it RMS, and over the many
# independent terms of a gradient's sum the fp32 gradient moves by at
# most that share of its norm. Both sides then round to bf16: a shift e
# turns into a one-step difference (step s <= 2**-7 of the value) with
# probability |e| / s, so the rounded gradients differ in norm by
# sqrt(s E|e|) <= sqrt(2**-7 * 2.3e-3) = 4.2e-3 of theirs. The limit is
# one step, 2**-7 = 7.8e-3, about twice that.
ROUNDING_NORM_TOL = 2 ** -7
# The bf16 flash forward against its mirror
# (flash_attention_reference(round_operands=True, block_k=FWD_TILE): the
# kernel's 64-key tiles, P rounded to bf16 before P V, l summed from the
# fp32 P). Both multiply the same bf16 operands exactly, sum in fp32 in
# another order and round O once to bf16, so an element may differ by one
# bf16 step, 2**-7 |mirror| at most; where O is near zero, by the fp32
# sums' own error instead; and by what flips of P move it (a P element
# whose two fp32 values straddle a bf16 rounding boundary rounds to
# neighbouring values: one step of P times |v| / l). forward_limits()
# derives the last two per element from FP32_DOT_REL and FP32_OPS_REL. In
# norm the kernel is held to FWD_NORM_TOL of the mirror, as the backward;
# to the unrounded plain version to ROUNDING_NORM_TOL (one rounding of P
# before one product, then one of O: the derivation above); its lse to
# the plain lse within forward_limits()' bound from the fp32 sums.
FWD_TILE = 64
FWD_ELT_REL = 2 ** -7
FWD_NORM_TOL = 1e-3
# The tied LM head on the card against the same function with the
# operands rounded to bf16 and multiplied in fp32 (JAX's dot_general with
# preferred_element_type=f32, and its transpose), in norm. Logits: fp32
# sums of the same exact products in another order, 7.6e-7 on an H100;
# rounding them to bf16 would read about 1e-3. Gradients: both sides
# round to bf16 sums that differ by the order and by the split of the
# logits' gradient into two bf16 parts (2**-16 of it), 5.4e-4 (dx) and
# 2.2e-4 (dw); rounding that gradient to bf16 instead, as one bf16
# product would, read 2.6e-3 in both and must fail.
HEAD_LOGITS_TOL = 1e-5
HEAD_GRAD_TOL = 1e-3
# RMSNorm kernel against its plain version. Both sum the fp32 squares (in
# other orders), take one rsqrt and round the product once to the output
# type, so an element may differ by one step of that type (2**-7 |plain|
# at most, plus 1e-6 near zero) where the two fp32 values straddle a
# rounding boundary, and by nothing else. Elementwise, a kernel that sums
# the squares over D - 8 columns stays within one step as well (it moves
# every element by about 0.1 %, a quarter of a step), so each case is also
# held in norm, ||kernel - plain|| / ||plain|| <= NORM_NORM_TOL. Readings
# on an H100: at [8192, 4096] bf16 9.7e-6 in norm and 0.99 of the
# elementwise limit (one step), the planted fault 2.3e-3 in norm; in fp32
# 9.5e-7 at most.
NORM_ELT_REL = 2 ** -7
NORM_ELT_ABS = 1e-6
NORM_NORM_TOL = 1e-4
SERVE_NEW_TOKENS = 32
TRAIN_BATCH = 8        # bench.py's first autotune candidate: batch 8, full remat
LLAMA_TRAIN_LAYERS = 8  # of 32: fp32 parameters and AdamW state fit one card
LLAMA_TRAIN_BATCH = 2   # x 4096 tokens, the model's context
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
# One GPT-2 124M step (batch 8 x 1024, bf16 compute) with the kernels
# against the plain attention, from the same weights and tokens; written
# before the first full run. The two attention paths differ only in the
# order of their fp32 sums (~1e-7 relative), so an output or gradient
# element rounds to another bf16 value (one step, 2**-8 = 3.9e-3
# relative) only where its fp32 value lies within that much of a rounding
# boundary: roughly one element in 1e3 to 1e4 per attention call. The
# differences then spread through 12 layers of bf16 matmuls forward and
# backward, each of which rounds again. Predicted: the loss (a mean over
# 8184 positions in fp32) within 1e-4 relative; the worst parameter's
# gradient within about 1e-2 in ||g_kernel - g_plain|| / ||g_plain||,
# largest for small tensors whose gradient is a sum with cancellation
# (LayerNorm and bias vectors). The bounds are those with a margin of ten
# and of five.
TRAIN_E2E_LOSS_TOL = 1e-3
TRAIN_E2E_GRAD_TOL = 5e-2
# One Llama-2-7B step (8 layers, batch 2 x 4096, bf16 compute, remat
# "dots") with the kernels against the plain attention and RMSNorm, from
# the same weights and tokens; written before the first full run. As for
# GPT-2 above, the two paths differ by one-step roundings of a small share
# of bf16 elements (attention outputs and gradients; a norm output where
# the two fp32 sums of squares differ in their last bit), which spread
# through 8 layers of bf16 matmuls forward and backward, each 4096 to
# 11008 wide. Predicted: the loss within 1e-4 relative, the worst
# parameter's gradient within about 1e-2 in relative norm. The limits are
# GPT-2's, that with a margin of ten and of five. Remat "full" against
# "dots" runs the same kernels on the same inputs (the recompute must give
# what the first forward gave), so its gradients are held to
# GRAD_NORM_TOL, a quarter of one bf16 step, and its loss to the same
# limit as the loss above.
LLAMA_E2E_LOSS_TOL = 1e-3
LLAMA_E2E_GRAD_TOL = 5e-2
# GPT-2 serving: a 256-token chunk, eight sequences of up to 1024 tokens.
GPT2_SERVE_CHUNK = 256
# Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1, config.json), cut
# to 2 of its 32 layers: fp32 parameters, gradients and AdamW's two
# moments take 16 bytes a parameter, 50.6 GB for 2 layers (3.165 B
# parameters), and AdamW's multi-tensor step a fourth copy while it runs.
MIXTRAL_TRAIN_LAYERS = 2
MIXTRAL_TRAIN_BATCH = 1  # x 4096 tokens
# One Mixtral step with the kernels against the plain attention and
# RMSNorm, from the same weights and tokens. Besides the one-step
# roundings of the Llama comparison above, the router sends a token
# elsewhere where two of its top experts lie within the two paths'
# difference of each other in router logit: that token's FFN output
# changes as a whole, and its experts' later routes move one place in
# the capacity stream. That is no rounding of a kernel. So the kernels
# are held to the plain versions at the kernel path's routes (the plain
# path takes them over, with its own router's weights): the loss within
# 1e-3 relative and every gradient within 5e-2 in relative norm,
# Llama's limits. With free routes the loss is held to 1e-3 as well, and
# every gradient to MIXTRAL_FREE_GRAD_TOL = 1: ||a - b|| < ||b|| implies
# <a, b> > ||a||^2 / 2 > 0, so the kernel path's gradient is still a
# descent direction of the plain path's loss. A tighter limit would not
# hold: after training on one batch the router is collapsed and its
# softmax saturated for most tokens, so its gradient comes mostly from
# the few tokens near a tie, the very ones that flip, and one flip can
# move it by half its norm. On an H100 with the seeds here, 5 tokens a
# layer routed otherwise on the training batch moved the worst gradient
# by 0.068 (pinned: 0.0079), 19 and 22 on a second batch
# (MIXTRAL_E2E_SEED) by 0.487 (pinned: 0.019); admitting the tokens
# routed otherwise a quarter at a time, the gap jumped from the pinned
# level to the free one at a single quarter on each batch; flips planted
# at the tokens nearest a tie (MIXTRAL_REROUTES a layer) moved it by
# 0.008 to 0.135 and 0.036 to 0.517. Remat "full" against "dots" runs
# the same kernels on the same inputs and must agree to the bit.
MIXTRAL_E2E_LOSS_TOL = 1e-3
MIXTRAL_E2E_GRAD_TOL = 5e-2
MIXTRAL_FREE_GRAD_TOL = 1.0
MIXTRAL_REROUTES = (4, 8, 16, 32, 64)
MIXTRAL_E2E_SEED = 5


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


def device_ms(fn, kernel: str, iters: int = 20, tries: int = 3) -> float:
    """Mean device time of ``fn`` in ms from the profiler: the kernels
    whose names hold ``kernel`` (every kernel for ``""``), summed, per
    call. Unlike time_ms, the host's time between launches is left out,
    so it reads the kernels themselves where a call's host work outlasts
    them. The trace now and then comes back without some of the kernels
    (all of them once, one in 20 three times in a row, in runs of this
    script): a reading with fewer kernels than calls is taken again, up
    to ``tries`` times, and the fullest one is kept."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)  # (kernels seen, their device µs)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if kernel in e.key and e.self_device_time_total > 0]
        best = max(best, (sum(e.count for e in found),
                          sum(e.self_device_time_total for e in found)))
        if best[0] >= iters:
            break
    seen, us = best
    if not seen:
        raise AssertionError(f"the profiler saw no kernel named {kernel!r} "
                             f"in {iters} calls, {tries} times")
    # A kernel missing from the trace: the mean over the kernels seen,
    # times the kernels a call launches.
    return us / seen * max(1, round(seen / iters)) / 1e3


def host_us(fn, calls: int = 50, repeats: int = 5) -> float:
    """The host's time a call of ``fn`` in µs: ``time.perf_counter_ns``
    over ``calls`` back-to-back calls started on an idle device (too few
    to fill the launch queue, so the device's time does not enter), the
    median of ``repeats`` such runs."""
    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter_ns() - t0) / calls / 1e3)
    torch.cuda.synchronize()
    return float(np.median(runs))


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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


# Libraries whose bf16 instances ("*mma_kernel*", one per head dim) must
# run on the tensor cores: the flash forward, the paged chunk path, dQ and
# dK/dV.
TENSOR_CORE_LIBRARIES = ("flash_attention", "paged_attention", "flash_bwd_dq",
                         "flash_bwd_dkv")
# The SASS of cp.async.bulk from global to shared memory on sm_90a, and
# the RMSNorm ring's instances: x and the scale each fp32 or bf16, times
# 1, 2, 4 or any number of 16-byte units a thread.
BULK_COPY_SASS = "UBLKCP"
RING_INSTANCES = 16


def phase_build() -> dict:
    from raytpu_torch.ops import _native

    t0 = time.perf_counter()
    seconds = _native.build()
    log(f"[build] {json.dumps(seconds)} total "
        f"{time.perf_counter() - t0:.2f} s")
    report = {}
    for name in [*_native.KERNELS, *_native.TOOLS]:
        report[name] = ptxas_report(_native.library_path(name))
        log(f"[build] {name}: registers and spills per kernel "
            f"{json.dumps(report[name])}")
    # Every bf16 instance of these must hold HMMA instructions in the
    # compiled code.
    for name in TENSOR_CORE_LIBRARIES:
        counts = sass_counts(_native.library_path(name), "HMMA")
        log(f"[build] {name}: HMMA instructions per kernel "
            f"{json.dumps(counts)}")
        tensor_core = [n for f, n in counts.items() if "mma_kernel" in f]
        if len(tensor_core) != len(_native.HEAD_DIMS) or not all(tensor_core):
            raise AssertionError(f"{name}: a bf16 instance has no tensor-core "
                                 f"instruction: {counts}")
        for f, n in counts.items():
            report[name].setdefault(f, {})["hmma"] = n
    # Every instance of the RMSNorm ring must fill its stages by the TMA's
    # bulk copy: cp.async.bulk (global -> shared) compiles to UBLKCP.
    counts = sass_counts(_native.library_path("rmsnorm"), BULK_COPY_SASS)
    log(f"[build] rmsnorm: {BULK_COPY_SASS} instructions per kernel "
        f"{json.dumps(counts)}")
    ring = [n for f, n in counts.items() if "ring_kernel" in f]
    if len(ring) != RING_INSTANCES or not all(ring):
        raise AssertionError(f"rmsnorm: a ring instance has no bulk copy "
                             f"({BULK_COPY_SASS}): {counts}")
    for f, n in counts.items():
        report["rmsnorm"].setdefault(f, {})["bulk_copies"] = n
    return report


# A kernel's name in a mangled symbol: its function name and template
# arguments ("flash_forward_mma_kernelILi128E",
# "paged_decode_kernelILi128ELi1ELi8E").
_KERNEL_NAME = re.compile(r"\d([a-z_]+_kernelI\w*?E)E")


def _kernel_name(symbol: str) -> str:
    found = _KERNEL_NAME.search(symbol)
    return found.group(1) if found else symbol


def ptxas_report(library) -> dict:
    """Registers, spill stores and loads of each kernel, from the
    ``-Xptxas -v`` report the build kept beside the library."""
    out, kernel = {}, None
    path = library.with_suffix(".log")
    for line in (path.read_text().splitlines() if path.exists() else []):
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            kernel = _kernel_name(found.group(1))
            out[kernel] = {}
            continue
        if kernel is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[kernel]["spill_stores"] = int(spill.group(1))
            out[kernel]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[kernel]["registers"] = int(regs.group(1))
    return out


def sass_counts(library, opcode: str) -> dict:
    """Instructions named ``opcode`` (HMMA: the tensor cores) in each
    kernel of a built library, from ``cuobjdump -sass``."""
    from raytpu_torch.ops import _native

    tool = pathlib.Path(_native.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(library)], check=True,
                          capture_output=True, text=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = _kernel_name(line.split(":")[-1].strip())
            counts[kernel] = 0
        elif kernel is not None and opcode in line:
            counts[kernel] += 1
    return counts


# ---- phase 3: the tensor cores' fp32 accumulation --------------------


def _probe(lib, mode: int, a, b, p=None):
    """``csrc/mma_probe.cu`` on [n, 64, D] tiles: mode 0 A B^T (the
    scores' product), mode 1 P B (P V, P fp32 [n, 64, 64])."""
    from raytpu_torch.ops import _native

    n, _, d = a.shape
    out = torch.empty((n, 64, 64 if mode == 0 else d), device="cuda")
    rc = lib.rt_mma_probe(a.data_ptr(), b.data_ptr(),
                          None if p is None else p.data_ptr(), out.data_ptr(),
                          mode, d, n, torch.cuda.current_stream().cuda_stream)
    _native.check_launch(lib, rc, "mma_probe")
    return out.double()


def _sum_reading(what: str, d: int, inputs: str, got, exact, mag,
                 n: int) -> dict:
    """The largest |error| / sum|terms| of sums of n terms, beside the
    bound of each rounding model (n units), and the mean signed error in
    units of 2**-24 (toward zero reads negative on positive sums)."""
    live = mag > 0
    rel = ((got - exact).abs() / mag)[live]
    signed = ((got - exact) / mag)[live]
    return {"product": what, "d": d, "inputs": inputs, "terms": n,
            "max_err_over_sum_terms": rel.max().item(),
            "bound_to_nearest": n * TC_UNITS["to nearest"],
            "bound_toward_zero": n * TC_UNITS["toward zero"],
            "mean_signed_err_units": (signed.mean() / 2 ** -24).item()}


def _rounding_cases(lib) -> list:
    """Sums built to tell the rounding models apart: sign (1 + f 2**-23)
    for f = 1/4 and 3/4 (the products 1 x 1 and 2**-12 x f 2**-11, both
    exact in bf16), the small one in the same 16-deep product as the 1 or
    in the next; to nearest gives 1 and 1 + 2**-23, toward zero 1 and 1.
    Returns, per case, the result's distance beyond 1 in units of
    2**-23."""
    d = 32
    a = torch.zeros((1, 64, d), device="cuda")
    b = torch.zeros((1, 64, d), device="cuda")
    cases = [(f, sign, col) for f in (0.25, 0.75) for sign in (1.0, -1.0)
             for col in (1, 16)]
    for i, (f, sign, col) in enumerate(cases):
        a[0, i, 0], b[0, i, 0] = sign, 1.0
        a[0, i, col], b[0, i, col] = sign * 2 ** -12, f * 2 ** -11
    out = _probe(lib, 0, a.bfloat16(), b.bfloat16())
    return [{"f": f, "sign": sign, "same_product": col < 16,
             "ulps_beyond_1": (out[0, i, i].abs().item() - 1) / 2 ** -23}
            for i, (f, sign, col) in enumerate(cases)]


def phase_accumulation(card_line: str) -> dict:
    """The tensor cores' fp32 sums of bf16 products (``csrc/mma_probe.cu``,
    the kernels' own mma.sync helpers, in their order) against exact sums
    (fp64 products and sums of the same bf16 values): the D-term dot
    products of the scores (D = 32, 64, 128) and the 64-key sums of P V,
    over random inputs, inputs of magnitudes 2**-20..2**20, pairs of
    terms that cancel but for a part in about 2**8, and positive terms;
    and the sums of _rounding_cases(). Fails unless the readings fit
    TC_ROUNDING, the model FP32_DOT_REL rests on: the built cases read as
    that model rounds them, and every reading lies within its bound."""
    from raytpu_torch.ops import _native

    lib = _native.load("mma_probe")
    gen = torch.Generator(device="cuda").manual_seed(11)
    n = 64  # tiles of 64 rows

    def draw(kind, d):
        x = torch.randn((n, 64, d), generator=gen, device="cuda")
        if kind == "magnitudes":
            x = x * torch.exp2(torch.randint(-20, 21, x.shape, generator=gen,
                                             device="cuda").float())
        return (x.abs() if kind == "positive" else x).bfloat16()

    rows = []
    for d in _native.HEAD_DIMS:
        for kind in ("normal", "magnitudes", "cancelling", "positive"):
            a, b = draw(kind, d), draw(kind, d)
            if kind == "cancelling":
                h = d // 2
                a[..., h:] = a[..., :h]
                b[..., h:] = (-b[..., :h].float() * (1 + 2 ** -7 * torch.randn(
                    (n, 64, h), generator=gen, device="cuda"))).bfloat16()
            a64, b64 = a.double(), b.double()
            rows.append(_sum_reading(
                "scores", d, kind, _probe(lib, 0, a, b),
                torch.bmm(a64, b64.transpose(1, 2)),
                torch.bmm(a64.abs(), b64.abs().transpose(1, 2)), d))
        for kind in ("softmax", "magnitudes"):
            s = torch.randn((n, 64, 64), generator=gen, device="cuda")
            pm = (torch.exp(s - s.amax(-1, keepdim=True)) if kind == "softmax"
                  else torch.exp2(-30 * torch.rand(s.shape, generator=gen,
                                                   device="cuda")))
            pm = pm.bfloat16().float()  # the kernel rounds P so
            v = draw("normal", d)
            p64, v64 = pm.double(), v.double()
            rows.append(_sum_reading("P V", d, kind, _probe(lib, 1, v, v, pm),
                                     torch.bmm(p64, v64),
                                     torch.bmm(p64, v64.abs()), 64))
    cases = _rounding_cases(lib)
    beyond = {(c["f"], c["sign"], c["same_product"]): round(c["ulps_beyond_1"])
              for c in cases}
    if all(u == (1 if f == 0.75 else 0) for (f, _, _), u in beyond.items()):
        model = "to nearest"
    elif all(u == 0 for u in beyond.values()):
        model = "toward zero"
    else:
        model = "neither"
    result = {"sums": rows, "rounding_cases": cases, "model": model,
              "assumed": TC_ROUNDING, "fp32_dot_rel": FP32_DOT_REL,
              "worst_share_of_bound": max(
                  r["max_err_over_sum_terms"] / (r["terms"] * TC_UNITS[
                      TC_ROUNDING]) for r in rows)}
    log(f"[accumulation] {json.dumps(result)} | {card_line}")
    if model != TC_ROUNDING or result["worst_share_of_bound"] > 1:
        raise AssertionError(f"the tensor cores' fp32 sums do not fit the "
                             f"model FP32_DOT_REL assumes ({TC_ROUNDING}): "
                             f"they read {model}, worst share of its bound "
                             f"{result['worst_share_of_bound']}")
    return result


# ---- phase 4: kernels against their plain versions ------------------


def _randn(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def forward_limits(q, k, v, causal: bool, scale: float,
                   block_k: int = FWD_TILE) -> dict:
    """How far the bf16 forward kernel's O and lse may lie from the mirror
    walked in blocks of ``block_k`` keys, as the kernel walks: per element
    of O, ``allowance`` (flips: for every P element with a bf16 rounding
    boundary within w of the mirror's fp32 value, one step of it times
    |v|, rescaled and divided by l as O is) and ``floor`` (the fp32 sums'
    error: FP32_DOT_REL for each key the row sees, at least a tile's, and
    FP32_OPS_REL for each tile's rescale, of sum |bf16(P)| |v| / l); per
    row ``lse_tol`` (three times the largest score difference, for the
    max and through P into l, the fp32 sum of l and a few roundings). w
    bounds the two sides' difference in P: the score's (FP32_DOT_REL over
    D products of |q| |k|, and the scale's rounding), the running max's
    (the largest score difference so far), and the subtraction's and
    exp's roundings."""
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    qf, kf, vf = (x.reshape(b * h, -1, d).float() for x in (q, k, v))
    qa, ka, va = qf.abs(), kf.abs(), vf.abs()
    last = torch.arange(t_q, device=q.device)[:, None] + (t_kv - t_q)
    m = torch.full((b * h, t_q, 1), -1e30, device=q.device)
    l, ds_max = torch.zeros_like(m), torch.zeros_like(m)
    allow, sums = torch.zeros_like(qf), torch.zeros_like(qf)
    gam = d * FP32_DOT_REL * scale
    for k0 in range(0, t_kv, block_k):
        blk = slice(k0, k0 + block_k)
        s = torch.bmm(qf, kf[:, blk].transpose(1, 2)) * scale
        ds = (gam * torch.bmm(qa, ka[:, blk].transpose(1, 2))
              + FP32_OPS_REL * s.abs())
        if causal:
            seen = torch.arange(k0, min(k0 + block_k, t_kv),
                                device=q.device)[None, :] <= last
            s = torch.where(seen, s, -1e30)
            ds = torch.where(seen, ds, 0.0)
        ds_max = torch.maximum(ds_max, ds.amax(-1, keepdim=True))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        c = torch.exp(m - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        w = p * (ds + ds_max + FP32_OPS_REL * (1 + (s - m_new).abs()))
        spread = (_bf16(p + w) - _bf16(p - w)).abs()
        allow = allow * c + torch.bmm(spread, va[:, blk])
        sums = sums * c + torch.bmm(_bf16(p), va[:, blk])
        m = m_new
        del s, ds, p, w, spread
    l = l.clamp_min(1e-30)
    keys = ((last + 1).clamp(max=t_kv) if causal
            else torch.full_like(last, t_kv)).float()
    tiles = torch.ceil(keys / block_k)
    floor = (FP32_DOT_REL * keys.clamp(min=block_k)
             + FP32_OPS_REL * (tiles + 1)) * sums / l
    lse = m + torch.log(l)
    lse_tol = (3 * ds_max + FP32_DOT_REL * keys
               + FP32_OPS_REL * (tiles + 2 + lse.abs()))
    return {"allowance": (allow / l).reshape(q.shape),
            "floor": floor.reshape(q.shape),
            "lse_tol": lse_tol.reshape(b, h, t_q, 1)}


def _without(o, p, v):
    """``o`` less the share ``p @ v`` of some keys (p: those keys' softmax
    weights), renormalised over the rest: what a kernel that skipped those
    keys would write; 0 in rows that see nothing else."""
    rest = 1 - p.sum(-1, keepdim=True)
    out = (o.float() - p @ v) / rest.clamp_min(1e-30)
    return torch.where(rest > 1e-6, out, 0.0)


def _fwd_readings(o, lse, mirror, plain, lse_plain, lim) -> dict:
    """The forward's output against the mirror (elementwise with the
    floor and the flip allowance, and without the allowance:
    ``elt_share_one_step``; in norm), against the plain version (in norm),
    and its lse against the plain lse (share of lse_tol)."""
    o, mirror = o.float(), mirror.float()
    one_step = FWD_ELT_REL * mirror.abs() + lim["floor"]
    return {**_agreement(o, mirror, FWD_ELT_REL, lim["floor"],
                         lim["allowance"]),
            "elt_share_one_step": ((o - mirror).abs() / one_step).max().item(),
            "flip_allowance_share": (lim["allowance"].mean()
                                     / one_step.mean()).item(),
            "plain_rel_norm": _agreement(o, plain)["rel_norm"],
            "plain_max_abs_err": (o - plain.float()).abs().max().item(),
            "lse_share": ((lse - lse_plain).abs()
                          / lim["lse_tol"]).max().item()}


def _fwd_within(r: dict) -> bool:
    return (r["rel_norm"] <= FWD_NORM_TOL and r["elt_share"] <= 1.0
            and r["plain_rel_norm"] <= ROUNDING_NORM_TOL
            and r["lse_share"] <= 1.0)


def flash_case(t: int, gen, h: int = 32, d: int = 128, b: int = 1,
               t_kv=None, causal: bool = True, plant: bool = False) -> dict:
    """The forward kernel on [b, h, t, d] queries against ``t_kv`` keys
    (``t`` if None) against its mirror and its plain version
    (_fwd_readings); with ``plant`` (causal self-attention), also the
    readings of the kernel's output with its first key tile's share
    taken out (a kernel that skips the tile)."""
    import torch.nn.functional as F

    from raytpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_attention_reference)

    t_kv = t_kv or t
    q = _randn((b, h, t, d), gen)
    k, v = (_randn((b, h, t_kv, d), gen) for _ in range(2))
    scale = d ** -0.5
    o_k, lse_k = flash_attention(q, k, v, causal=causal)
    o_m, _ = flash_attention_reference(q, k, v, causal, scale,
                                       round_operands=True, block_k=FWD_TILE)
    o_p, lse_p = flash_attention(q, k, v, causal=causal, force="reference")
    lim = forward_limits(q, k, v, causal, scale)
    torch.cuda.synchronize()
    row = {"case": f"flash B={b} H={h} T={t}"
                   f"{'' if t_kv == t else f' T_kv={t_kv}'} D={d} "
                   f"{'causal' if causal else 'full'}",
           **_fwd_readings(o_k, lse_k, o_m, o_p, lse_p, lim)}
    if plant:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                         k[:, :, :FWD_TILE].float()) * scale
        seen = (torch.arange(FWD_TILE, device="cuda")[None, :]
                <= torch.arange(t, device="cuda")[:, None])
        p = torch.where(seen, torch.exp(s - lse_k), 0.0)
        fault = _without(o_k, p, v[:, :, :FWD_TILE].float()).to(q.dtype)
        row["planted_first_key_tile_skipped"] = _fwd_readings(
            fault, lse_k, o_m, o_p, lse_p, lim)
    del lim, o_m, o_p
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + lse_k.numel() * 4
    flops = 4.0 * b * h * d * _visible_pairs(t, t_kv, causal)
    bound, by = bound_ms(nbytes, flops)
    # SDPA's is_causal is top-left aligned: a cross-length case passes
    # the bottom-aligned mask itself.
    mask = None
    if causal and t != t_kv:
        mask = torch.ones((t, t_kv), dtype=torch.bool,
                          device="cuda").tril(t_kv - t)
    def fwd():
        return flash_attention(q, k, v, causal=causal)

    ms = time_ms(fwd)
    with torch.no_grad():  # as the engine calls it
        host = host_us(fwd)
    row.update(
        ms=ms, device_ms=device_ms(fwd, "flash_forward"), host_us=host,
        plain_ms=time_ms(lambda: flash_attention(
            q, k, v, causal=causal, force="reference"), iters=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None)),
        bound_ms=bound, bound_by=by, tflops=flops / ms / 1e9,
        share_of_bound=bound / ms)
    return row


def paged_case(b: int, t: int, h: int, kv: int, gen, rng, q_start=None,
               d: int = 128, page_size: int = 16, n_pg: int = 128,
               plant: str = "") -> dict:
    """The paged kernel against its plain version (elementwise and in
    norm); page ids outside the pool must be clamped into it. ``plant``:
    also the readings of the kernel's output without one split's slots
    ("split", the second) or without the first 64 slots ("tile")."""
    from raytpu_torch.ops import _native
    from raytpu_torch.ops.paged_attention import (
        DECODE_ROWS, _heads_first, _visible, paged_attention, plan_splits)

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
    n_split, pages = (plan_splits(n_pg, page_size, b, kv,
                                  _native.sm_count(q.get_device()))
                      if t * h // kv <= DECODE_ROWS else (1, n_pg))

    def readings(o):
        a = _agreement(o, o_p)
        return {"max_abs_err": a["max_abs_err"],
                "plain_rel_norm": a["rel_norm"]}

    live = np.minimum(q_start + t, n_pg * page_size)  # slots each reads
    row = {"case": f"paged B={b} T={t} H={h} KV={kv} D={d} page={page_size} "
                   f"P={n_pg} context<={int(live.max())} splits={n_split}",
           **readings(o_k)}
    if plant:
        qf, ks, vs = _heads_first(q, k_pages, v_pages, bt)
        sc = torch.einsum("bhtd,bhld->bhtl", qf, ks) * d ** -0.5
        p = torch.softmax(torch.where(_visible(pos, ks.shape[2]), sc, -1e30),
                          dim=-1)
        if plant == "split":
            fault, drop = "second_split_dropped", slice(
                pages * page_size, 2 * pages * page_size)
        else:
            fault, drop = "first_key_tile_skipped", slice(0, FWD_TILE)
        o_f = _without(o_k.transpose(1, 2), p[..., drop], vs[:, :, drop])
        row[f"planted_{fault}"] = readings(o_f.transpose(1, 2).to(q.dtype))
        del qf, ks, vs, sc, p
    # (query, slot) pairs the rows see.
    seen = np.minimum(positions + 1, n_pg * page_size).sum()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * int(live.sum()) * kv * d * k_pages.element_size()
              + bt.numel() * 4 + pos.numel() * 4)
    flops = 4.0 * h * d * float(seen)
    bound, by = bound_ms(nbytes, flops)
    def paged():
        return paged_attention(q, k_pages, v_pages, bt, pos)

    ms = time_ms(paged)
    row.update(
        ms=ms, device_ms=device_ms(paged, "paged_"), host_us=host_us(paged),
        plain_ms=time_ms(lambda: paged_attention(
            q, k_pages, v_pages, bt, pos, force="reference")),
        library_ms=None, bound_ms=bound, bound_by=by,
        tflops=flops / ms / 1e9, share_of_bound=bound / ms)
    return row


def _paged_within(r: dict) -> bool:
    """Elementwise within KERNEL_TOL of the plain version and in norm
    within ROUNDING_NORM_TOL (one rounding of P; derivation above)."""
    return (r["max_abs_err"] <= KERNEL_TOL
            and r["plain_rel_norm"] <= ROUNDING_NORM_TOL)


def _agreement(got, want, elt_rel: float = GRAD_ELT_REL,
               elt_abs: float = GRAD_ELT_ABS, allowance=None) -> dict:
    """How far ``got`` lies from ``want``: the largest |got - want|, the
    norm ||got - want|| / ||want||, and the largest share of the
    elementwise limit elt_rel |want| + elt_abs (+ ``allowance``, per
    element)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = elt_rel * want.abs() + elt_abs
    if allowance is not None:
        limit = limit + allowance
    return {"max_abs_err": err.max().item(),
            "rel_norm": (err.norm() / want.norm()).item(),
            "elt_share": (err / limit).max().item()}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def flip_allowance(q, k, v, o, lse, g, causal: bool, scale: float,
                   chunk: int = 8) -> list:
    """Per element of (dQ, dK, dV), the most that flips can move it: the
    sum, over the terms of its product whose bf16 operand (P for dV, dS
    for dQ and dK) has a rounding boundary within the kernels' possible
    distance w from the mirror's fp32 value, of the operand's two
    candidate roundings' distance times |the other factor|. w bounds the
    fp32 differences (FP32_DOT_REL, FP32_OPS_REL): for P, the scores'
    sums and the roundings up to expf; for dS, those carried through
    P (dP - delta) scale and dP's own sum. Zero for almost every term;
    computed over ``chunk`` (b, h) slices at a time."""
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    flat = [x.reshape(b * h, x.shape[2], d).float() for x in (q, k, v, o, g)]
    lses = lse.reshape(b * h, t_q, 1).float()
    mask = torch.ones((t_q, t_kv), dtype=torch.bool,
                      device=q.device).tril(t_kv - t_q)
    gam = d * FP32_DOT_REL
    out = [torch.empty((b * h, t, d), device=q.device)
           for t in (t_q, t_kv, t_kv)]

    def spread(x, w):  # 0 unless a rounding boundary lies within w of x
        return (_bf16(x + w) - _bf16(x - w)).abs()

    for i in range(0, b * h, chunk):
        qf, kf, vf, of, gf = (x[i:i + chunk] for x in flat)
        ls = lses[i:i + chunk]
        s = torch.bmm(qf, kf.transpose(1, 2)) * scale
        p = torch.exp(s - ls)
        if causal:
            p = torch.where(mask, p, 0.0)
        w_p = p * (gam * scale * torch.bmm(qf.abs(), kf.abs().transpose(1, 2))
                   + FP32_OPS_REL * (1 + s.abs() + ls.abs()))
        dpd = torch.bmm(gf, vf.transpose(1, 2)) - (gf * of).sum(-1, True)
        ds = p * dpd * scale
        w_ds = (scale * (w_p * dpd.abs()
                         + p * gam * torch.bmm(gf.abs(), vf.abs().transpose(1, 2)))
                + FP32_OPS_REL * ds.abs())
        a_p, a_ds = spread(p, w_p), spread(ds, w_ds)
        del s, p, w_p, dpd, ds, w_ds
        out[0][i:i + chunk] = torch.bmm(a_ds, kf.abs())
        out[1][i:i + chunk] = torch.bmm(a_ds.transpose(1, 2), qf.abs())
        out[2][i:i + chunk] = torch.bmm(a_p.transpose(1, 2), gf.abs())
    return [x.reshape(b, h, -1, d) for x in out]


def _agrees(a: dict, norm_tol: float = GRAD_NORM_TOL) -> bool:
    return a["rel_norm"] <= norm_tol and a["elt_share"] <= 1.0


def _worst(readings) -> dict:
    return {key: max(r[key] for r in readings) for key in readings[0]}


def planted_faults(q, k, v, g, lse, delta, scale, got, mirror, plain,
                   allowance) -> dict:
    """Readings of two faults planted in the kernels' causal gradients
    (``got``, self-attention), which the limits must see: dQ without the
    first key tile's share, as from a dQ block that skips one tile of its
    loop, and dK, dV with the last key tile's rows zeroed, as from the
    dK/dV block with the smallest gradients never writing. Each against
    the mirror and, in norm, the unrounded plain backward."""
    tile = 64
    t = q.shape[2]
    kt, vt = k[:, :, :tile].float(), v[:, :, :tile].float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kt) * scale
    seen = (torch.arange(tile, device=q.device)[None, :]
            <= torch.arange(t, device=q.device)[:, None])
    p = torch.where(seen, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), vt)
    ds = p * (dp - delta[..., None]) * scale
    dq = got[0].float() - torch.einsum("bhqk,bhkd->bhqd", ds, kt)
    dk, dv = (x.clone() for x in got[1:])
    dk[:, :, -tile:] = 0
    dv[:, :, -tile:] = 0
    return {"dq_skips_first_key_tile": _readings(
                [dq], mirror[:1], plain[:1], allowance[:1]),
            "dkv_last_key_tile_unwritten": _readings(
                [dk, dv], mirror[1:], plain[1:], allowance[1:])}


def _readings(got, mirror, plain, allowance) -> dict:
    """The worst agreement of the gradients ``got`` with the mirror's
    (the elementwise share with the flip allowance, and without it:
    ``elt_share_one_step``, with the row along T of each tensor's worst
    element), and their worst norm distance from the unrounded plain
    ones."""
    one_step, rows = [], []
    for a, m in zip(got, mirror):
        share = (a.float() - m.float()).abs() / (
            GRAD_ELT_REL * m.float().abs() + GRAD_ELT_ABS)
        one_step.append(share.max().item())
        rows.append(int(share.flatten().argmax()) // share.shape[-1]
                    % share.shape[-2])
    return {**_worst([_agreement(a, m, allowance=w)
                      for a, m, w in zip(got, mirror, allowance)]),
            "elt_share_one_step": max(one_step),
            # The mean flip allowance over the mean one-step limit.
            "flip_allowance_share": max(
                (w.mean() / (GRAD_ELT_REL * m.float().abs()
                             + GRAD_ELT_ABS).mean()).item()
                for m, w in zip(mirror, allowance)),
            "worst_one_step_rows": rows,
            "plain_rel_norm": max(_agreement(a, b)["rel_norm"]
                                  for a, b in zip(got, plain))}


def _within_limits(r: dict) -> bool:
    """Within one step (plus the flip allowance) and GRAD_NORM_TOL of the
    mirror, and within ROUNDING_NORM_TOL of the unrounded plain backward
    in norm."""
    return _agrees(r) and r["plain_rel_norm"] <= ROUNDING_NORM_TOL


def _visible_pairs(t_q: int, t_kv: int, causal: bool) -> int:
    """(query, key) pairs under the bottom-aligned causal mask."""
    if not causal:
        return t_q * t_kv
    off = t_kv - t_q
    return sum(min(t_kv, i + off + 1) for i in range(t_q))


def flash_bwd_cases(b: int, h: int, t_q: int, t_kv: int, d: int,
                    causal: bool, gen, plant: bool = False) -> dict:
    """The dQ and the dK/dV kernels against the mirror backward and the
    unrounded plain backward on the same inputs (the forward kernel's o
    and lse, a random output gradient); the plain (the mirror's) and the
    SDPA times are of all three gradients. With ``plant``, also the
    readings of :func:`planted_faults`."""
    import torch.nn.functional as F

    from raytpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward_reference, flash_bwd_dkv,
        flash_bwd_dq)

    q, g = (_randn((b, h, t_q, d), gen) for _ in range(2))
    k, v = (_randn((b, h, t_kv, d), gen) for _ in range(2))
    scale = d ** -0.5
    o, lse = flash_attention(q, k, v, causal=causal)
    delta = torch.sum(g.float() * o.float(), dim=-1)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
    def mirror_bwd():
        return flash_attention_backward_reference(
            q, k, v, o, lse, g, causal, scale, round_operands=True)

    mirror = mirror_bwd()
    plain = flash_attention_backward_reference(q, k, v, o, lse, g, causal,
                                               scale)
    allowance = flip_allowance(q, k, v, o, lse, g, causal, scale)
    torch.cuda.synchronize()
    rows = {}
    if plant:
        rows["planted"] = planted_faults(q, k, v, g, lse, delta, scale,
                                         (dq, dk, dv), mirror, plain,
                                         allowance)
    plain_ms = time_ms(mirror_bwd, iters=5)
    # Yardstick: the backward of one SDPA call, fwd+bwd minus fwd. A
    # cross-length causal mask is bottom-aligned here and top-left in
    # SDPA's is_causal, so that case passes the mask itself.
    mask = None
    if causal and t_q != t_kv:
        mask = torch.ones((t_q, t_kv), dtype=torch.bool,
                          device="cuda").tril(t_kv - t_q)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            qr, kr, vr, attn_mask=mask, is_causal=causal and mask is None)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qr, kr, vr), g)

    with torch.no_grad():
        fwd_ms = time_ms(sdpa)
    library_ms = time_ms(sdpa_fwd_bwd) - fwd_ms
    pairs = b * h * _visible_pairs(t_q, t_kv, causal)
    es = q.element_size()
    q_bytes, kv_bytes = b * h * t_q * d * es, b * h * t_kv * d * es
    row_bytes = 2 * b * h * t_q * 4  # lse and delta, fp32
    shape = (f"B={b} H={h} T_q={t_q} T_kv={t_kv} D={d} "
             f"{'causal' if causal else 'full'}")
    for name, got, want, fn, nbytes, flops in (
            ("flash_bwd_dq", [dq], slice(0, 1),
             lambda: flash_bwd_dq(q, k, v, g, lse, delta, causal, scale),
             3 * q_bytes + 2 * kv_bytes + row_bytes, 6.0 * d * pairs),
            ("flash_bwd_dkv", [dk, dv], slice(1, 3),
             lambda: flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale),
             2 * q_bytes + 4 * kv_bytes + row_bytes, 8.0 * d * pairs)):
        bound, by = bound_ms(nbytes, flops)
        ms = time_ms(fn)
        rows[name] = {
            "case": f"{name} {shape}",
            **_readings(got, mirror[want], plain[want], allowance[want]),
            "ms": ms, "device_ms": device_ms(fn, name),
            "host_us": host_us(fn),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by,
            "tflops": flops / ms / 1e9, "share_of_bound": bound / ms,
        }
    return rows


def autograd_check(gen) -> dict:
    """Gradients through ``flash_attention`` under autograd (forward, dQ
    and dK/dV kernels) at the GPT-2 train shape, against the mirror
    backward fed the forward kernel's own o and lse, and against autograd
    through the plain versions. The forward kernel is held on its own
    (flash_case); its o differs from the plain version's by the rounding
    of P and by one-step differences, which reach delta = rowsum(dO o), so
    only the first comparison keeps one bf16 step a bound, and the second
    is held in norm only."""
    from raytpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward_reference)

    q, k, v, g = (_randn((TRAIN_BATCH, 12, 1024, 64), gen) for _ in range(4))
    grads = []
    for force in (None, "reference"):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        o, lse = flash_attention(*leaves, causal=True, force=force)
        grads.append(torch.autograd.grad(o, leaves, g))
        if force is None:
            mirror = flash_attention_backward_reference(
                q, k, v, o.detach(), lse, g, True, 64 ** -0.5,
                round_operands=True)
            allowance = flip_allowance(q, k, v, o.detach(), lse, g, True,
                                       64 ** -0.5)
    torch.cuda.synchronize()
    return {"case": "autograd dq, dk, dv B=8 H=12 T=1024 D=64 causal",
            **_readings(grads[0], mirror, grads[1], allowance)}


def rmsnorm_case(rows: int, d: int, dtype, gen, plant: bool = False,
                 grad: bool = False) -> dict:
    """The RMSNorm kernel against its plain version on ``[rows, d]``
    (eps 1e-5, Llama's), held elementwise to one step and in norm; with
    ``plant``, also the reading of a fault planted in the kernel's
    output (the squares summed over d - 8 columns); with ``grad``, the
    autograd Function's gradients against autograd of the plain version
    for a random output gradient. Times: the kernel (events, device and
    the wrapper's host time a call, under ``no_grad`` as in serving and
    with a scale that wants its gradient as in training), the plain
    version and ``F.rms_norm`` (events and device; the scale cast to x's
    dtype before the timing) on the same inputs."""
    import torch.nn.functional as F

    from raytpu_torch.ops.fused import rmsnorm, rmsnorm_reference

    eps = 1e-5
    x = _randn((rows, d), gen, dtype)
    scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    got = rmsnorm(x, scale, eps=eps)
    want = rmsnorm(x, scale, eps=eps, force="reference")
    torch.cuda.synchronize()
    row = {"case": f"rmsnorm N={rows} D={d} {str(dtype)[6:]}",
           **_agreement(got, want, NORM_ELT_REL, NORM_ELT_ABS)}
    if plant:
        xf = x.float()
        var = xf[:, :d - 8].square().sum(-1, keepdim=True) / d
        fault = (xf * torch.rsqrt(var + eps) * scale).to(dtype)
        row["planted_sum_skips_last_8_columns"] = _agreement(
            fault, want, NORM_ELT_REL, NORM_ELT_ABS)
    if grad:
        g = _randn((rows, d), gen, dtype)
        grads = []
        for fn in (lambda a, b: rmsnorm(a, b, eps=eps),
                   lambda a, b: rmsnorm_reference(a, b, eps)):
            leaves = [x.detach().requires_grad_(),
                      scale.detach().requires_grad_()]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
        torch.cuda.synchronize()
        row["grad"] = _worst([_agreement(a, b) for a, b in zip(*grads)])
    # x read once, out written once, the fp32 scale read once; about four
    # fp32 operations an element outside the tensor cores.
    bound, by = bound_ms(2 * x.numel() * x.element_size() + 4 * d,
                         4.0 * x.numel(), PEAK_FP32_FLOPS)
    def kernel():
        return rmsnorm(x, scale, eps=eps)

    leaf = scale.detach().requires_grad_()
    scale_x = scale.to(dtype)

    def library():
        return F.rms_norm(x, (d,), scale_x, eps)

    ms, dev = time_ms(kernel), device_ms(kernel, "rmsnorm")
    with torch.no_grad():
        host = host_us(kernel)
    row.update(
        ms=ms, device_ms=dev, host_us=host,
        host_us_grad=host_us(lambda: rmsnorm(x, leaf, eps=eps)),
        plain_ms=time_ms(lambda: rmsnorm(x, scale, eps=eps,
                                         force="reference")),
        library_ms=time_ms(library), library_device_ms=device_ms(library, ""),
        bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
        device_share_of_bound=bound / dev)
    return row


def phase_kernels(card_line: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    bwd = [flash_bwd_cases(TRAIN_BATCH, 12, 1024, 1024, 64, True, gen,
                           plant=True),
           flash_bwd_cases(TRAIN_BATCH, 12, 1024, 1024, 64, False, gen),
           flash_bwd_cases(4, 12, 1024, 1024, 128, True, gen),
           flash_bwd_cases(2, 4, 256, 1024, 64, True, gen)]
    cases = {
        "flash_forward": [flash_case(t, gen) for t in (128, 512, 1024)]
        + [flash_case(1024, gen, h=12, d=64, b=TRAIN_BATCH)],  # GPT-2 train
        "flash_bwd_dq": [c["flash_bwd_dq"] for c in bwd],
        "flash_bwd_dkv": [c["flash_bwd_dkv"] for c in bwd],
        "paged_attention": [
            paged_case(8, 1, 32, 32, gen, rng, plant="split"),  # decode
            paged_case(1, 512, 32, 32, gen, rng, q_start=1024,  # chunk
                       plant="tile"),
            paged_case(8, 1, 32, 8, gen, rng),                  # GQA decode
            paged_case(1, 512, 32, 8, gen, rng, q_start=512),   # GQA chunk
        ],
    }
    # Decode whose table gives one split, and one long context over many;
    # then the instances no main path runs: the forward without the mask
    # and across lengths, the decode path's 16-row blocks, D = 32 and 64,
    # a page of 8.
    gen_p = torch.Generator(device="cuda").manual_seed(2)
    rng_p = np.random.default_rng(2)
    cases["paged_attention"] += [
        paged_case(8, 1, 32, 32, gen_p, rng_p, n_pg=16),
        paged_case(1, 1, 32, 32, gen_p, rng_p, q_start=2000),
        paged_case(4, 2, 16, 4, gen_p, rng_p, d=64, n_pg=32),
        paged_case(2, 16, 8, 8, gen_p, rng_p, d=32, n_pg=32),
        paged_case(3, 1, 8, 4, gen_p, rng_p, d=32, page_size=8, n_pg=64),
        paged_case(1, 96, 8, 2, gen_p, rng_p, d=64, n_pg=32, q_start=200)]
    cases["flash_forward"] += [
        flash_case(256, gen_p, h=4, d=64, b=2, causal=False),
        flash_case(128, gen_p, h=4, d=32, b=2, t_kv=384)]
    # The cases PRs 2-3 ran keep their inputs: the Llama train shapes and
    # RMSNorm draw from a generator of their own, and lead their lists.
    gen_l = torch.Generator(device="cuda").manual_seed(1)
    lt, bf16 = LLAMA_TRAIN_BATCH, torch.bfloat16
    llama = flash_bwd_cases(lt, 32, 4096, 4096, 128, True, gen_l)
    cases["flash_forward"].insert(0, flash_case(4096, gen_l, b=lt,
                                                plant=True))
    cases["flash_bwd_dq"].insert(0, llama["flash_bwd_dq"])
    cases["flash_bwd_dkv"].insert(0, llama["flash_bwd_dkv"])
    cases["rmsnorm"] = [
        rmsnorm_case(lt * 4096, 4096, bf16, gen_l, plant=True, grad=True),
        rmsnorm_case(512, 4096, bf16, gen_l),              # serve chunk
        rmsnorm_case(8, 4096, bf16, gen_l),                # serve decode
        rmsnorm_case(lt * 4096, 4096, torch.float32, gen_l),
        rmsnorm_case(64, 4100, bf16, gen_l),               # D % 8 != 0
    ]
    # GPT-2 serving (D = 64, one query head a KV head: decode over ragged
    # contexts up to 1024, a 256-token chunk, a prefill bucket) and
    # Mixtral training (one sequence of 4096 tokens), on inputs of their
    # own.
    gen_s = torch.Generator(device="cuda").manual_seed(3)
    rng_s = np.random.default_rng(3)
    cases["paged_attention"] += [
        paged_case(8, 1, 12, 12, gen_s, rng_s, d=64, n_pg=64),
        paged_case(1, GPT2_SERVE_CHUNK, 12, 12, gen_s, rng_s, d=64,
                   n_pg=64, q_start=512)]
    cases["flash_forward"] += [
        flash_case(GPT2_SERVE_CHUNK, gen_s, h=12, d=64),
        flash_case(4096, gen_s, b=MIXTRAL_TRAIN_BATCH)]
    mixtral = flash_bwd_cases(MIXTRAL_TRAIN_BATCH, 32, 4096, 4096, 128, True,
                              gen_s)
    cases["flash_bwd_dq"].append(mixtral["flash_bwd_dq"])
    cases["flash_bwd_dkv"].append(mixtral["flash_bwd_dkv"])
    cases["rmsnorm"].append(rmsnorm_case(MIXTRAL_TRAIN_BATCH * 4096, 4096,
                                         bf16, gen_s))
    for name, rows in cases.items():
        for row in rows:
            log(f"[kernels] {name}: {json.dumps(row)} | {card_line}")
            if name == "rmsnorm":
                if not _agrees(row, NORM_NORM_TOL):
                    raise AssertionError(
                        f"rmsnorm {row['case']}: kernel differs from its "
                        f"plain version beyond one step elementwise or "
                        f"{NORM_NORM_TOL} in norm: {row}")
                if "grad" in row and not _agrees(row["grad"]):
                    raise AssertionError(
                        f"rmsnorm {row['case']}: the Function's gradients "
                        f"differ from autograd of the plain version: {row}")
            elif "rel_norm" in row:  # gradients
                if not _within_limits(row):
                    raise AssertionError(
                        f"{name} {row['case']}: kernel differs from the "
                        f"mirror backward beyond {GRAD_NORM_TOL} in norm or "
                        f"one bf16 step elementwise, or from the plain "
                        f"backward beyond {ROUNDING_NORM_TOL} in norm: "
                        f"{row}")
            elif name == "flash_forward":
                if not _fwd_within(row):
                    raise AssertionError(
                        f"flash_forward {row['case']}: kernel differs from "
                        f"the mirror beyond one bf16 step (plus the floor "
                        f"and the flip allowance) or {FWD_NORM_TOL} in norm, "
                        f"from the plain version beyond {ROUNDING_NORM_TOL} "
                        f"in norm, or in lse: {row}")
            elif not _paged_within(row):
                raise AssertionError(
                    f"{name} {row['case']}: kernel differs from its plain "
                    f"version beyond {KERNEL_TOL} or {ROUNDING_NORM_TOL} in "
                    f"norm: {row}")
    planted = bwd[0]["planted"]
    log(f"[kernels] planted faults (backward): {json.dumps(planted)} | "
        f"{card_line}")
    seen = {fault: not _agrees(r)
            and r["plain_rel_norm"] > ROUNDING_NORM_TOL
            for fault, r in planted.items()}
    norm_fault = cases["rmsnorm"][0]["planted_sum_skips_last_8_columns"]
    seen["rmsnorm_sum_skips_last_8_columns"] = not _agrees(norm_fault,
                                                           NORM_NORM_TOL)
    fwd_fault = cases["flash_forward"][0]["planted_first_key_tile_skipped"]
    seen["flash_forward_first_key_tile_skipped"] = not _fwd_within(fwd_fault)
    for row in cases["paged_attention"]:
        for fault in ("second_split_dropped", "first_key_tile_skipped"):
            if f"planted_{fault}" in row:
                seen[f"paged_{fault}"] = not _paged_within(
                    row[f"planted_{fault}"])
    log(f"[kernels] planted faults seen: {json.dumps(seen)} | {card_line}")
    if not all(seen.values()):
        raise AssertionError(f"the limits miss a planted fault: {seen}")
    auto = autograd_check(gen)
    log(f"[kernels] autograd: {json.dumps(auto)} | {card_line}")
    if not _within_limits(auto):
        raise AssertionError(f"autograd through the kernels differs from "
                             f"the mirror or the plain path: {auto}")
    return cases


# ---- phases 5 and 7: serve -------------------------------------------


def serve_prompts(rng, vocab: int):
    """Eight prompts of 64..1500 tokens; p1 and p4 share a 512-token
    prefix, p0, p1, p4, p5 and p7 are longer than the 512-token chunk."""
    prefix = rng.integers(0, vocab, 512).tolist()

    def fresh(n):
        return rng.integers(0, vocab, n).tolist()

    return {"p0": fresh(1500), "p1": prefix + fresh(180), "p2": fresh(64),
            "p3": fresh(300), "p4": prefix + fresh(90), "p5": fresh(900),
            "p6": fresh(200), "p7": fresh(1200)}


def gpt2_serve_prompts(rng, vocab: int):
    """Eight prompts of 48..900 tokens; g1 and g4 share a 256-token
    prefix, g0, g1, g3, g4, g5 and g7 are longer than the 256-token
    chunk."""
    prefix = rng.integers(0, vocab, GPT2_SERVE_CHUNK).tolist()

    def fresh(n):
        return rng.integers(0, vocab, n).tolist()

    return {"g0": fresh(900), "g1": prefix + fresh(120), "g2": fresh(48),
            "g3": fresh(300), "g4": prefix + fresh(60), "g5": fresh(600),
            "g6": fresh(150), "g7": fresh(700)}


def kernel_counters() -> dict:
    """Every kernel's launch counter, by its name in the kernels line."""
    from raytpu_torch.ops.flash_attention import (BWD_DKV_LAUNCHES,
                                                  BWD_DQ_LAUNCHES, LAUNCHES)
    from raytpu_torch.ops.fused import LAUNCHES as NORM
    from raytpu_torch.ops.paged_attention import LAUNCHES as PAGED

    return {"flash_forward": LAUNCHES, "flash_bwd_dq": BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": BWD_DKV_LAUNCHES, "paged_attention": PAGED,
            "rmsnorm": NORM}


def check_launches(launches: dict, want: dict) -> None:
    """Fail unless every kernel launched as ``want`` says: that many
    times, or at least once where it says None."""
    bad = {name: n for name, n in launches.items()
           if not (n > 0 if want[name] is None else n == want[name])}
    if bad:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"(None: at least one)")


def drive_engine(model, prompts: dict, arrivals: dict,
                 norms_per_forward: int, aborts=None, after=None,
                 **engine_kw) -> dict:
    """Serve ``prompts`` (request id -> tokens, each arriving before the
    step ``arrivals`` names) through a new InferenceEngine, greedy,
    SERVE_NEW_TOKENS each, with every kernel's launch counter set to 0
    just before and read just after; the ids ``aborts`` names for a step
    are aborted before it. Fails unless every request not aborted got
    its tokens, the prefix cache hit, the chunk path ran, the flash
    forward and the paged kernel launched, RMSNorm ``norms_per_forward``
    times a model forward and the backward kernels never. ``after(eng)``,
    if given, reads the engine once the traffic is done; its result is
    the result's ``"after"``."""
    aborts = aborts or {}
    from raytpu_torch.inference import InferenceEngine, SamplingParams

    sampling = SamplingParams(max_new_tokens=SERVE_NEW_TOKENS)
    # An engine's page pools outlive it until the cycle collector runs
    # (its KV cache and prefix cache name each other): free the earlier
    # phases' before the peak is read.
    gc.collect()
    torch.cuda.empty_cache()
    eng = InferenceEngine(model, page_size=16, max_num_seqs=8, **engine_kw)
    # The prefix counters are process-wide: this run's are a difference.
    hits0 = eng.stats()["prefix_cache"]["hit_tokens"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for counter in counters.values():
        counter.reset()
    tokens = {rid: [] for rid in prompts}
    steps = 0
    t0 = time.perf_counter()
    while steps == 0 or eng.has_unfinished() or steps <= max(arrivals):
        for rid in aborts.get(steps, []):
            if not eng.abort(rid):
                raise AssertionError(f"{rid} was not in the engine at step "
                                     f"{steps}")
        for rid in arrivals.get(steps, []):
            eng.add_request(rid, prompts[rid], sampling)
        for o in eng.step():
            tokens[o.request_id].append(o.token_id)
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.count for name, c in counters.items()}
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
        "prefix_hit_tokens": pc["hit_tokens"] - hits0,
        "prefill_calls": stats["prefill_calls"],
        "chunk_prefill_calls": stats["chunk_prefill_calls"],
        "decode_calls": stats["decode_calls"],
        # Every model forward: a prefill, a chunk or a decode.
        "forwards": sum(sum(stats[k].values()) for k in (
            "prefill_calls", "chunk_prefill_calls", "decode_calls")),
    }
    aborted = {rid for ids in aborts.values() for rid in ids}
    short = {rid: len(t) for rid, t in tokens.items()
             if len(t) != SERVE_NEW_TOKENS and rid not in aborted}
    if short:
        raise AssertionError(f"requests without {SERVE_NEW_TOKENS} "
                             f"tokens: {short}")
    check_launches(launches, {
        "flash_forward": None, "paged_attention": None,
        "rmsnorm": norms_per_forward * result["forwards"],
        "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    if result["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared prefix never hit the prefix cache")
    if not stats["chunk_prefill_calls"]:
        raise AssertionError("the chunked-prefill path never ran")
    result["tokens"] = tokens
    if after is not None:
        result["after"] = after(eng)
    del eng
    torch.cuda.empty_cache()
    return result


def without_tokens(result: dict) -> dict:
    return {k: v for k, v in result.items() if k != "tokens"}


def phase_serve(model, card_line: str) -> dict:
    prompts = serve_prompts(np.random.default_rng(1), model.config.vocab_size)
    # p4 arrives after p1's first chunk has registered the shared prefix.
    arrivals = {0: ["p0", "p1", "p2", "p3"], 2: ["p4", "p5"], 4: ["p6", "p7"]}
    # Every model forward (prefill, chunk or decode) runs 2 L + 1 norms.
    result = drive_engine(model, prompts, arrivals,
                          2 * model.config.n_layer + 1,
                          max_model_len=2048, prefill_chunk=512)
    log(f"[serve] {json.dumps(without_tokens(result))} | {card_line}")
    return result


def phase_gpt2_serve(model, card_line: str) -> dict:
    """GPT-2 124M behind the engine: the flash forward (prefills) and the
    paged kernel (chunks and decode, D = 64) must launch; GPT-2's
    LayerNorm has no kernel, so RMSNorm must not."""
    prompts = gpt2_serve_prompts(np.random.default_rng(1),
                                 model.config.vocab_size)
    # g4 arrives after g1's first chunk has registered the shared prefix.
    arrivals = {0: ["g0", "g1", "g2", "g3"], 2: ["g4", "g5"], 4: ["g6", "g7"]}
    result = drive_engine(model, prompts, arrivals, 0,
                          max_model_len=model.config.block_size,
                          prefill_chunk=GPT2_SERVE_CHUNK)
    log(f"[gpt2-serve] {json.dumps(without_tokens(result))} | {card_line}")
    return result


def device_kernels(prof) -> list:
    """(name, device microseconds, launches) of every kernel in a profile;
    user annotations (such as the optimizer's step range) are left out,
    since their device time is that of the kernels inside them."""
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total
            and not e.is_user_annotation]


# Kernel classes of a train step's profile, by substrings of kernel names
# (cuBLAS's Hopper GEMMs are "nvjet_*"; torch's foreach AdamW runs
# "multi_tensor_apply_kernel"s); everything else is elementwise, norm,
# reduction, embedding and copy work.
KERNEL_CLASSES = (("flash_attention", ("flash_",)),
                  ("rmsnorm", ("rmsnorm_kernel", "rmsnorm_ring_kernel")),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma", "splitK")),
                  ("optimizer", ("multi_tensor_apply",)))


def kernel_classes_ms(kernels) -> dict:
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out["other"] = 0.0
    for key, us, _ in kernels:
        cls = next((name for name, subs in KERNEL_CLASSES
                    if any(x in key for x in subs)), "other")
        out[cls] += us / 1e3
    return out


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
    kernels = device_kernels(prof)
    norm_bwd = [e for e in prof.key_averages()
                if e.key.endswith("_RMSNormBackward")]
    busy_us = sum(t for _, t, _ in kernels)
    # The paged kernels: decode's split and combine, the chunk path.
    attn_us = sum(t for k, t, _ in kernels if "paged_" in k)
    top = sorted(kernels, key=lambda kt: -kt[1])[:8]
    result = {
        "batch": 8, "context": "1024+", "decode_step_ms": step_ms,
        "profiled_step_ms": window_us / n / 1e3,
        "device_busy_share": busy_us / window_us if busy_us else
        "not measured",
        "paged_attention_ms_per_step": attn_us / n / 1e3,
        "top_kernels": [{"kernel": k[:90], "ms_per_step": t / n / 1e3,
                         "share_of_busy": t / busy_us} for k, t, _ in top],
    }
    log(f"[profile] {json.dumps(result)} | {card_line}")
    del eng
    torch.cuda.empty_cache()
    return result


# ---- phases 6 and 8: end to end against the plain path --------------


def phase_e2e(model, card_line: str, prefill=None, tag: str = "e2e"
              ) -> dict:
    """The model's ``prefill`` (Llama's by default) and the engine with the
    kernels against the plain versions."""
    from raytpu_torch.inference import InferenceEngine, SamplingParams
    from raytpu_torch.models.llama import llama_prefill

    prefill = prefill or llama_prefill
    cfg = model.config
    # Same weights, plain attention (and RMSNorm, where the model has it)
    # chosen through the config fields.
    plain = copy.copy(model)
    plain.config = dataclasses.replace(cfg, **{
        f: "reference" for f in ("attn_impl", "paged_attn", "norm_impl")
        if hasattr(cfg, f)})
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 256))).cuda()
    with torch.no_grad():
        lk = prefill(model, tokens)[0]
        lp = prefill(plain, tokens)[0]
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
    log(f"[{tag}] {json.dumps(result)} | {card_line}")
    if not rel <= E2E_TOL:
        raise AssertionError(f"prefill logits: kernel path differs from the "
                             f"plain path by {rel} of scale > {E2E_TOL}")
    return result


# ---- phases 19 and 20: LLMDeployment and the KV handoff ---------------

# Phase 5's engine, behind the replica body.
DEPLOYMENT_ENGINE = {"page_size": 16, "max_num_seqs": 8,
                     "max_model_len": 2048, "prefill_chunk": 512}
CLOSED_AFTER = 4  # tokens the closed stream takes before it closes
ABORT_AFTER = 2   # tokens the aborted stream takes before the abort
# New tokens asked of the closed and the aborted streams: far more than
# they take before their end, so neither can finish first.
OPEN_ENDED = 1024
# Every wait of the two phases (a stream's end, the idle snapshot) fails
# past this: the eight streams end in seconds (phase 5: 1.9 s of wall).
STREAM_DEADLINE_S = 300.0
HANDOFF_PROMPT = 1500  # 93 full pages of 16 shipped, a 12-token tail
SHORT_PROMPT = 10      # under a page: never pulls


@contextlib.contextmanager
def serving(*deps):
    """Run with ``deps``' stepping loops watched: yields the list that
    ``threading.excepthook`` fills with the exception of any thread that
    dies of one; on the way out fails on such a death (with the
    exception itself) or on a loop thread found dead, and shuts every
    deployment down, failing unless its loop thread joins."""
    died = []
    hook = threading.excepthook

    def record(args):
        died.append(args.exc_value)
        hook(args)

    threading.excepthook = record
    try:
        yield died
        check_loops(deps, died)
    finally:
        threading.excepthook = hook
        for dep in deps:
            dep.shutdown()
    alive = [dep for dep in deps if dep._step_thread.is_alive()]
    if alive:
        raise AssertionError(f"{len(alive)} stepping loops did not join "
                             f"at shutdown()")


def check_loops(deps, died) -> None:
    if died:
        raise died[0]
    if not all(dep._step_thread.is_alive() for dep in deps):
        raise AssertionError("a stepping loop died before shutdown()")


def join_streams(threads, deps, died) -> None:
    """Wait for the client threads, failing as soon as a stepping loop
    or a client dies, or past the deadline."""
    end = time.perf_counter() + STREAM_DEADLINE_S
    for t in threads:
        while t.is_alive():
            check_loops(deps, died)
            if time.perf_counter() > end:
                raise AssertionError(f"a stream did not end within "
                                     f"{STREAM_DEADLINE_S} s")
            t.join(timeout=0.05)
    check_loops(deps, died)


def wait_idle(dep) -> dict:
    """The deployment's idle snapshot: nothing running or waiting, no page
    held. Fails unless every usable page is free or parked in the prefix
    cache (a leaked pin would hold one)."""
    end = time.perf_counter() + STREAM_DEADLINE_S
    while True:
        p = dep.engine_pressure()
        if (p["running_requests"], p["waiting_requests"],
                p["kv_utilization"]) == (0.0, 0.0, 0.0):
            break
        if time.perf_counter() > end:
            raise AssertionError(f"never idle: {p}")
        time.sleep(0.01)
    eng = dep._engine
    with dep._cv:
        free, parked = len(eng.cache._free), eng.prefix_cache.reclaimable()
        held = eng.cache.num_sequences()
    if held or free + parked != eng.cache.total_pages:
        raise AssertionError(f"pages leaked: {held} sequences hold pages, "
                             f"{free} free + {parked} parked of "
                             f"{eng.cache.total_pages}")
    return {**p, "free_pages": free, "parked_pages": parked}


def time_steps(dep) -> list:
    """Make the deployment's engine sum the seconds of its steps (the loop
    holds the engine lock through each); returns the one-element sum."""
    held = [0.0]
    step = dep._engine.step

    def timed_step():
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            held[0] += time.perf_counter() - t0

    dep._engine.step = timed_step
    return held


def probe_lock(dep, stop: threading.Event, waits: list) -> threading.Thread:
    """A thread that takes the engine lock as a request thread does, every
    5 ms until ``stop``, and keeps how long each acquire waited."""
    def run():
        while not stop.is_set():
            t0 = time.perf_counter()
            with dep._cv:
                waits.append(time.perf_counter() - t0)
            stop.wait(0.005)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def quantiles_ms(xs) -> dict:
    xs = np.asarray(xs) * 1e3
    return {"p50_ms": float(np.percentile(xs, 50)),
            "p95_ms": float(np.percentile(xs, 95)),
            "max_ms": float(xs.max()), "n": int(xs.size)}


def token_agreement(got: dict, want: dict) -> dict:
    """Share of positions equal between two runs' tokens, and each
    request's first divergence."""
    same = sum(a == b for rid in want for a, b in zip(got[rid], want[rid]))
    total = sum(len(t) for t in want.values())
    first = {rid: next((i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                        if a != b), None) for rid in want}
    return {"share": same / total, "compared": total,
            "first_divergence": {r: i for r, i in first.items()
                                 if i is not None}}


def deployment_launches(launches: dict, forwards: int, n_layer: int
                        ) -> None:
    """The serving path's launches: the flash forward and the paged kernel
    at least once, RMSNorm 2 L + 1 times a forward (65 for Llama-2-7B),
    the backward kernels never."""
    check_launches(launches, {"flash_forward": None, "paged_attention": None,
                              "rmsnorm": (2 * n_layer + 1) * forwards,
                              "flash_bwd_dq": 0, "flash_bwd_dkv": 0})


def forwards_of(stats: dict) -> int:
    return sum(sum(stats[k].values()) for k in (
        "prefill_calls", "chunk_prefill_calls", "decode_calls"))


def drive_deployment(dep, died, prompts: dict, extra: dict) -> dict:
    """Phase 5's traffic through ``dep``: each prompt of ``prompts`` on its
    own client thread with SERVE_NEW_TOKENS greedy tokens, arriving by
    events (p0-p3 at once, p4 and p5 at p1's first token, p6 and p7 at
    p4's), and the ``extra`` streams (``closed``: closed after
    CLOSED_AFTER tokens; ``aborted``: aborted from outside after
    ABORT_AFTER) with p4 and p5; with every kernel counter set to 0 just
    before and read just after, the seconds the loop held the engine lock
    and the waits of a request thread for it."""
    from raytpu_torch.inference import serving as serving_mod

    tokens = {rid: [] for rid in [*prompts, *extra]}
    started, first_at = {}, {}
    got = {rid: threading.Event() for rid in tokens}
    held = time_steps(dep)
    waits, stop = [], threading.Event()

    def consume(rid, prompt, n):
        if rid == "aborted":  # the id dep.abort names
            serving_mod._request_context.set({"request_id": rid})
        gen = dep.generate(prompt, max_new_tokens=n)
        started[rid] = time.perf_counter()
        for tok in gen:
            tokens[rid].append(tok)
            if len(tokens[rid]) == 1:
                first_at[rid] = time.perf_counter()
            if len(tokens[rid]) == {"closed": CLOSED_AFTER,
                                    "aborted": ABORT_AFTER}.get(rid, 1):
                got[rid].set()
            if rid == "closed" and len(tokens[rid]) == CLOSED_AFTER:
                break
        gen.close()  # the closed stream's abort; a no-op on the rest

    def arrive(*rids):
        out = []
        for rid in rids:
            prompt = prompts.get(rid) or extra[rid]
            n = SERVE_NEW_TOKENS if rid in prompts else OPEN_ENDED
            t = threading.Thread(target=consume, args=(rid, prompt, n),
                                 daemon=True)
            t.start()
            out.append(t)
        return out

    def wait_for(rid):
        while not got[rid].wait(0.05):
            check_loops([dep], died)

    counters = kernel_counters()
    for counter in counters.values():
        counter.reset()
    prober = probe_lock(dep, stop, waits)
    t0 = time.perf_counter()
    threads = arrive("p0", "p1", "p2", "p3")
    wait_for("p1")
    threads += arrive("p4", "p5", *extra)
    wait_for("p4")
    threads += arrive("p6", "p7")
    aborted = None
    if "aborted" in extra:
        wait_for("aborted")
        aborted = dep.abort("aborted")
    join_streams(threads, [dep], died)
    wall = time.perf_counter() - t0
    stop.set()
    prober.join(timeout=5)
    launches = {name: c.count for name, c in counters.items()}
    ttft = [first_at[r] - started[r] for r in prompts]
    stats = dep.stats()
    return {"tokens": tokens, "aborted": aborted, "wall_s": wall,
            "launches": launches, "forwards": forwards_of(stats),
            "client_ttft_p50_s": float(np.percentile(ttft, 50)),
            "client_ttft_p95_s": float(np.percentile(ttft, 95)),
            "engine_ttft_p50_s": stats["ttft_p50_s"],
            "engine_ttft_p95_s": stats["ttft_p95_s"],
            "decode_tokens": stats["decode_tokens"],
            "decode_tokens_per_s": stats["decode_tokens"]
            / stats["decode_seconds"],
            "loop_lock_held_share": held[0] / wall,
            "request_lock_wait": quantiles_ms(waits)}


def phase_deployment(card_line: str, serve: dict) -> dict:
    """Llama-2-7B behind ``LLMDeployment`` (full width and depth, phase
    5's engine), driven by ``drive_deployment`` with a closed and an
    aborted stream: every stream's tokens, the closed and aborted ones
    ended, the launches, an idle snapshot with no page held, the loop's
    thread joined at shutdown; TTFT at the client and in the engine, the
    decode rate beside phase 5's, the loop's lock held and a request
    thread's waits for it, token agreement with phase 5. Then the same
    eight streams through a deployment with the JAX package's lock (a
    plain ``Condition()``), to show what the handed-over lock changes."""
    from raytpu_torch.inference import LLMDeployment, serving as serving_mod
    from raytpu_torch.models.llama import LlamaConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b()
    prompts = serve_prompts(np.random.default_rng(1), cfg.vocab_size)
    rng = np.random.default_rng(5)
    extra = {"closed": rng.integers(0, cfg.vocab_size, 100).tolist(),
             "aborted": rng.integers(0, cfg.vocab_size, 64).tolist()}
    dep = LLMDeployment(model="llama", model_config=cfg,
                        engine_options=DEPLOYMENT_ENGINE, seed=0)
    with serving(dep) as died:
        run = drive_deployment(dep, died, prompts, extra)
        idle = wait_idle(dep)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del dep
    gc.collect()
    torch.cuda.empty_cache()
    handoff_lock = serving_mod._HandoffLock
    serving_mod._HandoffLock = threading.RLock  # the JAX package's lock
    try:
        plain = LLMDeployment(model="llama", model_config=cfg,
                              engine_options=DEPLOYMENT_ENGINE, seed=0)
    finally:
        serving_mod._HandoffLock = handoff_lock
    with serving(plain) as died:
        jax_lock = drive_deployment(plain, died, prompts, {})
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    tokens = run.pop("tokens")
    result = {
        "model": "Llama-2-7B, 32 layers, bf16, random weights (seed 0)",
        "engine": DEPLOYMENT_ENGINE, **run,
        "phase5": {k: serve[k] for k in ("wall_s", "ttft_p50_s",
                                         "ttft_p95_s",
                                         "decode_tokens_per_s")},
        "closed_tokens": len(tokens["closed"]),
        "aborted_tokens": len(tokens["aborted"]), "idle": idle,
        "max_memory_allocated_gb": peak,
        "phase5_token_agreement": token_agreement(
            {r: tokens[r] for r in prompts}, serve["tokens"]),
        "jax_lock": {k: v for k, v in jax_lock.items()
                     if k not in ("tokens", "aborted")},
        "jax_lock_token_agreement": token_agreement(
            {r: jax_lock["tokens"][r] for r in prompts}, serve["tokens"]),
    }
    log(f"[deployment] {json.dumps(result)} | {card_line}")
    short = {r: len(t[r]) for t in (tokens, jax_lock["tokens"])
             for r in prompts if len(t[r]) != SERVE_NEW_TOKENS}
    if short:
        raise AssertionError(f"streams without {SERVE_NEW_TOKENS} tokens: "
                             f"{short}")
    if len(tokens["closed"]) != CLOSED_AFTER:
        raise AssertionError(f"the closed stream took "
                             f"{len(tokens['closed'])} tokens")
    if not (run["aborted"]
            and ABORT_AFTER <= len(tokens["aborted"]) < OPEN_ENDED):
        raise AssertionError(f"the abort did not end its stream: returned "
                             f"{run['aborted']}, {len(tokens['aborted'])} "
                             f"tokens")
    deployment_launches(run["launches"], run["forwards"], cfg.n_layer)
    return result


class TimedPeer:
    """A prefill replica as a decode replica's peer: times each
    ``kv_export_*`` call and counts the chunk reads; with ``fail_half``
    set, ``kv_export_read`` raises once half the stream has been read (a
    peer lost mid-stream)."""

    def __init__(self, dep):
        self.dep, self.fail_half = dep, False
        self.begin_s = self.read_s = self.end_s = 0.0
        self.begins = self.reads = 0
        self.total = 0

    def kv_export_begin(self, prompt, max_pages=None):
        t0 = time.perf_counter()
        meta = self.dep.kv_export_begin(prompt, max_pages)
        self.begin_s += time.perf_counter() - t0
        self.begins += 1
        self.total = meta["total_bytes"] if meta else 0
        return meta

    def kv_export_read(self, handoff_id, offset, length):
        if self.fail_half and offset >= self.total // 2:
            raise ConnectionError("planted: the peer is lost mid-stream")
        t0 = time.perf_counter()
        data = self.dep.kv_export_read(handoff_id, offset, length)
        self.read_s += time.perf_counter() - t0
        self.reads += 1
        return data

    def kv_export_end(self, handoff_id):
        t0 = time.perf_counter()
        ok = self.dep.kv_export_end(handoff_id)
        self.end_s += time.perf_counter() - t0
        return ok


def ask(dep, prompt, n: int = SERVE_NEW_TOKENS):
    """One greedy request from this thread: (TTFT from the generate call
    to the first token, the tokens)."""
    t0 = time.perf_counter()
    out, ttft = [], None
    for tok in dep.generate(prompt, max_new_tokens=n):
        if ttft is None:
            ttft = time.perf_counter() - t0
        out.append(tok)
    return ttft, out


def pinned_copy_gbps(pages: torch.Tensor, repeats: int = 5) -> dict:
    """The yardstick of the handoff: the same bytes, gathered on the card,
    in one device-to-host copy into pinned memory (best of ``repeats``)."""
    host = torch.empty(pages.shape, dtype=pages.dtype, pin_memory=True)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host.copy_(pages, non_blocking=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    nbytes = pages.numel() * pages.element_size()
    if not torch.equal(host.to(pages.device), pages):
        raise AssertionError("the pinned copy differs from the pages")
    return {"bytes": nbytes, "best_s": min(times), "times_s": times,
            "gb_per_s": nbytes / min(times) / 1e9}


def grafted_pages_equal(prefill, decode, prompt, n_pages: int) -> dict:
    """The decode replica's grafted pages against the prefill replica's,
    every layer, K and V, to the bit."""
    pages = []
    for dep in (prefill, decode):
        with dep._cv:
            pages.append(dep._engine.prefix_cache.match(
                prompt, max_pages=n_pages))
    if not all(len(p) == n_pages for p in pages):
        raise AssertionError(f"pages cached: {[len(p) for p in pages]} of "
                             f"{n_pages}")
    a, b = prefill._engine.cache, decode._engine.cache
    src, dst = (torch.tensor(p, device=a.device) for p in pages)
    unequal = [(li, kind) for li in range(a.num_layers)
               for kind, pa, pb in (("k", a.k, b.k), ("v", a.v, b.v))
               if not torch.equal(pa[li][src], pb[li][dst])]
    if unequal:
        raise AssertionError(f"grafted pages differ from the source's in "
                             f"(layer, K/V) {unequal[:8]}")
    return {"pages": n_pages, "layers": a.num_layers, "equal": True}


def phase_disagg(card_line: str) -> dict:
    """A prefill replica and a decode replica of Llama-2-7B (full width
    and depth, both from seed 0) on the one card: a 1500-token prompt
    served colocated on the prefill replica, then through the decode
    replica, which pulls its 93 full pages and prefills only the 12-token
    tail; the grafted pages equal to the source's; the prefill replica
    asked again gives the decode replica's tokens to the token; a prompt
    under a page never pulls; a pull whose peer is lost halfway falls
    back to a local prefill and leaves nothing pinned. Readings: the
    handoff's bytes, seconds and GB/s against one pinned copy of the same
    bytes, page reads a second, TTFT against the colocated one, peak
    memory."""
    from raytpu_torch.inference import LLMDeployment, disagg
    from raytpu_torch.models.llama import LlamaConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b()
    prefill = LLMDeployment(model="llama", model_config=cfg,
                            engine_options=DEPLOYMENT_ENGINE, seed=0,
                            role="prefill")
    peer = TimedPeer(prefill)
    decode = LLMDeployment(model="llama", model_config=cfg,
                           engine_options=DEPLOYMENT_ENGINE, seed=0,
                           role="decode", prefill=peer)
    rng = np.random.default_rng(4)
    prompt, fresh = (rng.integers(0, cfg.vocab_size,
                                  HANDOFF_PROMPT).tolist() for _ in range(2))
    short = rng.integers(0, cfg.vocab_size, SHORT_PROMPT).tolist()
    ps = DEPLOYMENT_ENGINE["page_size"]
    n_pages = (HANDOFF_PROMPT - 1) // ps
    with serving(prefill, decode) as died:
        same = [torch.equal(a, b) for a, b in zip(
            prefill._engine.model.state_dict().values(),
            decode._engine.model.state_dict().values())]
        if not all(same):
            raise AssertionError(f"the replicas' weights differ: "
                                 f"{same.count(False)} of {len(same)} tensors")
        counters = kernel_counters()
        for counter in counters.values():
            counter.reset()
        colo_ttft, colo = ask(prefill, prompt)
        pulled = []
        pull = decode._maybe_pull_prefix

        def timed_pull(p, **tags):
            t0 = time.perf_counter()
            n = pull(p, **tags)
            pulled.append((n, time.perf_counter() - t0))
            return n

        decode._maybe_pull_prefix = timed_pull
        before = disagg.stats()
        dec_prefill0 = decode.stats()["prefill_tokens"]
        ho_ttft, handed = ask(decode, prompt)
        after = disagg.stats()
        tail = decode.stats()["prefill_tokens"] - dec_prefill0
        check_loops([prefill, decode], died)
        graft = grafted_pages_equal(prefill, decode, prompt, n_pages)
        again_ttft, again = ask(prefill, prompt)
        # The same bytes in one pinned copy: the prefill replica's pages.
        with prefill._cv:
            cache = prefill._engine.cache
            src = torch.tensor(prefill._engine.prefix_cache.match(
                prompt, max_pages=n_pages), device=cache.device)
            gathered = torch.stack([torch.stack([cache.k[li][src],
                                                 cache.v[li][src]])
                                    for li in range(cache.num_layers)])
        yardstick = pinned_copy_gbps(gathered)
        del gathered
        reads = (peer.reads, peer.read_s, peer.begin_s, peer.end_s)
        # A prompt under a page: no pull, nothing exported.
        begins, pre_tokens = peer.begins, prefill.stats()["prefill_tokens"]
        _, short_out = ask(decode, short, 8)
        short_pulled = (disagg.stats() != after or peer.begins != begins
                        or prefill.stats()["prefill_tokens"] != pre_tokens)
        # A pull from a peer lost halfway: a fresh prompt prefilled
        # locally instead; the source's own prefill of it (in
        # kv_export_begin) samples the token the fallback must give first.
        sampled = []
        generate = prefill.generate

        def recording(*a, **kw):
            for tok in generate(*a, **kw):
                sampled.append(tok)
                yield tok

        prefill.generate = recording
        peer.fail_half = True
        dec_prefill1 = decode.stats()["prefill_tokens"]
        fault_before = disagg.stats()
        fb_ttft, fallback = ask(decode, fresh)
        fault_after = disagg.stats()
        del prefill.generate
        peer.fail_half = False
        open_exports = prefill._handoff_source.open_exports()
        idle = {"prefill": wait_idle(prefill), "decode": wait_idle(decode)}
        launches = {name: c.count for name, c in counters.items()}
        forwards = sum(forwards_of(d.stats()) for d in (prefill, decode))
        local = decode.stats()["prefill_tokens"] - dec_prefill1
    nbytes = after["bytes"] - before["bytes"]
    page_bytes = ps * cfg.n_kv_head * cfg.head_dim * cfg.dtype.itemsize
    pull_tokens, pull_s = pulled[0]
    result = {
        "model": "Llama-2-7B x 2 replicas, 32 layers, bf16, seed 0",
        "prompt": HANDOFF_PROMPT, "pages": after["pages"] - before["pages"],
        "tokens_grafted": pull_tokens, "tail_prefilled": tail,
        "handoff_bytes": nbytes, "pull_s": pull_s,
        "pull_gb_per_s": nbytes / pull_s / 1e9,
        "export_begin_s": reads[2], "export_end_s": reads[3],
        "chunk_reads": reads[0], "chunk_read_s": reads[1],
        "page_reads": nbytes // page_bytes,
        "page_reads_per_s": nbytes // page_bytes / reads[1],
        "read_gb_per_s": nbytes / reads[1] / 1e9,
        "pinned_copy": yardstick,
        "ttft_handoff_s": ho_ttft, "ttft_colocated_s": colo_ttft,
        "ttft_prefill_replica_again_s": again_ttft,
        "handoff_tokens_equal_prefill_again": handed == again,
        "colocated_token_agreement": token_agreement(
            {"a": handed}, {"a": colo}),
        "grafted": graft, "short_prompt_pulled": short_pulled,
        "short_tokens": len(short_out),
        "fallback": {"tokens": len(fallback), "ttft_s": fb_ttft,
                     "first_token": fallback[:1], "source_sampled": sampled,
                     "local_prefill_tokens": local,
                     "fallbacks": fault_after["fallbacks"]
                     - fault_before["fallbacks"],
                     "aborts": fault_after["aborts"]
                     - fault_before["aborts"],
                     "open_exports": open_exports},
        "idle": idle, "launches": launches, "forwards": forwards,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"[disagg] {json.dumps(result)} | {card_line}")
    if not (result["pages"] == n_pages and pull_tokens == n_pages * ps
            and nbytes == cfg.n_layer * 2 * n_pages * page_bytes
            and tail == HANDOFF_PROMPT - n_pages * ps):
        raise AssertionError("the handoff did not graft the prompt's full "
                             "pages and prefill only its tail")
    if handed != again or len(handed) != SERVE_NEW_TOKENS:
        raise AssertionError("the decode replica's tokens differ from the "
                             "prefill replica's for the same prompt")
    if short_pulled or len(short_out) != 8:
        raise AssertionError("the short prompt went to the peer")
    fb = result["fallback"]
    if not (len(fallback) == SERVE_NEW_TOKENS and sampled
            and fallback[0] == sampled[0] and fb["fallbacks"] == 1
            and fb["aborts"] == 1 and open_exports == 0
            and local == HANDOFF_PROMPT):
        raise AssertionError(f"the lost peer's pull did not fall back to a "
                             f"clean local prefill: {fb}")
    deployment_launches(launches, forwards, cfg.n_layer)
    del prefill, decode, peer
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---- phase 21: observability -----------------------------------------

# Rounds of the overhead reading. Each round serves the traffic in one
# adjacent pair a flag arm: off then on in even rounds, on then off in
# odd ones (off, on, on, off, ...), so each arm is read against an off run
# beside it, first as often as second.
OBS_ROUNDS = 10
OBS_ARMS = {"off": (False, False, False), "all": (True, True, True),
            "events": (True, False, False), "spans": (False, True, False),
            "profiler": (False, False, True)}
# For context only: the JAX package's own figure for request events on
# against off, 0.89 % median against a 3 % budget, came from a CPU run of
# a tiny Llama (BENCH_r20.json), not from a card.
JAX_CPU_EVENTS_OVERHEAD_PCT = 0.89
# The MFU gauge against FLOPs / step time / peak recomputed here: the
# same float64 operations, so only the last bits may differ.
MFU_REL = 1e-12
HOOK_CALLS = 2000
# Rounds of the step-paired reading: one decode step an arm a round.
STEP_PAIR_ROUNDS = 40
HBM_EVERY = 32  # the engine observes device memory every 32nd decode step
# Every request's events, in the JAX package's order: the first token is
# sampled inside the call that ends the prefill, so FIRST_TOKEN comes
# before PREFILL_END (tests/test_torch_request_events.py holds the port
# to the JAX engine's events on the CPU).
SERVED = ["ADMITTED", "PREFILL_START", "FIRST_TOKEN", "PREFILL_END",
          "FINISHED"]
ABORTED_RUNNING = SERVED[:-1] + ["ABORTED"]


def set_observability(events: bool, spans: bool, profile: bool) -> None:
    """Request events, tracing and profiling on or off, the event ring
    and span buffer empty."""
    from raytpu_torch.util import profiler, task_events, tracing

    for on, enable, disable in (
            (events, task_events.enable_request_events,
             task_events.disable_request_events),
            (spans, tracing.enable_tracing, tracing.disable_tracing),
            (profile, profiler.enable_profiling,
             profiler.disable_profiling)):
        (enable if on else disable)()
    task_events.clear()
    tracing.clear_spans()


def observability_series() -> dict:
    """The process-wide series the engine moves."""
    from raytpu_torch.inference import engine, prefix_cache
    from raytpu_torch.util.stepprof import step_profiler

    return {"prefill_tokens": engine._prefill_tokens_total.value,
            "decode_tokens": engine._decode_tokens_total.value,
            "lookups": prefix_cache._lookups_total.value,
            "hits": prefix_cache._hits_total.value,
            "hit_tokens": prefix_cache._hit_tokens_total.value,
            "ttft": len(engine._ttft_hist.observations),
            "steps": len(step_profiler("infer")._step.observations)}


def engine_gauges() -> dict:
    from raytpu_torch.inference import engine
    from raytpu_torch.util.metrics import Gauge

    return {g._name: g.value for g in vars(engine).values()
            if isinstance(g, Gauge)}


def read_engine(eng) -> dict:
    """What phase 21 reads of an engine once its traffic is done: its
    stats, the gauges beside the scheduler's and the cache's own
    numbers, the gauges after ``note_idle``, and its decode buckets."""
    gauges, stats = engine_gauges(), eng.stats()
    scheduler = {"running": len(eng.scheduler.running),
                 "waiting": len(eng.scheduler.waiting),
                 "kv_utilization": eng.cache.utilization()}
    eng.note_idle()
    return {"stats": stats, "gauges": gauges, "scheduler": scheduler,
            "idle": engine_gauges(), "decode_buckets": eng.decode_buckets,
            "page_size": eng.page_size, "decode_flops": eng.decode_flops}


def llama_decode_flops(cfg, bucket: int, pages: int, page_size: int
                       ) -> float:
    """The padded decode step's FLOPs from Llama's config alone: 2 × the
    weights of every product (q, k, v, o, gate, up, down, LM head) a
    row, plus QKᵀ and PV over every slot of the table."""
    d, hd = cfg.n_embd, cfg.head_dim
    matmul = cfg.n_layer * (2 * d * cfg.n_head * hd
                            + 2 * d * cfg.n_kv_head * hd
                            + 3 * d * cfg.n_inter) + cfg.vocab_size * d
    return (2.0 * matmul * bucket
            + 4.0 * cfg.n_layer * cfg.n_head * hd * bucket * pages
            * page_size)


def check_observed_run(on: dict, before: dict, after: dict, prompts: dict,
                       events: list, spans: list, hbm_seen: list,
                       cfg) -> dict:
    """Checks (a)-(d) of phase 21 on the run with everything on."""
    from raytpu_torch.util import stepprof, task_events
    from raytpu_torch.util.stepprof import step_profiler

    read = on["after"]
    stats = read["stats"]
    # (a) every request's transitions, in the JAX order; nothing dropped.
    by_id = {}
    for ev in events:
        by_id.setdefault(ev["id"], []).append(ev)
    walks = {rid: [e["transition"] for e in evs]
             for rid, evs in by_id.items()}
    want = {rid: ABORTED_RUNNING if rid == "x0" else SERVED
            for rid in prompts}
    if walks != want:
        raise AssertionError(f"request events {walks}, expected {want}")
    if task_events.dropped_count():
        raise AssertionError(f"{task_events.dropped_count()} events dropped")
    # (b) counter deltas against the engine's and the cache's own counts.
    moved = {k: after[k] - before[k] for k in before}
    starts = [e["data"] for e in events
              if e["transition"] == "PREFILL_START"]
    expect = {"prefill_tokens": stats["prefill_tokens"],
              "decode_tokens": stats["decode_tokens"],
              # One lookup an admission, a hit where the admission
              # grafted pages (the tokens PREFILL_START reports cached).
              "lookups": sum(w.count("ADMITTED") for w in walks.values()),
              "hits": sum(1 for s in starts if s["cached"] > 0),
              "hit_tokens": sum(s["cached"] for s in starts),
              "ttft": sum(1 for t in on["tokens"].values() if t),
              "steps": len(stats["decode_batch_hist"])}
    if moved != expect or moved["hit_tokens"] != on["prefix_hit_tokens"]:
        raise AssertionError(f"series moved {moved}, expected {expect}")
    gauges, sched = read["gauges"], read["scheduler"]
    pairs = {"raytpu_infer_running_requests": sched["running"],
             "raytpu_infer_waiting_requests": sched["waiting"],
             "raytpu_infer_kv_page_utilization": sched["kv_utilization"]}
    if any(gauges[k] != v for k, v in pairs.items()) or any(
            read["idle"][k] != 0.0 for k in (
                "raytpu_infer_prefill_tokens_per_s",
                "raytpu_infer_decode_tokens_per_s")):
        raise AssertionError(f"gauges {gauges} (idle {read['idle']}), "
                             f"scheduler and cache {sched}")
    # (c) one span a forward, by kind and bucket.
    by_span, by_call = {}, {}
    for s in spans:
        key = (s["name"], s["attributes"]["bucket"])
        by_span[key] = by_span.get(key, 0) + 1
    for name, kind in (("infer.prefill", "prefill_calls"),
                       ("infer.prefill_chunk", "chunk_prefill_calls"),
                       ("infer.decode", "decode_calls")):
        for bucket, n in stats[kind].items():
            key = (name, int(bucket.split("x")[0]))
            by_call[key] = by_call.get(key, 0) + n
    if by_span != by_call:
        raise AssertionError(f"spans {by_span}, engine calls {by_call}")
    # (d) the step profiler: MFU of the last step, the peak by name, the
    # device-memory gauges at each observation.
    prof = step_profiler("infer")
    name = torch.cuda.get_device_name(0)
    table_peak = stepprof.peak_for_name(name)
    if table_peak is None:
        raise AssertionError(f"no peak FLOP/s for {name!r} in "
                             f"stepprof.PEAK_BY_NAME")
    peak = prof.peak_flops()
    override = os.environ.get(stepprof.ENV_PEAK_FLOPS, "")
    if not override and peak != table_peak:
        raise AssertionError(f"the step profiler's peak {peak} is not the "
                             f"table's {table_peak} for {name!r}")
    last_b = stats["decode_batch_hist"][-1]
    bucket = min(b for b in read["decode_buckets"] if b >= last_b)
    dt, mfu = prof._step.observations[-1], prof._mfu.value
    keys = [k for k in prof._flops if k[1] == bucket and abs(
        min(1.0, prof._flops[k] / dt / peak) - mfu) <= MFU_REL * mfu]
    for key, flops in prof._flops.items():
        if not flops == read["decode_flops"](*key[1:]) == \
                llama_decode_flops(cfg, key[1], key[2], read["page_size"]):
            raise AssertionError(f"decode FLOPs at {key}: {flops}")
    if len(keys) != 1 or not 0.0 < mfu <= 1.0:
        raise AssertionError(f"MFU gauge {mfu} matches {keys} of "
                             f"{sorted(prof._flops)} (step {dt} s)")
    n_steps = len(stats["decode_batch_hist"])
    if len(hbm_seen) != (n_steps - 1) // HBM_EVERY + 1 or any(
            used != alloc or high != max_alloc
            for used, high, alloc, max_alloc in hbm_seen):
        raise AssertionError(f"device-memory gauges against the "
                             f"allocator at each observation: {hbm_seen}")
    return {"decode_steps": n_steps, "moved": moved,
            "mfu_last_step": mfu, "mfu_key": list(keys[0]),
            "last_step_s": dt, "flops_last_step": prof._flops[keys[0]],
            "peak_flops": peak, "peak_flops_by_name": table_peak,
            "peak_env_override": override,
            "hbm_observations": [
                {"used_gb": u / 1e9, "peak_gb": h / 1e9}
                for u, h, _, _ in hbm_seen],
            "spans": {f"{k[0]}:{k[1]}": v for k, v in by_span.items()},
            "events": len(events)}


def profile_two_decode_steps(model) -> dict:
    """(f): two decode steps of eight 128-token sequences inside
    ``tracing.profile``; the chrome trace it writes must name the paged
    kernel and the RMSNorm kernel among its CUDA kernels."""
    from raytpu_torch.inference import InferenceEngine, SamplingParams
    from raytpu_torch.util import tracing

    rng = np.random.default_rng(22)
    eng = InferenceEngine(model, page_size=16, max_num_seqs=8,
                          max_model_len=2048, prefill_chunk=512)
    for i in range(8):
        eng.add_request(f"f{i}", rng.integers(
            0, model.config.vocab_size, 128).tolist(),
            SamplingParams(max_new_tokens=8))
    eng.step()  # the eight prefills
    with tempfile.TemporaryDirectory() as logdir:
        with tracing.profile(logdir) as prof:
            eng.step()
            eng.step()
            torch.cuda.synchronize()
        with open(prof.trace_path) as f:
            trace = json.load(f)
        size = os.path.getsize(prof.trace_path)
    kernels = sorted({ev["name"] for ev in trace["traceEvents"]
                      if ev.get("cat") == "kernel"})
    found = {"paged": [k for k in kernels if "paged_" in k],
             "rmsnorm": [k for k in kernels if "rmsnorm" in k]}
    hist = eng.stats()["decode_batch_hist"]
    del eng
    torch.cuda.empty_cache()
    if hist != [8, 8] or not all(found.values()):
        raise AssertionError(f"profiled decode steps {hist}: paged and "
                             f"RMSNorm kernels in the trace {found} of "
                             f"{kernels}")
    return {"trace_bytes": size, "kernels": len(kernels),
            "paged_kernels": found["paged"],
            "rmsnorm_kernels": found["rmsnorm"]}


def hook_costs(device, events_per_decode_step: float) -> dict:
    """(g): the host's µs a call of each hook a decode step runs with its
    flag on (a span around the forward; the step profiler's cached FLOPs
    and its observation; the device-memory read every 32nd step; one
    request event), timed back to back over HOOK_CALLS calls, and the
    three flag checks a step pays with everything off."""
    from raytpu_torch.util import task_events, tracing
    from raytpu_torch.util.profiler import profiling_enabled
    from raytpu_torch.util.stepprof import step_profiler

    prof = step_profiler("infer")
    key = next(iter(prof._flops))

    def per_call(fn, calls: int = HOOK_CALLS) -> float:
        fn()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        return (time.perf_counter_ns() - t0) / calls / 1e3

    def span():
        with tracing.span("infer.decode", {"batch": 8, "bucket": 8}):
            pass

    def profiler():
        if profiling_enabled():
            flops = prof.ensure_flops(key, lambda: 0.0)
            prof.observe_step(0.0241, flops=flops)

    def event():
        if task_events.request_events_enabled():
            task_events.emit_request("hook-cost", "FIRST_TOKEN")

    def flags_off():
        if task_events.request_events_enabled():
            pass
        with tracing.span("infer.decode", {"batch": 8, "bucket": 8}):
            pass
        if profiling_enabled():
            pass

    def while_busy(fn) -> float:
        """``per_call`` over 200 calls while the card runs a queue of
        products (about half a second of them, checked still running at
        the end)."""
        a = torch.randn(8192, 8192, device=device, dtype=torch.bfloat16)
        b = torch.empty_like(a)
        for _ in range(400):
            torch.matmul(a, a, out=b)
        queued = torch.cuda.Event()
        queued.record()
        us = per_call(fn, 200)
        busy = not queued.query()
        torch.cuda.synchronize()
        return us if busy else float("nan")

    set_observability(True, True, True)
    try:
        out = {"span_us": per_call(span), "profiler_us": per_call(profiler),
               "hbm_read_us": per_call(lambda: prof.observe_hbm(device),
                                       200),
               "event_us": per_call(event),
               # A root span's parts that reach the system: two random
               # ids and the thread's native id; and the span again while
               # the card is busy (nan: the card went idle first).
               "urandom_us": per_call(lambda: os.urandom(16)),
               "native_id_us": per_call(threading.get_native_id),
               "span_us_card_busy": while_busy(span),
               "urandom_us_card_busy": while_busy(lambda: os.urandom(16))}
    finally:
        set_observability(False, False, False)
    out["flags_off_us"] = per_call(flags_off)
    out["events_per_decode_step"] = events_per_decode_step
    out["decode_step_hooks_us"] = (
        out["span_us"] + out["profiler_us"] + out["hbm_read_us"] / HBM_EVERY
        + events_per_decode_step * out["event_us"])
    return out


def spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs))}


def in_turns(rounds: int):
    """(arm, the two arms of its pair in the order they run) for each
    round and flag arm: (off, arm) in even rounds, (arm, off) in odd."""
    for r in range(rounds):
        for arm in list(OBS_ARMS)[1:]:
            yield arm, (("off", arm) if r % 2 == 0 else (arm, "off"))


def decode_step_pairs(model) -> dict:
    """(g): one engine's decode steps at batch 8 and 1024+ tokens (the
    profile phase's workload), each arm's flags set before its step, one
    step an arm a round for STEP_PAIR_ROUNDS rounds in turns. A step's
    host time ends with the logits' host copy, so it holds the device's
    work; each arm is read against its round's step with everything
    off."""
    from raytpu_torch.inference import InferenceEngine, SamplingParams

    rng = np.random.default_rng(3)
    eng = InferenceEngine(model, page_size=16, max_num_seqs=8,
                          max_model_len=2048, prefill_chunk=512)
    steps = STEP_PAIR_ROUNDS * (len(OBS_ARMS) - 1) * 2
    for i in range(8):
        eng.add_request(f"d{i}", rng.integers(
            0, model.config.vocab_size, 1024).tolist(),
            SamplingParams(max_new_tokens=steps + 16))
    while eng.stats()["decode_batch_hist"][-3:] != [8, 8, 8]:
        eng.step()  # both prefill chunks, then warm decode steps
    warm = len(eng.stats()["decode_batch_hist"])
    pairs = {arm: [] for arm in list(OBS_ARMS)[1:]}
    try:
        for arm, turn in in_turns(STEP_PAIR_ROUNDS):
            ms = {}
            for side in turn:
                set_observability(*OBS_ARMS[side])
                t0 = time.perf_counter()
                eng.step()
                ms[side] = (time.perf_counter() - t0) * 1e3
            pairs[arm].append((ms["off"], ms[arm]))
    finally:
        set_observability(False, False, False)
    timed = eng.stats()["decode_batch_hist"][warm:]
    del eng
    torch.cuda.empty_cache()
    if timed != [8] * steps:
        raise AssertionError(f"the paired steps were not all decode steps "
                             f"of eight: {timed}")
    return {"rounds": STEP_PAIR_ROUNDS,
            "off_step_ms": spread([o for ps in pairs.values()
                                   for o, _ in ps]),
            "delta_us": {arm: spread([(a - o) * 1e3 for o, a in ps])
                         for arm, ps in pairs.items()},
            "delta_pct": {arm: spread([(a / o - 1.0) * 100.0
                                       for o, a in ps])
                          for arm, ps in pairs.items()}}


def phase_observability(model, card_line: str) -> dict:
    """Llama-2-7B (full width and depth, phase 5's engine and prompts,
    plus a 64-token request aborted while it decodes) driven through
    ``drive_engine`` with request events, tracing and profiling on: (a)
    every request's events in the JAX order, none dropped; (b) the
    counters against the engine's and the prefix cache's own counts, the
    gauges against the scheduler and the cache, ``note_idle`` zeroing
    the rates; (c) one span a forward by kind and bucket; (d) one step
    time a decode step, the MFU gauge equal to the analytic FLOPs over
    the step time over the card's peak (by name), the device-memory
    gauges equal to the allocator's at each observation; (e) the same
    traffic with everything off: the same tokens to the bit, the same
    launches; (f) two decode steps inside ``tracing.profile``, whose
    trace names the paged and RMSNorm kernels; (g) a reading: the
    per-token cost of each arm against an adjacent off run over
    OBS_ROUNDS rounds in turns, the collector's share of each run, decode
    steps of eight paired the same way in one engine, and the hooks' host
    µs a decode step."""
    from raytpu_torch.util import task_events, tracing
    from raytpu_torch.util.stepprof import step_profiler

    t_phase = time.perf_counter()
    cfg = model.config
    prompts = serve_prompts(np.random.default_rng(1), cfg.vocab_size)
    prompts["x0"] = np.random.default_rng(21).integers(
        0, cfg.vocab_size, 64).tolist()
    # x0 decodes from step 1 and is aborted before step 3, before p6 and
    # p7 arrive, so the batch never holds more than eight.
    arrivals = {0: ["p0", "p1", "p2", "p3", "x0"], 2: ["p4", "p5"],
                4: ["p6", "p7"]}
    aborts = {3: ["x0"]}

    def serve(arm: str, after=None):
        """The traffic with ``arm``'s flags on: (result, events, spans).
        The result's ``gc`` is what the cyclic collector took of the run:
        its passes (the full collection ``drive_engine`` makes before the
        traffic left out) and their seconds."""
        pauses = []

        def collector(phase, info):
            if phase == "start":
                pauses.append([info["generation"], time.perf_counter()])
            else:
                pauses[-1][1] = time.perf_counter() - pauses[-1][1]

        set_observability(*OBS_ARMS[arm])
        gc.callbacks.append(collector)
        try:
            res = drive_engine(model, prompts, arrivals,
                               2 * cfg.n_layer + 1, aborts=aborts,
                               after=after, max_model_len=2048,
                               prefill_chunk=512)
            events, spans = task_events.get_events(), tracing.get_spans()
        finally:
            gc.callbacks.remove(collector)
            set_observability(False, False, False)
        del pauses[next(i for i, (g, _) in enumerate(pauses) if g == 2)]
        res["gc"] = {"passes": len(pauses),
                     "full": sum(g == 2 for g, _ in pauses),
                     "s": sum(t for _, t in pauses)}
        return res, events, spans

    # (a)-(d): everything on, the device-memory observations watched.
    prof = step_profiler("infer")
    hbm_seen = []
    observe_hbm = prof.observe_hbm

    def watched_hbm(device):
        observe_hbm(device)
        tag = (f"{torch.cuda.get_device_name(device)}:{device.index}",)
        hbm_seen.append((prof._hbm_used.values[tag],
                         prof._hbm_peak.values[tag],
                         torch.cuda.memory_allocated(device),
                         torch.cuda.max_memory_allocated(device)))

    before = observability_series()
    prof.observe_hbm = watched_hbm
    try:
        on, events, spans = serve("all", after=read_engine)
    finally:
        del prof.observe_hbm
    after = observability_series()
    checked = check_observed_run(on, before, after, prompts, events, spans,
                                 hbm_seen, cfg)
    # (e): everything off.
    off = serve("off")[0]
    if off["tokens"] != on["tokens"] or off["launches"] != on["launches"]:
        raise AssertionError(
            f"observability changed the run: tokens equal "
            f"{off['tokens'] == on['tokens']}, launches {on['launches']} "
            f"on against {off['launches']} off")
    # (f)
    profiled = profile_two_decode_steps(model)
    # (g)
    pairs = {arm: [] for arm in list(OBS_ARMS)[1:]}
    for arm, turn in in_turns(OBS_ROUNDS):
        rows = {}
        for side in turn:
            res = serve(side)[0]
            if res["tokens"] != off["tokens"] or \
                    res["launches"] != off["launches"]:
                raise AssertionError(f"{side} (paired with {arm}): tokens "
                                     f"or launches differ from the off run")
            n_tokens = sum(len(t) for t in res["tokens"].values())
            rows[side] = {
                "s_per_token": res["wall_s"] / n_tokens,
                "decode_step_ms": res["decode_tokens"]
                / res["decode_tokens_per_s"] / res["decode_steps"] * 1e3,
                "gc_s": res["gc"]["s"], "gc_full": res["gc"]["full"]}
        pairs[arm].append((rows["off"], rows[arm]))
    overhead = {arm: spread([(a["s_per_token"] / o["s_per_token"] - 1.0)
                             * 100.0 for o, a in ps])
                for arm, ps in pairs.items()}
    step_us = {arm: spread([(a["decode_step_ms"] - o["decode_step_ms"])
                            * 1e3 for o, a in ps])
               for arm, ps in pairs.items()}
    runs = {"off": [o for ps in pairs.values() for o, _ in ps],
            **{arm: [a for _, a in ps] for arm, ps in pairs.items()}}
    step_pairs = decode_step_pairs(model)
    hooks = hook_costs(torch.device("cuda", torch.cuda.current_device()),
                       checked["events"] / checked["decode_steps"])
    result = {
        "model": "Llama-2-7B, 32 layers, bf16, random weights (seed 0)",
        "traffic": "phase 5's eight prompts and arrivals, plus x0 (64 "
                   "tokens) aborted while decoding",
        **checked,
        "tokens_equal_on_off": True, "launches": on["launches"],
        "wall_s_on": on["wall_s"], "wall_s_off": off["wall_s"],
        "profile": profiled,
        "rounds": OBS_ROUNDS,
        "per_token_overhead_pct": overhead,
        "s_per_token_pairs": {arm: [[o["s_per_token"], a["s_per_token"]]
                                    for o, a in ps]
                              for arm, ps in pairs.items()},
        "decode_step_host_delta_us": step_us,
        "decode_step_ms_off": spread([o["decode_step_ms"]
                                      for o in runs["off"]]),
        # The collector's share of each arm's runs: retained spans and
        # events are objects that survive, which drives passes.
        "gc_s_per_run": {arm: spread([r["gc_s"] for r in rows])
                         for arm, rows in runs.items()},
        "gc_full_per_run": {arm: spread([r["gc_full"] for r in rows])
                            for arm, rows in runs.items()},
        "s_per_token_off": spread([o["s_per_token"] for o in runs["off"]]),
        "decode_step_pairs": step_pairs,
        "hooks": hooks,
        "decode_step_ms_perf_md": 24.1,
        "jax_cpu_events_overhead_pct": JAX_CPU_EVENTS_OVERHEAD_PCT,
        "jax_cpu_events_overhead_source": "BENCH_r20.json: a CPU run of a "
                                          "tiny Llama, not a card figure",
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"[observability] {json.dumps(result)} | {card_line}")
    log(f"[observability] MFU {checked['mfu_last_step']:.4f} of the last "
        f"decode step against {checked['peak_flops']:.4g} FLOP/s "
        f"({torch.cuda.get_device_name(0)}); per-token overhead, median "
        f"(min, max) over {OBS_ROUNDS} paired rounds: " + "; ".join(
            f"{arm} {v['median']:+.2f} % ({v['min']:+.2f}, "
            f"{v['max']:+.2f})" for arm, v in overhead.items())
        + f"; hooks {hooks['decode_step_hooks_us']:.1f} µs a decode step; "
        f"decode steps of eight, paired over {STEP_PAIR_ROUNDS} rounds, "
        f"median µs: " + ", ".join(
            f"{arm} {v['median']:+.0f}" for arm, v in
            step_pairs["delta_us"].items())
        + f" against {step_pairs['off_step_ms']['median']:.2f} ms off "
        f"| {card_line}")
    return result


# ---- phase 9: train -------------------------------------------------


def timed_steps(step, tokens) -> dict:
    """TRAIN_WARMUP steps, then TRAIN_STEPS timed ones, with every kernel
    counter set to 0 just before and read just after, and the peak
    memory over all of them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = kernel_counters()
    for counter in counters.values():
        counter.reset()
    losses = [step(tokens) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(tokens) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"wall": wall, "losses": [x.item() for x in losses],
            "launches": {name: c.count for name, c in counters.items()},
            "max_memory_allocated_gb":
            torch.cuda.max_memory_allocated() / 1e9}


def profile_step(step, tokens, step_ms: float, fp32_products=None) -> dict:
    """One step under the profiler: kernel time by class and name, the
    device's busy share, the launches. With ``fp32_products``, a test
    of an ``aten::mm``'s input shapes, the matrix-product kernels are
    split into those products' and the rest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=fp32_products is not None) as prof:
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    norm_bwd = [e for e in prof.key_averages()
                if e.key.endswith("_RMSNormBackward")]
    busy_us = sum(t for _, t, _ in kernels)
    top = sorted(kernels, key=lambda kt: -kt[1])[:10]
    by_class = kernel_classes_ms(kernels)
    if fp32_products is not None:
        # The products' kernels, by the ops that launched them.
        fp32_ms = sum(e.self_device_time_total for e in
                      prof.key_averages(group_by_input_shape=True)
                      if e.key == "aten::mm"
                      and fp32_products(e.input_shapes)) / 1e3
        by_class["fp32_products"] = fp32_ms or "not measured"
        by_class["matmul"] -= fp32_ms
    return {
        "profiled_step_ms": window_us / 1e3,
        # The host issues each of these, one by one, every step.
        "device_kernel_launches": sum(n for _, _, n in kernels),
        "device_busy_share": busy_us / window_us if busy_us else
        "not measured",
        "device_busy_ms": busy_us / 1e3,
        # The profiler slows the host, not the card: the busy time over
        # the unprofiled step time estimates the unprofiled busy share.
        "device_busy_over_unprofiled_step": busy_us / 1e3 / step_ms
        if busy_us else "not measured",
        "kernel_ms": {name: sum(t for k, t, _ in kernels if kernel in k)
                      / 1e3 for name, kernel in (
                          ("flash_forward", "flash_forward"),
                          ("flash_bwd_dq", "flash_bwd_dq"),
                          ("flash_bwd_dkv", "flash_bwd_dkv"),
                          ("rmsnorm", "rmsnorm_"))},
        # RMSNorm's backward is plain torch (the JAX package has no kernel
        # for it): the device time of the kernels its autograd node
        # launched, and its calls.
        "rmsnorm_backward": {
            "ms": max((e.device_time_total for e in norm_bwd), default=0)
            / 1e3,
            "calls": max((e.count for e in norm_bwd), default=0)},
        "by_class_ms": by_class,
        "top_kernels": [{"kernel": k[:90], "ms": t / 1e3,
                         "share_of_busy": t / busy_us} for k, t, _ in top],
    }


def head_check(model, tokens: int, card_line: str) -> dict:
    """The tied LM head at the train shape on the card's route (bf16
    products with fp32 output) against the operands rounded to bf16 and
    multiplied in fp32, JAX's function: the logits and both gradients
    for a random fp32 logits' gradient. The route's forward and backward
    are timed, beside a backward of fp32 products and one that rounds the
    logits' gradient to bf16 (a planted fault: it must read above
    HEAD_GRAD_TOL)."""
    import torch.nn.functional as F

    from raytpu_torch.models.gpt2 import tied_logits

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(5)
    w = model.wte.weight.detach()
    wb = w.to(bf16)
    x = _randn((tokens, w.shape[1]), gen)
    g = torch.randn((tokens, w.shape[0]), generator=gen, device="cuda")
    out = []
    for head in (lambda a, b: tied_logits(a, b, bf16),
                 lambda a, b: F.linear(a.float(), b.to(bf16).float())):
        leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
        logits = head(*leaves)
        out.append((logits.detach(), *torch.autograd.grad(logits, leaves, g)))

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm()).item()

    rel_norm = {name: rel(a, b)
                for name, a, b in zip(("logits", "dx", "dw"), *out)}
    gb = g.to(bf16)
    rounded_g = {
        "dx": rel(torch.mm(gb, wb), out[1][1]),
        "dw": rel(torch.mm(gb.t(), x, out_dtype=torch.float32).to(bf16),
                  out[1][2])}
    leaves = [x.detach().requires_grad_(), w.detach().requires_grad_()]
    result = {
        "head_rel_norm": rel_norm, "head_bf16_grad_rel_norm": rounded_g,
        "head_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
            tied_logits(*leaves, bf16), leaves, g), iters=5),
        "head_fwd_ms": time_ms(lambda: tied_logits(x, w, bf16), iters=5),
        "head_bwd_fp32_ms": time_ms(lambda: (
            torch.mm(g, wb.float()).to(bf16),
            torch.mm(g.t(), x.float()).to(bf16)), iters=5),
        "head_bwd_bf16_grad_ms": time_ms(lambda: (
            torch.mm(gb, wb), torch.mm(gb.t(), x, out_dtype=torch.float32)),
            iters=5),
    }
    log(f"[train-head] {json.dumps(result)} | {card_line}")
    if not (rel_norm["logits"] <= HEAD_LOGITS_TOL
            and rel_norm["dx"] <= HEAD_GRAD_TOL
            and rel_norm["dw"] <= HEAD_GRAD_TOL):
        raise AssertionError(f"tied head: the card's route differs from "
                             f"JAX's function: {rel_norm}")
    if not max(rounded_g.values()) > HEAD_GRAD_TOL:
        raise AssertionError(f"tied head: the limit misses a logits' "
                             f"gradient rounded to bf16: {rounded_g}")
    return result


def flops_per_token(cfg, n_params: int) -> float:
    """Training FLOPs per token as bench.py counts them, 6 N + 12 L E T
    (N the parameters a token goes through, ``n_params``; remat's
    recompute not counted)."""
    return 6.0 * n_params + 12.0 * cfg.n_layer * cfg.n_embd * cfg.block_size


def phase_train(card_line: str):
    """GPT-2 124M training steps; returns (result, model, tokens)."""
    from raytpu_torch.models.gpt2 import GPT2, GPT2Config, make_train_step

    cfg = GPT2Config.small()
    t0 = time.perf_counter()
    model = GPT2(cfg, device="cuda", seed=0)
    # optax.adamw(3e-4, weight_decay=0.1)'s settings over every parameter
    # (bench.py); the default multi-tensor (foreach) implementation.
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1, foreach=True)
    step = make_train_step(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.block_size))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] GPT-2 124M random weights: {n_params} parameters in "
        f"{time.perf_counter() - t0:.2f} s")
    run = timed_steps(step, tokens)
    result = train_result("GPT-2 124M", cfg, TRAIN_BATCH, run)
    log(f"[train] {json.dumps(result)} | {card_line}")
    # A step: each layer's forward and its full-remat recompute launch
    # the flash forward once each, the backward dQ and dK/dV once a
    # layer; GPT-2's LayerNorm has no kernel.
    check_train_launches(result, {
        "flash_forward": 2 * cfg.n_layer, "flash_bwd_dq": cfg.n_layer,
        "flash_bwd_dkv": cfg.n_layer, "paged_attention": 0, "rmsnorm": 0})
    check_losses(result["losses"])
    result["head"] = head_check(model, TRAIN_BATCH * cfg.block_size,
                                card_line)
    result["profile"] = profile_step(step, tokens, result["step_ms"])
    log(f"[train-profile] {json.dumps(result['profile'])} | {card_line}")
    return result, model, tokens


def train_result(name: str, cfg, batch: int, run: dict,
                 n_params: int = None) -> dict:
    """The run's numbers; MFU counts ``n_params`` (by default the
    config's approximate parameter count) a token."""
    flops = flops_per_token(cfg, n_params or cfg.n_params_approx)
    n_tokens = batch * cfg.block_size
    tokens_per_s = n_tokens * TRAIN_STEPS / run["wall"]
    steps = TRAIN_WARMUP + TRAIN_STEPS
    return {
        "model": name, "batch": batch, "seq": cfg.block_size,
        "n_layer": cfg.n_layer, "remat": cfg.remat,
        "optimizer": "AdamW foreach",
        "step_ms": run["wall"] / TRAIN_STEPS * 1e3,
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * flops / PEAK_BF16_FLOPS,
        "flops_per_token": flops,
        "max_memory_allocated_gb": run["max_memory_allocated_gb"],
        "losses": run["losses"], "launches": run["launches"],
        "launches_per_step": {k: v / steps
                              for k, v in run["launches"].items()},
    }


def check_train_launches(result: dict, per_step: dict) -> None:
    """Every kernel launched ``per_step`` times a step over the run."""
    steps = TRAIN_WARMUP + TRAIN_STEPS
    check_launches(result["launches"],
                   {k: v * steps for k, v in per_step.items()})


def check_losses(losses) -> None:
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")


# ---- phase 10: train end to end against the plain attention ----------


def loss_and_grads(model, loss_fn, tokens):
    """One step's loss and every parameter's gradient (a copy)."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def grad_rel_diffs(got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| for each parameter's gradient."""
    return {n: ((got[n] - want[n]).norm() / want[n].norm()).item()
            for n in want}


def e2e_result(loss_k: float, loss_p: float, rel: dict) -> dict:
    worst = max(rel, key=rel.get)
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "grad_rel_diff_worst": rel[worst], "worst_tensor": worst,
            "grad_rel_diff_median": float(np.median(list(rel.values()))),
            "tensors": len(rel),
            "worst_tensors": dict(sorted(rel.items(),
                                         key=lambda kv: -kv[1])[:5])}


def check_e2e(result: dict, loss_tol: float, grad_tol: float) -> None:
    if not result["loss_rel_diff"] <= loss_tol:
        raise AssertionError(f"train loss: kernels differ from the plain "
                             f"path by {result['loss_rel_diff']} > "
                             f"{loss_tol}")
    if not result["grad_rel_diff_worst"] <= grad_tol:
        raise AssertionError(f"gradient of {result['worst_tensor']}: "
                             f"kernels differ from the plain path by "
                             f"{result['grad_rel_diff_worst']} > {grad_tol}")


def phase_train_e2e(model, tokens, card_line: str) -> dict:
    from raytpu_torch.models.gpt2 import gpt2_loss_fn

    plain = copy.copy(model)  # the same parameters, plain attention
    plain.config = dataclasses.replace(model.config, attn_impl="reference")
    lk, gk = loss_and_grads(model, gpt2_loss_fn, tokens)
    lp, gp = loss_and_grads(plain, gpt2_loss_fn, tokens)
    result = {"batch": tokens.shape[0], "seq": tokens.shape[1],
              **e2e_result(lk, lp, grad_rel_diffs(gk, gp))}
    log(f"[train-e2e] {json.dumps(result)} | {card_line}")
    check_e2e(result, TRAIN_E2E_LOSS_TOL, TRAIN_E2E_GRAD_TOL)
    return result


# ---- phase 11: Llama train -------------------------------------------


def llama_train_config():
    """Llama-2-7B at full width, cut to LLAMA_TRAIN_LAYERS layers; every
    other field at its default (bf16 compute, remat "dots")."""
    from raytpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.llama2_7b(),
                               n_layer=LLAMA_TRAIN_LAYERS)


def phase_llama_train(card_line: str):
    """Llama-2-7B (8 layers) training steps; returns (result, model,
    tokens). The optimizer is dropped on return."""
    from raytpu_torch.models.llama import Llama, make_train_step

    cfg = llama_train_config()
    t0 = time.perf_counter()
    model = Llama(cfg, device="cuda", seed=0, param_dtype=torch.float32)
    # optax.adamw's settings, as in the GPT-2 phase; foreach.
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1, foreach=True)
    step = make_train_step(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LLAMA_TRAIN_BATCH, cfg.block_size))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[llama-train] Llama-2-7B, {cfg.n_layer} layers, random weights: "
        f"{n_params} parameters (approx. {cfg.n_params_approx}) in "
        f"{time.perf_counter() - t0:.2f} s")
    run = timed_steps(step, tokens)
    result = train_result(f"Llama-2-7B, {cfg.n_layer} of 32 layers", cfg,
                          LLAMA_TRAIN_BATCH, run)
    log(f"[llama-train] {json.dumps(result)} | {card_line}")
    # A step: each layer's forward and its "dots" recompute launch the
    # flash forward once each and its two norms once each; the backward
    # dQ and dK/dV once a layer; the final norm once.
    check_train_launches(result, {
        "flash_forward": 2 * cfg.n_layer, "flash_bwd_dq": cfg.n_layer,
        "flash_bwd_dkv": cfg.n_layer, "paged_attention": 0,
        "rmsnorm": 4 * cfg.n_layer + 1})
    check_losses(result["losses"])
    result["profile"] = profile_step(step, tokens, result["step_ms"])
    log(f"[llama-train-profile] {json.dumps(result['profile'])} | "
        f"{card_line}")
    return result, model, tokens


# ---- phase 12: Llama train end to end --------------------------------


def variant(model, **kw):
    """``model`` with the same parameters and its config's fields ``kw``
    changed."""
    m = copy.copy(model)
    m.config = dataclasses.replace(model.config, **kw)
    return m


def remat_agreement(model, loss_fn, tokens, lk: float, gk: dict) -> dict:
    """Remat "full" against the loss ``lk`` and gradients ``gk`` of
    "dots" (the same kernels; the recomputed forward must give what the
    first gave)."""
    lf, gf = loss_and_grads(variant(model, remat="full"), loss_fn, tokens)
    remat = grad_rel_diffs(gf, gk)
    return {"loss_full": lf, "loss_dots": lk,
            "grad_rel_diff_worst": max(remat.values()),
            "grad_max_abs_diff": max((gf[n] - gk[n]).abs().max().item()
                                     for n in gk),
            "bit_equal": lf == lk and all(torch.equal(gf[n], gk[n])
                                          for n in gk)}


def train_e2e(model, loss_fn, tokens) -> dict:
    """One step from the trained weights: the kernels against the plain
    attention and RMSNorm, and remat "full" against "dots"."""
    torch.cuda.reset_peak_memory_stats()
    lk, gk = loss_and_grads(model, loss_fn, tokens)
    full_vs_dots = remat_agreement(model, loss_fn, tokens, lk, gk)
    lp, gp = loss_and_grads(variant(model, attn_impl="reference",
                                    norm_impl="reference"), loss_fn, tokens)
    return {"batch": tokens.shape[0], "seq": tokens.shape[1],
            **e2e_result(lk, lp, grad_rel_diffs(gk, gp)),
            "full_vs_dots": full_vs_dots,
            "max_memory_allocated_gb":
            torch.cuda.max_memory_allocated() / 1e9}


def phase_llama_train_e2e(model, tokens, card_line: str) -> dict:
    from raytpu_torch.models.llama import llama_loss_fn

    result = train_e2e(model, llama_loss_fn, tokens)
    log(f"[llama-train-e2e] {json.dumps(result)} | {card_line}")
    check_e2e(result, LLAMA_E2E_LOSS_TOL, LLAMA_E2E_GRAD_TOL)
    remat = result["full_vs_dots"]
    if not (abs(remat["loss_full"] - remat["loss_dots"])
            <= LLAMA_E2E_LOSS_TOL * abs(remat["loss_dots"])
            and remat["grad_rel_diff_worst"] <= GRAD_NORM_TOL):
        raise AssertionError(f"remat 'full' and 'dots' give other results: "
                             f"{remat}")
    return result


# ---- phase 13: Mixtral train -----------------------------------------


def mixtral_train_config():
    """Mixtral-8x7B's widths as mistralai/Mixtral-8x7B-v0.1's config.json
    gives them (vocab 32000, width 4096, 32 heads of which 8 KV, 8 SwiGLU
    experts of 14336, 2 a token, rope theta 1e6), MIXTRAL_TRAIN_LAYERS of
    its 32 layers and a context of 4096 tokens; the JAX package's
    defaults elsewhere (capacity factor 1.25, router aux coefficient
    0.01, bf16 compute, remat "dots")."""
    from raytpu_torch.models.mixtral import MixtralConfig

    return MixtralConfig(vocab_size=32000, block_size=4096,
                         n_layer=MIXTRAL_TRAIN_LAYERS, n_head=32,
                         n_kv_head=8, n_embd=4096, n_inter=14336,
                         rope_theta=1e6, n_expert=8, n_expert_per_tok=2)


def routes(model, tokens) -> list:
    """Each layer's routes, ``(probs [N, E], topw [N, k], topi [N, k])``,
    in one forward without gradients, read by hooks on the MoE layers."""
    out = []

    def hook(moe, args):
        x = args[0]
        out.append(moe.route(x.reshape(-1, x.shape[-1])))

    handles = [layer.moe.register_forward_pre_hook(hook)
               for layer in model.layers]
    try:
        with torch.no_grad():
            model(tokens)
    finally:
        for h in handles:
            h.remove()
    return out


def dropped_slots(cfg, layer_routes) -> list:
    """Per layer, the routed slots that get no place in an expert: the
    share of all, those whose place in the stream is below 0 (the JAX
    package gives a route the place "its count at its expert minus E", so
    each expert's first E - 1 routes get none) and those past the
    capacity; and the busiest expert's load over the mean."""
    from raytpu_torch.models.mixtral import dispatch_masks, expert_capacity

    e = cfg.n_expert
    out = []
    for _, _, topi in layer_routes:
        n, k = topi.shape
        cap = expert_capacity(cfg, n)
        counts = torch.bincount(topi.flatten(), minlength=e)
        below = counts.clamp(max=e - 1).sum().item()
        past = (counts - (e - 1) - cap).clamp(min=0).sum().item()
        kept = dispatch_masks(topi, torch.ones_like(topi, dtype=torch.float32),
                              e, cap)[0].sum().item()
        if kept != k * n - below - past:
            raise AssertionError(f"dispatch keeps {kept} of {k * n} routes, "
                                 f"not {k * n - below - past}")
        out.append({"dropped_share": 1 - kept / (k * n),
                    "below_first_place": below, "past_capacity": past,
                    "capacity": cap,
                    "max_load_over_mean": counts.max().item() / (k * n / e)})
    return out


def phase_mixtral_train(card_line: str):
    """Mixtral (8x7B widths, MIXTRAL_TRAIN_LAYERS layers) training steps;
    returns (result, model, tokens). The optimizer is dropped on
    return."""
    from raytpu_torch.models.mixtral import (Mixtral, expert_capacity,
                                             make_train_step)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the routing products must run "
                             "in fp32, as on the JAX reference")
    cfg = mixtral_train_config()
    t0 = time.perf_counter()
    model = Mixtral(cfg, device="cuda", seed=0)
    # optax.adamw's settings, as in the GPT-2 phase; foreach.
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.1, foreach=True)
    step = make_train_step(model, opt)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MIXTRAL_TRAIN_BATCH, cfg.block_size))).cuda()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[mixtral-train] Mixtral-8x7B widths, {cfg.n_layer} layers, random "
        f"weights: {n_params} parameters in "
        f"{time.perf_counter() - t0:.2f} s")
    at_init = dropped_slots(cfg, routes(model, tokens))
    run = timed_steps(step, tokens)
    # MFU counts the parameters a token is routed through: the k experts
    # it picks and the router, not the capacity's spare slots or the fp32
    # dispatch and combine products.
    result = train_result(f"Mixtral-8x7B widths, {cfg.n_layer} of 32 layers",
                          cfg, MIXTRAL_TRAIN_BATCH, run, cfg.n_params_active)
    result["routing_at_init"] = at_init
    result["routing"] = dropped_slots(cfg, routes(model, tokens))
    log(f"[mixtral-train] {json.dumps(result)} | {card_line}")
    # A step, as Llama's: the flash forward twice a layer (forward and
    # the "dots" recompute), dQ and dK/dV once, the norms 4 L + 1.
    check_train_launches(result, {
        "flash_forward": 2 * cfg.n_layer, "flash_bwd_dq": cfg.n_layer,
        "flash_bwd_dkv": cfg.n_layer, "paged_attention": 0,
        "rmsnorm": 4 * cfg.n_layer + 1})
    check_losses(result["losses"])
    # The fp32 products: the router's (a dimension of E), dispatch and
    # combine (a dimension of E x capacity), forward and backward.
    n = MIXTRAL_TRAIN_BATCH * cfg.block_size
    fp32_dims = {cfg.n_expert, cfg.n_expert * expert_capacity(cfg, n)}
    result["profile"] = profile_step(
        step, tokens, result["step_ms"],
        lambda shapes: any(d in fp32_dims for s in shapes for d in s))
    log(f"[mixtral-train-profile] {json.dumps(result['profile'])} | "
        f"{card_line}")
    return result, model, tokens


# ---- phase 14: Mixtral train end to end -------------------------------


@contextlib.contextmanager
def pinned_routes(model, layer_routes):
    """Within it, each MoE layer of ``model`` (and of every variant that
    shares its layers) sends its tokens to the experts ``layer_routes``
    (each layer's ``topi`` [N, k]) names, with the weights its own
    router gives them there."""
    def pin(moe, topi):
        def route(xf):
            probs = type(moe).route(moe, xf)[0]
            topw = probs.gather(1, topi)
            return probs, topw / topw.sum(-1, keepdim=True), topi
        return route

    for layer, topi in zip(model.layers, layer_routes):
        layer.moe.route = pin(layer.moe, topi)
    try:
        yield
    finally:
        for layer in model.layers:
            del layer.moe.route


def rerouted(layer_routes, m: int) -> list:
    """Each layer's ``topi`` with the ``m`` tokens nearest a flip flipped:
    those whose two neighbouring experts among their top k + 1 lie
    closest in router logit, with that pair swapped (an order swap within
    the top k, or the last chosen expert traded for the first one not
    chosen): m route flips of the kind the two paths' roundings make."""
    out = []
    for probs, _, topi in layer_routes:
        k = topi.shape[1]
        p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        logp = torch.log(p[:, :k + 1].clamp_min(torch.finfo(p.dtype).tiny))
        gap, j = (logp[:, :-1] - logp[:, 1:]).min(-1)
        near = torch.argsort(gap, stable=True)[:m]
        order = order[:, :k + 1].clone()
        first = order[near, j[near]]
        order[near, j[near]] = order[near, j[near] + 1]
        order[near, j[near] + 1] = first
        out.append(order[:, :k])
    return out


def admitted(rk, rp, share: float) -> list:
    """Each layer's ``topi`` of the kernel path, the first ``share`` (in
    token order) of the tokens the plain path routes otherwise taking
    the plain path's routes."""
    out = []
    for (_, _, a), (_, _, b) in zip(rk, rp):
        other = (a != b).any(-1).nonzero()[:, 0]
        take = other[:round(share * len(other))]
        topi = a.clone()
        topi[take] = b[take]
        out.append(topi)
    return out


def route_gaps(model, tokens):
    """One batch: the tokens each layer routes otherwise on the plain path
    (attention and RMSNorm plain, same weights), and the kernel path's
    loss and gradients against the plain path's at the kernel path's
    routes (``pinned_routes``), at the plain path's own routes
    (``free_routes``), at the kernel path's routes with a share of the
    tokens routed otherwise taking the plain path's (``admitted``), and
    with m flips planted a layer for each m of MIXTRAL_REROUTES
    (``planted``). Returns (that, the kernel path's loss, its
    gradients)."""
    from raytpu_torch.models.mixtral import mixtral_loss_fn

    plain = variant(model, attn_impl="reference", norm_impl="reference")
    rk = routes(model, tokens)
    rp = routes(plain, tokens)
    otherwise = [int((a[2] != b[2]).any(-1).sum().item())
                 for a, b in zip(rk, rp)]
    lk, gk = loss_and_grads(model, mixtral_loss_fn, tokens)

    def against(layer_topi):
        with pinned_routes(model, layer_topi):
            lq, gq = loss_and_grads(plain, mixtral_loss_fn, tokens)
        return e2e_result(lk, lq, grad_rel_diffs(gk, gq))

    def brief(r: dict, **kw) -> dict:
        return {**kw, **{key: r[key] for key in (
            "loss_rel_diff", "grad_rel_diff_worst", "worst_tensor")}}

    pinned = against([topi for _, _, topi in rk])
    shares = [brief(against(admitted(rk, rp, f)), share=f)
              for f in (0.25, 0.5, 0.75)]
    planted = [brief(against(rerouted(rk, m)), a_layer=m)
               for m in MIXTRAL_REROUTES]
    del rp
    lp, gp = loss_and_grads(plain, mixtral_loss_fn, tokens)
    free = e2e_result(lk, lp, grad_rel_diffs(gk, gp))
    del gp
    return {"tokens_routed_otherwise": otherwise,
            "free_routes": free, "pinned_routes": pinned,
            "admitted": shares, "planted": planted}, lk, gk


def phase_mixtral_train_e2e(model, tokens, card_line: str) -> dict:
    """As Llama's, on the training batch and on a second batch: the
    kernels against the plain versions at the kernel path's routes and at
    free routes (MIXTRAL_FREE_GRAD_TOL: why both), and remat "full"
    against "dots" to the bit."""
    from raytpu_torch.models.mixtral import mixtral_loss_fn

    torch.cuda.reset_peak_memory_stats()
    result, lk, gk = route_gaps(model, tokens)
    result["full_vs_dots"] = remat_agreement(model, mixtral_loss_fn, tokens,
                                             lk, gk)
    del gk
    other = torch.from_numpy(np.random.default_rng(MIXTRAL_E2E_SEED).integers(
        0, model.config.vocab_size, tuple(tokens.shape))).cuda()
    result["second_batch"] = route_gaps(model, other)[0]
    result["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[mixtral-train-e2e] {json.dumps(result)} | {card_line}")
    for batch in (result, result["second_batch"]):
        check_e2e(batch["pinned_routes"], MIXTRAL_E2E_LOSS_TOL,
                  MIXTRAL_E2E_GRAD_TOL)
        check_e2e(batch["free_routes"], MIXTRAL_E2E_LOSS_TOL,
                  MIXTRAL_FREE_GRAD_TOL)
    if not result["full_vs_dots"]["bit_equal"]:
        raise AssertionError(f"remat 'full' and 'dots' are not equal to the "
                             f"bit: {result['full_vs_dots']}")
    return result


# ---- phase 15: GPT-2 dropout on the card -------------------------------
DROPOUT_RATE = 0.1
DROPOUT_BATCH = 8


def phase_gpt2_dropout(card_line: str) -> dict:
    """GPT-2 124M's training forward and backward at dropout 0.1 on the
    card (bf16 compute, fp32 parameters, 8 x 1024 tokens): rate 0 and the
    deterministic forward equal today's to the bit; the masks keep
    within five standard deviations of 1 - p and the survivors are
    divided by 1 - p exactly (the first block's residual, read by hooks);
    remat "full" against "none" under one generator seed, the gradients
    within GRAD_NORM_TOL in norm (bit-equal reported)."""
    from raytpu_torch.models.gpt2 import (GPT2, GPT2Config, dropout,
                                          dropout_keep, mean_nll)

    cfg = GPT2Config.small()
    rate = DROPOUT_RATE
    model = GPT2(dataclasses.replace(cfg, dropout=rate), device="cuda",
                 seed=0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (DROPOUT_BATCH, cfg.block_size))).cuda()

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    with torch.no_grad():
        plain = variant(model, dropout=0.0)
        want = plain(tokens)
        rate0_equal = (torch.equal(plain(tokens, deterministic=False,
                                         generator=gen(1)), want)
                       and torch.equal(model(tokens), want))
        seen = {}
        block = model.h[0]
        hooks = [block.attn.register_forward_hook(
                     lambda m, a, out: seen.__setitem__("y", out)),
                 block.ln_1.register_forward_pre_hook(
                     lambda m, a: seen.__setitem__("x0", a[0])),
                 block.ln_2.register_forward_pre_hook(
                     lambda m, a: seen.__setitem__("x1", a[0]))]
        dropped = model(tokens, deterministic=False, generator=gen(3))
        for h in hooks:
            h.remove()
        keep = dropout_keep(rate, seen["x0"].shape, gen(3), "cuda")
        residual_exact = torch.equal(
            seen["x1"], seen["x0"] + dropout(seen["y"], keep, rate))
        survivors_exact = torch.equal(
            dropout(seen["y"], keep, rate)[keep], seen["y"][keep] / (1 - rate))
    n = keep.numel()
    kept = int(keep.sum())
    sigma = float(np.sqrt(n * rate * (1 - rate)))

    def loss_fn(m, t):
        return mean_nll(m(t, deterministic=False, generator=gen(11))[:, :-1],
                        t[:, 1:])

    loss_none, g_none = loss_and_grads(variant(model, remat=False), loss_fn,
                                       tokens)
    loss_full, g_full = loss_and_grads(variant(model, remat=True), loss_fn,
                                       tokens)
    rel = grad_rel_diffs(g_full, g_none)
    result = {
        "rate": rate, "batch": DROPOUT_BATCH, "seq": cfg.block_size,
        "rate0_and_deterministic_bit_equal": rate0_equal,
        "dropped_differs": not torch.equal(dropped, want),
        "keep_share": kept / n, "keep_sigmas": abs(kept - n * (1 - rate))
        / sigma, "residual_exact": residual_exact,
        "survivors_exact": survivors_exact,
        "loss_remat_none": loss_none, "loss_remat_full": loss_full,
        "grad_rel_diff_worst": max(rel.values()),
        "grads_finite": all(bool(torch.isfinite(g).all())
                            for g in g_none.values()),
        "bit_equal": loss_none == loss_full and all(
            torch.equal(g_full[k], g_none[k]) for k in g_none)}
    log(f"[gpt2-dropout] {json.dumps(result)} | {card_line}")
    if not (rate0_equal and result["dropped_differs"] and residual_exact
            and survivors_exact and result["keep_sigmas"] < 5
            and result["grads_finite"] and np.isfinite(loss_none)
            and result["grad_rel_diff_worst"] <= GRAD_NORM_TOL
            and abs(loss_full - loss_none) <= 1e-6 * abs(loss_none)):
        raise AssertionError(f"GPT-2 dropout on the card: {result}")
    return result


# ---- phases 16-18: RLlib ---------------------------------------------
# The card against the CPU: one whole update from the same weights,
# optimizer state, batch and permutations, in IEEE fp32 on both (the RL
# path turns TF32 off while it runs, rl_module.ieee_fp32). What is held is
# each parameter's step (after minus before), not the parameter, whose
# norm is mostly the shared starting weights: the card's step within
# RL_STEP_TOL of the CPU's in relative norm. The same update with TF32 on
# (ieee_fp32 bypassed, a planted fault) must land above it. On an H100 the
# IEEE steps read 1.4e-5 (PPO) and 4.7e-7 (pixel PPO), the TF32 steps
# 3.5e-3 and 3.0e-2: the limit lies between, over ten times from each.
RL_STEP_TOL = 2e-4
PPO_MIN_WALL_S = 2.0  # benchmarks/bench_ppo.py's timed region


def _doubling(step_fn, start: int, min_wall: float = PPO_MIN_WALL_S):
    """benchmarks/bench_ppo.py's harness: ``step_fn`` (which returns its
    units) ``start`` times, doubled until the run takes ``min_wall``
    seconds; returns (units, seconds, calls)."""
    n = start
    while True:
        t0 = time.perf_counter()
        units = sum(step_fn() for _ in range(n))
        dt = time.perf_counter() - t0
        if dt >= min_wall:
            return units, dt, n
        n *= 2


def _on_device(params, device) -> bool:
    return all((_on_device(v, device) if isinstance(v, dict)
                else v.device.type == torch.device(device).type)
               for v in params.values())


def _finite_metrics(result: dict) -> bool:
    return all(np.isfinite(v) for k, v in result.items()
               if isinstance(v, float) and k not in (
                   "episode_return_mean", "episode_return_max"))


def _rel_steps(after: dict, before: dict, want: dict) -> dict:
    """Each parameter's step (``after`` - ``before``) against ``want``'s,
    in relative norm."""
    return {k: ((after[k] - before[k] - want[k]).norm()
                / want[k].norm()).item() for k in want}


@contextlib.contextmanager
def tf32_in_ppo_updates():
    """PPO's update with TF32 on in cuDNN's convolutions and cuBLAS's fp32
    products, in place of its ieee_fp32 block: the fault the card check
    must see."""
    import raytpu_torch.rllib.algorithms.ppo as ppo

    @contextlib.contextmanager
    def tf32(device):
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags

    ieee = ppo.ieee_fp32
    ppo.ieee_fp32 = tf32
    try:
        yield
    finally:
        ppo.ieee_fp32 = ieee


def card_against_cpu(algo, batch) -> dict:
    """One rollout update of ``algo``'s learner on its device and of a
    CPU twin from the same state, with the same permutations: each
    parameter's step on the card against the CPU's, in relative norm;
    then the same update on the card from the same state with TF32 on."""
    learner = algo.learner
    state = learner.get_state()
    before = state["params"]
    twin = type(learner)(learner.module, {**learner.config, "device": "cpu"})
    twin.set_state(state)
    perms = learner.permutations(batch["rewards"].size)
    want = twin.update(batch, perms)
    cpu_step = {k: v - before[k] for k, v in twin.get_weights().items()}
    got = learner.update(batch, perms)
    rel = _rel_steps(learner.get_weights(), before, cpu_step)
    worst = max(rel, key=rel.get)
    learner.set_state(state)
    with tf32_in_ppo_updates():
        learner.update(batch, perms)
    tf32 = _rel_steps(learner.get_weights(), before, cpu_step)
    return {"step_rel_diff_worst": rel[worst], "worst_tensor": worst,
            "step_rel_diff_worst_tf32": max(tf32.values()),
            # How far the parameters moved: what a comparison of the
            # parameters themselves would dilute a fault by.
            "step_norm_over_param_norm": (sum(
                float(v.norm()) ** 2 for v in cpu_step.values()) / sum(
                float(v.norm()) ** 2 for v in before.values())) ** 0.5,
            "metric_rel_diff": {k: abs(got[k] - want[k]) / max(abs(want[k]),
                                                                 1e-12)
                                for k in want},
            "metrics_card": got, "metrics_cpu": want,
            "all_on_device": _on_device(learner.params, learner.device)}


def _check_card_against_cpu(tag: str, r: dict) -> None:
    if not (r["step_rel_diff_worst"] <= RL_STEP_TOL
            < r["step_rel_diff_worst_tf32"] and r["all_on_device"]
            and _finite_metrics(r["metrics_card"])):
        raise AssertionError(f"{tag}: the card's update differs from the "
                             f"CPU's, or TF32's does not: {r}")


def iteration_split(algo, iterations: int = 3) -> dict:
    """Where a training_step's host time goes, over ``iterations`` of
    them: the numpy env step, the sampling forward with its two copies
    (obs to the device, actions/logp/values back), the learner's update
    (to its metrics' copy back) and the rest (buffers, connectors, the
    weight sync)."""
    runner = algo.env_runner_group.local_runner
    spent = {"env_step": 0.0, "sample_forward": 0.0, "update": 0.0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    step_batch, act, update = runner._vec.step_batch, runner.act, \
        algo.learner.update
    runner._vec.step_batch = timed("env_step", step_batch)
    runner.act = timed("sample_forward", act)
    algo.learner.update = timed("update", update)
    try:
        t0 = time.perf_counter()
        for _ in range(iterations):
            algo.training_step()
        wall = time.perf_counter() - t0
    finally:
        del runner._vec.step_batch, runner.act, algo.learner.update
    out = {f"{k}_ms": v / iterations * 1e3 for k, v in spent.items()}
    out["iteration_ms"] = wall / iterations * 1e3
    out["rest_ms"] = out["iteration_ms"] - sum(
        out[k] for k in ("env_step_ms", "sample_forward_ms", "update_ms"))
    return out


def ppo_config(device):
    """benchmarks/bench_ppo.py:33-41: CartPole-v1-vec, 64 envs x 64
    steps, lr 3e-4, 4 epochs, minibatches of 512, the (256, 256) fcnet."""
    from raytpu_torch.rllib import PPOConfig

    return (PPOConfig().environment("CartPole-v1-vec")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=64,
                         rollout_fragment_length=64)
            .training(lr=3e-4, num_epochs=4, minibatch_size=512)
            .debugging(seed=0).resources(device=device))


def ppo_rates(algo) -> dict:
    """bench_ppo's two figures: env-steps/s over whole training_steps
    (after two warm-up ones), and learner samples/s over repeated
    updates on one fixed rollout."""
    algo.training_step()
    algo.training_step()
    steps, dt, calls = _doubling(
        lambda: int(algo.training_step()["_env_steps"]), 5)
    batch = algo._concat_time_major(algo.env_runner_group.sample())
    size = int(batch["rewards"].size)
    algo.learner.update(batch)
    samples, l_dt, l_calls = _doubling(
        lambda: (algo.learner.update(batch), size)[1], 3)
    return {"env_steps_per_s": steps / dt, "iterations": calls,
            "wall_s": dt, "learner_samples_per_s": samples / l_dt,
            "learner_updates": l_calls, "learner_wall_s": l_dt,
            "batch": size}


def phase_rl_ppo(card_line: str) -> dict:
    """PPO at the north-star config (bench_ppo's) on the card: the two
    rates, an iteration's split and the device's busy share; one update
    on the card against the CPU's; and, labelled as a CPU reading, the
    same rates with device="cpu" on this machine."""
    algo = ppo_config("cuda").build()
    if not (_on_device(algo.learner.params, "cuda") and _on_device(
            algo.env_runner_group.local_runner.params, "cuda")):
        raise AssertionError("PPO: a parameter is not on the card")
    result = {"config": "bench_ppo: CartPole-v1-vec 64 envs x 64 steps, "
              "lr 3e-4, 4 epochs, minibatch 512, fcnet (256, 256)",
              **ppo_rates(algo), "split": iteration_split(algo)}
    r = algo.train()
    result["train_env_steps_per_s"] = r["env_steps_per_s"]
    result["metrics_finite"] = _finite_metrics(r)
    profile = profile_step(lambda _: algo.training_step(), None,
                           result["split"]["iteration_ms"])
    result["profile"] = {k: profile[k] for k in (
        "profiled_step_ms", "device_kernel_launches", "device_busy_ms",
        "device_busy_share", "device_busy_over_unprofiled_step",
        "top_kernels")}
    batch = algo._concat_time_major(algo.env_runner_group.sample())
    result["card_against_cpu"] = card_against_cpu(algo, batch)
    algo.stop()
    cpu = ppo_config("cpu").build()
    result["cpu_reading"] = {"what": "the same loop with device='cpu' "
                             "on this machine's host CPU", **ppo_rates(cpu)}
    cpu.stop()
    log(f"[rl-ppo] {json.dumps(result)} | {card_line}")
    if not result["metrics_finite"]:
        raise AssertionError(f"PPO: a metric is not finite: {r}")
    _check_card_against_cpu("PPO", result["card_against_cpu"])
    return result


def phase_rl_pixel_ppo(card_line: str) -> dict:
    """PPO with the conv module on Catch-v0 and FrameStack(2), 16 envs x
    40 steps (tests/test_rllib.py's pixel config): a warm-up iteration
    and three timed ones, a greedy evaluation, and one update on the card
    against the CPU's."""
    from raytpu_torch.rllib import FrameStack, PPOConfig

    algo = (PPOConfig().environment("Catch-v0")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=16,
                         rollout_fragment_length=40)
            .connectors(env_to_module=[FrameStack(2)])
            .training(lr=1e-3, num_epochs=8, minibatch_size=128,
                      entropy_coeff=0.01)
            .debugging(seed=0).resources(device="cuda")).build()
    if type(algo.module).__name__ != "ConvPolicyModule":
        raise AssertionError("pixel PPO: not the conv module")
    algo.train()
    times = [algo.train()["time_this_iter_s"] * 1e3 for _ in range(3)]
    result = {"config": "Catch-v0 + FrameStack(2), 16 envs x 40 steps, "
              "lr 1e-3, 8 epochs, minibatch 128",
              "iteration_ms": times,
              "env_steps_per_s": 640 / (np.mean(times) / 1e3),
              "greedy_return": algo.evaluate()["episode_return_mean"]}
    batch = algo._concat_time_major(algo.env_runner_group.sample())
    result["card_against_cpu"] = card_against_cpu(algo, batch)
    algo.stop()
    log(f"[rl-pixel-ppo] {json.dumps(result)} | {card_line}")
    _check_card_against_cpu("pixel PPO", result["card_against_cpu"])
    return result


class _Rows:
    """An offline dataset: column arrays, served by ``iter_batches`` as
    BC/MARWIL and CQL read a :mod:`raytpu.data` dataset."""

    def __init__(self, columns: dict):
        self.columns = columns

    def iter_batches(self, batch_size: int, batch_format: str = "numpy",
                     drop_last: bool = True):
        n = len(next(iter(self.columns.values())))
        for i in range(0, n - batch_size + 1, batch_size):
            yield {k: v[i:i + batch_size] for k, v in self.columns.items()}


def expert_rows(n_episodes: int = 30) -> dict:
    """tests/test_rllib.py:484-508's hand controller on CartPole (push
    toward the pole's angle plus half its angular velocity): obs, actions,
    discounted returns, rewards, next_obs, terminateds."""
    from raytpu_torch.rllib import CartPoleEnv

    env = CartPoleEnv({"seed": 0})
    cols = {k: [] for k in ("obs", "actions", "returns", "rewards",
                            "next_obs", "terminateds")}
    for ep in range(n_episodes):
        obs, _ = env.reset(seed=ep)
        rows, done = [], False
        while not done:
            a = 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0
            nobs, r, term, trunc, _ = env.step(a)
            rows.append((obs, a, r, nobs, term))
            obs, done = nobs, term or trunc
        g, returns = 0.0, []
        for _ in rows:
            g = 1.0 + 0.99 * g
            returns.append(g)
        for (o, a, r, no, term), ret in zip(rows, reversed(returns)):
            for k, v in zip(cols, (o, a, ret, r, no, term)):
                cols[k].append(v)
    return {"obs": np.asarray(cols["obs"], np.float32),
            "actions": np.asarray(cols["actions"], np.int32),
            "returns": np.asarray(cols["returns"], np.float32),
            "rewards": np.asarray(cols["rewards"], np.float32),
            "next_obs": np.asarray(cols["next_obs"], np.float32),
            "terminateds": np.asarray(cols["terminateds"])}


def phase_rl_algorithms(card_line: str) -> dict:
    """A few train() calls each: IMPALA, APPO and DQN on CartPole, SAC on
    Pendulum, BC and MARWIL on the hand controller's rows (evaluated
    greedily on CartPole), CQL on the same rows with the action as a 1-D
    Box in [-1, 1]; every metric finite, every parameter on the card."""
    from raytpu_torch.rllib import (APPOConfig, BCConfig, CQLConfig,
                                    DQNConfig, IMPALAConfig, MARWILConfig,
                                    SACConfig)

    rows = expert_rows()
    cartpole = {"env": "CartPole-v1", "runners": (4, 32)}
    configs = {
        "IMPALA": (IMPALAConfig(), cartpole, {"num_fragments_per_step": 4}),
        "APPO": (APPOConfig(), cartpole, {"num_fragments_per_step": 4,
                                          "use_kl_loss": True}),
        "DQN": (DQNConfig(), {"env": "CartPole-v1", "runners": (8, 32)},
                {"num_steps_sampled_before_learning_starts": 256,
                 "train_batch_size": 64, "target_network_update_freq": 256}),
        "SAC": (SACConfig(), {"env": "Pendulum-v1", "runners": (4, 50)},
                {"num_steps_sampled_before_learning_starts": 200,
                 "train_batch_size": 128, "updates_per_step": 8}),
        "BC": (BCConfig().offline(dataset=_Rows(rows)),
               {"env": "CartPole-v1"}, {"train_batch_size": 256}),
        "MARWIL": (MARWILConfig().offline(dataset=_Rows(rows)),
                   {"env": "CartPole-v1"}, {"train_batch_size": 256}),
        "CQL": (CQLConfig().offline(
            dataset=_Rows({**rows, "actions": (2.0 * rows["actions"] - 1.0)
                           [:, None].astype(np.float32)}),
            observation_dim=4, action_dim=1, action_low=-1.0,
            action_high=1.0), {},
            {"train_batch_size": 256, "updates_per_iteration": 10}),
    }
    out = {}
    for name, (config, env, training) in configs.items():
        if "env" in env:
            config = config.environment(env["env"])
        if "runners" in env:
            config = config.env_runners(num_env_runners=0,
                                        num_envs_per_env_runner=env[
                                            "runners"][0],
                                        rollout_fragment_length=env[
                                            "runners"][1])
        algo = config.training(**training).debugging(seed=0).resources(
            device="cuda").build()
        t0 = time.perf_counter()
        results = [algo.train() for _ in range(3)]
        took = time.perf_counter() - t0
        params = algo.learner.params
        last = {k: v for k, v in results[-1].items()
                if isinstance(v, float) and k not in ("time_this_iter_s",)}
        entry = {"iterations": 3, "ms_per_iteration": took / 3 * 1e3,
                 "timesteps_total": results[-1]["timesteps_total"],
                 "finite": all(_finite_metrics(r) for r in results),
                 "learned": any("loss" in k for k in results[-1]),
                 "on_device": _on_device(params, "cuda"), "last": last}
        if algo.env_runner_group is not None:
            entry["greedy_return"] = algo.evaluate()["episode_return_mean"]
        algo.stop()
        out[name] = entry
        if not (entry["finite"] and entry["learned"] and entry["on_device"]):
            raise AssertionError(f"{name} on the card: {entry}")
    log(f"[rl-algorithms] {json.dumps(out)} | {card_line}")
    return out


KERNEL_META = {  # name: (source, the TPU kernel it replaces)
    "flash_forward": ("raytpu_torch/ops/csrc/flash_attention.cu",
                      "raytpu/ops/flash_attention.py:159"),
    "flash_bwd_dq": ("raytpu_torch/ops/csrc/flash_bwd_dq.cu",
                     "raytpu/ops/flash_attention.py:297"),
    "flash_bwd_dkv": ("raytpu_torch/ops/csrc/flash_bwd_dkv.cu",
                      "raytpu/ops/flash_attention.py:347"),
    "paged_attention": ("raytpu_torch/ops/csrc/paged_attention.cu",
                        "raytpu/ops/paged_attention.py:175"),
    "rmsnorm": ("raytpu_torch/ops/csrc/rmsnorm.cu",
                "raytpu/ops/fused.py:29"),
}


# What the kernels line keeps of each case.
CASE_KEYS = ("case", "ms", "device_ms", "host_us", "host_us_grad", "bound_ms",
             "library_ms", "library_device_ms", "max_abs_err")


def kernel_line(cases: dict, runs: dict) -> dict:
    """One entry per kernel, its numbers at the shape where its main path
    spends most (the first case of each: the Llama train shape, and
    decode with a batch of eight for paged attention); ``launches`` sums
    the runs of the main paths (``launches_by_run``); ``cases`` lists
    every case the kernels phase held it to."""
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        row = cases[name][0]
        by_run = {run: launches[name] for run, launches in runs.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_run.values()),
            "max_abs_err": max(r["max_abs_err"] for r in cases[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["case"],
            "launches_by_run": by_run,
            "cases": [{key: r[key] for key in CASE_KEYS if key in r}
                      for r in cases[name]],
        })
    return {"kernels": out}


def main() -> int:
    card_line = phase_device()
    from raytpu_torch.models.gpt2 import GPT2, GPT2Config, gpt2_prefill
    from raytpu_torch.models.llama import Llama, LlamaConfig

    phase_build()
    phase_accumulation(card_line)
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
    observability = phase_observability(model, card_line)
    del model
    torch.cuda.empty_cache()
    deployment = phase_deployment(card_line, serve)
    disagg = phase_disagg(card_line)
    t0 = time.perf_counter()
    gpt2 = GPT2(GPT2Config.small(), device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"[gpt2-serve] GPT-2 124M random weights: "
        f"{sum(p.numel() for p in gpt2.parameters())} parameters in "
        f"{time.perf_counter() - t0:.2f} s")
    gpt2_serve = phase_gpt2_serve(gpt2, card_line)
    phase_e2e(gpt2, card_line, gpt2_prefill, "gpt2-e2e")
    del gpt2
    torch.cuda.empty_cache()
    train, gpt2, tokens = phase_train(card_line)
    phase_train_e2e(gpt2, tokens, card_line)
    del gpt2, tokens
    torch.cuda.empty_cache()
    llama, llama_model, tokens = phase_llama_train(card_line)
    torch.cuda.empty_cache()  # the optimizer's state is gone
    phase_llama_train_e2e(llama_model, tokens, card_line)
    del llama_model, tokens
    torch.cuda.empty_cache()
    mixtral, mixtral_model, tokens = phase_mixtral_train(card_line)
    torch.cuda.empty_cache()  # the optimizer's state is gone
    phase_mixtral_train_e2e(mixtral_model, tokens, card_line)
    del mixtral_model, tokens
    torch.cuda.empty_cache()
    phase_gpt2_dropout(card_line)
    torch.cuda.empty_cache()
    # The RL path reaches none of the five kernels: every counter must
    # read 0 after it.
    counters = kernel_counters()
    for counter in counters.values():
        counter.reset()
    phase_rl_ppo(card_line)
    phase_rl_pixel_ppo(card_line)
    phase_rl_algorithms(card_line)
    rllib = {name: c.count for name, c in counters.items()}
    check_launches(rllib, {name: 0 for name in counters})
    runs = {"serve": serve["launches"],
            "observability": observability["launches"],
            "deployment": deployment["launches"],
            "disagg": disagg["launches"],
            "gpt2_serve": gpt2_serve["launches"],
            "gpt2_train": train["launches"],
            "llama_train": llama["launches"],
            "mixtral_train": mixtral["launches"], "rllib": rllib}
    log(json.dumps(kernel_line(cases, runs)))
    log(card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
