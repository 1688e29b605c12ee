#!/usr/bin/env python3
"""Device time of the RMSNorm kernel under fixed grid plans, on one GPU.

    python3 rmsnorm_plans.py

The kernel (``raytpu_torch/ops/csrc/rmsnorm.cu``) takes its grid from the
host: ``blocks`` blocks of ``threads`` threads with ``stages`` rows in
flight a block, which ``raytpu_torch.ops.fused.plan_rows`` picks from the
row count and size. This launches it under the plan ``plan_rows`` picks
and under fixed ones, on the same inputs, for x of 4096 columns (Llama's
and Mixtral's width) in bf16 from 8 to 16384 rows and in fp32:

- ``one row a block``: as many blocks as rows, 256 threads, one stage;
- ``wave 256`` and ``wave 128``: a persistent grid of as many blocks as
  the card holds at once, of 256 threads (4 an SM) or 128 (8 an SM), up to
  3 rows in flight, each walking the rows ``b, b + blocks, ...``;
- ``walk 2``, ``walk 4``, ``walk 8``: blocks of 256 threads walking that
  many rows each, up to 3 in flight.

For each, the device time (profiler, ``chip_smoke.device_ms``), the median
of 5 rounds taken in turns, and its share of the bytes bound. Every plan's
output is held to the plain version first. Prints one line a shape and,
last, the card's name and power limit.
"""

from __future__ import annotations

import statistics
import sys

import torch

import chip_smoke as cs

ROUNDS = 5
SHAPES = [(n, torch.bfloat16) for n in (8, 512, 1024, 2048, 4096, 6144, 8192,
                                       16384)]
SHAPES += [(4096, torch.float32), (8192, torch.float32)]
D = 4096


def plans(n: int, row_bytes: int, n_sm: int) -> dict:
    from raytpu_torch.ops import fused

    def walk(rows_each: int, threads: int = 256, blocks=None):
        blocks = min(n, blocks or -(-n // rows_each))
        stages = max(1, min(fused._STAGES, fused._SMEM_DEFAULT // row_bytes,
                            -(-n // blocks)))
        return blocks, stages, min(threads, row_bytes // 16)

    return {"planned": fused.plan_rows(n, row_bytes, n_sm),
            "one row a block": (n, 1, min(256, row_bytes // 16)),
            "wave 256": walk(0, 256, 4 * n_sm),
            "wave 128": walk(0, 128, 8 * n_sm),
            "walk 2": walk(2), "walk 4": walk(4), "walk 8": walk(8)}


def main() -> int:
    card = cs.phase_device()
    from raytpu_torch.ops import _native, fused

    _native.build(["rmsnorm"])
    n_sm = _native.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, dtype in SHAPES:
        x = cs._randn((n, D), gen, dtype)
        scale = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
        out = torch.empty_like(x)
        want = fused.rmsnorm_reference(x, scale, 1e-5)
        row_bytes = D * x.element_size()
        bound, _ = cs.bound_ms(2 * x.numel() * x.element_size() + 4 * D, 0.0)
        code = _native.DTYPE_CODES[dtype]
        fns = {}
        for name, plan in plans(n, row_bytes, n_sm).items():
            def fn(plan=plan):
                _native.launch("rmsnorm", 0, x.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), n, D, code, 0, 1e-5, *plan)
            fn()
            agree = cs._agreement(out, want, cs.NORM_ELT_REL, cs.NORM_ELT_ABS)
            if not cs._agrees(agree, cs.NORM_NORM_TOL):
                raise AssertionError(f"{name} {plan}: {agree}")
            fns[f"{name} {plan}"] = fn
        reads = {k: [] for k in fns}
        for r in range(ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                reads[k].append(cs.device_ms(fns[k], "rmsnorm", iters=40))
        line = "  ".join(f"{k}: {statistics.median(v):.5f} ms "
                         f"({bound / statistics.median(v):.3f})"
                         for k, v in reads.items())
        cs.log(f"[plans] N={n} D={D} {str(dtype)[6:]} x "
               f"{n * row_bytes / 2**20:.0f} MiB, bound {bound:.5f} ms | "
               f"{line}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
