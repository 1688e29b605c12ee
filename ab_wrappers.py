#!/usr/bin/env python3
"""The port's kernel wrappers compared between checkouts on one NVIDIA GPU.

    python3 ab_wrappers.py [--jsonl PATH] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (``.`` for this
one; another commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). The trees run in the order given (name one twice
to alternate: ``OLD . . OLD``), each in a process of its own that builds
and imports that tree's ``raytpu_torch`` and measures it with this
checkout's ``chip_smoke.py`` helpers:

- the six RMSNorm cases of ``chip_smoke.py``'s kernels phase: agreement
  with the plain version, CUDA-event time, device time (profiler), the
  wrapper's host time a call, the plain version's and ``F.rms_norm``'s
  times;
- the device time and host time a call of the other four wrappers at
  the main paths' small and large shapes, and a checksum of each output
  (the same inputs in every tree, so equal checksums mean equal results);
- the host time of each piece of the RMSNorm wrapper's path at
  ``[8, 4096]`` bf16 (the split).

Each run prints a summary, and its JSON line goes to PATH where
``--jsonl`` names one. Exits non-zero if a run fails or a kernel
disagrees with its plain version.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
CHILD_TIMEOUT_S = 900


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path: a tree under test
    holds a chip_smoke.py of its own."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  HERE / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _checksum(*tensors) -> float:
    return float(sum(t.double().sum().item() for t in tensors))


def rmsnorm_cases(cs, torch) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, rows = torch.bfloat16, []
    for n, d, dtype in ((8192, 4096, bf16), (512, 4096, bf16),
                        (8, 4096, bf16), (8192, 4096, torch.float32),
                        (64, 4100, bf16), (4096, 4096, bf16)):
        row = cs.rmsnorm_case(n, d, dtype, gen)
        if not cs._agrees(row, cs.NORM_NORM_TOL):
            raise AssertionError(f"rmsnorm disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def other_wrappers(cs, torch) -> dict:
    """Device time, host time a call and output checksum of the flash
    forward, dQ, dK/dV and paged wrappers at serve and train shapes
    (host time over 1000 calls where the device takes less than the
    host, 100 where it takes more)."""
    import numpy as np

    from raytpu_torch.ops.flash_attention import (flash_attention,
                                                  flash_bwd_dkv, flash_bwd_dq)
    from raytpu_torch.ops.paged_attention import paged_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for name, (b, h, t, d) in (("flash_forward gpt2-prefill",
                                (1, 12, 256, 64)),
                               ("flash_forward llama-train",
                                (2, 32, 4096, 128))):
        q, k, v = (cs._randn((b, h, t, d), gen) for _ in range(3))

        def fwd():
            return flash_attention(q, k, v, causal=True)

        with torch.no_grad():
            host = cs.host_us(fwd, calls=1000 if t < 1024 else 100)
        out[name] = {"device_ms": cs.device_ms(fwd, "flash_forward"),
                     "host_us": host, "checksum": _checksum(*fwd())}
    q, k, v, g = (cs._randn((8, 12, 1024, 64), gen) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=True)
    delta = torch.sum(g.float() * o.float(), dim=-1)
    scale = 64 ** -0.5
    for name, fn in (
            ("flash_bwd_dq", lambda: [flash_bwd_dq(q, k, v, g, lse, delta,
                                                   True, scale)]),
            ("flash_bwd_dkv", lambda: flash_bwd_dkv(q, k, v, g, lse, delta,
                                                    True, scale))):
        out[f"{name} gpt2-train"] = {
            "device_ms": cs.device_ms(fn, name),
            "host_us": cs.host_us(fn, calls=100),
            "checksum": _checksum(*fn())}
    rng = np.random.default_rng(4)
    for name, (b, hd, d, n_pg) in (("paged gpt2-decode", (8, 12, 64, 64)),
                                   ("paged llama-decode",
                                    (8, 32, 128, 128))):
        num_pages = b * n_pg + 1
        kp, vp = (cs._randn((num_pages, 16, hd, d), gen) for _ in range(2))
        tables = rng.permutation(np.arange(1, num_pages)).reshape(b, n_pg)
        pos = rng.integers(64, n_pg * 16 - 1, size=(b, 1))
        qd = cs._randn((b, 1, hd, d), gen)
        bt = torch.from_numpy(tables.astype(np.int32)).cuda()
        pt = torch.from_numpy(pos.astype(np.int32)).cuda()

        def paged():
            return paged_attention(qd, kp, vp, bt, pt)

        out[name] = {"device_ms": cs.device_ms(paged, "paged_"),
                     "host_us": cs.host_us(paged, calls=1000),
                     "checksum": _checksum(paged())}
    return out


def rmsnorm_split(cs, torch) -> dict:
    """Host µs a call of each piece of the RMSNorm wrapper's path at
    [8, 4096] bf16, each timed alone (``chip_smoke.host_us``)."""
    from raytpu_torch.ops import _native, fused

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = cs._randn((8, 4096), gen)
    s = 1.0 + 0.1 * torch.randn(4096, generator=gen, device="cuda")
    eps, d = 1e-5, 4096
    out_t = torch.empty_like(x)
    lib = _native.load("rmsnorm")
    fn = lib.rt_rmsnorm
    stream = torch.cuda.current_stream().cuda_stream

    parent = len(fn.argtypes) == 8  # x, scale, out, n, d, dtype, eps, stream
    if not parent:
        plan = fused.plan_rows(8, 2 * d, _native.sm_count(0))

    def args(rows):
        if parent:
            return (x.data_ptr(), s.data_ptr(), out_t.data_ptr(), rows, d, 1,
                    eps, stream)
        return (x.data_ptr(), s.data_ptr(), out_t.data_ptr(), rows, d, 1, 0,
                eps, *plan, stream)

    def check():
        if parent:  # one call a tensor
            _native.check_inputs("rmsnorm", x.device, x.dtype, x)
            _native.check_inputs("rmsnorm", x.device, torch.float32, s)
        else:  # one pass
            _native.check_inputs("rmsnorm", x.get_device(), None, x, s)

    def context():
        with torch.cuda.device(x.device):
            pass

    pieces = {
        "Function.apply": lambda: fused._RMSNorm.apply(x, s, eps, None),
        "_rmsnorm_cuda": lambda: fused._rmsnorm_cuda(x, s, eps),
        "reshape+contiguous": lambda: x.reshape(-1, d).contiguous(),
        "scale.to(fp32)": lambda: s.to(torch.float32).contiguous(),
        "check_inputs": check,
        "empty_like": lambda: torch.empty_like(x),
        "_native.load": lambda: _native.load("rmsnorm"),
        "x.device": lambda: x.device,
        "torch.cuda.device context": context,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "current_device": torch.cuda.current_device,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "data_ptr x3": lambda: (x.data_ptr(), s.data_ptr(),
                                out_t.data_ptr()),
        "ctypes call, no launch (n_rows 0)": lambda: fn(*args(0)),
        "ctypes call and launch": lambda: fn(*args(8)),
    }
    if not parent:
        pieces["plan_rows, cached"] = lambda: fused._plan(
            8, 2 * d, _native.sm_count(0))
        pieces["_native.launch"] = lambda: _native.launch(
            "rmsnorm", 0, *args(8)[:-1])
    split = {}
    with torch.no_grad():
        split["rmsnorm, no_grad"] = cs.host_us(
            lambda: fused.rmsnorm(x, s, eps=eps), calls=1000)
        for name, piece in pieces.items():
            split[name] = cs.host_us(piece, calls=1000)
    leaf = s.detach().requires_grad_()
    split["rmsnorm, scale requires grad"] = cs.host_us(
        lambda: fused.rmsnorm(x, leaf, eps=eps), calls=1000)
    return split


def child(tree: str) -> int:
    sys.path.insert(0, str(pathlib.Path(tree).resolve()))
    import torch

    cs = _chip_smoke()
    card = cs.phase_device()
    from raytpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.build()
    result = {"tree": tree, "card": card,
              "package": str(pathlib.Path(_native.__file__).parents[1]),
              "build_s": time.perf_counter() - t0,
              "rmsnorm": rmsnorm_cases(cs, torch),
              "others": other_wrappers(cs, torch),
              "split": rmsnorm_split(cs, torch)}
    print(json.dumps(result), flush=True)
    return 0


def summary(r: dict) -> str:
    lines = [f"== {r['tree']} ({r['package']}) | {r['card']}"]
    for c in r["rmsnorm"]:
        lines.append(
            f"  {c['case']:<28} ms {c['ms']:.4f} dev {c['device_ms']:.4f} "
            f"host_us {c['host_us']:.1f} grad {c['host_us_grad']:.1f} "
            f"bound {c['bound_ms']:.4f} lib {c['library_ms']:.4f} "
            f"lib_dev {c['library_device_ms']:.4f}")
    for name, o in r["others"].items():
        lines.append(f"  {name:<28} dev {o['device_ms']:.4f} host_us "
                     f"{o['host_us']:.1f} checksum {o['checksum']!r}")
    lines.append("  split (µs): " + ", ".join(
        f"{k} {v:.2f}" for k, v in r["split"].items()))
    return "\n".join(lines)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1])
    jsonl = None
    if argv[:1] == ["--jsonl"]:
        jsonl, argv = pathlib.Path(argv[1]), argv[2:]
    results, rc = [], 0
    for tree in argv or ["."]:
        proc = subprocess.run([sys.executable, str(HERE / "ab_wrappers.py"),
                               "--child", tree], capture_output=True,
                              text=True, timeout=CHILD_TIMEOUT_S)
        if proc.returncode != 0:
            print(f"ab_wrappers: {tree} failed ({proc.returncode}):\n"
                  f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}",
                  file=sys.stderr)
            rc = 1
            continue
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(summary(results[-1]), flush=True)
    if jsonl is not None:
        jsonl.parent.mkdir(parents=True, exist_ok=True)
        with open(jsonl, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
