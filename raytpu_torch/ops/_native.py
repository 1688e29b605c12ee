"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, and loaded with
``ctypes``. The build runs at first use, into ``raytpu_torch/_build/``
(listed in ``.gitignore``), under a file name keyed by a hash of the
sources and the flags: an edited source rebuilds, an unchanged one is
reused. Missing libraries are compiled together, one ``nvcc`` each.

Nothing here is imported from, or needed by, the CPU path: the plain
PyTorch versions beside each kernel never touch this module's build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
# Headers the kernels include; every library's name hashes all of them.
HEADERS = ("attention_mma.cuh", "attention_tile.cuh", "flash_bwd_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HEAD_DIMS = (32, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library name -> (C entry point, its argument types)
KERNELS = {
    "flash_attention": ("rt_flash_forward",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    "paged_attention": ("rt_paged_attention",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _F, _P]),
    "flash_bwd_dq": ("rt_flash_bwd_dq",
                     [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                      _P]),
    "flash_bwd_dkv": ("rt_flash_bwd_dkv",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _F, _P]),
    "rmsnorm": ("rt_rmsnorm", [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                               _P]),
}
# Measuring kernels on no main path (built and loaded the same way).
TOOLS = {
    "mma_probe": ("rt_mma_probe", [_P, _P, _P, _P, _I, _I, _I, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, ctypes._CFuncPtr] = {}


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one each time it
    launches the kernel, and nowhere else."""

    def __init__(self):
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def nvcc_command(nvcc: str, source: pathlib.Path,
                 output: pathlib.Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(output), str(source)]


def find_nvcc() -> str:
    home = pathlib.Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", *HEADERS):
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile the libraries that are not built yet (by default every
    kernel's and every tool's), all at once; returns the seconds each
    build took (0.0 for one already built). The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    names = list(names or [*KERNELS, *TOOLS])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(nvcc_command(nvcc, CSRC / f"{name}.cu", tmp),
                                stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, log, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in running.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        entry, argtypes = {**KERNELS, **TOOLS}[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def entry(name: str):
    """The C entry point of the kernel library ``name`` (built and loaded
    if needed), its argument types declared; kept, so that a launch looks
    nothing up on the library."""
    fn = _entries.get(name)
    if fn is None:
        entry_point = {**KERNELS, **TOOLS}[name][0]
        fn = _entries[name] = getattr(load(name), entry_point)
    return fn


def launch(what: str, index: int, *args) -> None:
    """Call kernel library ``what``'s entry point with ``args`` and the
    current stream of CUDA device ``index``, and raise if the launch
    failed. The stream's handle is read on every call and nothing here
    synchronises or allocates (a graph capture's side stream is honoured);
    the device is made current only where it is not already."""
    fn = _entries.get(what) or entry(what)
    if index == torch.cuda.current_device():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        check_launch(_libs[what], rc, what)


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (asked once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dtype_code(what: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    return DTYPE_CODES[dtype]


def check_inputs(what: str, index: int, dtype: Optional[torch.dtype],
                 *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on device ``index`` (the kernels load 16-byte vectors), of
    ``dtype`` unless that is None; one pass, no device objects built."""
    for x in tensors:
        if not x.is_cuda or x.get_device() != index:
            raise ValueError(f"{what}: all inputs must be on one CUDA "
                             f"device, got {x.device} and device {index}")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{what}: expected {dtype}, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             f"16-byte aligned")
