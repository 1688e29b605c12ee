"""Step-level device attribution: live MFU, step-time distributions and
device-memory gauges; the port of ``raytpu/util/stepprof.py``.

The JAX package takes a step's FLOPs from XLA's ``cost_analysis`` of the
compiled program; the port runs eagerly and has no compiled program to
ask, so the engine counts them analytically (:func:`decode_step_flops`),
cached per shape bucket exactly as the JAX engine caches XLA's answer.
MFU is FLOPs / step seconds / :func:`device_peak_flops`.

Every emission site is behind the ``profiling_enabled()`` flag at the
CALLER — this module never checks the flag itself, so a hook pays
exactly one boolean read when profiling is off.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Optional

import torch

from raytpu_torch.util.metrics import Gauge, Histogram

ENV_PEAK_FLOPS = "RAYTPU_CHIP_PEAK_FLOPS"

# Per-card dense bf16 peak FLOP/s by device-name substring (NVIDIA's
# data sheet, without sparsity); first match wins. The H100 SXM names
# itself "NVIDIA H100 80GB HBM3".
PEAK_BY_NAME = (
    ("H100 80GB HBM3", 989e12),
)
# The JAX package's fallback for a device it has no peak for (its CPU):
# MFU then reads as a relative signal instead of an absent series.
_FALLBACK_PEAK_FLOPS = 1e12

_STEP_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def peak_for_name(name: str) -> Optional[float]:
    """The table's peak for a device name, or None when it has none."""
    for sub, peak in PEAK_BY_NAME:
        if sub in name:
            return peak
    return None


def device_peak_flops() -> float:
    """Peak FLOP/s of one local card: ``RAYTPU_CHIP_PEAK_FLOPS``
    override first, then the table by the current card's name, then the
    fallback (no card, or a card the table does not know)."""
    env = os.environ.get(ENV_PEAK_FLOPS, "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if torch.cuda.is_available():
        peak = peak_for_name(torch.cuda.get_device_name())
        if peak is not None:
            return peak
    return _FALLBACK_PEAK_FLOPS


def decode_step_flops(matmul_params: int, n_layer: int, n_head: int,
                      head_dim: int, batch: int, pages: int,
                      page_size: int) -> float:
    """FLOPs of one decode step at batch bucket ``batch`` and block-table
    width ``pages``, counted over the PADDED program, as the JAX
    package's ``cost_analysis`` counts its decode (with the reference
    paged attention, which gathers the whole table):

        2 × matmul_params × batch
          + 4 × n_layer × n_head × head_dim × batch × pages × page_size

    The first term is a multiply and an add per weight per row for every
    product of the step: the attention projections, the MLP and the LM
    head (``matmul_params`` counts their weights; embedding lookups are
    not products). The second is QKᵀ and PV of every query head over
    every slot of the table. XLA's count also holds the elementwise
    work (norms, rotary, softmax, residuals), which this one leaves out.

    This is the work of the padded shapes, not of the kernel: the paged
    kernel stops at each row's last live page (``context_lens``) and a
    padding row attends to one slot, so the attention it does is at most
    the second term, and less for rows shorter than the table."""
    return (2.0 * matmul_params * batch
            + 4.0 * n_layer * n_head * head_dim * batch * pages * page_size)


class StepProfiler:
    """One per process and workload kind (``train`` / ``infer``)."""

    def __init__(self, kind: str = "train"):
        if kind == "train":
            self._mfu = Gauge("raytpu_train_mfu",
                              "model FLOPs utilization per train step")
            self._step = Histogram("raytpu_train_step_seconds",
                                   "train step wall time",
                                   boundaries=_STEP_BUCKETS)
        elif kind == "infer":
            self._mfu = Gauge("raytpu_infer_decode_mfu",
                              "model FLOPs utilization per decode step")
            self._step = Histogram("raytpu_infer_step_seconds",
                                   "decode step wall time",
                                   boundaries=_STEP_BUCKETS)
        else:
            raise ValueError(f"unknown StepProfiler kind {kind!r}")
        self.kind = kind
        self._hbm_used = Gauge("raytpu_hbm_used_bytes",
                               "device memory in use",
                               tag_keys=("device",))
        self._hbm_peak = Gauge("raytpu_hbm_peak_bytes",
                               "device memory high-water mark",
                               tag_keys=("device",))
        self._flops: Dict[object, Optional[float]] = {}
        self._peak: Optional[float] = None
        self._lock = threading.Lock()

    # -- FLOPs accounting --------------------------------------------------

    def ensure_flops(self, key, thunk: Callable[[], Optional[float]]
                     ) -> Optional[float]:
        """Per-bucket cached FLOPs: ``thunk`` runs once per distinct
        ``key``."""
        with self._lock:
            if key in self._flops:
                return self._flops[key]
        flops = thunk()
        flops = float(flops) if flops else None
        with self._lock:
            self._flops[key] = flops
        return flops

    def peak_flops(self) -> float:
        if self._peak is None:
            self._peak = device_peak_flops()
        return self._peak

    # -- emission (callers guard with profiling_enabled()) -----------------

    def observe_step(self, dt_s: float, key=None,
                     flops: Optional[float] = None) -> None:
        """One step took ``dt_s`` seconds; emit the step-time histogram
        and, when per-step FLOPs are known (explicit or cached under
        ``key``), the MFU gauge."""
        dt_s = float(dt_s)
        if dt_s <= 0:
            return
        self._step.observe(dt_s)
        if flops is None and key is not None:
            with self._lock:
                flops = self._flops.get(key)
        if flops:
            self._mfu.set(min(1.0, float(flops) / dt_s /
                              self.peak_flops()))

    def observe_hbm(self, device: torch.device) -> None:
        """Device-memory gauges of ``device`` from the caching
        allocator's statistics (``allocated_bytes.all.current`` and
        ``.peak``: ``torch.cuda.memory_allocated`` and
        ``max_memory_allocated``), tagged ``"<name>:<index>"``. A quiet
        no-op for a CPU device, as the JAX package's is on its CPU."""
        if device.type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        tag = {"device": f"{torch.cuda.get_device_name(device)}:"
                         f"{device.index}"}
        used = stats.get("allocated_bytes.all.current")
        peak = stats.get("allocated_bytes.all.peak")
        if used is not None:
            self._hbm_used.set(float(used), tags=tag)
        if peak is not None:
            self._hbm_peak.set(float(peak), tags=tag)


_profilers: Dict[str, StepProfiler] = {}
_factory_lock = threading.Lock()


def step_profiler(kind: str = "train") -> StepProfiler:
    """Process-wide singleton per kind, so every engine books into the
    same series."""
    with _factory_lock:
        sp = _profilers.get(kind)
        if sp is None:
            sp = _profilers[kind] = StepProfiler(kind)
        return sp
