"""The host's cards, the port's counterpart of
:func:`raytpu.core.topology.detect_local_tpu` and only that: a card has
no ICI box to place on.

Like the TPU function it never creates a device context: it counts the
cards through NVML (``nvmlDeviceGetCount``, the driver's management
library, loaded with ``ctypes``), never through ``torch.cuda``, whose
first query fixes the process's visible cards (a child bound later
could not change them). NVML sees the cards the container was given, as
CUDA does; the driver's files do not (``/proc/driver/nvidia/gpus`` and
the ``/dev/nvidia<N>`` nodes may name cards of the host this process
cannot open). Without NVML (no driver) there is no card. What the
process's ``CUDA_VISIBLE_DEVICES`` leaves of them is what it may hand
out.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

NVML_LIBRARY = "libnvidia-ml.so.1"


def _host_cards() -> int:
    """The cards NVML counts (0 without NVML)."""
    try:
        nvml = ctypes.CDLL(NVML_LIBRARY)
    except OSError:
        return 0
    if nvml.nvmlInit_v2() != 0:
        return 0
    try:
        count = ctypes.c_uint(0)
        if nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
            return 0
        return int(count.value)
    finally:
        nvml.nvmlShutdown()


def visible_ids(env: Optional[str], host_cards: int) -> List[str]:
    """The cards a process may use, by the ids its
    ``CUDA_VISIBLE_DEVICES`` (``env``, None when unset) names, in its
    order: every card of the host when unset; none for an empty value or
    from the first invalid entry on (``-1``, an index past the host's),
    as CUDA reads the variable. A UUID (``GPU-...``, ``MIG-...``) counts
    as one card."""
    if env is None:
        return [str(i) for i in range(host_cards)]
    out: List[str] = []
    for entry in (e.strip() for e in env.split(",")):
        if entry.startswith(("GPU-", "MIG-")):
            out.append(entry)
            continue
        if not entry.isdigit() or int(entry) >= host_cards:
            break  # CUDA stops at the first entry it cannot read
        out.append(entry)
    return out


def detect_local_gpus() -> Dict[str, object]:
    """The cards this process may hand out: ``{"gpus": count, "ids":
    [the CUDA_VISIBLE_DEVICES entry of each]}``, read without touching
    CUDA."""
    ids = visible_ids(os.environ.get("CUDA_VISIBLE_DEVICES"), _host_cards())
    return {"gpus": len(ids), "ids": ids}


def bind_card(visible: str) -> None:
    """Bind this process to the cards its grant names (their
    ``CUDA_VISIBLE_DEVICES`` entries, comma-separated), before its first
    CUDA call: its device is then ``cuda:0``. Raises where CUDA is
    already set up in this process (it would keep the cards it saw)."""
    import torch

    bad_fork = getattr(torch.cuda, "_is_in_bad_fork", lambda: False)()
    if torch.cuda.is_initialized() or bad_fork:
        raise RuntimeError(
            f"cannot bind this process to card(s) {visible!r}: CUDA was set "
            f"up in it already (a CUDA call before the binding, or in the "
            f"process it was forked from)")
    if not visible:
        raise RuntimeError("a card binding names no card")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
