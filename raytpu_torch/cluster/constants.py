"""The tuning constants of ``raytpu/cluster/constants.py`` that the
port's serving plane reads, under the same names and the same
environment overrides (``RAYTPU_<NAME>``), read once at import as the JAX
package reads them. Callers read them as module attributes at call time
(``constants.KV_STREAM_CHUNK_BYTES``), so a test can patch one."""

from __future__ import annotations

import os


def _f(name: str, default: float) -> float:
    return float(os.environ.get(f"RAYTPU_{name}", str(default)))


def _i(name: str, default: int) -> int:
    return int(os.environ.get(f"RAYTPU_{name}", str(default)))


# Process-wide in-flight transfer payload budget in BYTES, shared by every
# concurrent transfer (raytpu/cluster/constants.py:139).
TRANSFER_WINDOW_BYTES = _i("TRANSFER_WINDOW_BYTES", 64 * 1024 * 1024)
# Cap on digests per replica prefix summary (oldest registrations first;
# raytpu/cluster/constants.py:265).
PREFIX_SUMMARY_MAX = _i("PREFIX_SUMMARY_MAX", 1024)
# Chunk size for streaming KV pages between replicas during a
# disaggregated prefill->decode handoff; each chunk is admitted through
# the transfer ByteWindow (raytpu/cluster/constants.py:277).
KV_STREAM_CHUNK_BYTES = _i("KV_STREAM_CHUNK_BYTES", 262144)
# How long a prefill replica keeps an opened-but-unfinished KV export
# pinned before assuming the decode peer died and freeing the pages
# (raytpu/cluster/constants.py:280).
KV_HANDOFF_TTL_S = _f("KV_HANDOFF_TTL_S", 30.0)
