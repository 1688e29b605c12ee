"""Opt-out usage stats — local collection only: the port's copy of
:mod:`raytpu.util.usage_stats`, with torch's version where the JAX
package reports JAX's.

Reference analogue: ``python/ray/_private/usage/usage_lib.py`` — Ray
records cluster metadata and library usage and (unless
``RAY_USAGE_STATS_ENABLED=0``) reports it. Ours keeps the same shape with
a privacy-first default for this environment: collection is in-process,
the report is written to a local JSON file under the session temp dir,
and nothing ever leaves the machine (the reporter interface is pluggable
so an operator can point it at their own endpoint).

Env knobs: ``RAYTPU_USAGE_STATS_ENABLED`` (default "1" — local file
only), ``RAYTPU_USAGE_STATS_PATH`` (default: ``<tmp>/usage_stats.json``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

_lock = threading.Lock()
_features: Dict[str, int] = {}
_extra: Dict[str, Any] = {}


def enabled() -> bool:
    return os.environ.get("RAYTPU_USAGE_STATS_ENABLED", "1") != "0"


def record_library_usage(name: str) -> None:
    """Count a feature/library touch (reference:
    ``usage_lib.record_library_usage``). Cheap; safe to call per-init."""
    if not enabled():
        return
    with _lock:
        _features[name] = _features.get(name, 0) + 1


def record_extra(key: str, value: Any) -> None:
    if not enabled():
        return
    with _lock:
        _extra[key] = value


def _cluster_metadata() -> Dict[str, Any]:
    import platform

    from raytpu_torch._version import __version__

    meta = {
        "raytpu_version": __version__,
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
        "timestamp": int(time.time()),
    }
    try:
        import torch

        meta["torch_version"] = torch.__version__
    except Exception:
        pass
    return meta


def report(path: Optional[str] = None) -> Optional[str]:
    """Write the usage report locally; returns the path (None when
    disabled). Called at shutdown by the runtime; never raises."""
    if not enabled():
        return None
    try:
        path = path or os.environ.get(
            "RAYTPU_USAGE_STATS_PATH",
            os.path.join(os.environ.get("TMPDIR", "/tmp"),
                         "raytpu_usage_stats.json"))
        with _lock:
            payload = {
                **_cluster_metadata(),
                "library_usages": dict(_features),
                "extra": dict(_extra),
            }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        return path
    except Exception:
        return None


def reset() -> None:
    with _lock:
        _features.clear()
        _extra.clear()
