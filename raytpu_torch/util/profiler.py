"""The profiling flag; the part of ``raytpu/util/profiler.py`` that the
engine's step profiler reads. The JAX package's continuous sampler (the
duty-cycled stack sampler and its shipping) is not ported."""

from __future__ import annotations

import os

ENV_PROFILE = "RAYTPU_PROFILE_CONTINUOUS"

_profile_enabled = os.environ.get(ENV_PROFILE, "") in ("1", "true", "True")


def profiling_enabled() -> bool:
    """THE flag check: every step-profiler emission site guards with
    exactly this call, so the default-off mode costs one boolean read
    per site."""
    return _profile_enabled


def enable_profiling(env: bool = False) -> None:
    global _profile_enabled
    _profile_enabled = True
    if env:
        os.environ[ENV_PROFILE] = "1"


def disable_profiling(env: bool = False) -> None:
    global _profile_enabled
    _profile_enabled = False
    if env:
        os.environ[ENV_PROFILE] = "0"
