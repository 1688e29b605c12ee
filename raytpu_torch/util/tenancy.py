"""Tenant identity propagation: the port of :mod:`raytpu.util.tenancy`.

The tenant is an ambient identity a program declares with the
``RAYTPU_TENANT`` environment variable (read once at import) or scopes
with :func:`tenant_scope`. The serve router stamps it into each request's
metadata (``raytpu_torch/serve/_private/router.py``), where a replica's
user code and the serving ledger read it. ``to_wire``/``from_wire`` are
the JAX package's frame helpers, kept as they are.

Not ported: the RPC frame's ``"tn"`` field and the head's quotas and fair
queueing that key off it (the port has no cluster).
"""

from __future__ import annotations

import contextvars
import os
from contextlib import contextmanager
from typing import Any, Optional

ENV_VAR = "RAYTPU_TENANT"

# The accounting bucket for traffic that declares no tenant at all.
# With RAYTPU_TENANTS=1 the head books untenanted work here so system
# traffic and older programs still fall under *some* quota row.
DEFAULT_TENANT = "default"

# Process-level default, read once at import (workers and cluster
# daemons inherit os.environ, the failpoints/tracing arming pattern).
_env_default = os.environ.get(ENV_VAR, "") or ""

_current: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("raytpu_tenant", default=None)


def current_tenant() -> str:
    """The ambient tenant identity: innermost :func:`tenant_scope` or
    re-anchored frame value, else the process ``RAYTPU_TENANT`` default,
    else ``""`` (untenanted)."""
    t = _current.get()
    if t is not None:
        return t
    return _env_default


def set_current_tenant(tenant: Optional[str]):
    """Anchor ``tenant`` as the ambient identity; returns a reset token
    (``RpcServer._dispatch`` re-anchors per dispatch task with this)."""
    return _current.set(tenant)


def reset_current_tenant(token) -> None:
    _current.reset(token)


def set_process_tenant(tenant: str, env: bool = False) -> None:
    """Set the process-level default tenant. ``env=True`` additionally
    exports it so subprocesses spawned afterwards inherit it (the
    ``cfg(env=True)`` pattern from failpoints/tracing)."""
    global _env_default
    _env_default = str(tenant or "")
    if env:
        if _env_default:
            os.environ[ENV_VAR] = _env_default
        else:
            os.environ.pop(ENV_VAR, None)


@contextmanager
def tenant_scope(tenant: str):
    """Scope a tenant identity over a block of code::

        with tenancy.tenant_scope("team-interactive"):
            ref = f.remote()          # spec + frames carry the tenant
    """
    token = _current.set(str(tenant))
    try:
        yield
    finally:
        _current.reset(token)


def to_wire() -> Optional[str]:
    """The ``"tn"`` frame stamp: a plain str (strict-wire primitive), or
    None when no tenant is ambient (the field is then omitted — the
    untenanted wire is byte-identical to the pre-tenancy wire)."""
    t = current_tenant()
    return t or None


def from_wire(value: Any) -> Optional[str]:
    """Validate an inbound ``"tn"`` field (untrusted peer bytes)."""
    if isinstance(value, str) and value:
        return value
    return None
