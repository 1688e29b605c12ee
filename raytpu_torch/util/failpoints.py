"""Deterministic failpoint injection for chaos testing; the port's copy
of :mod:`raytpu.util.failpoints`.

Production code is threaded with *named* failpoints that compile to
near-zero no-ops until a test arms them with an action expression (the
``fail::fail_point!()`` family of TiKV/etcd). Armed failpoints can
raise, delay, kill the process, or tell the call site to drop a message
— gated by counts and probabilities so multi-step recovery scenarios
(e.g. "drop the first 3 heartbeats, then behave") are expressed in one
string.

Expression grammar (TiKV ``fail-rs`` style)::

    spec  := term ("->" term)*
    term  := [PCT "%"] [CNT "*"] action
    action := "off" | "drop" | "kill_process"
            | "raise(" EXC [",MSG"] ")" | "delay(" SECONDS ")"

Terms are consumed left to right: a ``CNT*``-gated term fires CNT times
then yields to the next term; a term without a count fires forever.
``PCT%`` gates each evaluation on a *deterministically seeded* RNG
(seed = ``RAYTPU_TORCH_FAILPOINTS_SEED`` env, default 0; the same draws
as the JAX package's for the same seed) so probabilistic chaos runs are
still reproducible.

Examples::

    failpoints.cfg("disagg.read_chunk", "1*raise(OSError)")
    failpoints.cfg("disagg.pull_chunk", "2*off->1*raise(ConnectionError)")
    failpoints.cfg("transfer.fetch", "50%raise(OSError)")

Activation channels:

- **Python API** — ``cfg()`` / ``off()`` / ``clear()`` in-process.
- **Env var** — ``RAYTPU_TORCH_FAILPOINTS="name=spec;name2=spec2"``
  parsed at import, so worker processes of the port's runtime (which
  inherit ``os.environ``) arm themselves; ``cfg(..., env=True)``
  additionally exports the spec so processes spawned *after* the call
  inherit it. The port reads its own variables, never the JAX
  package's: arming one package in a process that runs both never arms
  the other.

What it leaves out: the JAX package's head-RPC arming of running remote
processes (the port has no head); to arm a running worker, call ``cfg``
inside it (``runtime.call``).

Call sites do::

    act = failpoint("disagg.read_chunk")
    if act is DROP:
        return  # swallow the message

``failpoint()`` raises / sleeps / kills internally; the only return
values are ``None`` (no-op) and the ``DROP`` sentinel for sites that
support swallowing a message.

Every evaluation and fire is counted (``stat()``), so chaos tests can
assert "the failpoint fired exactly N times" instead of sleeping and
hoping.
"""

from __future__ import annotations

import os
import random
import re
import signal
import threading
import time
from typing import Dict, List, Optional

ENV_VAR = "RAYTPU_TORCH_FAILPOINTS"
SEED_ENV_VAR = "RAYTPU_TORCH_FAILPOINTS_SEED"


class DROP:  # sentinel: call site should swallow the message
    """Returned by :func:`failpoint` when a ``drop`` action fires."""

    def __init__(self):  # pragma: no cover - never instantiated
        raise TypeError("DROP is a sentinel, not a class to instantiate")


class FailpointError(ValueError):
    """Malformed failpoint spec."""


_TERM_RE = re.compile(
    r"^(?:(?P<pct>\d+(?:\.\d+)?)%)?"
    r"(?:(?P<cnt>\d+)\*)?"
    r"(?P<action>[a-z_]+)"
    r"(?:\((?P<args>[^)]*)\))?$"
)

_ACTIONS = ("off", "drop", "kill_process", "raise", "delay")


def _resolve_exc(name: str):
    """Exception class by name: builtins, then raytpu_torch.core.errors."""
    import builtins

    cls = getattr(builtins, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    try:
        from raytpu_torch.core import errors as _errors

        cls = getattr(_errors, name, None)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            return cls
    except Exception:  # pragma: no cover - errors module always imports
        pass
    raise FailpointError(f"unknown exception class {name!r} "
                         "(must be a builtin or raytpu_torch.core.errors name)")


class _Term:
    __slots__ = ("pct", "remaining", "action", "arg", "text")

    def __init__(self, text: str):
        m = _TERM_RE.match(text.strip())
        if m is None:
            raise FailpointError(f"bad failpoint term {text!r}")
        self.text = text.strip()
        self.pct = float(m.group("pct")) / 100.0 if m.group("pct") else None
        self.remaining = int(m.group("cnt")) if m.group("cnt") else None
        self.action = m.group("action")
        if self.action not in _ACTIONS:
            raise FailpointError(
                f"unknown failpoint action {self.action!r} "
                f"(expected one of {_ACTIONS})")
        args = (m.group("args") or "").strip()
        if self.action == "raise":
            if not args:
                raise FailpointError("raise() needs an exception class name")
            parts = [p.strip() for p in args.split(",", 1)]
            self.arg = (_resolve_exc(parts[0]),
                        parts[1] if len(parts) > 1 else None)
        elif self.action == "delay":
            if not args:
                raise FailpointError("delay() needs seconds")
            try:
                self.arg = float(args)
            except ValueError:
                raise FailpointError(
                    f"delay() needs numeric seconds, got {args!r}") from None
            if self.arg < 0:
                raise FailpointError("delay() seconds must be >= 0")
        else:
            if args:
                raise FailpointError(
                    f"action {self.action!r} takes no arguments")
            self.arg = None


class _Failpoint:
    __slots__ = ("name", "spec", "terms", "hits", "fires", "_rng", "_lock")

    def __init__(self, name: str, spec: str):
        terms = [_Term(t) for t in spec.split("->")]
        if not terms:
            raise FailpointError("empty failpoint spec")
        self.name = name
        self.spec = spec
        self.terms = terms
        self.hits = 0
        self.fires = 0
        # Deterministic per-failpoint RNG: probability gates reproduce
        # exactly across runs for a fixed seed.
        seed = int(os.environ.get(SEED_ENV_VAR, "0") or "0")
        self._rng = random.Random(f"{seed}:{name}")
        self._lock = threading.Lock()

    def trigger(self):
        """Evaluate the failpoint once. Executes the current term's
        action (raise / sleep / kill) or returns DROP / None."""
        with self._lock:
            self.hits += 1
            term = self.terms[0] if self.terms else None
            if term is None:
                return None
            if term.pct is not None and self._rng.random() >= term.pct:
                return None  # probability gate: skipped, count not consumed
            if term.remaining is not None:
                term.remaining -= 1
                if term.remaining <= 0:
                    self.terms.pop(0)
            if term.action == "off":
                return None
            self.fires += 1
            action, arg = term.action, term.arg
        # Execute outside the lock: delay must not serialize other
        # threads' evaluations, and raise must not poison the lock.
        if action == "drop":
            return DROP
        if action == "raise":
            exc_cls, msg = arg
            raise exc_cls(msg if msg is not None
                          else f"failpoint {self.name!r} fired")
        if action == "delay":
            time.sleep(arg)
            return None
        if action == "kill_process":
            # SIGKILL, like a real crash: no cleanup, no atexit — the
            # exact signal a chaos test wants to survive.
            os.kill(os.getpid(), signal.SIGKILL)
        return None


# Process-local registry. The hot path reads only this dict: when it is
# empty (the production state) failpoint() is a function call plus one
# truthiness check. Mutation goes through _REG_LOCK.
_REG: Dict[str, _Failpoint] = {}
_REG_LOCK = threading.Lock()


def failpoint(name: str):
    """Evaluate the named failpoint. Near-zero-cost no-op (one empty-dict
    check) when nothing is armed. Returns ``DROP`` when a drop action
    fires, else ``None``; raise/delay/kill happen internally."""
    if not _REG:
        return None
    fp = _REG.get(name)
    if fp is None:
        return None
    return fp.trigger()


def cfg(name: str, spec: str, env: bool = False) -> None:
    """Arm (or re-arm) a failpoint with an action expression.

    ``env=True`` additionally exports the registry to the
    ``RAYTPU_TORCH_FAILPOINTS`` env var so subprocesses spawned
    afterwards (the runtime's workers) inherit the armed state.
    """
    fp = _Failpoint(name, spec)  # validate before mutating the registry
    with _REG_LOCK:
        _REG[name] = fp
    if env:
        _export_env()


def off(name: str, env: bool = False) -> None:
    """Disarm a single failpoint (no-op if it isn't armed)."""
    with _REG_LOCK:
        _REG.pop(name, None)
    if env:
        _export_env()


def clear(env: bool = True) -> None:
    """Disarm every failpoint and (by default) scrub the env var so no
    later subprocess inherits stale chaos state."""
    with _REG_LOCK:
        _REG.clear()
    if env:
        os.environ.pop(ENV_VAR, None)


def active() -> Dict[str, str]:
    """Currently armed failpoints: ``{name: original spec}``."""
    with _REG_LOCK:
        return {name: fp.spec for name, fp in _REG.items()}


def stat(name: str) -> Optional[dict]:
    """Counters for one failpoint: ``{"spec", "hits", "fires",
    "exhausted"}`` — or None if it was never armed (or already cleared).

    ``hits`` counts evaluations, ``fires`` counts actions actually
    taken; ``exhausted`` is True once every count-gated term is spent.
    Chaos tests assert on these instead of sleeping and hoping.
    """
    fp = _REG.get(name)
    if fp is None:
        return None
    with fp._lock:
        return {"spec": fp.spec, "hits": fp.hits, "fires": fp.fires,
                "exhausted": not fp.terms}


def stats() -> Dict[str, dict]:
    """``stat()`` for every armed failpoint."""
    with _REG_LOCK:
        names = list(_REG)
    out = {}
    for n in names:
        s = stat(n)
        if s is not None:
            out[n] = s
    return out


def wait_fired(name: str, times: int = 1, timeout: float = 10.0) -> bool:
    """Block until the named failpoint has fired >= ``times`` (bounded
    poll; returns False on timeout). Lets tests synchronize on 'the
    fault has actually been injected' instead of sleeping a guess."""
    deadline = time.monotonic() + timeout
    while True:
        s = stat(name)
        if s is not None and s["fires"] >= times:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)


# -- env propagation --------------------------------------------------------


def _export_env() -> None:
    with _REG_LOCK:
        specs = {name: fp.spec for name, fp in _REG.items()}
    if specs:
        os.environ[ENV_VAR] = ";".join(
            f"{n}={s}" for n, s in sorted(specs.items()))
    else:
        os.environ.pop(ENV_VAR, None)


def parse_env(value: str) -> Dict[str, str]:
    """Parse ``name=spec;name2=spec2`` (whitespace-tolerant)."""
    out: Dict[str, str] = {}
    for part in value.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise FailpointError(
                f"bad {ENV_VAR} entry {part!r} (expected name=spec)")
        name, spec = part.split("=", 1)
        out[name.strip()] = spec.strip()
    return out


def load_env(value: Optional[str] = None) -> List[str]:
    """Arm failpoints from ``RAYTPU_TORCH_FAILPOINTS`` (or an explicit
    string). Called once at import; safe to call again after mutating
    the env var. Returns the names armed."""
    raw = os.environ.get(ENV_VAR, "") if value is None else value
    if not raw:
        return []
    names = []
    for name, spec in parse_env(raw).items():
        cfg(name, spec)
        names.append(name)
    return names


# The runtime's worker processes inherit os.environ — arming happens
# here, at first import.
load_env()
