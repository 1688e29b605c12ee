"""The port's failpoints (raytpu_torch/util/failpoints.py) against the
JAX package's (raytpu/util/failpoints.py), on the CPU: the same specs
and seeds give the same sequence of fires and the same counts; the same
specs are refused; each package arms itself from its own environment
variable only; ``cfg(env=True)`` arms the port's worker processes
spawned after it, where ``kill_process`` ends the worker.

Armed failpoints are process-wide, so the fixture below clears both
packages' and their variables after every test: nothing armed here
leaks into another test. Workers import this module by name, so it
imports nothing of JAX or of the JAX package at its top level."""

import os

import pytest

from raytpu_torch import runtime
from raytpu_torch.core.errors import ActorDiedError
from raytpu_torch.util import failpoints as port_fp

# kill_process would end this process: the worker test below fires it.
SPECS = ["50%raise(OSError)", "3*off->2*raise(ConnectionError)->off",
         "25%2*drop->10%delay(0)", "40%3*raise(OSError)->drop", "drop",
         "70%raise(KeyError,gone)"]


@pytest.fixture
def both(monkeypatch):
    """Both packages' failpoint modules, cleared after the test together
    with their environment variables."""
    from raytpu.util import failpoints as jax_fp

    yield {"jax": jax_fp, "port": port_fp}
    for fp in (jax_fp, port_fp):
        fp.clear(env=True)
    assert port_fp.active() == {} and jax_fp.active() == {}


def draws(fp, name: str, spec: str, n: int) -> list:
    """What ``n`` evaluations of an armed failpoint do, one word each,
    then its counts."""
    fp.cfg(name, spec)
    out = []
    for _ in range(n):
        try:
            act = fp.failpoint(name)
            out.append("drop" if act is fp.DROP else "none")
        except Exception as exc:
            out.append(f"{type(exc).__name__}:{exc}")
    return out + [fp.stat(name)]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("seed", ["0", "7"])
def test_the_same_spec_and_seed_fire_alike(both, monkeypatch, spec, seed):
    monkeypatch.setenv("RAYTPU_FAILPOINTS_SEED", seed)
    monkeypatch.setenv("RAYTPU_TORCH_FAILPOINTS_SEED", seed)
    got = {tag: draws(fp, "disagg.read_chunk", spec, 40)
           for tag, fp in both.items()}
    assert got["jax"] == got["port"]
    assert got["port"][-1]["hits"] == 40


def test_bad_specs_are_refused_alike(both):
    for spec in ("", "raise", "raise(NoSuchError)", "delay(x)",
                 "delay(-1)", "drop(1)", "3*explode", "50%"):
        errors = []
        for fp in both.values():
            with pytest.raises(fp.FailpointError) as err:
                fp.cfg("x", spec)
            errors.append(str(err.value).replace("raytpu_torch.", "raytpu."))
        assert errors[0] == errors[1]


def test_each_package_arms_from_its_own_variable(both, monkeypatch):
    jax_fp = both["jax"]
    monkeypatch.setenv("RAYTPU_TORCH_FAILPOINTS", "a=1*drop; b=off")
    assert port_fp.load_env() == ["a", "b"]
    assert jax_fp.load_env() == []
    assert port_fp.active() == {"a": "1*drop", "b": "off"}
    assert jax_fp.active() == {}
    port_fp.clear(env=True)
    assert "RAYTPU_TORCH_FAILPOINTS" not in os.environ
    monkeypatch.setenv("RAYTPU_FAILPOINTS", "c=drop")
    assert port_fp.load_env() == [] and jax_fp.load_env() == ["c"]
    # cfg(env=True) exports the port's armed set to its variable.
    port_fp.cfg("d", "2*raise(OSError)", env=True)
    assert os.environ["RAYTPU_TORCH_FAILPOINTS"] == "d=2*raise(OSError)"
    assert port_fp.wait_fired("d", 1, timeout=0.01) is False
    with pytest.raises(OSError):
        port_fp.failpoint("d")
    assert port_fp.wait_fired("d", 1, timeout=1.0)
    assert port_fp.stats() == {"d": {"spec": "2*raise(OSError)", "hits": 1,
                                     "fires": 1, "exhausted": False}}


class Chaos:
    def hit(self, name):
        from raytpu_torch.util import failpoints

        failpoints.failpoint(name)
        return failpoints.stat(name)


def test_a_worker_spawned_after_cfg_env_is_armed(both):
    port_fp.cfg("chaos.hit", "1*off->1*kill_process", env=True)
    try:
        worker = runtime.remote(Chaos).remote()
    finally:
        port_fp.clear(env=True)
    first = runtime.get(worker.hit.remote("chaos.hit"), timeout=60)
    assert first == {"spec": "1*off->1*kill_process", "hits": 1,
                     "fires": 0, "exhausted": False}
    with pytest.raises(ActorDiedError, match="exited with code -9"):
        runtime.get(worker.hit.remote("chaos.hit"), timeout=60)
    # This process was never armed by the worker's variable.
    assert port_fp.active() == {}
