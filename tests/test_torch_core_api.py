"""The core API at raytpu_torch's top level, held to the JAX package's.

tests/test_api.py's ``TestPlacementGroups`` (without the TPU-contiguity
case), ``TestUtil``'s actor pool and queue and ``TestIntrospection`` run
as scripts through both packages, each a case parametrised by package:
the JAX package at ``init(num_cpus=4, num_tpus=2)``, the port at
``init(num_cpus=4, num_gpus=2)`` (two pretend cards: its ledger counts
them, its children are bound to them, nothing touches CUDA), the JAX
``"TPU"`` read as the port's ``"GPU"``. Each script's readings, among
them ``available_resources()`` after every step (a creation, an
admission, a kill, a group's creation and removal), must be equal
through both; an error must have the same type.

One runtime of each package for the module. This module imports nothing
of JAX at its top: the port's task workers import it by name.
"""

import importlib
import time

import pytest

import raytpu_torch

T = 60.0
PACKAGES = ("raytpu", "raytpu_torch")


@pytest.fixture(scope="module")
def pkgs():
    """Both packages, initialized with four CPUs and two accelerators;
    task events on in the port (its timeline reads them)."""
    import os

    import raytpu

    from raytpu_torch.util import task_events

    saved = os.environ.get(task_events.ENV_VAR)
    task_events.enable_task_events(env=True)
    raytpu.shutdown()
    raytpu.init(num_cpus=4, num_tpus=2)
    raytpu_torch.init(num_cpus=4, num_gpus=2)
    yield {"raytpu": raytpu, "raytpu_torch": raytpu_torch}
    raytpu.shutdown()
    raytpu_torch.shutdown()
    task_events.disable_task_events()
    if saved is None:
        os.environ.pop(task_events.ENV_VAR, None)
    else:
        os.environ[task_events.ENV_VAR] = saved


def as_port(d: dict) -> dict:
    """A reading of resources with the JAX ``"TPU"`` read as ``"GPU"``."""
    return {("GPU" if k == "TPU" else k): v for k, v in d.items()}


def settled(r, want=None) -> dict:
    """``available_resources()`` once it stops moving (the JAX local
    backend admits and releases on its threads), or once it equals
    ``want``."""
    end = time.monotonic() + T
    last = None
    while time.monotonic() < end:
        now = as_port(r.available_resources())
        if now == want or (want is None and now == last):
            return now
        last = now
        time.sleep(0.05)
    return last


def accel(r, n: float) -> dict:
    """``{"num_tpus": n}`` for the JAX package, ``{"num_gpus": n}`` for
    the port."""
    return {("num_tpus" if r.__name__ == "raytpu" else "num_gpus"): n}


def bundle(r, n: float) -> dict:
    return {("TPU" if r.__name__ == "raytpu" else "GPU"): n}


class Doubler:
    def double(self, x):
        return x * 2


class Holder:
    def ping(self):
        return "ok"


def in_bundle():
    return "in-bundle"


def one():
    return 1


def who(_=None):
    import raytpu_torch as r

    ctx = r.get_runtime_context()
    return ctx.get_task_id() is not None


# ---- the scripts --------------------------------------------------------


def script_basic_pg(r):
    out = []
    pg = r.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    out.append(r.get(pg.ready(), timeout=T))
    out.append(pg.bundle_count)
    out.append(settled(r))
    assert out[-1]["CPU"] == 2.0  # 4 - 2 reserved
    r.remove_placement_group(pg)
    out.append(settled(r))
    assert out[-1]["CPU"] == 4.0
    return out


def script_task_in_pg(r):
    pg = r.placement_group([{"CPU": 2}], strategy="PACK")
    f = r.remote(num_cpus=2)(in_bundle)
    ref = f.options(placement_group=pg,
                    placement_group_bundle_index=0).remote()
    out = [r.get(ref, timeout=T), settled(r)]
    r.remove_placement_group(pg)
    return out + [settled(r)]


def script_scheduling_strategy_object(r):
    strategies = importlib.import_module(
        f"{r.__name__}.util.scheduling_strategies")
    pg = r.placement_group([{"CPU": 1}])
    f = r.remote(num_cpus=1)(one)
    ref = f.options(scheduling_strategy=strategies
                    .PlacementGroupSchedulingStrategy(
                        placement_group=pg,
                        placement_group_bundle_index=0)).remote()
    out = [r.get(ref, timeout=T)]
    r.remove_placement_group(pg)
    return out + [settled(r)]


def script_accelerator_pg_and_actor(r):
    """A group of a whole accelerator and a CPU, an actor admitted into
    it, the actor's kill, the group's removal; then an actor holding one
    accelerator outside any group, and its kill."""
    out = []
    pg = r.placement_group([{"CPU": 1, **bundle(r, 1)}],
                           strategy="STRICT_PACK")
    out.append(settled(r))
    a = r.remote(Holder).options(num_cpus=1, **accel(r, 1),
                                 placement_group=pg,
                                 placement_group_bundle_index=0).remote()
    out.append(r.get(a.ping.remote(), timeout=T))
    out.append(settled(r))
    r.kill(a)
    r.remove_placement_group(pg)
    out.append(settled(r, {"CPU": 4.0, "GPU": 2.0}))
    b = r.remote(Holder).options(num_cpus=1, **accel(r, 1)).remote()
    out.append(r.get(b.ping.remote(), timeout=T))
    out.append(settled(r, {"CPU": 3.0, "GPU": 1.0}))
    r.kill(b)
    out.append(settled(r, {"CPU": 4.0, "GPU": 2.0}))
    return out


def script_actor_pool(r):
    util = importlib.import_module(f"{r.__name__}.util")
    cls = r.remote(Doubler)
    actors = [cls.remote() for _ in range(2)]
    pool = util.ActorPool(actors)
    out = sorted(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [0, 2, 4, 6, 8, 10, 12, 14]
    for a in actors:
        r.kill(a)
    return out


def script_queue(r):
    util = importlib.import_module(f"{r.__name__}.util")
    q = util.Queue(maxsize=2)
    q.put("a")
    q.put("b")
    out = [q.full(), q.get(), q.get(), q.empty()]
    assert out == [True, "a", "b", True]
    errors = importlib.import_module(f"{r.__name__}.util.queue")
    with pytest.raises(errors.Empty):
        q.get(block=False)
    q.shutdown()
    return out


def script_cluster_resources(r):
    out = [as_port(r.cluster_resources()), len(r.nodes())]
    assert out[0]["CPU"] == 4.0 and out[1] == 1
    [node] = r.nodes()
    out.append(sorted(node))
    return out


def script_runtime_context_in_task(r):
    ref = r.remote(who).remote() if r.__name__ == "raytpu_torch" else \
        r.remote(_jax_who).remote()
    out = [r.get(ref, timeout=T)]
    assert out == [True]
    ctx = r.get_runtime_context()
    out.append(ctx.get_task_id() is None)  # the driver runs no task
    out.append(ctx.get_job_id() is not None and ctx.get_node_id() is not None)
    return out


def _jax_who():
    import raytpu as r

    ctx = r.get_runtime_context()
    return ctx.get_task_id() is not None


def script_timeline(r):
    f = r.remote(one)
    r.get([f.remote() for _ in range(3)], timeout=T)
    end = time.monotonic() + T
    trace = r.timeline()
    while len(trace) < 3 and time.monotonic() < end:
        time.sleep(0.05)
        trace = r.timeline()
    assert len(trace) >= 3
    assert all(ev["ph"] == "X" for ev in trace)
    return [len(trace) >= 3]


SCRIPTS = [script_basic_pg, script_task_in_pg,
           script_scheduling_strategy_object,
           script_accelerator_pg_and_actor, script_actor_pool, script_queue,
           script_cluster_resources, script_runtime_context_in_task,
           script_timeline]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[7:])
def test_scripts_read_alike_through_both_packages(pkgs, script):
    got = {name: script(r) for name, r in pkgs.items()}
    assert got["raytpu_torch"] == got["raytpu"]


@pytest.mark.parametrize("bundles, strategy", [
    ([{"CPU": 1000}], "PACK"),
    ([{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD"),
    ([{"ACCEL": 3}], "STRICT_PACK")], ids=["too-big", "strict-spread",
                                           "accelerators"])
def test_a_group_that_cannot_be_reserved_raises_the_same_type(
        pkgs, bundles, strategy):
    raised = {}
    for name, r in pkgs.items():
        b = [{(("TPU" if name == "raytpu" else "GPU") if k == "ACCEL"
               else k): v for k, v in x.items()} for x in bundles]
        with pytest.raises(Exception) as err:
            r.placement_group(b, strategy=strategy)
        raised[name] = type(err.value).__name__
        assert settled(r) == {"CPU": 4.0, "GPU": 2.0}
    assert raised["raytpu_torch"] == raised["raytpu"] == "PlacementGroupError"


def test_an_infeasible_task_fails_fast_with_the_same_type(pkgs):
    types = {}
    for name, r in pkgs.items():
        f = r.remote(num_cpus=1000)(one)
        t0 = time.monotonic()
        with pytest.raises(Exception) as err:
            r.get(f.remote(), timeout=10)
        assert time.monotonic() - t0 < 10
        types[name] = type(err.value).__name__
    assert types["raytpu_torch"] == types["raytpu"] == "TaskError"


def test_current_placement_group_and_group_info(pkgs):
    r = pkgs["raytpu_torch"]
    assert r.get_current_placement_group() is None
    pg = r.placement_group([{"CPU": 1, "GPU": 0.5}, {"CPU": 1, "GPU": 0.5}],
                           strategy="SPREAD")
    try:
        info = pg.info()
        assert info["state"] == "created" and info["strategy"] == "SPREAD"
        # SPREAD puts each bundle's share on the card with most room.
        assert info["cards"] == [[0], [1]] and pg.cards(1) == [1]
        got = r.get(r.remote(_current_group).options(
            num_cpus=1, num_gpus=0.5, placement_group=pg,
            placement_group_bundle_index=1).remote(), timeout=T)
        assert got == (pg.id.hex(), "1")
    finally:
        r.remove_placement_group(pg)
    assert pg.info() is None
    assert settled(r) == {"CPU": 4.0, "GPU": 2.0}


def _current_group():
    import os

    import raytpu_torch as r

    pg = r.get_current_placement_group()
    return pg.id.hex(), os.environ.get("CUDA_VISIBLE_DEVICES")


def test_the_top_level_exports_the_jax_package_s_names():
    import raytpu

    assert set(raytpu.__all__) <= set(raytpu_torch.__all__)
    for name in raytpu.__all__:
        assert getattr(raytpu_torch, name) is not None
    assert raytpu_torch.__version__ == raytpu.__version__
