"""The port's serve (raytpu_torch/serve) on the CPU, held to the JAX
package's (raytpu.serve): the behaviours of tests/test_serve.py, each
run through both packages with the results compared — deploy and call,
init arguments and methods, a function deployment, several replicas
spreading load, status and delete, ``reconfigure``, a redeploy of
``user_config`` alone that keeps the replicas, a removed deployment
dropped, scale from zero, autoscale up, a replica replaced after its
death, batching and multiplexing — and the router's probe hardening, and
the autoscaling policy's and the prefix router's decisions equal to the
JAX package's on the same inputs. Then composition, a handle unpickled
in another process, and what the port refuses: a target or an argument
that does not pickle, an unknown actor option.

Replicas are processes that rebuild a deployment's class by importing
this module by name, so it imports nothing of JAX or of the JAX package
at its top level; the JAX twins of the classes that need a package's own
decorator are defined inside the tests (the JAX serve pickles them with
cloudpickle). One serve instance of each package serves the module; each
test deletes its applications. Spawning replica processes is most of
this module's time, so the port's replicas of the plain applications
start together when the module does (``PRESTARTED``): a test's own
``serve.run`` of the same application then redeploys it unchanged, which
keeps its replicas. No assertion races a wall clock: waits poll with
generous deadlines.
"""

import asyncio
import multiprocessing
import os
import random
import threading
import time

import pytest

from raytpu_torch import runtime
from raytpu_torch import serve as port_serve
from raytpu_torch.serve._private import prefix_router as port_prefix
from raytpu_torch.serve._private.autoscaling_policy import (
    AutoscalingPolicyManager as PortPolicy, EnginePressure as PortPressure)
from raytpu_torch.serve._private.controller import get_controller
from raytpu_torch.serve.config import AutoscalingConfig as PortAutoscaling

DEADLINE_S = 60.0


# ---- deployment bodies, shared by both packages ------------------------


class Doubler:
    def __call__(self, x):
        return 2 * x


class Adder:
    def __init__(self, increment):
        self.increment = increment

    def __call__(self, x):
        return x + self.increment

    def echo(self, x):
        return ("echo", x)

    def count(self, n):
        for i in range(n):
            yield i + self.increment


class Combiner:
    """tests/test_serve.py:78's ingress: it calls the two deployments it
    is bound to, through their handles."""

    def __init__(self, doubler, adder):
        self.doubler = doubler
        self.adder = adder

    def __call__(self, x):
        d = self.doubler.remote(x).result()
        return self.adder.remote(d).result()

    def chained(self, x):
        # A response passed as an argument of the next call.
        return self.adder.remote(self.doubler.remote(x)).result()

    def count(self, n):
        # A stream of a composed deployment, streamed on.
        for v in self.adder.count.remote_streaming(n):
            yield 10 * v


def square(x):
    return x * x


class WhoAmI:
    def __init__(self):
        self.me = (os.getpid(), id(self))

    def __call__(self, _):
        return self.me


class Configurable:
    def __init__(self):
        self.threshold = None

    def reconfigure(self, cfg):
        self.threshold = cfg["threshold"]

    def __call__(self, _):
        return self.threshold


class Stateful:
    def __init__(self):
        self.v = None
        self.created = (os.getpid(), time.monotonic())

    def reconfigure(self, cfg):
        self.v = cfg["v"]

    def __call__(self, _):
        return (self.v, self.created)


class Slow:
    def __call__(self, _):
        time.sleep(0.3)
        return "done"


class ColdStart:
    def __call__(self, x):
        return x + 1


class Fragile:
    def __call__(self, _):
        return "alive"


# ---- the port's twins of classes that use a package's decorator --------


class PortBatched:
    def __init__(self):
        self.batch_sizes = []

    @port_serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
    async def handle(self, items):
        self.batch_sizes.append(len(items))
        return [i * 10 for i in items]

    async def __call__(self, x):
        return await self.handle(x)

    def sizes(self):
        return self.batch_sizes


class PortMultiModel:
    def __init__(self):
        self.loads = []

    @port_serve.multiplexed(max_num_models_per_replica=2)
    async def get_model(self, model_id):
        self.loads.append(model_id)
        return f"model:{model_id}"

    async def __call__(self, _):
        return await self.get_model(port_serve.get_multiplexed_model_id())

    def load_count(self):
        return self.loads


# ---- the two serve instances ------------------------------------------

# Applications whose port replicas start together with the module:
# name: (target, init args, deployment options).
PRESTARTED = {
    "app1": (Doubler, (), {}), "app2": (Adder, (5,), {}),
    "fapp": (square, (), {}), "gdh": (Adder, (1,), {}),
    "mrep": (WhoAmI, (), {"num_replicas": 3}), "rm": (Adder, (1,), {}),
    "cfg": (Configurable, (), {"user_config": {"threshold": 1}}),
    "ucfg": (Stateful, (), {"user_config": {"v": 1}}),
    "ft": (Fragile, (), {"num_replicas": 1, "health_check_period_s": 0.2}),
    "pickle": (Doubler, (), {})}


@pytest.fixture(scope="module")
def pkgs():
    """``{"jax": raytpu.serve, "port": raytpu_torch.serve}``, one instance
    of each for the module, with the port's PRESTARTED applications
    running; both shut down at its end, leaving no replica process."""
    import raytpu
    from raytpu import serve as jax_serve

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    before = {p.pid for p in multiprocessing.active_children()}
    errors = []

    def start(name, target, args, options):
        try:
            port_serve.run(deploy(port_serve, target, **options).bind(*args),
                           name=name, route_prefix=None)
        except Exception as exc:  # reported below, not lost in the thread
            errors.append((name, exc))

    starts = [threading.Thread(target=start, args=(name, *app))
              for name, app in PRESTARTED.items()]
    for t in starts:
        t.start()
    for t in starts:
        t.join(timeout=DEADLINE_S)
    assert not any(t.is_alive() for t in starts) and errors == []
    yield {"jax": jax_serve, "port": port_serve}
    port_serve.shutdown()
    jax_serve.shutdown()
    raytpu.shutdown()
    left = [(p.name, p.pid) for p in multiprocessing.active_children()
            if p.pid not in before]
    assert left == []


def poll(fn, what: str, deadline_s: float = DEADLINE_S):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        got = fn()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def run_both(pkgs, name, make_app, scenario):
    """``scenario(serve, handle)`` for each package on the application
    ``make_app(serve)`` deployed as ``name``; the two results, the app
    deleted after each."""
    out = {}
    for tag, serve in pkgs.items():
        handle = serve.run(make_app(serve), name=name, route_prefix=None)
        try:
            out[tag] = scenario(serve, handle)
        finally:
            serve.delete(name)
    return out["jax"], out["port"]


def deploy(serve, target, **options):
    dep = serve.deployment(target)
    return dep.options(**options) if options else dep


# ---- the behaviours of tests/test_serve.py, through both ---------------


def test_deploy_and_call(pkgs):
    jax, port = run_both(pkgs, "app1", lambda s: deploy(s, Doubler).bind(),
                         lambda s, h: h.remote(21).result())
    assert jax == port == 42


def test_init_args_and_methods(pkgs):
    jax, port = run_both(
        pkgs, "app2", lambda s: deploy(s, Adder).bind(5),
        lambda s, h: (h.remote(10).result(), h.echo.remote(3).result()))
    assert jax == port == (15, ("echo", 3))


def test_function_deployment(pkgs):
    jax, port = run_both(pkgs, "fapp", lambda s: deploy(s, square).bind(),
                         lambda s, h: h.remote(9).result())
    assert jax == port == 81


def test_multiple_replicas_spread_load(pkgs):
    jax, port = run_both(
        pkgs, "mrep", lambda s: deploy(s, WhoAmI, num_replicas=3).bind(),
        lambda s, h: len({h.remote(i).result() for i in range(30)}))
    assert jax >= 2 and port >= 2  # pow-2 routing uses several replicas


def test_status_and_delete(pkgs):
    got = {}
    for tag, serve in pkgs.items():
        serve.run(deploy(serve, Doubler).bind(), name="stapp",
                  route_prefix=None)
        got[tag] = serve.status()["stapp"]
        serve.delete("stapp")
        assert "stapp" not in serve.status()
    assert got["jax"] == got["port"]
    assert got["port"]["deployments"]["Doubler"] == {
        "status": "RUNNING", "target_replicas": 1, "running_replicas": 1,
        "healthy_replicas": 1}


def test_get_deployment_handle(pkgs):
    def scenario(serve, _):
        return serve.get_deployment_handle("Adder", "gdh").remote(1).result()

    jax, port = run_both(pkgs, "gdh", lambda s: deploy(s, Adder).bind(1),
                         scenario)
    assert jax == port == 2


def test_composition(pkgs):
    def app(serve):
        return deploy(serve, Combiner).bind(deploy(serve, Doubler).bind(),
                                            deploy(serve, Adder).bind(100))

    jax, port = run_both(pkgs, "comp", app,
                         lambda s, h: h.remote(7).result())
    assert jax == port == 114


def test_a_composition_streams_and_chains(pkgs):
    handle = port_serve.run(
        deploy(port_serve, Combiner).bind(
            deploy(port_serve, Doubler).bind(),
            deploy(port_serve, Adder).bind(100)),
        name="comp-stream", route_prefix=None)
    try:
        assert list(handle.count.remote_streaming(3)) == [1000, 1010, 1020]
        assert handle.chained.remote(7).result() == 114
        assert handle.remote(handle.chained.remote(1)).result() == 304
        deps = port_serve.status()["comp-stream"]["deployments"]
        assert {name: d["status"] for name, d in deps.items()} == {
            "Combiner": "RUNNING", "Doubler": "RUNNING", "Adder": "RUNNING"}
    finally:
        port_serve.delete("comp-stream")


def test_reconfigure_user_config(pkgs):
    def scenario(serve, handle):
        first = handle.remote(0).result()
        serve.run(deploy(serve, Configurable,
                         user_config={"threshold": 9}).bind(),
                  name="cfg", route_prefix=None)
        return first, poll(lambda: handle.remote(0).result() == 9 and 9,
                           "the new user_config")

    jax, port = run_both(
        pkgs, "cfg",
        lambda s: deploy(s, Configurable, user_config={"threshold": 1}).bind(),
        scenario)
    assert jax == port == (1, 9)


def test_user_config_only_redeploy_keeps_replicas(pkgs):
    def scenario(serve, handle):
        v1, created1 = handle.remote(0).result()
        serve.run(deploy(serve, Stateful, user_config={"v": 2}).bind(),
                  name="ucfg", route_prefix=None)
        v2, created2 = poll(lambda: (lambda r: r[0] == 2 and r)(
            handle.remote(0).result()), "v == 2")
        return v1, v2, created1 == created2

    jax, port = run_both(
        pkgs, "ucfg",
        lambda s: deploy(s, Stateful, user_config={"v": 1}).bind(), scenario)
    assert jax == port == (1, 2, True)  # the same replica: no restart


def test_removed_deployment_is_dropped(pkgs):
    got = {}
    for tag, serve in pkgs.items():
        serve.run(deploy(serve, Adder).bind(1), name="rm", route_prefix=None)
        serve.run(deploy(serve, Doubler).bind(), name="rm",
                  route_prefix=None)
        poll(lambda: "Adder" not in serve.status()["rm"]["deployments"],
             "Adder dropped")
        got[tag] = sorted(serve.status()["rm"]["deployments"])
        serve.delete("rm")
    assert got["jax"] == got["port"] == ["Doubler"]


def test_scale_from_zero(pkgs):
    def make(serve):
        return deploy(serve, ColdStart, autoscaling_config=dict(
            min_replicas=0, max_replicas=2, target_ongoing_requests=1.0,
            initial_replicas=0, upscale_delay_s=0.3,
            downscale_delay_s=60.0)).bind()

    def scenario(serve, handle):
        before = serve.status()["cold"]["deployments"]["ColdStart"][
            "running_replicas"]
        # The first request makes the handle report demand: 0 -> 1.
        return before, handle.remote(41).result()

    jax, port = run_both(pkgs, "cold", make, scenario)
    assert jax == port == (0, 42)


def test_e2e_autoscale_up(pkgs):
    def make(serve):
        return deploy(serve, Slow, autoscaling_config=dict(
            min_replicas=1, max_replicas=3, target_ongoing_requests=1.0,
            upscale_delay_s=0.1, downscale_delay_s=60.0)).bind()

    def scenario(serve, handle):
        results = []
        threads = [threading.Thread(
            target=lambda: results.append(handle.remote(0).result()))
            for _ in range(12)]
        for t in threads:
            t.start()
        scaled = poll(lambda: serve.status()["auto"]["deployments"]["Slow"][
            "running_replicas"] > 1, "a second replica")
        for t in threads:
            t.join(timeout=DEADLINE_S)
        assert not any(t.is_alive() for t in threads)
        return scaled, results

    jax, port = run_both(pkgs, "auto", make, scenario)
    assert jax == port == (True, ["done"] * 12)


def _replace_after_death(serve, handle, kill):
    assert handle.remote(0).result() == "alive"
    [(rid, replica)] = kill.running("ft#Fragile")
    kill(replica)

    def replaced():
        try:
            if handle.remote(0).result(timeout_s=5) != "alive":
                return False
        except Exception:  # the dead replica may take a request first
            return False
        now = kill.running("ft#Fragile")
        return bool(now) and now[0][0] != rid

    return poll(replaced, "a replacement replica")


def test_replica_replaced_after_death(pkgs):
    import raytpu

    def jax_kill(replica):
        raytpu.kill(replica)

    jax_kill.running = lambda name: raytpu.get(
        raytpu.get_actor("SERVE_CONTROLLER").get_running_replicas.remote(
            name))

    def port_kill(replica):
        os.kill(replica.pid, 9)

    port_kill.running = lambda name: get_controller().call(
        "get_running_replicas", name)
    kills = {"jax": jax_kill, "port": port_kill}
    got = {}
    for tag, serve in pkgs.items():
        handle = serve.run(deploy(serve, Fragile, num_replicas=1,
                                  health_check_period_s=0.2).bind(),
                           name="ft", route_prefix=None)
        try:
            got[tag] = _replace_after_death(serve, handle, kills[tag])
        finally:
            serve.delete("ft")
    assert got["jax"] is got["port"] is True


def test_batch_accumulates(pkgs):
    from raytpu import serve as jax_serve

    class Batched:  # the JAX twin of PortBatched
        def __init__(self):
            self.batch_sizes = []

        @jax_serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        async def handle(self, items):
            self.batch_sizes.append(len(items))
            return [i * 10 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

        def sizes(self):
            return self.batch_sizes

    targets = {"jax": Batched, "port": PortBatched}

    def scenario(serve, handle):
        resps = [handle.remote(i) for i in range(8)]
        return ([r.result() for r in resps],
                max(handle.sizes.remote().result()) > 1)

    got = {}
    for tag, serve in pkgs.items():
        handle = serve.run(deploy(serve, targets[tag]).bind(), name="batch",
                           route_prefix=None)
        try:
            got[tag] = scenario(serve, handle)
        finally:
            serve.delete("batch")
    assert got["jax"] == got["port"] == ([i * 10 for i in range(8)], True)


def test_multiplexed_lru(pkgs):
    from raytpu import serve as jax_serve

    class MultiModel:  # the JAX twin of PortMultiModel
        def __init__(self):
            self.loads = []

        @jax_serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return f"model:{model_id}"

        async def __call__(self, _):
            return await self.get_model(jax_serve.get_multiplexed_model_id())

        def load_count(self):
            return self.loads

    targets = {"jax": MultiModel, "port": PortMultiModel}

    def scenario(serve, handle):
        h = {m: handle.options(multiplexed_model_id=m) for m in "abc"}
        out = [h["a"].remote(0).result(), h["b"].remote(0).result(),
               h["a"].remote(0).result()]
        loads = handle.load_count.remote().result()
        out += [h["c"].remote(0).result(), h["b"].remote(0).result()]
        return out, loads, handle.load_count.remote().result()

    got = {}
    for tag, serve in pkgs.items():
        handle = serve.run(deploy(serve, targets[tag]).bind(), name="mux",
                           route_prefix=None)
        try:
            got[tag] = scenario(serve, handle)
        finally:
            serve.delete("mux")
    assert got["jax"] == got["port"]
    out, first, last = got["port"]
    assert out == ["model:a", "model:b", "model:a", "model:c", "model:b"]
    assert first.count("a") == 1 and first.count("b") == 1
    assert last.count("c") == 1 and last.count("b") == 2


# ---- the router's probe hardening (tests/test_serve.py:226-301) --------


class _ProbeRef:
    def __init__(self, qlen):
        self.qlen = qlen


class _ProbeMethod:
    def __init__(self, qlen):
        self.qlen = qlen

    def remote(self):
        return _ProbeRef(self.qlen)


class _FakeReplica:
    def __init__(self, qlen):
        self.get_queue_len = _ProbeMethod(qlen)


class _StubRuntime:
    """runtime.get stand-in: qlen=None simulates a probe that hangs
    until the router's PROBE_TIMEOUT_S budget expires."""

    @staticmethod
    def get(ref, timeout=None):
        if ref.qlen is None:
            raise TimeoutError("queue-len probe timed out")
        return ref.qlen


def _replica_set(replicas, max_ongoing=4):
    from raytpu_torch.serve._private import router as router_mod

    rs = object.__new__(router_mod.ReplicaSet)
    rs._controller = None
    rs._full_name = "t#D"
    rs._max_ongoing = max_ongoing
    rs._lock = threading.Lock()
    rs._replicas = list(replicas)
    rs._version = 0
    rs._stopped = False
    rs._have_replicas = threading.Event()
    rs._have_replicas.set()
    return rs


def test_timed_out_probe_never_wins_the_pick(monkeypatch):
    from raytpu_torch.serve._private import router as router_mod

    monkeypatch.setattr(router_mod, "runtime", _StubRuntime)
    healthy = _FakeReplica(qlen=3)    # busy, but answering
    wedged = _FakeReplica(qlen=None)  # probe hangs
    rs = _replica_set([("r-ok", healthy), ("r-wedged", wedged)])
    for _ in range(10):
        assert rs.choose(timeout_s=5.0) is healthy


def test_all_probes_failing_times_out_instead_of_guessing(monkeypatch):
    from raytpu_torch.serve._private import router as router_mod

    monkeypatch.setattr(router_mod, "runtime", _StubRuntime)
    rs = _replica_set([("r-wedged", _FakeReplica(qlen=None))])
    with pytest.raises(TimeoutError):
        rs.choose(timeout_s=0.3)


# ---- pure decisions, equal to the JAX package's ------------------------


POLICY_CONFIGS = [
    dict(min_replicas=1, max_replicas=10, target_ongoing_requests=2.0,
         upscale_delay_s=1.0, downscale_delay_s=2.0),
    dict(min_replicas=2, max_replicas=4, target_ongoing_requests=1.0,
         upscale_delay_s=0.0, downscale_delay_s=0.0),
    dict(min_replicas=1, max_replicas=10, target_ongoing_requests=100.0,
         target_engine_waiting=2.0, target_kv_utilization=0.8,
         upscale_delay_s=0.0, downscale_delay_s=0.0),
    dict(min_replicas=1, max_replicas=10, target_ongoing_requests=100.0,
         target_engine_waiting=1.0, target_ttft_s=0.5,
         upscale_smoothing_factor=0.5, downscale_smoothing_factor=0.25,
         upscale_delay_s=1.0, downscale_delay_s=2.0),
]


@pytest.mark.parametrize("config", range(len(POLICY_CONFIGS)))
def test_autoscaling_decisions_equal_the_jax_package_s(config):
    from raytpu.serve._private.autoscaling_policy import (
        AutoscalingPolicyManager, EnginePressure)
    from raytpu.serve.config import AutoscalingConfig

    kw = POLICY_CONFIGS[config]
    jax = AutoscalingPolicyManager(AutoscalingConfig(**kw))
    port = PortPolicy(PortAutoscaling(**kw))
    rng = random.Random(config)
    now, current = 0.0, 3
    for _ in range(400):
        total = rng.choice([0.0, 1.0, 4.0, 20.0, rng.uniform(0, 40)])
        fields = None if rng.random() < 0.3 else dict(
            waiting_requests=rng.choice([0.0, rng.uniform(0, 12)]),
            kv_utilization=rng.uniform(0, 1),
            ttft_p95_s=rng.choice([0.0, rng.uniform(0, 3)]))
        now += rng.choice([0.1, 0.5, 1.2])
        want = jax.get_decision_num_replicas(
            total, current, now=now,
            engine_pressure=fields and EnginePressure(**fields))
        got = port.get_decision_num_replicas(
            total, current, now=now,
            engine_pressure=fields and PortPressure(**fields))
        assert got == want
        assert port.desired(total, current) == jax.desired(total, current)
        if got is not None:
            current = got


def test_prefix_routing_decisions_equal_the_jax_package_s():
    from raytpu.serve._private import prefix_router as jax_prefix

    rng = random.Random(7)
    page = 4
    system = [rng.randrange(1000) for _ in range(4 * page)]
    for trial in range(60):
        prompt = system[:rng.randrange(0, len(system) + 1)] + [
            rng.randrange(1000) for _ in range(rng.randrange(0, 9))]
        digests = port_prefix.prompt_digests(prompt, page)
        assert digests == jax_prefix.prompt_digests(prompt, page)
        snapshot = []
        for r in range(rng.randrange(1, 6)):
            held = system[:page * rng.randrange(0, 5)]
            snapshot.append((f"r{r}", f"handle-{r}",
                             port_prefix.prompt_digests(held, page)))
        qlens = {f"handle-{r}": rng.choice([0, 1, 3, 8])
                 for r in range(len(snapshot))}
        for rid, _, held in snapshot:
            assert port_prefix.match_len(digests, held) == \
                jax_prefix.match_len(digests, held)
        picks = [mod.select_replica(digests, snapshot, qlens.get, 4,
                                    random.Random(trial))
                 for mod in (jax_prefix, port_prefix)]
        assert picks[0] == picks[1]


# ---- what the port refuses ---------------------------------------------


def test_composition_deploys_bound_nodes_and_passes_handles(pkgs):
    """Composition: a bound node in the arguments is deployed with the
    application and arrives as its handle, and a handle among them
    passes as it is. (The proxies and ASGI ingress, which this test held
    to raising before, are held to the JAX package's in
    tests/test_torch_serve_http.py and tests/test_torch_serve_grpc.py.)"""
    handle = port_serve.get_deployment_handle("Doubler", "x")
    composed = deploy(port_serve, Adder).bind(
        deploy(port_serve, Doubler).bind())
    port_serve.run(composed, name="comp", route_prefix=None)
    port_serve.run(deploy(port_serve, Adder).bind(handle), name="comp2",
                   route_prefix=None)
    try:
        for app, want in (("comp", port_serve.get_deployment_handle(
                "Doubler", "comp")), ("comp2", handle)):
            [(_, replica)] = get_controller().call(
                "get_running_replicas", f"{app}#Adder")
            got = runtime.get(runtime.call(replica, increment_of),
                              timeout=DEADLINE_S)
            assert isinstance(got, port_serve.DeploymentHandle)
            assert got == want
        assert set(port_serve.status()["comp"]["deployments"]) == {
            "Adder", "Doubler"}
    finally:
        port_serve.delete("comp")
        port_serve.delete("comp2")
    assert "comp" not in port_serve.status()


def increment_of(replica):
    """Run in a replica process: what its Adder was built with."""
    return replica._callable.increment


def unpickle_in_replica(replica, blob):
    """Run in a replica process: unpickle the handle ``blob`` there and
    call it: its router finds the controller by name."""
    import pickle

    return pickle.loads(blob).remote(21).result(timeout_s=DEADLINE_S)


def test_a_handle_unpickled_in_another_process_raises(pkgs):
    """It raised before; now a handle pickles by name and routes from a
    replica process, which finds the running controller (and starts
    none)."""
    import pickle

    handle = port_serve.get_deployment_handle("Doubler", "x").echo
    again = pickle.loads(pickle.dumps(handle))  # this process: equal
    assert again == handle and again._method_name == "echo"
    controller = get_controller().actor.pid
    [(_, replica)] = get_controller().call("get_running_replicas",
                                           "pickle#Doubler")
    blob = pickle.dumps(port_serve.get_deployment_handle("Doubler",
                                                         "pickle"))
    assert runtime.get(runtime.call(replica, unpickle_in_replica, blob),
                       timeout=DEADLINE_S) == 42
    assert get_controller().actor.pid == controller
    port_serve.delete("pickle")


def _local_target():
    class Local:
        def __call__(self, x):
            return x
    return Local


def test_what_does_not_pickle_is_refused_before_any_process(pkgs):
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(TypeError, match="Local"):
        port_serve.run(deploy(port_serve, _local_target()).bind(),
                       name="local")
    with pytest.raises(TypeError, match="init argument 0"):
        port_serve.run(deploy(port_serve, Adder).bind(lambda: 1),
                       name="lam")
    with pytest.raises(TypeError, match="init argument 'lock'"):
        port_serve.run(deploy(port_serve, Adder).bind(
            increment=1, lock=threading.Lock()), name="lock")
    with pytest.raises(ValueError, match="runtime_env"):
        deploy(port_serve, Doubler, ray_actor_options={"runtime_env": {}})
    with pytest.raises(TypeError, match="called directly"):
        deploy(port_serve, Doubler)()
    left = [(p.name, p.pid) for p in multiprocessing.active_children()
            if p.pid not in before]
    assert left == []
    for name in ("local", "lam", "lock"):
        assert name not in port_serve.status()


class FailsToStart:
    def __init__(self):
        raise RuntimeError("this replica cannot start")


def test_a_replica_that_cannot_start_fails_run_before_its_timeout(pkgs):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="this replica cannot start"):
        port_serve.run(deploy(port_serve, FailsToStart).bind(),
                       name="nostart", wait_for_ready_timeout_s=3600)
    assert time.monotonic() - t0 < 3600  # raised, not timed out
    st = port_serve.status()["nostart"]["deployments"]["FailsToStart"]
    assert st["status"] == "DEPLOY_FAILED"
    assert "this replica cannot start" in st["message"]
    port_serve.delete("nostart")


def test_a_port_handle_streams_a_sync_and_an_async_handler(pkgs):
    handle = port_serve.run(deploy(port_serve, Streams).bind(),
                            name="streams", route_prefix=None)
    try:
        assert list(handle.count.remote_streaming(4)) == [0, 1, 2, 3]
        assert list(handle.acount.remote_streaming(3)) == [0, 1, 2]
        assert list(handle.one.remote_streaming(5)) == [5]

        async def twice():
            return await handle.one.remote(21) * 2

        assert asyncio.run(twice()) == 42
    finally:
        port_serve.delete("streams")


class Streams:
    def count(self, n):
        yield from range(n)

    async def acount(self, n):
        for i in range(n):
            yield i

    def one(self, x):
        return x
