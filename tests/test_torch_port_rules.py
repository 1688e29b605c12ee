"""Rules of the port (raytpu_torch/, chip_smoke.py): it imports neither
JAX nor the JAX package (nor ``prometheus_client``: its metrics are in
memory only; nor ``cloudpickle``: the chip machine has none, so the
runtime pickles by value itself), no module imports ``pyarrow``,
``pandas`` or ``PIL`` at its top (the Data library imports them where a
reader needs them), its entry points never move to the CPU on their own, its
CUDA kernels are built from the repo's sources for Hopper, and its
observability keeps the JAX package's lint rules: every request event
is emitted under one flag check and every transition the JAX serving
plane emits is emitted (RTP021), every metric it constructs is declared
(RTP015), and its flight recorder keeps the rules of
tests/test_task_events.py: every task event, ship and tombstone site
under one flag check, and every ``TaskTransition`` emitted or listed
with the reason the port never emits it (RTP003)."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import raytpu_torch
from raytpu_torch.ops import _native

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "raytpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "ab_wrappers.py", REPO / "rmsnorm_plans.py",
    REPO / "rl_kinks.py"]

# The port's copies of raytpu/util's observability.
UTIL_MODULES = ("metrics", "tracing", "task_events", "serve_slo",
                "profiler", "stepprof", "tsdb", "metrics_export",
                "profstore", "memprofile", "stack_dump")

# The operator's surface (the dashboard, the CLI, job submission), each
# with its JAX module of the same path, and the HTTP server they share
# (the port's own: the JAX servers are aiohttp apps).
OPERATOR_MODULES = ("dashboard/__init__.py", "dashboard/app.py",
                    "job/__init__.py", "job/manager.py", "job/server.py",
                    "job/sdk.py", "scripts/__init__.py", "scripts/cli.py",
                    "__main__.py")
# What the chip machine lacks, so neither they nor serve may import.
HTTP_PACKAGES = ("aiohttp", "requests")

# The port's runtime layer and the JAX modules whose calls it copies.
RUNTIME_MODULES = ("core.errors", "runtime.api", "runtime.generator",
                   "runtime.serialization", "runtime.object_ref",
                   "runtime.refcount", "runtime.object_store",
                   "runtime.remote_function",
                   "util.tenancy", "util.failpoints",
                   "core.ids", "core.resources", "runtime.context",
                   "runtime.placement_group", "util.actor_pool",
                   "util.queue", "util.scheduling_strategies",
                   "util.usage_stats")
# The port's own modules of the card as a resource, with no JAX module
# of their path (the JAX local backend's ledger and
# ``detect_local_tpu`` are their counterparts).
RESOURCE_MODULES = ("runtime.ledger", "core.topology")

# The serve library, each module with its JAX module of the same path.
SERVE_MODULES = ("serve/__init__.py", "serve/api.py", "serve/batching.py",
                 "serve/config.py", "serve/deployment.py", "serve/handle.py",
                 "serve/multiplex.py", "serve/_private/autoscaling_policy.py",
                 "serve/_private/controller.py", "serve/_private/long_poll.py",
                 "serve/_private/prefix_router.py",
                 "serve/_private/replica.py", "serve/_private/router.py",
                 "serve/_private/proxy.py", "serve/_private/grpc_proxy.py")

# The Train library and its models, each with its JAX module.
TRAIN_MODULES = ("train/__init__.py", "train/config.py",
                 "train/checkpoint.py", "train/session.py",
                 "train/trainer.py", "train/torch_trainer.py",
                 "models/mlp.py", "models/resnet.py")

# The Tune library and the events module its retries record through,
# each with its JAX module of the same path.
TUNE_MODULES = ("tune/__init__.py", "tune/search.py", "tune/schedulers.py",
                "tune/external.py", "tune/tuner.py", "util/events.py")

# The Data library and the runtime's microbenchmarks, each with its JAX
# module of the same path.
DATA_MODULES = ("data/__init__.py", "data/block.py", "data/executor.py",
                "data/dataset.py", "data/read_api.py", "data/tfrecord.py",
                "data/avro.py", "perf.py")

# Compiled graphs, channels and workflows, each with its JAX module of
# the same path.
GRAPH_MODULES = ("dag/__init__.py", "dag/node.py", "dag/compiled.py",
                 "runtime/channel.py", "workflow/__init__.py",
                 "workflow/api.py", "workflow/executor.py",
                 "workflow/storage.py")

# The parallel package and the collectives, each with its JAX module of
# the same path.
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py",
                    "parallel/sharding.py", "parallel/ring_attention.py",
                    "parallel/ulysses.py", "parallel/pipeline.py",
                    "parallel/moe.py", "collective/__init__.py",
                    "collective/collective.py", "collective/mesh_ops.py")

# Packages the Data library imports only where a reader or writer needs
# them (the card's machine may lack them).
OPTIONAL_PACKAGES = ("cloudpickle", "pyarrow", "pandas", "PIL")

# Run in a fresh interpreter: this test process has JAX loaded
# (tests/conftest.py imports it).
_IMPORT_ALL = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import raytpu_torch
for m in pkgutil.walk_packages(raytpu_torch.__path__, "raytpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "raytpu", "prometheus_client",
                   "cloudpickle")


def test_port_imports_no_jax_and_nothing_of_raytpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "raytpu_torch.inference.engine" in loaded
    assert "raytpu_torch.dashboard.app" in loaded
    assert {f"raytpu_torch.util.{m}" for m in UTIL_MODULES} <= set(loaded)
    assert {f"raytpu_torch.{m}" for m in RUNTIME_MODULES
            + RESOURCE_MODULES + ("_version",)} <= set(loaded)
    assert {"raytpu_torch." + m[:-3].replace("/", ".").replace(
        ".__init__", "") for m in TRAIN_MODULES + SERVE_MODULES
        + DATA_MODULES + GRAPH_MODULES + PARALLEL_MODULES} <= set(loaded)
    assert "chip_smoke" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_name_no_jax_or_raytpu_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (path, names)


def _top_level_imports(tree: ast.Module):
    """The modules a file imports outside any function or class."""
    pending = list(tree.body)
    while pending:
        node = pending.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            pending.extend(ast.iter_child_nodes(node))
        elif isinstance(node, ast.ExceptHandler):
            pending.extend(node.body)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_no_optional_package_at_their_top(path):
    names = list(_top_level_imports(ast.parse(path.read_text())))
    assert not [n for n in names
                if n.split(".")[0] in OPTIONAL_PACKAGES], (path, names)


def test_data_modules_are_held_to_the_rules():
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for name in DATA_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()
    import raytpu.data as jdata

    import raytpu_torch.data as pdata

    assert pdata.__all__ == [n for n in jdata.__all__ if n != "from_jax"]
    assert all(hasattr(pdata, n) for n in pdata.__all__)
    assert not hasattr(pdata.Dataset, "iter_jax_batches")


def test_importing_data_and_the_runtime_loads_no_optional_package():
    code = ("import json, sys; import raytpu_torch.data, raytpu_torch.perf, "
            "raytpu_torch.runtime, raytpu_torch.data.avro, "
            "raytpu_torch.data.tfrecord; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"raytpu_torch." + m[:-3].replace("/", ".").replace(
        ".__init__", "") for m in DATA_MODULES} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)
            or m.split(".")[0] in OPTIONAL_PACKAGES] == []


def test_entry_points_raise_without_a_card(monkeypatch):
    from raytpu_torch.inference import InferenceEngine, PagedKVCache
    from raytpu_torch.models.gpt2 import GPT2, GPT2Config
    from raytpu_torch.models.llama import Llama, LlamaConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        raytpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Llama(cfg, param_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(2, 4, 8, 2, 32)
    model = Llama(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(model)
    assert InferenceEngine(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT2(GPT2Config.tiny())
    assert GPT2(GPT2Config.tiny(), device="cpu").device.type == "cpu"


def test_rl_entry_points_raise_without_a_card(monkeypatch):
    from raytpu_torch.rllib import BCConfig, PPOConfig, SACConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in (PPOConfig().environment("CartPole-v1"),
                   SACConfig().environment("Pendulum-v1"),
                   BCConfig().offline(dataset=object(), observation_dim=4,
                                      action_dim=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            config.build()
    algo = PPOConfig().environment("CartPole-v1").resources(
        device="cpu").build()
    assert algo.learner.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in algo.learner.params.values())
    assert algo.env_runner_group.local_runner.device.type == "cpu"


def test_serve_modules_are_held_to_the_rules():
    # The AST scan and the fresh-interpreter import above cover them.
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    assert {p.relative_to(REPO / "raytpu_torch").as_posix() for p in
            (REPO / "raytpu_torch" / "serve").rglob("*.py")} - {
        "serve/_private/__init__.py"} == set(SERVE_MODULES)
    for name in SERVE_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()


def test_importing_serve_loads_no_jax():
    # Nor aiohttp or grpc: the HTTP proxy is on the standard library's
    # asyncio streams, and grpc is imported when the gRPC proxy starts.
    code = ("import json, sys; import raytpu_torch.serve as s; "
            "import raytpu_torch.serve._private.proxy, "
            "raytpu_torch.serve._private.grpc_proxy; "
            "s.LLMDeployment; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "raytpu_torch.inference.serving" in loaded
    assert [m for m in loaded if _forbidden(m)
            or m.split(".")[0] in ("aiohttp", "grpc")] == []


def test_serve_exports_the_jax_packages_names():
    import raytpu.serve as jserve

    import raytpu_torch.serve as pserve

    assert pserve.__all__ == jserve.__all__
    assert all(hasattr(pserve, n) for n in pserve.__all__)


class Plain:
    """A deployment body for the replica-process checks below."""

    def __call__(self, x):
        return x


def test_replica_processes_import_no_jax_and_an_llm_replica_needs_a_card(
        monkeypatch):
    # A replica loads nothing forbidden; an LLM replica asked for the
    # card where there is none fails its deployment, so serve.run raises
    # at once (no fallback to the CPU), naming CUDA, and no process stays.
    import multiprocessing

    from raytpu_torch import runtime, serve
    from raytpu_torch.serve._private.controller import get_controller

    before = {p.pid for p in multiprocessing.active_children()}
    try:
        handle = serve.run(serve.deployment(Plain).bind(), name="plain",
                           route_prefix=None)
        assert handle.remote(3).result(timeout_s=60) == 3
        [(_, replica)] = get_controller().call("get_running_replicas",
                                               "plain#Plain")
        assert runtime.get(runtime.call(replica, forbidden_in_worker),
                           timeout=60) == []
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the child's view
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.run(serve.LLMDeployment.bind(model="llama"), name="llm",
                      route_prefix=None, wait_for_ready_timeout_s=600)
        assert serve.status()["llm"]["deployments"]["LLMDeployment"][
            "status"] == "DEPLOY_FAILED"
    finally:
        serve.shutdown()
    assert {p.pid for p in multiprocessing.active_children()} <= before


_IMPORT_TOP = """
import json, multiprocessing, sys, torch
import raytpu_torch
print(json.dumps({"cuda": torch.cuda.is_initialized(),
                  "children": len(multiprocessing.active_children()),
                  "forbidden": sorted(m for m in sys.modules
                                      if m.split(".")[0] in ("jax", "raytpu"))}))
"""


def test_import_creates_no_cuda_context_and_starts_no_process():
    """``import raytpu_torch`` (the core API at its top included) in a
    fresh interpreter: no CUDA context, no child, nothing of JAX."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_TOP], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "cuda": False, "children": 0, "forbidden": []}


_PRELOAD = """
import importlib, json, torch

def touched(*a, **k):
    raise AssertionError("a CUDA query at import")

for name in ("is_available", "device_count", "current_device", "init",
             "_lazy_init", "get_device_properties"):
    setattr(torch.cuda, name, touched)
from raytpu_torch.runtime import starter
for name in starter.PRELOAD:
    importlib.import_module(name)
print(json.dumps(torch.cuda.is_initialized()))
"""


def test_the_starter_s_preload_queries_no_card():
    """What every server of the starter imports before it forks (a CUDA
    query there would fix the device count of every child before its
    binding) makes no CUDA call."""
    out = subprocess.run([sys.executable, "-c", _PRELOAD], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "false"


def test_the_top_level_holds_the_jax_package_s_names():
    import raytpu

    assert set(raytpu.__all__) <= set(raytpu_torch.__all__)
    assert all(hasattr(raytpu_torch, name) for name in raytpu_torch.__all__)


def test_runtime_modules_are_held_to_the_rules():
    # The AST scan and the fresh-interpreter import above cover them.
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for m in RUNTIME_MODULES:
        path = m.replace(".", "/") + ".py"
        assert path in names
        assert (REPO / "raytpu" / path).is_file()
    assert {"runtime/__init__.py", "runtime/api.py",
            "runtime/generator.py"} <= names


def forbidden_in_worker(instance):
    """Run inside a worker process: the forbidden modules it has loaded."""
    return sorted(m for m in sys.modules if _forbidden(m))


def _runner_config(device):
    from raytpu_torch.rllib import PPOConfig

    return {"env": "CartPole-v1", "env_config": {},
            "module_spec": PPOConfig().environment(
                "CartPole-v1").rl_module_spec(),
            "rollout_fragment_length": 8, "num_envs_per_env_runner": 2,
            "seed": 0, "gamma": 0.99, "env_to_module_connectors": [],
            "module_to_env_connectors": [], "device": device}


def test_runner_processes_import_no_jax_and_nothing_of_raytpu():
    import multiprocessing

    from raytpu_torch import runtime
    from raytpu_torch.rllib.env.env_runner import EnvRunnerGroup

    group = EnvRunnerGroup(_runner_config("cpu"), 1)
    try:
        [runner] = group.remote_runners
        assert runtime.get(runtime.call(runner, forbidden_in_worker),
                           timeout=60) == []
        assert group.sample()[0]["env_steps"] == 16
    finally:
        group.stop()
    assert runner.pid not in {p.pid for p in
                              multiprocessing.active_children()}


def test_runner_processes_raise_without_a_card(monkeypatch):
    # The runner process resolves the device itself: asked for the card
    # (device None) where it sees none, it raises; it never moves to the
    # CPU. The group's construction names the failure and leaves no
    # process behind.
    import multiprocessing

    from raytpu_torch.core.errors import ActorDiedError
    from raytpu_torch.rllib.env.env_runner import EnvRunnerGroup

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the child's view
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(ActorDiedError, match="CUDA"):
        EnvRunnerGroup(_runner_config(None), 2)
    assert {p.pid for p in multiprocessing.active_children()} <= before


def test_train_modules_are_held_to_the_rules():
    # The AST scan and the fresh-interpreter import above cover them.
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for name in TRAIN_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()


def test_train_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    # The models, a CUDA gang (before any process starts) and a worker
    # asked for a card where there is none all raise; none moves to the
    # CPU on its own.
    import multiprocessing

    from raytpu_torch import train
    from raytpu_torch.models import MLPClassifier, ResNet, ResNetConfig
    from raytpu_torch.train.trainer import TrainWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MLPClassifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        ResNet(ResNetConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainWorker(0, 1, {}, "cuda")
    before = {p.pid for p in multiprocessing.active_children()}
    with pytest.raises(RuntimeError, match="CUDA"):
        train.DataParallelTrainer(
            report_forbidden, run_config=train.RunConfig(
                storage_path=str(tmp_path))).fit()
    assert {p.pid for p in multiprocessing.active_children()} <= before
    assert MLPClassifier(device="cpu").head.weight.device.type == "cpu"
    assert TrainWorker(0, 1, {}, "cpu").context.device.type == "cpu"


def report_forbidden(config):
    """A train loop: reports the forbidden modules its worker has
    loaded."""
    from raytpu_torch import train

    train.report({"forbidden": sorted(m for m in sys.modules
                                      if _forbidden(m))})


def test_train_workers_import_no_jax_and_nothing_of_raytpu(tmp_path):
    import multiprocessing
    import threading

    from raytpu_torch import train

    before = {p.pid for p in multiprocessing.active_children()}
    gang = train.DataParallelTrainer(
        report_forbidden,
        scaling_config=train.ScalingConfig(num_workers=2, device="cpu"),
        run_config=train.RunConfig(storage_path=str(tmp_path)))
    out = []
    fit = threading.Thread(target=lambda: out.append(gang.fit()),
                           daemon=True)
    fit.start()
    fit.join(180)  # a hang fails here, not at the suite's limit
    assert not fit.is_alive()
    [result] = out
    assert result.error is None
    assert result.metrics["forbidden"] == []
    assert {p.pid for p in multiprocessing.active_children()} <= before


def test_tune_modules_are_held_to_the_rules():
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for name in TUNE_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()
    import raytpu.tune as jtune

    import raytpu_torch.tune as ptune

    assert ptune.__all__ == jtune.__all__
    assert all(hasattr(ptune, n) for n in ptune.__all__)


def test_importing_tune_loads_no_jax_cloudpickle_or_raytpu():
    code = ("import json, sys; import raytpu_torch.tune, "
            "raytpu_torch.util.events; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"raytpu_torch." + m[:-3].replace("/", ".").replace(
        ".__init__", "") for m in TUNE_MODULES} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_tune_trials_raise_without_a_card(monkeypatch, tmp_path):
    # A trial on "cuda" (the default) raises at fit, before any trial
    # process starts; so does a trainer trainable on the card.
    import multiprocessing

    from raytpu_torch import train, tune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = {p.pid for p in multiprocessing.active_children()}
    rc = train.RunConfig(storage_path=str(tmp_path))
    for tuner in (
            tune.Tuner(report_forbidden, run_config=rc),
            tune.Tuner(report_forbidden, run_config=rc,
                       tune_config=tune.TuneConfig(device="cuda")),
            tune.Tuner(train.DataParallelTrainer(report_forbidden),
                       run_config=rc)):
        with pytest.raises(RuntimeError, match="CUDA"):
            tuner.fit()
    assert {p.pid for p in multiprocessing.active_children()} <= before


def test_tune_trials_import_no_jax_and_nothing_of_raytpu(tmp_path):
    import threading

    from raytpu_torch import train, tune

    out = []
    tuner = tune.Tuner(report_forbidden,
                       tune_config=tune.TuneConfig(device="cpu"),
                       run_config=train.RunConfig(storage_path=str(tmp_path)))
    fit = threading.Thread(target=lambda: out.append(tuner.fit()),
                           daemon=True)
    fit.start()
    fit.join(180)  # a hang fails here, not at the suite's limit
    assert not fit.is_alive()
    [grid] = out
    assert not grid.errors
    assert grid[0].metrics["forbidden"] == []


# The JAX package's RL modules, each with its port (raytpu_torch/rllib).
RL_MODULES = ("env/envs.py", "env/gym_adapter.py", "env/env_runner.py",
              "utils/replay_buffer.py", "connectors.py", "core/rl_module.py",
              "core/learner.py", "algorithms/algorithm.py",
              "algorithms/ppo.py", "algorithms/impala.py",
              "algorithms/appo.py", "algorithms/dqn.py", "algorithms/sac.py",
              "algorithms/cql.py", "algorithms/bc.py")


def test_every_rl_module_is_ported_and_held_to_the_rules():
    ported = {p.relative_to(REPO / "raytpu_torch" / "rllib").as_posix()
              for p in PORT_FILES if "rllib" in p.parts}
    for name in RL_MODULES:
        assert (REPO / "raytpu" / "rllib" / name).is_file()
        assert name in ported
    assert "convert.py" in ported


def test_engine_refuses_what_is_not_ported():
    from raytpu_torch.inference import InferenceEngine
    from raytpu_torch.models.llama import Llama, LlamaConfig

    model = Llama(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError):
        InferenceEngine(model, tp=2, device="cpu")


def test_engine_serves_gpt2_on_the_cpu_when_asked():
    from raytpu_torch.inference import InferenceEngine
    from raytpu_torch.models.gpt2 import GPT2, GPT2Config

    model = GPT2(GPT2Config.tiny(), device="cpu")
    eng = InferenceEngine(model, device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(NotImplementedError):
        InferenceEngine(model, tp=2, device="cpu")


def test_every_model_module_is_held_to_the_rules():
    # The AST scan and the fresh-interpreter import above cover every
    # module of the package, the Mixtral port's included.
    models = {p.name for p in PORT_FILES if p.parent.name == "models"}
    assert {"gpt2.py", "llama.py", "mixtral.py", "common.py",
            "convert.py", "mlp.py", "resnet.py"} <= models


def test_kernel_sources_and_hopper_build_command():
    for name in _native.KERNELS:
        assert (_native.CSRC / f"{name}.cu").is_file()
    for header in _native.HEADERS:
        assert (_native.CSRC / header).is_file()
    cmd = _native.nvcc_command("nvcc", _native.CSRC / "x.cu",
                               pathlib.Path("libx.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    # The build lands in a directory .gitignore lists.
    rel = _native.BUILD_DIR.relative_to(REPO).as_posix()
    assert f"{rel}/" in (REPO / ".gitignore").read_text().split()
    # The library name follows the sources: editing one rebuilds.
    assert _native.library_path("paged_attention").parent == _native.BUILD_DIR


# Each kernel library and the TPU kernel (file::function) it replaces.
REPLACES = {
    "flash_attention": "raytpu/ops/flash_attention.py::_flash_kernel",
    "paged_attention": "raytpu/ops/paged_attention.py::_paged_kernel",
    "flash_bwd_dq": "raytpu/ops/flash_attention.py::_flash_bwd_dq_kernel",
    "flash_bwd_dkv": "raytpu/ops/flash_attention.py::_flash_bwd_dkv_kernel",
    "rmsnorm": "raytpu/ops/fused.py::_rmsnorm_kernel",
}


def test_kernel_sources_name_the_tpu_kernel_they_replace():
    assert set(REPLACES) == set(_native.KERNELS)
    for name, tpu in REPLACES.items():
        text = (_native.CSRC / f"{name}.cu").read_text()
        assert tpu in text
        # ... and the TPU kernel exists where the comment says.
        path, fn = tpu.split("::")
        assert f"def {fn}(" in (REPO / path).read_text()


def test_rmsnorm_kernel_is_built_for_hopper_from_its_source():
    assert "rmsnorm" in _native.KERNELS
    assert _native.KERNELS["rmsnorm"][0] == "rt_rmsnorm"
    src = _native.CSRC / "rmsnorm.cu"
    assert "_rmsnorm_kernel" in src.read_text()
    cmd = _native.nvcc_command("nvcc", src, pathlib.Path("librmsnorm.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd and str(src) in cmd
    assert _native.library_path("rmsnorm").name.startswith("librmsnorm-")


def test_rmsnorm_off_the_cpu_launches_the_kernel_or_raises():
    # A tensor that is not on the CPU never reaches the plain version:
    # here (no card) the wrapper's input checks refuse it.
    from raytpu_torch.ops import rmsnorm

    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(x, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="force"):
        rmsnorm(torch.ones(4, 8), torch.ones(8), force="interpret")


def test_every_included_header_is_in_the_build_key():
    # An edited header must rebuild every library that includes it.
    included = set()
    for src in _native.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            for line in src.read_text().splitlines():
                if line.startswith('#include "'):
                    included.add(line.split('"')[1])
    assert included == set(_native.HEADERS)


def test_serving_plane_modules_are_held_to_the_rules():
    # The AST scan and the fresh-interpreter import above cover every
    # module of the package, the serving plane's included.
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    assert {"inference/serving.py", "inference/disagg.py",
            "cluster/constants.py", "cluster/transfer.py"} <= names
    for name in ("inference/serving.py", "inference/disagg.py",
                 "cluster/constants.py", "cluster/transfer.py"):
        assert (REPO / "raytpu" / name).is_file()


def test_deployment_raises_without_a_card(monkeypatch):
    import threading

    from raytpu_torch.inference import LLMDeployment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    def loops():
        return {t for t in threading.enumerate() if t.name == "llm-step-loop"}

    before = loops()
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMDeployment()
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMDeployment(model="gpt2", role="prefill")
    assert loops() <= before  # no loop was started


def test_deployment_on_the_cpu_when_asked():
    from raytpu_torch.inference import LLMDeployment

    dep = LLMDeployment(device="cpu", engine_options={
        "page_size": 8, "max_num_seqs": 2, "max_model_len": 32})
    try:
        assert dep._engine.device.type == "cpu"
        assert dep._engine.model.device.type == "cpu"
        out = list(dep.generate([1, 2, 3], max_new_tokens=3))
        assert len(out) == 3 and all(isinstance(t, int) for t in out)
    finally:
        dep.shutdown()
    assert not dep._step_thread.is_alive()


# ---- observability: the JAX package's RTP015 and RTP021 ---------------


def _parse(path: pathlib.Path) -> ast.AST:
    return ast.parse(path.read_text())


def test_util_modules_are_held_to_the_rules():
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for m in UTIL_MODULES:
        assert f"util/{m}.py" in names
        assert (REPO / "raytpu" / "util" / f"{m}.py").is_file()


def _guarded_emissions(node, guarded=0, site="emit_request",
                       flag="request_events_enabled"):
    """(line, guarded) of every ``site`` call under ``node``: guarded
    when it sits in the body of exactly one ``if`` whose test calls
    ``flag()`` exactly once (a test calling it twice is reported as line
    -1; a site under two such guards as unguarded: its path checks the
    flag twice)."""
    def flag_calls(expr):
        return sum(1 for sub in ast.walk(expr) if isinstance(sub, ast.Call)
                   and _named(sub, flag))

    if isinstance(node, ast.If):
        n = flag_calls(node.test)
        if n > 1:
            yield (-1, False)
        yield from _guarded_emissions(node.test, guarded, site, flag)
        for child in node.body:
            yield from _guarded_emissions(child, guarded + (n == 1), site,
                                          flag)
        for child in node.orelse:
            yield from _guarded_emissions(child, guarded, site, flag)
        return
    if isinstance(node, ast.Call) and _named(node, site):
        yield (node.lineno, guarded == 1)
    for child in ast.iter_child_nodes(node):
        yield from _guarded_emissions(child, guarded, site, flag)


def _callee(call: ast.Call):
    f = call.func
    return f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)


def _named(call: ast.Call, name: str) -> bool:
    """Whether ``call`` calls ``name``: a bare name matches any callee of
    that name, ``module.attr`` only that attribute of that name."""
    if "." not in name:
        return _callee(call) == name
    module, attr = name.split(".")
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == attr
            and isinstance(f.value, ast.Name) and f.value.id == module)


def _transitions(tree) -> set:
    """``RequestTransition.X`` names a module references."""
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and getattr(node.value, "attr", getattr(node.value, "id", None))
            == "RequestTransition"}


DEFINING = REPO / "raytpu_torch" / "util" / "task_events.py"


def test_every_request_emission_is_under_one_flag_check():
    for path in PORT_FILES:
        if path == DEFINING:
            continue
        for line, guarded in _guarded_emissions(_parse(path)):
            assert guarded, f"{path.relative_to(REPO)}:{line}"

    def sites(root: pathlib.Path) -> int:
        return sum(len(list(_guarded_emissions(_parse(p))))
                   for p in sorted(root.glob("*.py")))

    # As many sites as the JAX serving plane's: the scheduler's five,
    # the engine's three, the replica's two.
    assert sites(REPO / "raytpu_torch" / "inference") == \
        sites(REPO / "raytpu" / "inference") == 10


def test_every_transition_the_jax_serving_plane_emits_is_emitted():
    def emitted(root: pathlib.Path) -> set:
        return set().union(*(_transitions(_parse(p))
                             for p in sorted(root.glob("*.py"))))

    jax_side = emitted(REPO / "raytpu" / "inference")
    port_side = emitted(REPO / "raytpu_torch" / "inference")
    assert jax_side == {
        "ADMITTED", "PREFILL_START", "PREFILL_END", "HANDOFF_START",
        "HANDOFF_END", "FIRST_TOKEN", "PREEMPTED", "RESUMED", "FINISHED",
        "ABORTED"}
    assert jax_side <= port_side


_METRIC_CTORS = ("Counter", "Gauge", "Histogram")
METRICS_MODULE = REPO / "raytpu_torch" / "util" / "metrics.py"


def _metric_names(path: pathlib.Path) -> list:
    """(line, first argument) of every metric constructed in a module:
    calls of the names imported from raytpu_torch.util.metrics (the
    classes themselves inside it), or of ``<metrics module>.Counter``."""
    tree = _parse(path)
    ctors, modules = set(), set()
    if path == METRICS_MODULE:
        ctors = set(_METRIC_CTORS)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == "raytpu_torch.util.metrics":
                ctors |= {a.asname or a.name for a in node.names
                          if a.name in _METRIC_CTORS}
            elif node.module == "raytpu_torch.util":
                modules |= {a.asname or a.name for a in node.names
                            if a.name == "metrics"}
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (isinstance(f, ast.Name) and f.id in ctors) or (
                isinstance(f, ast.Attribute) and f.attr in _METRIC_CTORS
                and isinstance(f.value, ast.Name) and f.value.id in modules):
            arg = node.args[0] if node.args else None
            out.append((node.lineno, arg.value if isinstance(
                arg, ast.Constant) else None))
    return out


def test_every_metric_the_port_constructs_is_declared():
    from raytpu_torch.util.metrics import DECLARED_METRICS

    minted = set()
    for path in PORT_FILES:
        for line, name in _metric_names(path):
            where = f"{path.relative_to(REPO)}:{line}"
            assert name is not None, f"{where}: name is not a literal"
            assert name in DECLARED_METRICS, f"{where}: {name}"
            minted.add(name)
    # ... and the table holds exactly the names the port mints.
    assert minted == set(DECLARED_METRICS)


# ---- the flight recorder and the metrics pipeline ----------------------

# The members of TaskTransition the port never emits, each with why.
NOT_EMITTED = {
    "PENDING_SCHED": "no nodes: a task waits only for a free slot of the "
                     "one pool, which its SUBMITTED already says",
    "SCHEDULED": "no head picks a node: the pool runs every task",
    "LEASED": "no leases: the pool's workers are its own, never leased",
    "RESTARTING": "an actor's restart is recorded as the JAX local "
                  "backend records it: DEAD, RESTARTED, then CREATED",
    "TRANSFERRED": "no nodes to cross: a value's segment is mapped where "
                   "it is read",
    "NODE_ADDED": "one host, no node lifecycle",
    "NODE_DIED": "one host, no node lifecycle",
}
RECORDER = REPO / "raytpu_torch" / "util" / "task_events.py"
METRICS = REPO / "raytpu_torch" / "util" / "metrics.py"


def _task_transitions(tree) -> set:
    """``TaskTransition.X`` names a module references."""
    return {node.attr for node in ast.walk(tree)
            if isinstance(node, ast.Attribute)
            and getattr(node.value, "attr", getattr(node.value, "id", None))
            == "TaskTransition"}


def test_every_task_event_emission_is_under_one_flag_check():
    sites = 0
    for path in PORT_FILES:
        if path == RECORDER:
            continue
        for line, guarded in _guarded_emissions(
                _parse(path), site="task_events.emit",
                flag="task_events.enabled"):
            assert guarded, f"{path.relative_to(REPO)}:{line}"
            sites += 1
    # The pool's four (SUBMITTED, RETRIED twice, a dead worker's FAILED),
    # its worker's four (RUNNING, FINISHED twice, FAILED), an actor's four
    # (CREATED, DEAD, and a restart's DEAD and RESTARTED), its calls' two
    # (SUBMITTED; FINISHED at a reply or a stream's end or close), the
    # object table's PUT.
    assert sites == 15


@pytest.mark.parametrize("site,flag,n", [
    ("metrics.collect", "metrics.enabled", 2),
    ("metrics.drain", "metrics.enabled", 2),
    ("records.proc_dead", "metrics.enabled", 3),
    ("task_events.drain", "task_events.ship_enabled", 2)])
def test_every_ship_site_is_under_one_flag_check(site, flag, n):
    """Metric collection and tombstones under ``metrics.enabled()``, an
    event ring's drain under ``task_events.ship_enabled()``, outside the
    modules that define them."""
    found = 0
    for path in PORT_FILES:
        if path in (RECORDER, METRICS):
            continue
        for line, guarded in _guarded_emissions(_parse(path), site=site,
                                                flag=flag):
            assert guarded, f"{path.relative_to(REPO)}:{line}"
            found += 1
    assert found == n

def test_the_submit_path_checks_the_recorder_once():
    """TaskPool.submit: exactly one ``task_events.enabled()`` check, and
    its emission inside it (tests/test_task_events.py:402)."""
    tree = _parse(REPO / "raytpu_torch" / "runtime" / "task_pool.py")
    [submit] = [f for node in ast.walk(tree) if isinstance(node, ast.ClassDef)
                and node.name == "TaskPool" for f in node.body
                if isinstance(f, ast.FunctionDef) and f.name == "submit"]
    checks = [n for n in ast.walk(submit) if isinstance(n, ast.Call)
              and _named(n, "task_events.enabled")]
    assert len(checks) == 1
    assert [g for _, g in _guarded_emissions(
        submit, site="task_events.emit",
        flag="task_events.enabled")] == [True]


def test_every_task_transition_is_emitted_or_listed_with_its_reason():
    from raytpu_torch.util.task_events import TaskTransition

    emitted = set().union(*(
        _task_transitions(_parse(p)) for p in PORT_FILES if p != RECORDER))
    assert set(NOT_EMITTED) <= set(TaskTransition.ALL)
    assert not emitted & set(NOT_EMITTED)
    assert set(TaskTransition.ALL) - emitted == set(NOT_EMITTED)


def test_the_state_api_has_the_jax_package_s_names():
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for path in ("state/__init__.py", "state/api.py"):
        assert path in names
        assert (REPO / "raytpu" / path).is_file()

    def exported(path):
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__" for t in node.targets):
                return ast.literal_eval(node.value)
        return None

    assert exported(REPO / "raytpu_torch" / "state" / "__init__.py") == \
        exported(REPO / "raytpu" / "state" / "__init__.py")


# ---- the operator's surface: the dashboard, the CLI and jobs ----------


def test_graph_modules_are_held_to_the_rules():
    """Each of the port's modules of compiled graphs, channels and
    workflows has its JAX module of the same path and that module's
    public names."""
    import importlib

    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for name in GRAPH_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()
    for mod in ("dag", "workflow"):
        jmod = importlib.import_module(f"raytpu.{mod}")
        pmod = importlib.import_module(f"raytpu_torch.{mod}")
        assert pmod.__all__ == jmod.__all__
        assert all(hasattr(pmod, n) for n in pmod.__all__)
    from raytpu.runtime import channel as jchannel

    from raytpu_torch.runtime import channel as pchannel

    assert {"Channel", "ChannelClosed"} <= set(vars(pchannel))
    assert {"Channel", "ChannelClosed"} <= set(vars(jchannel))


def test_parallel_modules_are_held_to_the_rules():
    """Each of the port's modules of the parallel package and the
    collectives has its JAX module of the same path; the two packages
    export the JAX package's names."""
    import importlib

    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for name in PARALLEL_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()
    for mod in ("parallel", "collective"):
        jmod = importlib.import_module(f"raytpu.{mod}")
        pmod = importlib.import_module(f"raytpu_torch.{mod}")
        assert pmod.__all__ == jmod.__all__
        assert all(hasattr(pmod, n) for n in pmod.__all__)


def test_importing_the_parallel_package_loads_no_jax_and_no_group():
    """In a fresh interpreter, in either order: no JAX, no process group
    and no CUDA context."""
    for first, second in (("parallel", "collective"),
                          ("collective", "parallel")):
        code = (f"import json, sys; import raytpu_torch.{first}, "
                f"raytpu_torch.{second}; import torch, "
                f"torch.distributed as d; print(json.dumps(["
                f"sorted(sys.modules), d.is_initialized(), "
                f"torch.cuda.is_initialized()]))")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        loaded, group, cuda = json.loads(out.stdout.strip().splitlines()[-1])
        assert [m for m in loaded if _forbidden(m)] == []
        assert not group and not cuda


def test_operator_modules_are_held_to_the_rules():
    names = {p.relative_to(REPO / "raytpu_torch").as_posix()
             for p in PORT_FILES if "raytpu_torch" in p.parts}
    for name in OPERATOR_MODULES:
        assert name in names
        assert (REPO / "raytpu" / name).is_file()
    assert "util/http_server.py" in names


@pytest.mark.parametrize("name", OPERATOR_MODULES + (
    "util/http_server.py", "util/stack_dump.py", "util/profiler.py",
    "util/profstore.py", "util/memprofile.py", "runtime/api.py",
    "runtime/records.py", "serve/_private/proxy.py"))
def test_operator_sources_import_no_aiohttp_or_requests(name):
    for node in ast.walk(_parse(REPO / "raytpu_torch" / name)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _forbidden(n)
                    or n.split(".")[0] in HTTP_PACKAGES], (name, names)


def _loaded(code: str) -> list:
    """The modules a fresh interpreter has loaded after ``code``, which
    prints them as its last line."""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_cli_s_help_loads_no_jax_raytpu_aiohttp_or_requests():
    loaded = _loaded(
        "import contextlib, io, json, runpy, sys\n"
        "sys.argv = ['raytpu_torch', '--help']\n"
        "with contextlib.redirect_stdout(io.StringIO()) as help_text:\n"
        "    try:\n"
        "        runpy.run_module('raytpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "assert 'dashboard' in help_text.getvalue()\n"
        "print(json.dumps(sorted(sys.modules)))")
    assert "raytpu_torch.scripts.cli" in loaded
    assert [m for m in loaded if _forbidden(m)
            or m.split(".")[0] in HTTP_PACKAGES] == []


def test_started_servers_load_no_jax_raytpu_aiohttp_or_requests():
    loaded = _loaded(
        "import json, sys, urllib.request\n"
        "from raytpu_torch.dashboard import DashboardServer\n"
        "from raytpu_torch.job import JobManager, JobServer, "
        "JobSubmissionClient\n"
        "import tempfile\n"
        "dash = DashboardServer(port=0)\n"
        "url = dash.start()\n"
        "for path in ('/', '/api/summary', '/stacks', "
        "'/profile?duration=0.1', '/api/profile'):\n"
        "    with urllib.request.urlopen(url + path, timeout=60) as r:\n"
        "        assert r.status == 200, path\n"
        "jobs = JobServer(JobManager(log_dir=tempfile.mkdtemp()))\n"
        "client = JobSubmissionClient(jobs.start())\n"
        "job = client.submit_job(entrypoint='true')\n"
        "assert client.wait_until_finished(job, 60) == 'SUCCEEDED'\n"
        "jobs.stop()\n"
        "dash.stop()\n"
        "print(json.dumps(sorted(sys.modules)))")
    assert {"raytpu_torch.dashboard.app", "raytpu_torch.job.server",
            "raytpu_torch.util.http_server"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)
            or m.split(".")[0] in HTTP_PACKAGES] == []
