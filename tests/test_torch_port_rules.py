"""Rules of the port (raytpu_torch/, chip_smoke.py): it imports neither
JAX nor the JAX package (nor ``prometheus_client``: its metrics are in
memory only), its entry points never move to the CPU on their own, its
CUDA kernels are built from the repo's sources for Hopper, and its
observability keeps the JAX package's lint rules: every request event
is emitted under one flag check and every transition the JAX serving
plane emits is emitted (RTP021), and every metric it constructs is
declared (RTP015)."""

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
    REPO / "chip_smoke.py", REPO / "ab_wrappers.py", REPO / "rmsnorm_plans.py"]

# The port's copies of raytpu/util's serving-plane observability.
UTIL_MODULES = ("metrics", "tracing", "task_events", "serve_slo",
                "profiler", "stepprof")

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
    return top in ("jax", "jaxlib", "flax", "raytpu", "prometheus_client")


def test_port_imports_no_jax_and_nothing_of_raytpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "raytpu_torch.inference.engine" in loaded
    assert {f"raytpu_torch.util.{m}" for m in UTIL_MODULES} <= set(loaded)
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
            "convert.py"} <= models


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


def _guarded_emissions(node, guarded=False):
    """(line, guarded) of every ``emit_request`` call under ``node``:
    guarded when it sits in the body of an ``if`` whose test calls
    ``request_events_enabled()`` exactly once (a test calling it twice
    is reported as line -1)."""
    def flag_calls(expr):
        return sum(1 for sub in ast.walk(expr) if isinstance(sub, ast.Call)
                   and _callee(sub) == "request_events_enabled")

    if isinstance(node, ast.If):
        n = flag_calls(node.test)
        if n > 1:
            yield (-1, False)
        yield from _guarded_emissions(node.test, guarded)
        for child in node.body:
            yield from _guarded_emissions(child, guarded or n == 1)
        for child in node.orelse:
            yield from _guarded_emissions(child, guarded)
        return
    if isinstance(node, ast.Call) and _callee(node) == "emit_request":
        yield (node.lineno, guarded)
    for child in ast.iter_child_nodes(node):
        yield from _guarded_emissions(child, guarded)


def _callee(call: ast.Call):
    f = call.func
    return f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)


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
