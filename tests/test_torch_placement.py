"""The libraries take the card as a resource: Train's gang in its placement
group, Tune's trials and serve's replicas sharing cards through the
driver's ledger, on one runtime with two pretend cards (nothing touches
CUDA: the gang and the trials run on the CPU, holding and bound to their
shares all the same).

- ``ScalingConfig.bundle_specs`` equals the JAX package's, its ``"TPU"``
  chips a worker read as the port's ``"GPU": 1``;
- a world-2 gloo gang runs inside its STRICT_PACK group (each worker
  reads it as its current group) and the group is gone after ``fit``;
- a Tune run with ``resources_per_trial={"CPU": 1, "GPU": 0.5}`` holds at
  most four trials at once on two cards, each bound to its card;
- a serve replica with ``ray_actor_options={"num_gpus": 0.5}`` takes its
  share while it lives and gives it back at ``serve.shutdown()``.

This module imports nothing of JAX at its top: workers import it by name.
"""

import os
import time

import pytest

from raytpu_torch import runtime, train, tune
from raytpu_torch.train import RunConfig, ScalingConfig

T = 60.0


@pytest.fixture(scope="module")
def tree():
    runtime.init(num_cpus=6, num_gpus=2, resources={"slot": 2})
    yield runtime
    runtime.shutdown()


def test_bundle_specs_equal_the_jax_package_s():
    from raytpu.train.config import ScalingConfig as JaxScaling

    def as_port(bundles):
        return [{("GPU" if k == "TPU" else k): v for k, v in b.items()}
                for b in bundles]

    for port, jax in (
            (ScalingConfig(num_workers=2),
             JaxScaling(num_workers=2, use_tpu=True, chips_per_worker=1)),
            (ScalingConfig(num_workers=3, device="cpu",
                           resources_per_worker={"CPU": 2, "mem": 1}),
             JaxScaling(num_workers=3,
                        resources_per_worker={"CPU": 2, "mem": 1})),
            (ScalingConfig(num_workers=2, resources_per_worker={"x": 1}),
             JaxScaling(num_workers=2, use_tpu=True, chips_per_worker=1,
                        resources_per_worker={"x": 1}))):
        assert port.placement_strategy == jax.placement_strategy
        assert port.bundle_specs() == as_port(jax.bundle_specs())
        assert port.bundle_specs(1) == as_port(jax.bundle_specs(1))
    with pytest.raises(ValueError, match="placement_strategy"):
        ScalingConfig(placement_strategy="ANYWHERE")


def gang_loop(config):
    import raytpu_torch

    pg = raytpu_torch.get_current_placement_group()
    ctx = train.get_context()
    train.report({"pg": pg.id.hex(), "strategy": pg.strategy,
                  "bundles": pg.bundle_specs, "world": ctx.world_size})


def test_a_gloo_gang_runs_in_its_strict_pack_group(tree, tmp_path):
    result = train.DataParallelTrainer(
        gang_loop, scaling_config=ScalingConfig(
            num_workers=2, device="cpu",
            resources_per_worker={"CPU": 1, "slot": 1}),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None
    m = result.metrics
    assert m["world"] == 2 and m["strategy"] == "STRICT_PACK"
    assert m["bundles"] == [{"CPU": 1.0, "slot": 1.0}] * 2
    api = runtime.api
    assert api._ledger().group_info(m["pg"]) is None
    assert api._ledger().groups() == []
    assert runtime.available_resources() == runtime.cluster_resources()


def test_a_gang_whose_bundles_cannot_be_reserved_fails(tree, tmp_path):
    result = train.DataParallelTrainer(
        gang_loop, scaling_config=ScalingConfig(
            num_workers=2, device="cpu", resources_per_worker={"CPU": 4}),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert "PlacementGroupError" in str(result.error)
    assert runtime.api._ledger().groups() == []


def trial(config):
    started = time.time()
    time.sleep(0.3)
    tune.report({"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                 "span": [started, time.time()], "x": config["x"]})


def test_trials_share_the_cards_through_resources_per_trial(tree, tmp_path):
    grid = tune.Tuner(
        trial, param_space={"x": tune.grid_search(list(range(6)))},
        tune_config=tune.TuneConfig(
            device="cpu", max_concurrent_trials=6,
            resources_per_trial={"CPU": 1, "GPU": 0.5}),
        run_config=RunConfig(name="share", storage_path=str(tmp_path))).fit()
    results = [r.metrics for r in grid]
    assert sorted(m["x"] for m in results) == list(range(6))
    assert {m["visible"] for m in results} <= {"0", "1"}
    spans = [m["span"] for m in results]
    at_once = max(sum(1 for a, b in spans if a <= t < b) for t, _ in spans)
    assert at_once <= 4
    assert runtime.available_resources() == runtime.cluster_resources()


class Where:
    def __call__(self, _=None):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_a_replica_takes_its_share_of_a_card(tree):
    from raytpu_torch import serve

    try:
        handle = serve.run(serve.deployment(Where).options(
            ray_actor_options={"num_gpus": 0.5}).bind(), name="where")
        assert handle.remote().result() == "0"
        assert runtime.available_resources()["GPU"] == 1.5
    finally:
        serve.shutdown()
    end = time.monotonic() + T
    while runtime.available_resources() != runtime.cluster_resources():
        assert time.monotonic() < end
        time.sleep(0.05)
