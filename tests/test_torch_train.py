"""The port's Train library (raytpu_torch/train) on the CPU, at
``device="cpu"`` (gloo): the counterparts of tests/test_train.py's
trainer, checkpoint and ``prepare_data_loader`` tests, and beyond them:
one MLP run through the JAX package's ``JaxTrainer`` and through the
port's trainer from the same weights and batches, world size 2 (DDP,
half a batch a rank) against world size 1, a worker process that dies
mid-run, no worker process left after ``fit``, checkpoints that both
packages' managers keep alike, ``Checkpoint.from_dict`` across the
packages, and the guards.

The workers import this module by name to load the loops, so it imports
nothing of JAX or of the JAX package at module level; the loops are
module-level functions (the port's loop crosses by pickle). Every fit
runs under a time limit (:func:`fit`): a hang fails the test instead of
running the suite into its limit."""

import multiprocessing
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from raytpu_torch import train
from raytpu_torch.models import convert
from raytpu_torch.models.mlp import MLPClassifier, xent_loss
from raytpu_torch.train import (Checkpoint, CheckpointConfig, FailureConfig,
                                RunConfig, ScalingConfig)

# Seconds a fit may take here: a worker process starts (imports torch) in
# a few seconds; anything past this is a hang.
FIT_TIMEOUT_S = 180.0
# fp32 on both sides through a small MLP and 20 Adam steps.
TOL = 1e-5


def fit(trainer, timeout: float = FIT_TIMEOUT_S):
    """``trainer.fit()`` under a time limit."""
    out = {}

    def run():
        try:
            out["result"] = trainer.fit()
        except BaseException as e:  # noqa: BLE001  re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"fit() did not end within {timeout} s"
    if "error" in out:
        raise out["error"]
    return out["result"]


def children() -> set:
    return {p.pid for p in multiprocessing.active_children()}


def cpu(n: int = 1, **kw) -> ScalingConfig:
    return ScalingConfig(num_workers=n, device="cpu", **kw)


def trainer(loop, tmp, n=1, config=None, **run):
    return train.DataParallelTrainer(
        loop, train_loop_config=config, scaling_config=cpu(n),
        run_config=RunConfig(storage_path=str(tmp), **run))


# ---- the loops (module level: they cross to the workers by pickle) ----


def loop_metrics(config):
    for step in range(config["steps"]):
        train.report({"loss": 1.0 / (step + 1), "step": step,
                      "world": train.get_context().world_size})


def loop_real_training(config):
    model = train.prepare_model(MLPClassifier(
        hidden=(32,), n_classes=4, in_features=8, device="cpu"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 8, generator=g)
    y = (x.sum(dim=1) > 0).long() * 3
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for _ in range(20):
        opt.zero_grad()
        loss = xent_loss(model, {"x": x, "y": y})
        loss.backward()
        opt.step()
        losses.append(loss.item())
        train.report({"loss": losses[-1]})
    assert losses[-1] < losses[0]  # actually learning


def _step_checkpoint(step: int) -> Checkpoint:
    d = tempfile.mkdtemp()
    with open(os.path.join(d, "step.txt"), "w") as f:
        f.write(str(step))
    return Checkpoint(d)


def _resume_step() -> int:
    ckpt = train.get_checkpoint()
    if ckpt is None:
        return 0
    with open(os.path.join(ckpt.path, "step.txt")) as f:
        return int(f.read()) + 1


def loop_checkpoints(config):
    for step in range(4):
        train.report({"score": step}, checkpoint=_step_checkpoint(step))


def loop_raises(config):
    raise RuntimeError("worker exploded")


def loop_restart(config):
    start = _resume_step()
    for step in range(start, 6):
        train.report({"step": step}, checkpoint=_step_checkpoint(step))
        if step == 3 and start == 0:
            raise RuntimeError("simulated mid-train crash")


def loop_dies(config):
    """Exits the process after step 3 on the first attempt (the marker
    file says which attempt this is)."""
    first = not os.path.exists(config["marker"])
    start = _resume_step()
    for step in range(start, 6):
        train.report({"step": step, "pid": os.getpid()},
                     checkpoint=_step_checkpoint(step))
        if step == 3 and first:
            with open(config["marker"], "w") as f:
                f.write(str(os.getpid()))
            os._exit(1)


def loop_fails_first(config):
    """Raises before any report on the first attempt (the marker file
    says which attempt this is), then runs on from its checkpoint."""
    start = _resume_step()
    if not os.path.exists(config["marker"]):
        open(config["marker"], "w").close()
        raise RuntimeError("failed before its first checkpoint")
    for step in range(start, 6):
        train.report({"step": step}, checkpoint=_step_checkpoint(step))


def loop_mlp(config):
    """Adam steps of the MLP from ``config["state"]`` over
    ``config["batches"]``, each rank taking its share of every batch;
    reports the local loss each step, and the parameters at the end."""
    ctx = train.get_context()
    model = MLPClassifier(device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in config["state"].items()})
    model = train.prepare_model(model)
    opt = torch.optim.Adam(model.parameters(), lr=config["lr"])
    for x, y in config["batches"]:
        share = len(x) // ctx.world_size
        rows = slice(ctx.rank * share, (ctx.rank + 1) * share)
        batch = {"x": torch.from_numpy(x[rows]),
                 "y": torch.from_numpy(y[rows])}
        opt.zero_grad()
        loss = xent_loss(model, batch)
        loss.backward()
        opt.step()
        train.report({"loss": loss.item()})
    inner = getattr(model, "module", model)
    train.report({"params": {n: p.detach().numpy().copy()
                             for n, p in inner.named_parameters()}})


# ---- tests/test_train.py's JaxTrainer tests, in the port --------------


def test_fit_reports_metrics_at_world_size_2(tmp_path):
    result = fit(trainer(loop_metrics, tmp_path, 2, {"steps": 5}))
    assert result.error is None
    assert len(result.metrics_history) == 5
    assert result.metrics["step"] == 4
    assert result.metrics["world"] == 2


def test_fit_real_training(tmp_path):
    result = fit(trainer(loop_real_training, tmp_path))
    assert result.error is None
    assert result.metrics["loss"] < 1.0


def test_checkpointing_and_topk(tmp_path):
    result = fit(trainer(loop_checkpoints, tmp_path,
                         checkpoint_config=CheckpointConfig(
                             num_to_keep=2,
                             checkpoint_score_attribute="score")))
    assert result.error is None
    assert result.checkpoint is not None
    with open(os.path.join(result.checkpoint.path, "step.txt")) as f:
        assert f.read() == "3"
    kept = sorted(os.listdir(os.path.join(result.path, "checkpoints")))
    assert kept == ["checkpoint_000003", "checkpoint_000004"]


def test_worker_error_surfaces(tmp_path):
    before = children()
    result = fit(trainer(loop_raises, tmp_path, 2))
    assert result.error is not None
    assert "worker exploded" in str(result.error)
    assert children() <= before  # nor does a failed fit leave a process


def test_gang_restart_on_failure(tmp_path):
    result = fit(trainer(loop_restart, tmp_path,
                         failure_config=FailureConfig(max_failures=1)))
    assert result.error is None
    assert result.metrics["step"] == 5
    steps = [m["step"] for m in result.metrics_history]
    assert steps == [0, 1, 2, 3, 4, 5]  # resumed after the last checkpoint


def test_a_restart_before_any_checkpoint_keeps_the_resume_point(tmp_path):
    # The JAX trainer restarts from manager.latest(), None here, and so
    # from scratch; the port keeps the run's own resume point.
    first = fit(trainer(loop_checkpoints, tmp_path / "first"))
    assert first.error is None
    resumed = fit(train.DataParallelTrainer(
        loop_fails_first, train_loop_config={"marker": str(tmp_path / "m")},
        scaling_config=cpu(), resume_from_checkpoint=first.checkpoint,
        run_config=RunConfig(storage_path=str(tmp_path / "second"),
                             failure_config=FailureConfig(max_failures=1))))
    assert resumed.error is None
    assert [m["step"] for m in resumed.metrics_history] == [4, 5]


def test_pytree_roundtrip_through_dcp(tmp_path):
    from raytpu_torch.train import restore_pytree, save_pytree

    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4),
            "nested": {"h": torch.arange(6, dtype=torch.bfloat16),
                       "step": torch.tensor(7)}, "lr": 3e-4}
    ckpt = save_pytree(tree, os.path.join(tmp_path, "ptree"))
    ckpt = save_pytree(tree, ckpt.path)  # replaces the directory
    out = restore_pytree(ckpt)
    assert set(out) == set(tree) and out["lr"] == 3e-4
    for got, want in ((out["w"], tree["w"]), (out["b"], tree["b"]),
                      (out["nested"]["h"], tree["nested"]["h"]),
                      (out["nested"]["step"], tree["nested"]["step"])):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    target = {"w": torch.zeros(3, 4), "b": torch.zeros(4),
              "nested": {"h": torch.zeros(6, dtype=torch.bfloat16),
                         "step": torch.tensor(0)}, "lr": None}
    w = target["w"]
    assert restore_pytree(ckpt.path, target=target) is target
    assert target["w"] is w  # loaded in place
    torch.testing.assert_close(w, tree["w"], rtol=0, atol=0)
    assert target["lr"] == 3e-4


# ---- beyond tests/test_train.py ---------------------------------------


def test_report_marks_the_train_step_profiler(monkeypatch):
    # As raytpu/train/session.py:61-67: with profiling on, each report
    # after the first observes one step (with its FLOPs where the metrics
    # carry them) and the device's memory; with it off, nothing.
    from raytpu_torch.train import session as session_mod

    seen = []

    class Prof:
        marks = iter([None, 0.25, 0.5])

        def mark(self):
            return next(self.marks)

        def observe_step(self, dt, flops=None):
            seen.append(("step", dt, flops))

        def observe_hbm(self, device):
            seen.append(("hbm", device.type))

    prof = Prof()
    monkeypatch.setattr(session_mod, "step_profiler", lambda kind: prof)
    s = session_mod._Session(session_mod.TrainContext(
        device=torch.device("cpu")))
    monkeypatch.setattr(session_mod, "profiling_enabled", lambda: False)
    s.report({"loss": 1.0})
    assert seen == []
    monkeypatch.setattr(session_mod, "profiling_enabled", lambda: True)
    for metrics in ({"loss": 1.0}, {"loss": 0.9, "flops": 2e9},
                    {"loss": 0.8}):
        s.report(metrics)
    assert seen == [("step", 0.25, 2e9), ("hbm", "cpu"),
                    ("step", 0.5, None), ("hbm", "cpu")]
    assert len(s.drain()) == 4


def _mlp_run(seed: int = 0, steps: int = 20, b: int = 16):
    """The JAX MLP's init (fashion-MNIST's shapes) as numpy, and seeded
    numpy batches."""
    import jax
    import jax.numpy as jnp

    from raytpu.models import mlp as jax_mlp

    rng = np.random.default_rng(seed)
    batches = [(rng.standard_normal((b, 28, 28, 1)).astype(np.float32),
                rng.integers(0, 10, b).astype(np.int32))
               for _ in range(steps)]
    model = jax_mlp.MLPClassifier(hidden=(128, 128), n_classes=10)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.asarray(batches[0][0]))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params), batches


def _mlp_config(params, batches):
    state = {k: v.numpy() for k, v in
             convert.mlp_state_from_jax(params).items()}
    return {"state": state, "batches": batches, "lr": 1e-2}


def test_mlp_losses_match_the_jax_trainer(raytpu_local, tmp_path):
    import jax
    import jax.numpy as jnp
    import optax

    from raytpu.models import mlp as jax_mlp
    from raytpu.train import JaxTrainer
    from raytpu.train import RunConfig as JaxRunConfig
    from raytpu.train import ScalingConfig as JaxScalingConfig
    from raytpu.train import report as jax_report

    model, params, batches = _mlp_run()

    def jax_loop(config):
        p = jax.tree_util.tree_map(jnp.asarray, params)
        opt = optax.adam(1e-2)
        state = opt.init(p)

        @jax.jit
        def step(p, state, x, y):
            loss, grads = jax.value_and_grad(
                lambda q: jax_mlp.xent_loss(model, q, {"x": x, "y": y}))(p)
            updates, state = opt.update(grads, state, p)
            return optax.apply_updates(p, updates), state, loss

        for x, y in batches:
            p, state, loss = step(p, state, x, y)
            jax_report({"loss": float(loss)})

    want = JaxTrainer(
        jax_loop, scaling_config=JaxScalingConfig(num_workers=1),
        run_config=JaxRunConfig(storage_path=str(tmp_path / "jax")),
    ).fit()
    assert want.error is None
    got = fit(trainer(loop_mlp, tmp_path / "port", 1,
                      _mlp_config(params, batches)))
    assert got.error is None
    jl = [m["loss"] for m in want.metrics_history]
    pl = [m["loss"] for m in got.metrics_history[:-1]]
    assert len(jl) == len(pl) == 20
    assert pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=TOL, atol=0)


def test_world_2_ddp_matches_world_1(tmp_path):
    _, params, batches = _mlp_run(seed=1, steps=8)
    config = _mlp_config(params, batches)
    one = fit(trainer(loop_mlp, tmp_path / "w1", 1, config))
    two = fit(trainer(loop_mlp, tmp_path / "w2", 2, config))
    assert one.error is None and two.error is None
    p1, p2 = one.metrics["params"], two.metrics["params"]
    assert set(p1) == set(p2)
    moved = 0.0
    for name in p1:
        np.testing.assert_allclose(p2[name], p1[name], rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(p1[name]).max()))
        moved = max(moved, float(np.abs(p1[name] - config["state"][name])
                                 .max()))
    assert moved > 1e-3  # the steps moved the parameters


def test_a_dead_worker_restarts_the_gang(tmp_path):
    before = children()
    result = fit(trainer(loop_dies, tmp_path, 1,
                         {"marker": str(tmp_path / "died")},
                         failure_config=FailureConfig(max_failures=1)))
    assert result.error is None
    assert result.metrics["step"] == 5
    with open(tmp_path / "died") as f:
        dead = int(f.read())
    pids = {m["pid"] for m in result.metrics_history}
    assert dead in pids and len(pids) == 2  # a second process finished
    assert children() <= before


def test_a_dead_gang_s_undrained_checkpoints_are_registered(tmp_path):
    # The loop reports four checkpointed steps and exits at once, mostly
    # before the trainer's first poll: those reports are read back from
    # their staged snapshots, so the restart resumes after step 3.
    result = fit(trainer(loop_dies, tmp_path, 1,
                         {"marker": str(tmp_path / "died")},
                         failure_config=FailureConfig(max_failures=1)))
    assert result.error is None
    with open(tmp_path / "died") as f:
        dead = int(f.read())
    steps = [(m["step"], m["pid"] == dead) for m in result.metrics_history]
    assert steps == [(0, True), (1, True), (2, True), (3, True),
                     (4, False), (5, False)]
    assert not os.path.exists(result.path + "/.staged_ckpts")


def test_a_dead_worker_without_retries_fails_fit(tmp_path):
    from raytpu_torch.core.errors import TaskError

    before = children()
    result = fit(trainer(loop_dies, tmp_path, 2,
                         {"marker": str(tmp_path / "died")}))
    assert isinstance(result.error, TaskError)
    assert "ActorDiedError" in str(result.error)
    assert children() <= before


def test_no_worker_process_outlives_fit(tmp_path):
    before = children()
    result = fit(trainer(loop_metrics, tmp_path, 2, {"steps": 2}))
    assert result.error is None
    assert children() <= before


def _register_all(manager_cls, checkpoint_cls, root, seq, **kw):
    manager = manager_cls(str(root / "checkpoints"), **kw)
    for i, metrics in enumerate(seq):
        d = root / f"src_{i}"
        d.mkdir()
        (d / "state.txt").write_text(str(i))
        manager.register(checkpoint_cls(str(d)), metrics)
    kept = sorted(os.listdir(root / "checkpoints"))
    saved = {name: (root / "checkpoints" / name / "_metrics.json")
             .read_text() for name in kept}
    return kept, saved, _name(manager.best()), _name(manager.latest())


def _name(ckpt):
    return None if ckpt is None else os.path.basename(ckpt.path)


@pytest.mark.parametrize("kw", [
    {"num_to_keep": 2, "score_attribute": "score"},
    {"num_to_keep": 2, "score_attribute": "score", "score_order": "min"},
    {"num_to_keep": 1},
    {},
], ids=["top2-max", "top2-min", "recency", "keep-all"])
def test_checkpoint_manager_keeps_what_the_jax_one_keeps(tmp_path, kw):
    from raytpu.train.checkpoint import Checkpoint as JaxCheckpoint
    from raytpu.train.checkpoint import CheckpointManager as JaxManager

    seq = [{"score": s, "step": i, "tag": object() if i == 2 else "x"}
           for i, s in enumerate([0.3, 0.9, 0.1, 0.5, 0.7])]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_side = _register_all(JaxManager, JaxCheckpoint, tmp_path / "jax",
                             seq, **kw)
    port_side = _register_all(train.CheckpointManager, Checkpoint,
                              tmp_path / "port", seq, **kw)
    # The object's repr differs between the two runs only by its address.
    def strip(saved):
        return {k: v.split(" at ")[0] for k, v in saved.items()}

    assert jax_side[0] == port_side[0]
    assert strip(jax_side[1]) == strip(port_side[1])
    assert jax_side[2:] == port_side[2:]


def test_checkpoint_from_dict_crosses_both_ways():
    from raytpu.train.checkpoint import Checkpoint as JaxCheckpoint

    data = {"step": 7, "name": "run", "w": np.arange(6.0).reshape(2, 3),
            "ids": np.array([3, 1], dtype=np.int32)}

    def same(a, b):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    same(JaxCheckpoint(Checkpoint.from_dict(data).path).to_dict(), data)
    same(Checkpoint(JaxCheckpoint.from_dict(data).path).to_dict(), data)


def test_guards_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="elastic"):
        ScalingConfig(num_workers=2, min_workers=1, elastic=True)
    with pytest.raises(NotImplementedError, match="multi-host"):
        ScalingConfig(coordinator_address="10.0.0.2:29500")
    ScalingConfig(num_workers=2, elastic=True)  # fixed-size: no probe needed
    ScalingConfig(coordinator_address="auto")
    with pytest.raises(ValueError, match="device"):
        ScalingConfig(device="tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    # The tree's cards are the driver's ledger's: one.
    from raytpu_torch.runtime import api
    monkeypatch.setattr(api, "cluster_resources",
                        lambda: {"CPU": 4.0, "GPU": 1.0})
    gang = train.DataParallelTrainer(
        loop_metrics, scaling_config=ScalingConfig(num_workers=2))
    before = children()
    with pytest.raises(ValueError, match="2 workers.*has 1"):
        gang.fit()
    assert children() <= before


def test_a_loop_that_does_not_pickle_is_refused(tmp_path):
    def closure(config):
        train.report({"x": 1})

    for loop in (closure, lambda config: None):
        with pytest.raises(ValueError, match="does not pickle"):
            trainer(loop, tmp_path).fit()


# ---- tests/test_train.py's prepare_data_loader tests, in the port ------


class TestPrepareDataLoader:
    """The loader rebuild: constructor attributes kept, loud warnings on
    the unshardable pass-through cases. A fake world of 2 is injected by
    monkeypatching torch.distributed; construction never iterates."""

    @pytest.fixture
    def world2(self, monkeypatch):
        import torch.distributed as dist

        monkeypatch.setattr(dist, "is_available", lambda: True)
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(dist, "get_rank", lambda: 0)

    def test_rebuild_preserves_loader_attrs(self, world2):
        from torch.utils.data import DataLoader, TensorDataset

        from raytpu_torch.train import prepare_data_loader

        def init_fn(_):
            pass

        gen = torch.Generator()
        ds = TensorDataset(torch.arange(32).float())
        loader = DataLoader(ds, batch_size=4, shuffle=True,
                            num_workers=2, pin_memory=True,
                            worker_init_fn=init_fn, generator=gen,
                            persistent_workers=True, prefetch_factor=4,
                            timeout=7.5, drop_last=True)
        out = prepare_data_loader(loader)
        assert out is not loader
        assert out.batch_size == 4 and out.drop_last
        assert out.pin_memory is True
        assert out.worker_init_fn is init_fn
        assert out.generator is gen
        assert out.persistent_workers is True
        assert out.prefetch_factor == 4
        assert out.timeout == 7.5
        assert out.sampler.shuffle and out.sampler.num_replicas == 2

    def test_rebuild_no_workers_skips_worker_only_kwargs(self, world2):
        from torch.utils.data import DataLoader, TensorDataset

        from raytpu_torch.train import prepare_data_loader

        ds = TensorDataset(torch.arange(8).float())
        out = prepare_data_loader(DataLoader(ds, batch_size=2))
        assert out.num_workers == 0
        assert not out.sampler.shuffle  # eval loader stays ordered

    def test_custom_sampler_replacement_warns(self, world2):
        from torch.utils.data import (DataLoader, TensorDataset,
                                      WeightedRandomSampler)

        from raytpu_torch.train import prepare_data_loader

        ds = TensorDataset(torch.arange(8).float())
        loader = DataLoader(
            ds, batch_size=2,
            sampler=WeightedRandomSampler([1.0] * 8, 8))
        with pytest.warns(UserWarning, match="WeightedRandomSampler"):
            out = prepare_data_loader(loader)
        assert out.sampler.num_replicas == 2  # still sharded

    def test_iterable_dataset_warns_and_passes_through(self, world2):
        from torch.utils.data import DataLoader, IterableDataset

        from raytpu_torch.train import prepare_data_loader

        class Stream(IterableDataset):
            def __iter__(self):
                return iter(range(8))

        loader = DataLoader(Stream(), batch_size=2)
        with pytest.warns(UserWarning, match="FULL dataset"):
            assert prepare_data_loader(loader) is loader

    def test_batch_sampler_loader_warns_and_passes_through(self, world2):
        from torch.utils.data import (BatchSampler, DataLoader,
                                      SequentialSampler, TensorDataset)

        from raytpu_torch.train import prepare_data_loader

        ds = TensorDataset(torch.arange(8).float())
        bs = BatchSampler(SequentialSampler(ds), batch_size=2,
                          drop_last=False)
        loader = DataLoader(ds, batch_sampler=bs)
        with pytest.warns(UserWarning, match="FULL dataset"):
            assert prepare_data_loader(loader) is loader
