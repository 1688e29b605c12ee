"""The port's Data library (raytpu_torch/data) against the JAX package's
(raytpu/data) on the CPU: every test of tests/test_data.py's transforms,
exchanges, consumption, operators and ingest runs the same scenario on
the same seeded inputs through both packages, and the rows are equal
(in order wherever the JAX package defines one), and then the JAX
test's own assertions hold for the port's result. Sources and sinks
are in tests/test_torch_data_io.py.

Differences the counterparts carry: ``test_materialize``'s spy counts
calls in a file (the port's tasks run in worker processes, the JAX
package's in threads of the test process); the budget reads the
port's ``executor.DATA_MEMORY_BUDGET_BYTES`` where the JAX test sets
``cfg.data_memory_budget_bytes``; ``TestExchangeOnCluster`` becomes the
same shuffle and sort across the port's task pool processes (and the
JAX package's local fabric); ``test_dataset_into_trainer`` runs through
the port's trainer at world size 2 on gloo. ``test_iter_jax_batches``
and ``test_from_jax`` (JAX arrays) have no counterpart.

This module imports nothing of JAX at its top: the port's task workers
and train workers import it by name to find its module-level helpers.
"""

import math
import os

import numpy as np
import pytest
import torch

import raytpu_torch.data as td
from raytpu_torch import runtime
from raytpu_torch.data.block import BlockAccessor


@pytest.fixture(scope="module")
def both():
    """(the JAX package's data module, the port's): one fabric each for
    the whole module (the port's task pool starts four workers)."""
    import raytpu
    import raytpu.data as jd

    raytpu.shutdown()
    raytpu.init(num_cpus=4)
    runtime.shutdown()
    runtime.init(num_cpus=4)
    yield jd, td
    raytpu.shutdown()
    runtime.shutdown()


def plain(x):
    """A result with numpy scalars and arrays as Python values (NaN as a
    string), for equality."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [plain(v) for v in x.tolist()]
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def same(both, scenario):
    """``scenario(rd)`` through both packages: the port's result, once it
    equals the JAX package's."""
    jd, port = both
    want = scenario(jd)
    got = scenario(port)
    assert plain(got) == plain(want)
    return got


def ids(rows, key="id"):
    return [int(r[key]) for r in rows]


class TestTransforms:
    def test_map_batches_numpy(self, both):
        total = same(both, lambda rd: rd.range(100, blocks=4).map_batches(
            lambda b: {"id": b["id"] * 2}).sum("id"))
        assert total == 2 * sum(range(100))

    def test_map_and_filter(self, both):
        rows = same(both, lambda rd: (
            rd.range(20, blocks=2)
            .map(lambda r: {"v": int(r["id"]) + 1})
            .filter(lambda r: r["v"] % 2 == 0)).take_all())
        assert sorted(r["v"] for r in rows) == [2, 4, 6, 8, 10, 12, 14, 16,
                                               18, 20]

    def test_flat_map(self, both):
        rows = same(both, lambda rd: rd.range(5, blocks=1).flat_map(
            lambda r: [{"v": int(r["id"])}, {"v": int(r["id"])}]).take_all())
        assert len(rows) == 10

    def test_chained_streaming(self, both):
        def scenario(rd):
            ds = (rd.range(1000, blocks=8)
                  .map_batches(lambda b: {"id": b["id"] + 1})
                  .map_batches(lambda b: {"id": b["id"] * 3}))
            return ds.min("id"), ds.max("id"), ids(ds.take_all())

        lo, hi, _ = same(both, scenario)
        assert lo == 3.0 and hi == 3000.0

    def test_limit_stops_early(self, both):
        rows = same(both, lambda rd: rd.range(10_000, blocks=100)
                    .limit(15).take_all())
        assert len(rows) == 15

    def test_repartition(self, both):
        def scenario(rd):
            ds = rd.range(100, blocks=10).repartition(3)
            return ds.stats()["blocks"], ids(ds.take_all())

        blocks, rows = same(both, scenario)
        assert blocks == 3 and rows == list(range(100))

    def test_random_shuffle_preserves_rows(self, both):
        rows = same(both, lambda rd: ids(rd.range(50, blocks=5)
                                         .random_shuffle(seed=7).take_all()))
        assert sorted(rows) == list(range(50))

    def test_sort(self, both):
        rows = same(both, lambda rd: rd.from_items(
            [{"k": v} for v in [5, 3, 9, 1]]).sort("k").take_all())
        assert [r["k"] for r in rows] == [1, 3, 5, 9]

    def test_union(self, both):
        rows = same(both, lambda rd: ids(rd.range(10).union(
            rd.range(5)).take_all()))
        assert len(rows) == 15

    def test_select_drop_columns(self, both):
        def scenario(rd):
            ds = rd.from_numpy({"a": np.arange(5), "b": np.arange(5)})
            return (sorted(ds.select_columns(["a"]).take(1)[0]),
                    sorted(ds.drop_columns(["a"]).take(1)[0]))

        assert same(both, scenario) == (["a"], ["b"])


class TestConsumption:
    def test_iter_batches_sizes(self, both):
        sizes = same(both, lambda rd: [len(b["id"]) for b in rd.range(
            103, blocks=7).iter_batches(batch_size=25)])
        assert sum(sizes) == 103 and all(s == 25 for s in sizes[:-1])

    def test_iter_batches_pandas(self, both):
        cols = same(both, lambda rd: list(next(rd.range(10, blocks=2)
                                               .iter_batches(
            batch_size=10, batch_format="pandas")).columns))
        assert cols == ["id"]

    def test_to_pandas(self, both):
        frame = same(both, lambda rd: rd.range(10).to_pandas()[
            "id"].tolist())
        assert len(frame) == 10

    def test_materialize(self, both, tmp_path):
        def scenario(rd):
            log = str(tmp_path / f"spy-{rd.__name__}.log")

            def spy(b):
                with open(log, "a") as f:
                    f.write("1\n")
                return b

            ds = rd.range(10, blocks=2).map_batches(spy).materialize()
            first = ds.count()
            calls = len(open(log).read().split())
            second = ds.count()  # second pass reuses blocks
            return first, second, calls, len(open(log).read().split())

        first, second, calls, after = same(both, scenario)
        assert first == second == 10 and after == calls


class TestStreamingSplit:
    def test_split_covers_all_rows(self, both):
        def scenario(rd):
            its = rd.range(100, blocks=10).streaming_split(2)
            return ids(its[0].iter_rows()), ids(its[1].iter_rows())

        rows0, rows1 = same(both, scenario)
        assert sorted(rows0 + rows1) == list(range(100))
        assert rows0 and rows1

    def test_split_batches(self, both):
        def scenario(rd):
            its = rd.range(64, blocks=8).streaming_split(2)
            return [len(b["id"]) for it in its
                    for b in it.iter_batches(batch_size=8)]

        assert sum(same(both, scenario)) == 64


def shard_rows_loop(config):
    """A train loop (module level: the trainer sends it by name): this
    rank's rows of the train shard, written to a file of its own."""
    from raytpu_torch import train

    ctx = train.get_context()
    seen = [int(i) for batch in train.get_dataset_shard("train")
            .iter_batches(batch_size=10) for i in batch["id"]]
    np.save(os.path.join(config["out"], f"rank{ctx.get_world_rank()}.npy"),
            np.asarray(seen, np.int64))
    train.report({"rows_seen": len(seen)})


class TestTrainIntegration:
    def test_dataset_into_trainer(self, both, tmp_path):
        import raytpu.data as jd
        from raytpu.train import JaxTrainer, RunConfig, ScalingConfig, report
        from raytpu.train.session import get_dataset_shard

        from raytpu_torch import train

        def loop(config):
            it = get_dataset_shard("train")
            seen = 0
            for batch in it.iter_batches(batch_size=10):
                seen += len(batch["id"])
            report({"rows_seen": seen})

        want = JaxTrainer(
            loop, datasets={"train": jd.range(100, blocks=10)},
            scaling_config=ScalingConfig(num_workers=2),
            run_config=RunConfig(storage_path=str(tmp_path / "jax")),
        ).fit()
        assert want.error is None and want.metrics["rows_seen"] > 0

        out = tmp_path / "port-rows"
        out.mkdir()
        result = train.DataParallelTrainer(
            shard_rows_loop, train_loop_config={"out": str(out)},
            datasets={"train": td.range(100, blocks=10)},
            scaling_config=train.ScalingConfig(num_workers=2, device="cpu"),
            run_config=train.RunConfig(storage_path=str(tmp_path / "port")),
        ).fit()
        assert result.error is None, result.error
        assert result.metrics["rows_seen"] > 0
        per_rank = [np.load(out / f"rank{r}.npy") for r in (0, 1)]
        assert all(len(rows) for rows in per_rank)
        assert sorted(np.concatenate(per_rank).tolist()) == list(range(100))


class TestDistributedExchange:
    def test_repartition_spreads_rows(self, both):
        sizes = same(both, lambda rd: [len(b["id"]) for b in rd.range(
            1000, blocks=3).repartition(5).iter_blocks()])
        assert len(sizes) == 5 and sum(sizes) == 1000
        assert max(sizes) - min(sizes) <= len(sizes), sizes

    def test_random_shuffle_permutes_all_rows(self, both):
        out = np.asarray(same(both, lambda rd: np.concatenate(
            [b["id"] for b in rd.range(2000, blocks=4)
             .random_shuffle(seed=7).iter_blocks()])))
        assert len(out) == 2000
        np.testing.assert_array_equal(np.sort(out), np.arange(2000))
        assert not np.array_equal(out, np.arange(2000)), "not shuffled"

    def test_sample_sort_globally_ordered(self, both):
        vals = np.random.default_rng(3).permutation(3000).astype(np.int64)

        def scenario(rd):
            asc = [np.asarray(b["v"]) for b in rd.from_numpy(
                {"v": vals}, blocks=6).sort("v").iter_blocks()]
            desc = np.concatenate([np.asarray(b["v"]) for b in rd.from_numpy(
                {"v": vals}, blocks=6).sort("v", descending=True)
                .iter_blocks()])
            return asc, desc

        asc, desc = same(both, scenario)
        np.testing.assert_array_equal(np.concatenate(asc), np.sort(vals))
        maxes = [b.max() for b in asc if b.size]
        mins = [b.min() for b in asc if b.size]
        for i in range(len(maxes) - 1):
            assert maxes[i] <= mins[i + 1]
        np.testing.assert_array_equal(desc, np.sort(vals)[::-1])


class TestOperatorFusion:
    def test_adjacent_map_stages_fuse(self, both):
        def scenario(rd):
            ex = rd.executor
            ops = [ex.OpSpec("a", lambda b: b), ex.OpSpec("b", lambda b: b),
                   ex.OpSpec("c", lambda b: b)]
            return [o.name for o in ex.fuse_ops(ops)]

        assert same(both, scenario) == ["a->b->c"]

    def test_actor_pool_stage_is_fusion_barrier(self, both):
        def scenario(rd):
            ex = rd.executor
            ops = [ex.OpSpec("a", lambda b: b), ex.OpSpec("b", lambda b: b),
                   ex.OpSpec("pool", lambda b: b,
                             compute=ex.ActorPoolStrategy(1)),
                   ex.OpSpec("c", lambda b: b)]
            return [o.name for o in ex.fuse_ops(ops)]

        assert same(both, scenario) == ["a->b", "pool", "c"]

    def test_fused_pipeline_correct(self, both):
        total = same(both, lambda rd: sum(int(b["id"].sum()) for b in (
            rd.range(100, blocks=4)
            .map_batches(lambda b: {"id": b["id"] * 2})
            .map_batches(lambda b: {"id": b["id"] + 1})
        ).iter_batches(batch_size=25)))
        assert total == sum(2 * i + 1 for i in range(100))


class TestActorPoolOperator:
    def test_stateful_class_udf_amortizes_setup(self, both):
        def scenario(rd):
            class ExpensiveModel:
                def __init__(self):
                    # "Load the model" once per actor.
                    self.offset = 1000
                    self.calls = 0

                def __call__(self, batch):
                    self.calls += 1
                    return {"id": batch["id"] + self.offset,
                            "calls": np.full(len(batch["id"]), self.calls)}

            blocks = list(rd.range(80, blocks=8).map_batches(
                ExpensiveModel, compute=rd.ActorPoolStrategy(size=2))
                .iter_blocks())
            return blocks

        blocks = same(both, scenario)
        assert len(blocks) == 8
        ids_ = np.sort(np.concatenate([b["id"] for b in blocks]))
        np.testing.assert_array_equal(ids_, np.arange(80) + 1000)
        # Two actors x 4 blocks each: per-actor call counters reach 4.
        assert max(int(b["calls"].max()) for b in blocks) == 4

    def test_class_udf_without_pool_rejected(self, both):
        class Udf:
            def __call__(self, b):
                return b

        for rd in both:
            with pytest.raises(ValueError, match="ActorPoolStrategy"):
                rd.range(10).map_batches(Udf)


def task_pid(block):
    """A stage that tags each row with the task worker's pid."""
    return {**block, "pid": np.full(len(block["id"]), os.getpid())}


class TestExchangeOnCluster:
    def test_shuffle_and_sort_across_nodes(self, both):
        def scenario(rd):
            out = np.concatenate([np.asarray(b["id"]) for b in rd.range(
                4000, blocks=4).random_shuffle(seed=1).iter_blocks()])
            flat = np.concatenate([np.asarray(b["id"]) for b in rd.range(
                1000, blocks=4).random_shuffle(seed=2).sort("id")
                .iter_blocks()])
            return out, flat

        out, flat = same(both, scenario)
        np.testing.assert_array_equal(np.sort(out), np.arange(4000))
        np.testing.assert_array_equal(flat, np.arange(1000))
        # The port's exchange ran in the pool's processes, not here.
        pids = np.concatenate([b["pid"] for b in td.range(
            4000, blocks=8).random_shuffle(seed=1).map_batches(task_pid)
            .iter_blocks()])
        assert os.getpid() not in set(pids.tolist())
        assert len(set(pids.tolist())) >= 2
        assert set(pids.tolist()) <= set(runtime.api.pool_workers())


class TestGroupBy:
    def test_groupby_aggregations(self, both):
        def scenario(rd):
            ds = rd.from_items([{"k": i % 3, "v": float(i)}
                                for i in range(30)], blocks=4)
            return ({r["k"]: r["count()"]
                     for r in ds.groupby("k").count().take_all()},
                    {r["k"]: r["sum(v)"]
                     for r in ds.groupby("k").sum("v").take_all()},
                    {r["k"]: r["mean(v)"]
                     for r in ds.groupby("k").mean("v").take_all()})

        counts, sums, means = same(both, scenario)
        assert counts == {0: 10, 1: 10, 2: 10}
        assert sums[0] == sum(float(i) for i in range(0, 30, 3))
        assert abs(means[1] - np.mean([float(i)
                                       for i in range(1, 30, 3)])) < 1e-9

    def test_stable_hash_spreads_keys(self, both):
        from raytpu.data.dataset import _stable_hash as jax_hash

        from raytpu_torch.data.dataset import _stable_hash

        for vals in (np.arange(1000), np.arange(1000) * 0.5,
                     np.array([f"k{i}" for i in range(1000)])):
            np.testing.assert_array_equal(_stable_hash(vals),
                                          jax_hash(vals))
            counts = np.bincount((_stable_hash(vals) % 8).astype(np.int64),
                                 minlength=8)
            assert (counts > 0).all() and counts.max() < 400, counts

    def test_groupby_string_keys_land_whole(self, both):
        rows = same(both, lambda rd: rd.from_items(
            [{"k": f"key{i % 5}", "v": 1} for i in range(50)], blocks=5)
            .groupby("k").count().take_all())
        keys = [r["k"] for r in rows]
        assert sorted(keys) == sorted(set(keys))
        assert all(r["count()"] == 10 for r in rows)

    def test_map_groups(self, both):
        def top1(group):
            i = int(np.argmax(group["v"]))
            return {"k": group["k"][i:i + 1], "v": group["v"][i:i + 1]}

        rows = same(both, lambda rd: sorted(
            rd.from_items([{"k": i % 2, "v": float(i)} for i in range(10)],
                          blocks=3).groupby("k").map_groups(top1)
            .take_all(), key=lambda r: r["k"]))
        assert [r["v"] for r in rows] == [8.0, 9.0]


class TestZipSplit:
    def test_zip(self, both):
        rows = same(both, lambda rd: rd.from_numpy(
            {"x": np.arange(100)}, blocks=3).zip(rd.from_numpy(
                {"y": np.arange(100) * 2}, blocks=2)).take_all())
        assert len(rows) == 100 and all(r["y"] == 2 * r["x"] for r in rows)

    def test_zip_mismatch_raises(self, both):
        for rd in both:
            with pytest.raises(Exception, match="equal row counts"):
                rd.range(10).zip(rd.range(11)).take_all()

    def test_split(self, both):
        counts = same(both, lambda rd: [s.count() for s in rd.range(
            100, blocks=8).split(4)])
        assert len(counts) == 4 and sum(counts) == 100

    def test_train_test_split(self, both):
        def scenario(rd):
            train, test = rd.range(100, blocks=5).train_test_split(0.2)
            return ids(train.take_all()), ids(test.take_all())

        train, test = same(both, scenario)
        assert len(train) == 80 and len(test) == 20
        assert sorted(train + test) == list(range(100))


class TestDataParityMethods:
    def test_random_sample(self, both):
        def scenario(rd):
            ds = rd.range(2000, blocks=4)
            return (ids(ds.random_sample(0.3, seed=0).take_all()),
                    ds.random_sample(0.0).count(),
                    ds.random_sample(1.0).count())

        kept, none, every = same(both, scenario)
        assert 450 < len(kept) < 750 and none == 0 and every == 2000
        for rd in both:
            with pytest.raises(ValueError):
                rd.range(10).random_sample(1.5)

    def test_unique(self, both):
        assert same(both, lambda rd: rd.from_items(
            [{"k": i % 5} for i in range(100)], blocks=4).unique("k")) == \
            [0, 1, 2, 3, 4]

    def test_split_at_indices(self, both):
        def scenario(rd):
            parts = rd.range(100, blocks=5).split_at_indices([30, 75])
            return [ids(p.take_all()) for p in parts]

        parts = same(both, scenario)
        assert [len(p) for p in parts] == [30, 45, 25]
        assert parts[0] == list(range(30))
        assert parts[2] == list(range(75, 100))

    def test_take_batch(self, both):
        batch = same(both, lambda rd: rd.range(100, blocks=4).take_batch(10))
        assert list(batch["id"]) == list(range(10))
        for rd in both:
            with pytest.raises(ValueError, match="empty"):
                rd.from_items([], blocks=1).take_batch(5)

    def test_random_sample_decorrelated_across_blocks(self, both):
        kept = sorted(same(both, lambda rd: ids(rd.range(2000, blocks=4)
                                                .random_sample(0.3, seed=0)
                                                .take_all())))
        per_block = [[i % 500 for i in kept if lo <= i < lo + 500]
                     for lo in (0, 500, 1000, 1500)]
        assert not all(b == per_block[0] for b in per_block[1:])

    def test_split_at_indices_empty_dataset(self, both):
        counts = same(both, lambda rd: [p.count() for p in rd.from_items(
            [], blocks=1).split_at_indices([3, 7])])
        assert counts == [0, 0, 0]

    def test_train_test_split_empty_dataset(self, both):
        counts = same(both, lambda rd: [d.count() for d in rd.from_items(
            [], blocks=1).train_test_split(0.25)])
        assert counts == [0, 0]


class TestResourceBudget:
    def test_budget_throttles_admission(self, both, monkeypatch):
        from raytpu.core.config import cfg

        from raytpu_torch.data import executor

        def scenario(rd):
            ds = rd.from_numpy({"x": np.zeros(16 * 100_000, np.float64)},
                               blocks=16).map_batches(lambda b: b)
            n = sum(len(b["x"]) for b in ds.iter_blocks())
            budget = ds._last_budget
            return (n, budget.throttle_events > 0,
                    budget.warm_peak_in_flight)

        old = cfg.data_memory_budget_bytes
        cfg.set("data_memory_budget_bytes", 2 * 1024 * 1024)  # 2MB
        monkeypatch.setattr(executor, "DATA_MEMORY_BUDGET_BYTES",
                            2 * 1024 * 1024)
        try:
            n, throttled, warm_peak = same(both, scenario)
        finally:
            cfg.set("data_memory_budget_bytes", old)
        assert n == 16 * 100_000 and throttled
        # ~0.8MB blocks under a 2MB budget admit at most 2 in flight.
        assert 0 < warm_peak <= 2

    def test_default_budget_fills_window(self, both):
        def scenario(rd):
            ds = rd.range(4000, blocks=16).map_batches(lambda b: b)
            total = sum(BlockAccessor(b).num_rows()
                        for b in ds.iter_blocks())
            return total, ds._last_budget.peak_in_flight

        total, peak = same(both, scenario)
        assert total == 4000 and peak >= 8


class TestTorchBatches:
    def test_iter_torch_batches(self, both):
        batches = same(both, lambda rd: [
            {k: v.tolist() for k, v in b.items()}
            for b in rd.from_numpy({"x": np.arange(64, dtype=np.float64)},
                                   blocks=2).iter_torch_batches(
                batch_size=32, dtypes=torch.float32,
                **({"device": "cpu"} if rd is td else {}))])
        assert len(batches) == 2
        got = list(td.from_numpy({"x": np.arange(64, dtype=np.float64)},
                                 blocks=2).iter_torch_batches(
            batch_size=32, dtypes=torch.float32, device="cpu"))
        assert isinstance(got[0]["x"], torch.Tensor)
        assert got[0]["x"].dtype == torch.float32
        assert float(sum(b["x"].sum() for b in got)) == float(
            np.arange(64).sum())

    def test_iter_torch_batches_needs_a_card_by_default(self, both,
                                                        monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            next(td.range(10).iter_torch_batches(batch_size=5))
