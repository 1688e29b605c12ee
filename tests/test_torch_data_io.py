"""The port's Data sources and sinks (raytpu_torch/data/read_api.py and
the writers of raytpu_torch/data/dataset.py) against the JAX package's,
on the CPU, where pyarrow, pandas and PIL are installed: each test of
tests/test_data.py's sources, sinks and readers runs the same scenario
through both packages (each writing under a directory of its own), the
rows are equal (sorted where the JAX test sorts them), and the JAX
test's own assertions hold for the port's result. Each reader that needs
a package raises ImportError naming it where that package is missing.

This module imports nothing of JAX at its top (the port's task workers
import it by name).
"""

import glob
import io
import math
import os
import sqlite3
import tarfile

import numpy as np
import pytest
import torch

import raytpu_torch.data as td
from raytpu_torch import runtime
from raytpu_torch.data.block import BlockAccessor


@pytest.fixture(scope="module")
def both():
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


def same(both, tmp_path, scenario):
    """``scenario(rd, directory)`` through both packages, each in a
    directory of its own: the port's result, once it equals the JAX
    package's."""
    jd, port = both
    want = scenario(jd, tmp_path / "jax")
    got = scenario(port, tmp_path / "port")
    assert plain(got) == plain(want)
    return got


def by(key):
    return lambda rows: sorted(rows, key=lambda r: r[key])


class TestSources:
    def test_range(self, both, tmp_path):
        count, first = same(both, tmp_path, lambda rd, d: (
            rd.range(100, blocks=4).count(), rd.range(100, blocks=4).take(3)))
        assert count == 100 and plain(first) == [{"id": 0}, {"id": 1},
                                                 {"id": 2}]

    def test_from_items(self, both, tmp_path):
        rows = same(both, tmp_path, lambda rd, d: rd.from_items(
            [{"a": i} for i in range(10)]).take_all())
        assert len(rows) == 10

    def test_from_numpy(self, both, tmp_path):
        count, total = same(both, tmp_path, lambda rd, d: (
            rd.from_numpy({"x": np.arange(20), "y": np.arange(20) * 2},
                          blocks=4).count(),
            rd.from_numpy({"x": np.arange(20), "y": np.arange(20) * 2},
                          blocks=4).sum("y")))
        assert count == 20 and total == 380.0

    def test_parquet_roundtrip(self, both, tmp_path):
        def scenario(rd, d):
            rd.range(50, blocks=2).write_parquet(str(d / "pq"))
            back = rd.read_parquet(str(d / "pq"))
            return back.count(), back.sum("id")

        assert same(both, tmp_path, scenario) == (50, sum(range(50)))

    def test_csv_roundtrip(self, both, tmp_path):
        def scenario(rd, d):
            rd.range(30, blocks=1).write_csv(str(d / "csv"))
            return rd.read_csv(str(d / "csv")).take_all()

        assert len(same(both, tmp_path, scenario)) == 30


class TestNewDatasources:
    def test_read_write_numpy_roundtrip(self, both, tmp_path):
        def scenario(rd, d):
            out = str(d / "npys")
            rd.range(100, blocks=4).map_batches(
                lambda b: {"data": b["id"].astype(np.float32)}
            ).write_numpy(out, "data")
            return sorted(float(v) for b in rd.read_numpy(out).iter_blocks()
                          for v in BlockAccessor(b).to_numpy()["data"]
                          .ravel())

        assert same(both, tmp_path, scenario) == [float(i)
                                                   for i in range(100)]

    def test_read_binary_files(self, both, tmp_path):
        def scenario(rd, d):
            d.mkdir()
            (d / "a.bin").write_bytes(b"alpha")
            (d / "b.bin").write_bytes(b"beta")
            rows = rd.read_binary_files(str(d / "*.bin"),
                                        include_paths=True).take_all()
            return [r["bytes"] for r in sorted(rows,
                                               key=lambda r: r["path"])]

        assert same(both, tmp_path, scenario) == [b"alpha", b"beta"]

    def test_from_torch(self, both, tmp_path):
        from torch.utils.data import TensorDataset

        tds = TensorDataset(torch.arange(20, dtype=torch.float32))
        rows = same(both, tmp_path,
                    lambda rd, d: rd.from_torch(tds, blocks=4).take_all())
        assert len(rows) == 20


class TestDatasinks:
    @staticmethod
    def _table(d, name):
        d.mkdir(exist_ok=True)
        db = str(d / name)
        conn = sqlite3.connect(db)
        conn.execute("CREATE TABLE out (id INTEGER, name TEXT)")
        conn.commit()
        conn.close()
        return db

    def test_write_sql_roundtrip(self, both, tmp_path):
        def scenario(rd, d):
            db = self._table(d, "w.db")
            rd.from_items([{"id": i, "name": f"n{i}"} for i in range(300)]
                          ).write_sql("INSERT INTO out VALUES (?, ?)",
                                      lambda: sqlite3.connect(db))
            return by("id")(rd.read_sql("SELECT id, name FROM out",
                                        lambda: sqlite3.connect(db))
                            .take_all())

        rows = same(both, tmp_path, scenario)
        assert len(rows) == 300 and plain(rows[7]) == {"id": 7, "name": "n7"}

    def test_write_images_roundtrip(self, both, tmp_path):
        images = np.stack([np.full((8, 8, 3), i, np.uint8) for i in range(4)])
        names = np.asarray([f"img{i}.png" for i in range(4)])

        def scenario(rd, d):
            out = str(d / "imgs")
            rd.from_numpy({"image": images, "fname": names}).write_images(
                out, "image", filename_column="fname")
            return sorted(rd.read_images(out).take_all(),
                          key=lambda r: int(r["image"][0, 0, 0]))

        got = same(both, tmp_path, scenario)
        assert len(got) == 4 and got[2]["image"].shape == (8, 8, 3)
        assert (got[2]["image"] == 2).all()

    def test_write_sql_mixed_key_order(self, both, tmp_path):
        rows = [{"id": 0, "name": "n0"}, {"name": "n1", "id": 1},
                {"id": 2, "name": "n2"}, {"name": "n3", "id": 3}]

        def scenario(rd, d):
            db = self._table(d, "mixed.db")
            rd.from_items(rows).write_sql("INSERT INTO out VALUES (?, ?)",
                                          lambda: sqlite3.connect(db))
            return by("id")(rd.read_sql("SELECT id, name FROM out",
                                        lambda: sqlite3.connect(db))
                            .take_all())

        assert plain(same(both, tmp_path, scenario)) == [
            {"id": i, "name": f"n{i}"} for i in range(4)]

    def test_write_sql_mismatched_keys_raise(self, both, tmp_path):
        for rd in both:
            db = self._table(tmp_path / rd.__name__, "bad.db")
            with pytest.raises(Exception, match="do not match"):
                rd.from_items([{"id": 0, "name": "n0"},
                               {"id": 1, "nome": "typo"}]).write_sql(
                    "INSERT INTO out VALUES (?, ?)",
                    lambda: sqlite3.connect(db))

    def test_write_images_extensionless_names(self, both, tmp_path):
        from PIL import Image

        images = np.stack([np.full((4, 4, 3), i, np.uint8) for i in range(3)])
        names = np.asarray([f"frame_{i}" for i in range(3)])

        def scenario(rd, d):
            out = str(d / "raw_imgs")
            rd.from_numpy({"image": images, "fname": names}).write_images(
                out, "image", file_format="png", filename_column="fname")
            img = Image.open(os.path.join(out, "frame_2"))
            return sorted(os.listdir(out)), img.format, img.size

        assert same(both, tmp_path, scenario) == (
            ["frame_0", "frame_1", "frame_2"], "PNG", (4, 4))

    def test_write_webdataset_roundtrip(self, both, tmp_path):
        rows = [{"__key__": f"s{i:03d}", "txt": f"caption {i}",
                 "bin": bytes([i, i + 1])} for i in range(6)]

        def scenario(rd, d):
            out = str(d / "wds")
            rd.from_items(rows).write_webdataset(out)
            return by("__key__")(rd.read_webdataset(out).take_all())

        got = same(both, tmp_path, scenario)
        assert len(got) == 6 and got[0]["__key__"] == "s000"
        assert got[3]["txt"] == "caption 3" and got[3]["bin"] == bytes([3, 4])


class _Recorder:
    """A sqlite connection that logs the SQL it runs to a file (the
    partitioned read's pushdown check), at module level in the JAX
    test's place: the port carries a class defined inside a test by
    value too, but this one is shared by both runs."""

    def __init__(self, db, qlog):
        self._c = sqlite3.connect(db)
        self._qlog = qlog

    def cursor(self):
        real, qlog = self._c.cursor(), self._qlog

        class Cur:
            def execute(self, q, *a):
                with open(qlog, "a") as f:
                    f.write(q.replace("\n", " ") + "\n")
                return real.execute(q, *a)

            def __getattr__(self, name):
                return getattr(real, name)

        return Cur()

    def close(self):
        self._c.close()


def _items_table(d, name, rows, schema="t (k INTEGER, v TEXT)"):
    d.mkdir(exist_ok=True)
    db = str(d / name)
    conn = sqlite3.connect(db)
    conn.execute(f"CREATE TABLE {schema}")
    table = schema.split()[0]
    conn.executemany(f"INSERT INTO {table} VALUES (?, ?)", rows)
    conn.commit()
    conn.close()
    return db


class TestMoreDatasources:
    def test_read_sql(self, both, tmp_path):
        def scenario(rd, d):
            db = _items_table(d, "t.db", [(i, f"n{i}") for i in range(20)],
                              "items (id INTEGER, name TEXT)")
            return by("id")(rd.read_sql(
                "SELECT id, name FROM items WHERE id < 10",
                lambda: sqlite3.connect(db)).take_all())

        rows = same(both, tmp_path, scenario)
        assert len(rows) == 10 and plain(rows[3]) == {"id": 3, "name": "n3"}

    def test_read_sql_partitioned_parallel_pushdown(self, both, tmp_path):
        def scenario(rd, d):
            db = _items_table(d, "p.db", [(i, f"v{i}") for i in range(100)],
                              "m (id INTEGER, v TEXT)")
            qlog = str(d / "queries.log")
            rows = by("id")(rd.read_sql(
                "SELECT id, v FROM m",
                lambda: _Recorder(db, qlog), partition_column="id",
                num_partitions=4).take_all())
            seen = open(qlog).read().splitlines()
            return rows, sorted(q for q in seen if "raytpu_part" in q), \
                any("raytpu_bounds" in q for q in seen)

        rows, parts, bounds = same(both, tmp_path, scenario)
        assert len(rows) == 100
        assert plain(rows[0]) == {"id": 0, "v": "v0"}
        assert plain(rows[99]) == {"id": 99, "v": "v99"}
        assert len(parts) == 4 and all("WHERE" in q for q in parts)
        assert bounds

    def test_read_sql_partitioned_explicit_bounds_and_nulls(self, both,
                                                            tmp_path):
        def scenario(rd, d):
            db = _items_table(d, "n.db", [(i, f"x{i}") for i in range(10)]
                              + [(None, "null-row")])
            rows = rd.read_sql("SELECT k, v FROM t",
                               lambda: sqlite3.connect(db),
                               partition_column="k", num_partitions=3,
                               lower_bound=0, upper_bound=9).take_all()
            narrow = rd.read_sql("SELECT k, v FROM t",
                                 lambda: sqlite3.connect(db),
                                 partition_column="k", num_partitions=2,
                                 lower_bound=3, upper_bound=5).take_all()
            return sorted(r["v"] for r in rows), len(narrow)

        values, narrow = same(both, tmp_path, scenario)
        assert len(values) == 11 and "null-row" in values and narrow == 11

    def test_read_sql_partitioned_all_null_column(self, both, tmp_path):
        def scenario(rd, d):
            db = _items_table(d, "allnull.db",
                              [(None, f"r{i}") for i in range(5)])
            return sorted(r["v"] for r in rd.read_sql(
                "SELECT k, v FROM t", lambda: sqlite3.connect(db),
                partition_column="k", num_partitions=3).take_all())

        assert len(same(both, tmp_path, scenario)) == 5

    def test_tfrecords_roundtrip(self, both, tmp_path):
        def scenario(rd, d):
            out = str(d / "tfr")
            rd.from_items([{"id": i, "name": f"row{i}", "score": float(i) / 2}
                           for i in range(12)], blocks=3).write_tfrecords(out)
            shards = len(glob.glob(out + "/*.tfrecord"))
            return shards, by("id")(rd.read_tfrecords(out).take_all())

        shards, rows = same(both, tmp_path, scenario)
        assert shards == 3 and len(rows) == 12
        assert rows[5]["id"] == 5 and rows[5]["name"] == b"row5"
        assert abs(rows[5]["score"] - 2.5) < 1e-6

    def test_partitioned_parquet_roundtrip(self, both, tmp_path):
        items = [{"year": 2023 + i % 2, "tag": f"t{i % 3}", "v": i}
                 for i in range(12)]

        def scenario(rd, d):
            out = str(d / "pq")
            rd.from_items(items, blocks=2).write_parquet(
                out, partition_cols=["year", "tag"])
            files = glob.glob(out + "/**/*.parquet", recursive=True)
            back = by("v")(rd.read_parquet(out).take_all())
            proj = rd.read_parquet(out, columns=["v", "year"]).take_all()
            flat = rd.read_parquet(out, partitioning=None).take_all()
            return (sorted(os.path.relpath(f, out) for f in files), back,
                    sorted(proj[0]), sorted(flat[0]),
                    isinstance(back[0]["year"], (int, np.integer)))

        files, back, proj, flat, typed = same(both, tmp_path, scenario)
        assert files and all("year=" in f and "tag=" in f for f in files)
        assert len(back) == 12
        assert plain(back[5]) == {"year": 2024, "tag": "t2", "v": 5}
        assert typed and proj == ["v", "year"] and flat == ["v"]

    def test_partitioned_parquet_nulls_mixed_types_and_root_scope(
            self, both, tmp_path):
        items = [{"year": None, "tag": "2024", "v": 0},
                 {"year": float("nan"), "tag": "unknown", "v": 1},
                 {"year": 2.5, "tag": "2024", "v": 2}]

        def scenario(rd, d):
            out = str(d / "pq2")
            rd.from_items(items, blocks=1).write_parquet(
                out, partition_cols=["year", "tag"])
            back = by("v")(rd.read_parquet(out).take_all())
            deep = d / "job=77" / "data"
            rd.from_items([{"x": 1}], blocks=1).write_parquet(str(deep))
            return back, rd.read_parquet(str(deep)).take_all()

        back, deep = same(both, tmp_path, scenario)
        assert len(back) == 3 and back[0]["year"] is None
        assert math.isnan(back[1]["year"]) and back[2]["year"] == 2.5
        assert [r["tag"] for r in back] == ["2024", "unknown", "2024"]
        assert all(isinstance(r["tag"], str) for r in back)
        assert plain(deep) == [{"x": 1}]

    def test_avro_roundtrip(self, both, tmp_path):
        items = [{"id": i, "name": f"row{i}", "score": i / 4,
                  "ok": i % 2 == 0} for i in range(12)]

        def scenario(rd, d):
            out, out2 = str(d / "av"), str(d / "av2")
            rd.from_items(items, blocks=3).write_avro(out)
            files = len(glob.glob(out + "/*.avro"))
            back = by("id")(rd.read_avro(out).take_all())
            rd.from_items([{"k": 1, "opt": None}, {"k": 2, "opt": "x"}],
                          blocks=1).write_avro(out2, codec="deflate")
            return files, back, by("k")(rd.read_avro(out2).take_all())

        files, back, rows = same(both, tmp_path, scenario)
        assert files == 3 and len(back) == 12
        assert plain(back[7]) == {"id": 7, "name": "row7", "score": 1.75,
                                  "ok": False}
        assert plain(rows) == [{"k": 1, "opt": None}, {"k": 2, "opt": "x"}]

    def test_orc_roundtrip(self, both, tmp_path):
        items = [{"id": i, "name": f"r{i}", "v": i * 0.5} for i in range(10)]

        def scenario(rd, d):
            out = str(d / "orc")
            rd.from_items(items, blocks=2).write_orc(out)
            return (len(glob.glob(out + "/*.orc")),
                    by("id")(rd.read_orc(out).take_all()),
                    [sorted(r) for r in rd.read_orc(
                        out, columns=["id"]).take_all()])

        files, back, proj = same(both, tmp_path, scenario)
        assert files == 2 and plain(back) == items
        assert all(cols == ["id"] for cols in proj)

    def test_from_huggingface(self, both, tmp_path):
        import datasets as hf

        src = hf.Dataset.from_dict(
            {"id": list(range(20)), "text": [f"t{i}" for i in range(20)]})
        shuf = src.shuffle(seed=0)
        filt = src.filter(lambda r: r["id"] % 2 == 0)

        def scenario(rd, d):
            return ([r["id"] for r in rd.from_huggingface(
                src, blocks=4).take_all()],
                [r["id"] for r in rd.from_huggingface(
                    shuf, blocks=4).take_all()],
                [r["id"] for r in rd.from_huggingface(
                    filt, blocks=2).take_all()])

        contiguous, shuffled, filtered = same(both, tmp_path, scenario)
        assert contiguous == list(range(20))
        assert shuffled == list(shuf["id"])
        assert filtered == list(range(0, 20, 2))
        for rd in both:
            with pytest.raises(TypeError):
                rd.from_huggingface({"not": "a dataset"})

    def test_read_tfrecords_raw(self, both, tmp_path):
        from raytpu_torch.data.tfrecord import write_records

        def scenario(rd, d):
            d.mkdir()
            write_records(str(d / "r.tfrecord"), [b"alpha", b"beta"])
            return [r["data"] for r in rd.read_tfrecords(
                str(d / "r.tfrecord"), raw=True).take_all()]

        assert same(both, tmp_path, scenario) == [b"alpha", b"beta"]

    def test_read_images(self, both, tmp_path):
        from PIL import Image

        def scenario(rd, d):
            d.mkdir()
            for i, color in enumerate([(255, 0, 0), (0, 255, 0)]):
                Image.new("RGB", (8, 6), color).save(d / f"im{i}.png")
            blocks = list(rd.read_images(str(d / "*.png"),
                                         size=(4, 4)).iter_blocks())
            return [BlockAccessor(b).to_numpy()["image"] for b in blocks]

        images = same(both, tmp_path, scenario)
        assert len(images) == 2
        assert images[0].shape == (1, 4, 4, 3)
        assert images[0].dtype == np.float32
        assert float(images[0][0, 0, 0, 0]) == 255.0

    @staticmethod
    def _shard(path, members):
        path.parent.mkdir(exist_ok=True)
        with tarfile.open(path, "w") as tf:
            for key, payload in members:
                info = tarfile.TarInfo(key)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))

    def test_read_webdataset(self, both, tmp_path):
        def scenario(rd, d):
            self._shard(d / "shard-000.tar", [
                ("s0.txt", b"hello"), ("s0.bin", b"\x01"),
                ("s1.txt", b"world"), ("s1.bin", b"\x02")])
            return by("__key__")(rd.read_webdataset(
                str(d / "shard-000.tar")).take_all())

        rows = same(both, tmp_path, scenario)
        assert [r["__key__"] for r in rows] == ["s0", "s1"]
        assert rows[0]["txt"] == "hello" and rows[1]["bin"] == b"\x02"

    def test_read_webdataset_heterogeneous_keys(self, both, tmp_path):
        def scenario(rd, d):
            self._shard(d / "het.tar", [("s0.txt", b"only-text"),
                                        ("s1.txt", b"text"),
                                        ("s1.cls", b"7")])
            return by("__key__")(rd.read_webdataset(
                str(d / "het.tar")).take_all())

        rows = same(both, tmp_path, scenario)
        assert rows[0]["cls"] is None and rows[1]["cls"] == "7"

    def test_read_images_skips_non_images(self, both, tmp_path):
        from PIL import Image

        def scenario(rd, d):
            d.mkdir()
            Image.new("RGB", (4, 4), (1, 2, 3)).save(d / "a.png")
            (d / "README.md").write_text("not an image")
            return len(list(rd.read_images(str(d)).iter_blocks()))

        assert same(both, tmp_path, scenario) == 1

    def test_empty_shard_does_not_poison_batches(self, both, tmp_path):
        def scenario(rd, d):
            self._shard(d / "empty.tar", [])
            self._shard(d / "data.tar", [("a.txt", b"x"), ("b.txt", b"y")])
            return sum(b.num_rows for b in rd.read_webdataset(
                [str(d / "empty.tar"), str(d / "data.tar")]).iter_batches(
                    batch_size=10, batch_format="pyarrow"))

        assert same(both, tmp_path, scenario) == 2

    def test_cross_shard_schema_promotion(self, both, tmp_path):
        def scenario(rd, d):
            self._shard(d / "p0.tar", [("s0.txt", b"t0")])
            self._shard(d / "p1.tar", [("s1.txt", b"t1"), ("s1.cls", b"9")])
            batch = next(rd.read_webdataset(str(d / "*.tar")).iter_batches(
                batch_size=10, batch_format="pyarrow"))
            return batch.num_rows, sorted(batch.column_names)

        rows, cols = same(both, tmp_path, scenario)
        assert rows == 2 and "cls" in cols


@pytest.mark.parametrize("reader,package", [
    ("read_parquet", "pyarrow"), ("read_csv", "pyarrow"),
    ("read_json", "pyarrow"), ("read_images", "PIL")])
def test_a_reader_without_its_package_raises_naming_it(monkeypatch,
                                                       tmp_path, reader,
                                                       package):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == package
                        else real(name, *a))
    with pytest.raises(ImportError, match=repr(package)):
        getattr(td, reader)(str(tmp_path))
