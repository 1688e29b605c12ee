"""Dataset sources, the port of :mod:`raytpu.data.read_api`: every
reader and ``from_*`` of the JAX package but ``from_jax`` (JAX arrays in;
give ``from_numpy`` host arrays instead).

The readers run as the port's tasks, defined where the JAX package
defines them and carried by value. ``pyarrow``, ``pandas`` and ``PIL``
are imported inside the tasks and the writers that use them; a reader
that builds arrow tables (or decodes images) first checks that its
package is installed and raises ``ImportError`` naming it where it is
not, rather than failing inside a task."""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from raytpu_torch import runtime
from raytpu_torch.data.block import block_from_rows
from raytpu_torch.data.dataset import Dataset


def _need(package: str, what: str) -> None:
    """Raise ImportError naming ``package`` where it is not installed."""
    import importlib.util

    if importlib.util.find_spec(package) is None:
        raise ImportError(f"{what} needs the {package!r} package, which "
                          f"is not installed")


def range(n: int, *, blocks: int = 8) -> Dataset:  # noqa: A001
    """Integers [0, n) as column 'id' (reference: ``ray.data.range``)."""
    import builtins

    blocks = max(1, min(blocks, n or 1))

    def source():
        per = -(-n // blocks)
        for i in builtins.range(blocks):
            lo, hi = i * per, min((i + 1) * per, n)
            if lo >= n:
                break
            yield runtime.put({"id": np.arange(lo, hi, dtype=np.int64)})

    return Dataset(source, [], name=f"range({n})")


def range_tensor(n: int, *, shape=(1,), blocks: int = 8) -> Dataset:
    blocks = max(1, min(blocks, n or 1))

    def source():
        import builtins

        per = -(-n // blocks)
        for i in builtins.range(blocks):
            lo, hi = i * per, min((i + 1) * per, n)
            if lo >= n:
                break
            count = hi - lo
            data = np.arange(lo, hi, dtype=np.float32).reshape(
                (count,) + (1,) * len(shape)) * np.ones((1,) + tuple(shape),
                                                        np.float32)
            yield runtime.put({"data": data})

    return Dataset(source, [], name=f"range_tensor({n})")


def from_generator(generator, *, name: str = "from_generator") -> Dataset:
    """Dataset over a streaming task's output.

    ``generator`` is an :class:`~raytpu_torch.runtime.ObjectRefGenerator`
    (from a ``num_returns="streaming"`` task) or a zero-arg callable
    returning one.
    Each yielded chunk (dict of arrays, list of rows, arrow table, pandas
    frame) becomes one block — consumable by ``iter_batches`` while the
    producer task is still running (reference: Ray Data over streaming
    generators, ``python/ray/data/read_api.py`` iterator sources).

    A bare generator is single-consumption (like any iterator); pass a
    callable to make the dataset re-iterable.
    """
    from raytpu_torch.data.block import normalize_batch_output
    from raytpu_torch.data.executor import OpSpec

    def source():
        gen = generator() if callable(generator) else generator
        for ref in gen:
            yield ref

    ds = Dataset(source, [], name=name)
    return ds._with_op(OpSpec("normalize", normalize_batch_output))


def from_items(items: List[Any], *, blocks: int = 8) -> Dataset:
    _need("pyarrow", "from_items")
    items = list(items)
    blocks = max(1, min(blocks, len(items) or 1))

    def source():
        import builtins

        per = -(-len(items) // blocks)
        for i in builtins.range(blocks):
            chunk = items[i * per: (i + 1) * per]
            if not chunk:
                break
            rows = [x if isinstance(x, dict) else {"item": x} for x in chunk]
            yield runtime.put(block_from_rows(rows))

    return Dataset(source, [], name="from_items")


def from_numpy(arrays: Dict[str, np.ndarray], *, blocks: int = 1) -> Dataset:
    def source():
        import builtins

        n = len(next(iter(arrays.values())))
        per = -(-n // blocks)
        for i in builtins.range(blocks):
            lo, hi = i * per, min((i + 1) * per, n)
            if lo >= n:
                break
            yield runtime.put({k: np.asarray(v)[lo:hi]
                              for k, v in arrays.items()})

    return Dataset(source, [], name="from_numpy")


def from_pandas(df) -> Dataset:
    _need("pyarrow", "from_pandas")
    import pyarrow as pa

    table = pa.Table.from_pandas(df, preserve_index=False)

    def source():
        yield runtime.put(table)

    return Dataset(source, [], name="from_pandas")


def from_arrow(table) -> Dataset:
    def source():
        yield runtime.put(table)

    return Dataset(source, [], name="from_arrow")


def _expand_paths(paths, suffix: str, recursive: bool = False
                  ) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            if recursive:
                # Partitioned layouts nest files under col=value/.
                files.extend(sorted(_glob.glob(
                    os.path.join(p, f"**/*{suffix}"), recursive=True)))
            else:
                files.extend(sorted(_glob.glob(
                    os.path.join(p, f"*{suffix}"))))
        elif any(ch in p for ch in "*?["):
            files.extend(sorted(_glob.glob(p)))
        else:
            files.append(p)
    if not files:
        raise FileNotFoundError(f"no {suffix} files under {paths}")
    return files


def read_parquet(paths, *, columns: Optional[Sequence[str]] = None,
                 partitioning: Optional[str] = "hive") -> Dataset:
    """One remote read task per file — IO parallelism rides the task
    fabric (reference: parquet datasource). Hive-partitioned layouts
    (``root/col=value/.../part.parquet``, e.g. from
    ``write_parquet(partition_cols=...)`` or Spark) are detected by
    default: ``col`` comes back as a column parsed from the path
    (int/float/None/string inferred); ``partitioning=None`` disables.
    """
    _need("pyarrow", "read_parquet")
    files = _expand_paths(paths, ".parquet", recursive=True)
    # Partition values are resolved at PLANNING time, driver-side:
    # segments are parsed only BELOW the user-passed read roots (a
    # col=value directory above the dataset must not inject columns),
    # and one partition schema is typed across ALL files (a dataset
    # with year=2024 and year=unknown reads year as string everywhere,
    # never int-in-one-file/str-in-another).
    part_vals: Dict[str, Dict[str, Any]] = {}
    if partitioning == "hive":
        roots = [p for p in ([paths] if isinstance(paths, str)
                             else list(paths)) if os.path.isdir(p)]
        raw = {f: _hive_raw_segments(f, roots) for f in files}
        part_vals = _type_partition_values(raw)

    @runtime.remote(name="data::read_parquet")
    def read_one(path, parts):
        import pyarrow as pa
        import pyarrow.parquet as pq

        file_cols = None
        if columns:
            file_cols = [c for c in columns if c not in parts]
        table = pq.read_table(path, columns=file_cols)
        for k, v in parts.items():
            if columns and k not in columns:
                continue
            table = table.append_column(
                k, pa.array([v] * len(table)))
        return table

    def source():
        for f in files:
            yield read_one.remote(f, part_vals.get(f, {}))

    return Dataset(source, [], name="read_parquet")


HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _hive_raw_segments(path: str, roots: List[str]) -> Dict[str, str]:
    """``key=value`` path segments BELOW the matching read root, raw
    (unquoted string) values; {} when the file is under no known root."""
    import urllib.parse

    rel = None
    for root in sorted(roots, key=len, reverse=True):
        r = root.rstrip(os.sep) + os.sep
        if path.startswith(r):
            rel = path[len(r):]
            break
    if rel is None:
        return {}
    out: Dict[str, str] = {}
    for seg in rel.split(os.sep)[:-1]:
        if "=" in seg:
            k, _, v = seg.partition("=")
            out[k] = urllib.parse.unquote(v)
    return out


def _type_partition_values(raw: Dict[str, Dict[str, str]]
                           ) -> Dict[str, Dict[str, Any]]:
    """One type per partition key across the whole dataset: int if
    every value parses as int, else float if every value parses, else
    string. ``__HIVE_DEFAULT_PARTITION__`` decodes to None."""
    def parses(vals, cast) -> bool:
        for v in vals:
            try:
                cast(v)
            except ValueError:
                return False
        return True

    by_key: Dict[str, List[str]] = {}
    for parts in raw.values():
        for k, v in parts.items():
            if v != HIVE_NULL:
                by_key.setdefault(k, []).append(v)
    casts: Dict[str, Any] = {}
    for k, vals in by_key.items():
        casts[k] = (int if parses(vals, int)
                    else float if parses(vals, float) else str)
    return {f: {k: (None if v == HIVE_NULL
                    else casts.get(k, str)(v))
                for k, v in parts.items()}
            for f, parts in raw.items()}


def read_csv(paths, **read_kwargs) -> Dataset:
    _need("pyarrow", "read_csv")
    files = _expand_paths(paths, ".csv")

    @runtime.remote(name="data::read_csv")
    def read_one(path):
        import pyarrow as pa
        import pyarrow.csv as pacsv

        return pacsv.read_csv(path)

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_csv")


def read_json(paths, **read_kwargs) -> Dataset:
    _need("pyarrow", "read_json")
    files = _expand_paths(paths, ".json")

    @runtime.remote(name="data::read_json")
    def read_one(path):
        import pyarrow.json as pajson

        return pajson.read_json(path)

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_json")


def read_text(paths) -> Dataset:
    _need("pyarrow", "read_text")
    files = _expand_paths(paths, "")

    @runtime.remote(name="data::read_text")
    def read_one(path):
        with open(path) as f:
            lines = [ln.rstrip("\n") for ln in f]
        return block_from_rows([{"text": ln} for ln in lines])

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_text")


def read_numpy(paths) -> Dataset:
    """One block per ``.npy`` file (reference: numpy datasource)."""
    files = _expand_paths(paths, ".npy")

    @runtime.remote(name="data::read_numpy")
    def read_one(path):
        arr = np.load(path)
        return {"data": arr}

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_numpy")


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    """Whole files as ``bytes`` rows (reference: binary datasource —
    the image/audio/file-blob workhorse)."""
    _need("pyarrow", "read_binary_files")
    files = _expand_paths(paths, "")

    @runtime.remote(name="data::read_binary")
    def read_one(path):
        with open(path, "rb") as f:
            data = f.read()
        row = {"bytes": data}
        if include_paths:
            row["path"] = path
        return block_from_rows([row])

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_binary_files")


def from_torch(torch_dataset, *, blocks: int = 8) -> Dataset:
    """A map-style ``torch.utils.data.Dataset`` as a raytpu Dataset
    (reference: ``ray.data.from_torch``). Items convert via numpy; rows
    are ``{"item": value}`` unless the item is a dict."""
    _need("pyarrow", "from_torch")

    n = len(torch_dataset)
    blocks = max(1, min(blocks, n or 1))

    def _to_host(v):
        try:
            import torch

            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
        except ImportError:  # pragma: no cover
            pass
        if isinstance(v, np.ndarray) and v.ndim == 0:
            return v.item()
        return v

    def _to_row(x):
        if isinstance(x, dict):
            return {k: _to_host(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            if len(x) == 1:
                return {"item": _to_host(x[0])}
            return {f"item_{i}": _to_host(v) for i, v in enumerate(x)}
        return {"item": _to_host(x)}

    def source():
        import builtins

        per = -(-n // blocks)
        for i in builtins.range(blocks):
            lo, hi = i * per, min((i + 1) * per, n)
            if lo >= n:
                break
            rows = [_to_row(torch_dataset[j]) for j in builtins.range(lo, hi)]
            yield runtime.put(block_from_rows(rows))

    return Dataset(source, [], name="from_torch")


def read_sql(sql: str, connection_factory, *, blocks: int = 1,
             partition_column: Optional[str] = None,
             num_partitions: Optional[int] = None,
             lower_bound=None, upper_bound=None) -> Dataset:
    """Rows of a SQL query as a Dataset (reference: SQL datasource,
    ``python/ray/data/datasource/sql_datasource.py``).

    ``connection_factory`` is a zero-arg callable returning a DBAPI
    connection (e.g. ``lambda: sqlite3.connect(path)``) — it runs inside
    the read task, so the connection itself never serializes.

    **Partitioned reads**: with ``partition_column`` +
    ``num_partitions``, the query runs as N PARALLEL read tasks, each
    executing a range-predicate sub-query

        ``SELECT * FROM (<sql>) WHERE col >= lo AND col < hi``

    (JDBC/Spark-style pushdown: each partition moves only its own rows).
    ``lower_bound``/``upper_bound`` set the partition STRIDE only — they
    never filter: the first partition's lower and the last partition's
    upper predicate are open-ended (Spark JDBC semantics), and NULL
    partition-column rows ride the last partition's ``IS NULL`` arm,
    so every row lands in exactly one partition. When bounds are
    omitted a MIN/MAX pre-query derives them; the column must be
    numeric-ish.
    """
    _need("pyarrow", "read_sql")
    if partition_column is None:
        @runtime.remote(name="data::read_sql")
        def read_all():
            conn = connection_factory()
            try:
                # DB-API 2.0 (conn.execute is sqlite-only)
                cur = conn.cursor()
                cur.execute(sql)
                cols = [d[0] for d in cur.description]
                rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            finally:
                conn.close()
            return block_from_rows(rows)

        def source():
            yield read_all.remote()

        ds = Dataset(source, [], name="read_sql")
        return ds.repartition(blocks) if blocks > 1 else ds

    n = int(num_partitions or blocks or 1)
    if n < 1:
        raise ValueError("num_partitions must be >= 1")
    col = str(partition_column)

    if lower_bound is None or upper_bound is None:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT MIN({col}), MAX({col}) "  # noqa: S608
                        f"FROM ({sql}) AS raytpu_bounds")
            lo_db, hi_db = cur.fetchone()
        finally:
            conn.close()
        if lo_db is None:
            # Empty result set OR every row has a NULL partition column:
            # a single unpartitioned read covers both correctly.
            return read_sql(sql, connection_factory, blocks=1)
        lower_bound = lo_db if lower_bound is None else lower_bound
        upper_bound = hi_db if upper_bound is None else upper_bound

    def _literal(x) -> str:
        # Bounds are embedded as validated NUMERIC literals, not bind
        # params: DBAPI paramstyle varies by driver (qmark vs pyformat
        # vs ...) and a literal number is portable across all of them.
        if isinstance(x, bool) or not isinstance(x, (int, float,
                                                     np.integer,
                                                     np.floating)):
            raise TypeError(
                f"partition_column bounds must be numeric, got "
                f"{type(x).__name__} ({x!r}); use explicit numeric "
                f"lower_bound/upper_bound (e.g. epoch seconds for "
                f"time columns)")
        return repr(int(x) if isinstance(x, np.integer) else
                    float(x) if isinstance(x, np.floating) else x)

    @runtime.remote(name="data::read_sql_partition")
    def read_partition(lo, hi, first: bool, last: bool):
        # JDBC/Spark semantics: bounds set the STRIDE, they never
        # filter — the first partition's lower and the last partition's
        # upper predicate are open-ended, and the last also adopts
        # NULL-column rows, so every row lands in exactly one partition.
        clauses = []
        if not first:
            clauses.append(f"{col} >= {_literal(lo)}")
        if not last:
            clauses.append(f"{col} < {_literal(hi)}")
        pred = " AND ".join(clauses) if clauses else "1=1"
        if last:
            pred = f"({pred}) OR {col} IS NULL"
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(f"SELECT * FROM ({sql}) AS raytpu_part "  # noqa: S608
                        f"WHERE {pred}")
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
        finally:
            conn.close()
        return block_from_rows(rows)

    # Validate bounds eagerly (a TypeError at .remote() execution time
    # would surface as a task error instead of at the call site).
    _literal(lower_bound), _literal(upper_bound)
    integral = isinstance(lower_bound, int) and isinstance(upper_bound, int)

    def _boundary(i: int):
        # Integer bounds use pure integer arithmetic: float strides lose
        # precision past 2**53 (e.g. snowflake ids) and would misplace
        # boundary rows between partitions.
        if integral:
            return lower_bound + (upper_bound - lower_bound) * i // n
        lo_f, hi_f = float(lower_bound), float(upper_bound)
        return lo_f + (hi_f - lo_f) * i / n

    def source():
        import builtins

        for i in builtins.range(n):
            yield read_partition.remote(_boundary(i), _boundary(i + 1),
                                        i == 0, i == n - 1)

    return Dataset(source, [], name="read_sql")


def read_images(paths, *, size=None, mode: str = "RGB",
                include_paths: bool = False) -> Dataset:
    """Image files as float32 arrays via PIL (reference: image
    datasource). ``size=(w, h)`` resizes; one block per file. Without
    ``size`` the corpus must share dimensions for any batching path
    (``iter_batches``/``take_batch`` concatenate [1,H,W,C] arrays);
    mixed-size corpora should pass ``size=``."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
    _need("PIL", "read_images")
    files = [f for f in _expand_paths(paths, "")
             if f.lower().endswith(exts)]
    if not files:
        raise FileNotFoundError(f"no image files under {paths}")

    @runtime.remote(name="data::read_images")
    def read_one(path):
        from PIL import Image

        img = Image.open(path).convert(mode)
        if size is not None:
            img = img.resize(tuple(size))
        arr = np.asarray(img, dtype=np.float32)[None]  # [1, H, W, C]
        block = {"image": arr}
        if include_paths:
            block["path"] = np.asarray([path])
        return block

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_images")


def read_webdataset(paths) -> Dataset:
    """WebDataset-style tar shards: files grouped by key (basename
    before the first dot), one row per key with a column per extension
    (reference: webdataset datasource). Text-like members decode to
    str; everything else stays bytes."""
    _need("pyarrow", "read_webdataset")
    files = _expand_paths(paths, ".tar")

    @runtime.remote(name="data::read_webdataset")
    def read_shard(path):
        import tarfile

        samples: Dict[str, dict] = {}
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                base = os.path.basename(member.name)
                key, _, ext = base.partition(".")
                data = tf.extractfile(member).read()
                if ext in ("txt", "json", "cls", "csv"):
                    try:
                        data = data.decode("utf-8")
                    except UnicodeDecodeError:
                        pass
                samples.setdefault(key, {"__key__": key})[ext] = data
        # Samples may carry different extension sets; block columns are
        # the union, absent members become None.
        all_keys = sorted({k for s in samples.values() for k in s})
        rows = [{k: samples[key].get(k) for k in all_keys}
                for key in sorted(samples)]
        return block_from_rows(rows)

    def source():
        for f in files:
            yield read_shard.remote(f)

    return Dataset(source, [], name="read_webdataset")


def read_tfrecords(paths, *, raw: bool = False) -> Dataset:
    """TFRecord files of ``tf.train.Example`` protos as a Dataset, one
    block per file read in parallel (reference: tfrecords datasource;
    codec notes in :mod:`raytpu_torch.data.tfrecord`). ``raw=True`` skips the
    Example parse and yields one ``{"data": bytes}`` row per record."""
    _need("pyarrow", "read_tfrecords")
    files = _expand_paths(paths, ".tfrecord")

    @runtime.remote(name="data::read_tfrecords")
    def read_file(path):
        from raytpu_torch.data.tfrecord import decode_example, read_records

        if raw:
            rows = [{"data": rec} for rec in read_records(path)]
        else:
            rows = [decode_example(rec) for rec in read_records(path)]
        return block_from_rows(rows)

    def source():
        for f in files:
            yield read_file.remote(f)

    return Dataset(source, [], name="read_tfrecords")


def read_orc(paths, *, columns: Optional[Sequence[str]] = None) -> Dataset:
    """ORC files as a Dataset, one remote read task per file
    (reference analogue: ``python/ray/data/read_api.py`` ``read_orc``
    via the ORC datasource; here pyarrow.orc does the codec work and IO
    parallelism rides the task fabric)."""
    _need("pyarrow", "read_orc")
    files = _expand_paths(paths, ".orc")

    @runtime.remote(name="data::read_orc")
    def read_one(path):
        from pyarrow import orc

        return orc.read_table(path, columns=list(columns)
                              if columns else None)

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_orc")


def from_huggingface(hf_dataset, *, blocks: int = 8) -> Dataset:
    """A HuggingFace ``datasets.Dataset`` as a Dataset (reference
    analogue: ``python/ray/data/read_api.py`` ``from_huggingface``).

    The HF dataset is arrow-backed; each block is a contiguous shard
    converted to an arrow table. ``IterableDataset`` (streaming) is not
    supported — materialize it first (mirrors the reference's
    constraint for non-streaming parallelism).
    """
    try:
        import datasets as hf
    except ImportError as e:  # pragma: no cover
        raise ImportError("from_huggingface requires the 'datasets' "
                          "package") from e
    if isinstance(hf_dataset, hf.IterableDataset):
        raise TypeError(
            "from_huggingface needs a materialized datasets.Dataset; "
            "streaming IterableDataset is unsupported (use "
            ".take()/.to_list() or load without streaming=True)")
    if not isinstance(hf_dataset, hf.Dataset):
        raise TypeError(f"expected datasets.Dataset, got "
                        f"{type(hf_dataset).__name__}")
    # A shuffled/filtered/selected HF dataset is a view: an indices
    # mapping over the unmodified arrow table. Materialize the view
    # first, or every shard's .data.table would be the FULL original
    # table (duplicated, wrong-order rows).
    if getattr(hf_dataset, "_indices", None) is not None:
        hf_dataset = hf_dataset.flatten_indices()
    n = len(hf_dataset)
    blocks = max(1, min(blocks, n) if n else 1)

    def source():
        import builtins

        for i in builtins.range(blocks):
            shard = hf_dataset.shard(num_shards=blocks, index=i,
                                     contiguous=True)
            yield runtime.put(shard.data.table.combine_chunks())

    return Dataset(source, [], name="from_huggingface")


def read_avro(paths) -> Dataset:
    """Avro object container files as a Dataset, one block per file
    read in parallel (reference: avro datasource; dependency-free OCF
    codec in :mod:`raytpu_torch.data.avro` — null + deflate codecs)."""
    _need("pyarrow", "read_avro")
    files = _expand_paths(paths, ".avro")

    @runtime.remote(name="data::read_avro")
    def read_one(path):
        from raytpu_torch.data.avro import read_file

        _, records = read_file(path)
        return block_from_rows(list(records))

    def source():
        for f in files:
            yield read_one.remote(f)

    return Dataset(source, [], name="read_avro")
