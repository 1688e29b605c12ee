"""Dataset, the port of :mod:`raytpu.data.dataset`: lazy, streaming
datasets on the port's tasks (:mod:`raytpu_torch.runtime`).

A Dataset is a lazy plan: a block source plus a chain of operators;
consumption streams blocks through remote tasks with bounded in-flight
work (:mod:`raytpu_torch.data.executor`). Blocks live in the object
store; the driver holds refs only.

Global ops (sort/repartition/random_shuffle) run as distributed two-phase
exchanges (map partition tasks + reduce merge tasks), with the JAX
package's partitioning and seeds, so ``random_shuffle(seed=)`` gives its
permutation. Everything else streams. The remote functions the JAX
package defines inside methods are defined there here too: they, their
closures and the user's lambdas go to the task workers by value.

``streaming_split(n)`` starts a :class:`_SplitCoordinator` actor process
(``num_cpus=0``) that iterates the dataset, so its tasks are submitted
from there (to the same task pool) and it owns their blocks; each
:class:`DataIterator` pickles into another process (a train worker) and
pulls its blocks' refs from the coordinator, reading each block from the
segment its task wrote. ``iter_torch_batches`` runs on the card unless
``device="cpu"`` is passed. ``iter_jax_batches`` is the JAX package's
only and is not carried over.
"""

from __future__ import annotations

import functools
import itertools
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from raytpu_torch import resolve_device, runtime
from raytpu_torch.data.block import (
    BlockAccessor,
    batch_format_view,
    block_from_rows,
    concat_blocks,
    normalize_batch_output,
)
from raytpu_torch.data.executor import OpSpec, run_pipeline


class Dataset:
    def __init__(self, source_fn: Callable[[], Iterator], ops: List[OpSpec],
                 name: str = "dataset"):
        self._source_fn = source_fn  # () -> iterator of block refs
        self._ops = ops
        self._name = name

    # -- transforms (lazy) ----------------------------------------------------

    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    num_cpus: float = 1.0, batch_size: Optional[int] = None,
                    fn_kwargs: Optional[dict] = None,
                    compute=None) -> "Dataset":
        """Apply fn to whole blocks (reference: ``Dataset.map_batches``).
        `batch_size=None` keeps source block boundaries (fastest).

        ``compute=ActorPoolStrategy(size=n)`` runs the stage on n
        long-lived actors; ``fn`` may then be a CLASS whose instances are
        built once per actor (stateful UDF — the place to load/jit a
        model once and reuse it per block)."""
        import inspect as _inspect

        kw = fn_kwargs or {}

        if _inspect.isclass(fn):
            if compute is None:
                raise ValueError(
                    "class-based map_batches UDFs require "
                    "compute=ActorPoolStrategy(...)")
            user_cls = fn

            class op:  # instantiated once per pool actor
                def __init__(self):
                    self._inner = user_cls()

                def __call__(self, block):
                    view = batch_format_view(block, batch_format)
                    return normalize_batch_output(self._inner(view, **kw))
        else:
            def op(block):
                view = batch_format_view(block, batch_format)
                return normalize_batch_output(fn(view, **kw))

        ds = self._with_op(OpSpec(getattr(fn, "__name__", "map_batches"),
                                  op, num_cpus=num_cpus, compute=compute))
        if batch_size is not None:
            ds = ds._rechunk(batch_size)
        return ds

    def map(self, fn: Callable, *, num_cpus: float = 1.0) -> "Dataset":
        def op(block):
            rows = BlockAccessor(block).to_rows()
            return block_from_rows([fn(r) for r in rows])

        return self._with_op(OpSpec(getattr(fn, "__name__", "map"), op,
                                    num_cpus=num_cpus))

    def filter(self, fn: Callable) -> "Dataset":
        def op(block):
            rows = BlockAccessor(block).to_rows()
            return block_from_rows([r for r in rows if fn(r)])

        return self._with_op(OpSpec("filter", op))

    def flat_map(self, fn: Callable) -> "Dataset":
        def op(block):
            rows = BlockAccessor(block).to_rows()
            out = []
            for r in rows:
                out.extend(fn(r))
            return block_from_rows(out)

        return self._with_op(OpSpec("flat_map", op))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def op(batch):
            batch = dict(batch)
            batch[name] = fn(batch)
            return batch

        return self.map_batches(op, batch_format="numpy")

    def drop_columns(self, cols: Sequence[str]) -> "Dataset":
        def op(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        return self.map_batches(op, batch_format="numpy")

    def select_columns(self, cols: Sequence[str]) -> "Dataset":
        def op(batch):
            return {k: batch[k] for k in cols}

        return self.map_batches(op, batch_format="numpy")

    def limit(self, n: int) -> "Dataset":
        parent = self

        def source():
            remaining = n
            for ref in parent._iter_block_refs():
                if remaining <= 0:
                    break
                block = runtime.get(ref)
                rows = BlockAccessor(block).num_rows()
                if rows <= remaining:
                    remaining -= rows
                    yield ref
                else:
                    yield runtime.put(
                        BlockAccessor(block).slice(0, remaining))
                    remaining = 0

        return Dataset(source, [], name=f"{self._name}.limit({n})")

    def union(self, *others: "Dataset") -> "Dataset":
        parents = [self, *others]

        def source():
            for p in parents:
                yield from p._iter_block_refs()

        return Dataset(source, [], name="union")

    @staticmethod
    def _global_offsets(in_refs) -> np.ndarray:
        """Per-block global row offsets (len+1, int64) via one remote
        count pass — shared by the offset-based exchanges."""

        @runtime.remote(name="data::count")
        def count(block):
            return BlockAccessor(block).num_rows()

        counts = runtime.get([count.remote(r) for r in in_refs])
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def _all_to_all(self, num_out: Optional[int], assign_fn, name: str,
                    post_fn=None, prepare_fn=None) -> "Dataset":
        """Two-phase distributed shuffle (reference:
        ``python/ray/data/_internal/planner/exchange/`` push-based
        shuffle): map tasks partition each input block into ``n_out``
        pieces (``assign_fn(block_numpy, rows, block_idx, n_out, aux) ->
        partition id per row``); reduce tasks concatenate piece j of every
        map output (+ optional ``post_fn`` e.g. a local sort). The driver
        only ever holds refs — dataset size is bounded by the cluster's
        object store, not driver RAM. ``num_out=None`` preserves the input
        block count (parallelism follows the data); ``prepare_fn(in_refs,
        n_out)`` computes small driver-side aux state (offsets, sort
        boundaries) before the exchange."""
        parent = self

        def source():
            in_refs = list(parent._iter_block_refs())
            if not in_refs:
                return
            n_out = max(1, int(num_out) if num_out else len(in_refs))
            aux = prepare_fn(in_refs, n_out) if prepare_fn else None

            @runtime.remote(num_returns=n_out, name=f"data::{name}-map")
            def split(block, idx):
                npd = BlockAccessor(block).to_numpy()
                rows = BlockAccessor(block).num_rows()
                assign = assign_fn(npd, rows, idx, n_out, aux)
                pieces = []
                for j in range(n_out):
                    mask = assign == j
                    pieces.append({k: np.asarray(v)[mask]
                                   for k, v in npd.items()})
                return tuple(pieces) if n_out > 1 else pieces[0]

            @runtime.remote(name=f"data::{name}-reduce")
            def merge(j, *pieces):
                live = [p for p in pieces
                        if BlockAccessor(p).num_rows() > 0]
                out = concat_blocks(live) if live else pieces[0]
                if post_fn is not None:
                    out = post_fn(out, j)
                return out

            parts = [split.remote(ref, i) for i, ref in enumerate(in_refs)]
            if n_out == 1:
                parts = [[p] for p in parts]
            for j in range(n_out):
                yield merge.remote(j, *[p[j] for p in parts])

        return Dataset(source, [], name=f"{self._name}.{name}")

    def repartition(self, num_blocks: int) -> "Dataset":
        """Distributed all-to-all repartition into near-equal blocks,
        PRESERVING row order (reference: ``Dataset.repartition``): a cheap
        remote count pass gives global offsets, rows then map to
        contiguous output ranges."""

        def prepare(in_refs, n_out):
            offsets = self._global_offsets(in_refs)
            total = int(offsets[-1])
            per = max(1, -(-total // n_out))
            return offsets, per

        def assign(npd, rows, idx, n_out, aux):
            offsets, per = aux
            return np.minimum(
                (int(offsets[idx]) + np.arange(rows)) // per, n_out - 1)

        return self._all_to_all(num_blocks, assign, "repartition",
                                prepare_fn=prepare)

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        """Distributed random shuffle: rows hash to random reducers, each
        reducer permutes locally — a true all-to-all, no driver
        materialization (reference: ``Dataset.random_shuffle``). Output
        parallelism follows the input block count unless overridden."""

        def assign(npd, rows, idx, n_out, aux):
            rng = np.random.default_rng(
                None if seed is None else seed + 7919 * idx)
            return rng.integers(0, n_out, size=rows)

        def post(block, j):
            npd = BlockAccessor(block).to_numpy()
            n = BlockAccessor(block).num_rows()
            rng = np.random.default_rng(
                None if seed is None else seed + 104729 * (j + 1))
            perm = rng.permutation(n)
            return {k: np.asarray(v)[perm] for k, v in npd.items()}

        return self._all_to_all(num_blocks, assign, "shuffle",
                                post_fn=post)

    def sort(self, key: str, descending: bool = False,
             num_blocks: Optional[int] = None) -> "Dataset":
        """Distributed sample sort: sample boundaries from every block,
        range-partition rows to reducers, reducers sort locally — output
        blocks are globally ordered (reference: ``Dataset.sort`` over the
        sort exchange). Sampling pulls only small per-block samples to the
        driver, never the data."""

        def prepare(in_refs, n_out):
            @runtime.remote(name="data::sort-sample")
            def sample(block):
                vals = np.asarray(BlockAccessor(block).to_numpy()[key])
                if vals.size == 0:
                    return vals
                k = min(64, vals.size)
                idx = np.linspace(0, vals.size - 1, k).astype(np.int64)
                return np.sort(vals)[idx]

            samples = np.concatenate(
                [s for s in runtime.get([sample.remote(r)
                                        for r in in_refs])
                 if np.asarray(s).size] or [np.zeros(0)])
            if samples.size == 0:
                return np.zeros(0)
            qs = np.linspace(0, 1, n_out + 1)[1:-1]
            return np.quantile(np.sort(samples), qs)

        def assign(npd, rows, idx, n_out, boundaries):
            vals = np.asarray(npd[key])
            part = np.searchsorted(boundaries, vals, side="right")
            if descending:
                part = (n_out - 1) - part
            return part

        def post(block, j):
            npd = BlockAccessor(block).to_numpy()
            order = np.argsort(np.asarray(npd[key]), kind="stable")
            if descending:
                order = order[::-1]
            return {k2: np.asarray(v)[order] for k2, v in npd.items()}

        return self._all_to_all(num_blocks, assign, "sort",
                                post_fn=post, prepare_fn=prepare)

    def random_sample(self, fraction: float, *,
                      seed: Optional[int] = None) -> "Dataset":
        """Bernoulli row sample (reference: ``Dataset.random_sample``).
        The seed is salted per block (like random_shuffle) — one shared
        seed would draw the SAME mask in every block, correlating the
        sample across the dataset."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        parent = self

        def source():
            @runtime.remote(name="data::sample")
            def sample(block, idx):
                rng = np.random.default_rng(
                    None if seed is None else seed + 7919 * idx)
                npd = BlockAccessor(block).to_numpy()
                n = BlockAccessor(block).num_rows()
                mask = rng.random(n) < fraction
                return {k: np.asarray(v)[mask] for k, v in npd.items()}

            for i, ref in enumerate(parent._iter_block_refs()):
                yield sample.remote(ref, i)

        return Dataset(source, [], name=f"{self._name}.sample")

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (reference: ``Dataset.unique``):
        per-block distincts in remote tasks, merged on the driver —
        result size is the number of DISTINCT values, not rows."""

        @runtime.remote(name="data::unique")
        def distinct(block):
            return np.unique(np.asarray(
                BlockAccessor(block).to_numpy()[column]))

        refs = [distinct.remote(r) for r in self._iter_block_refs()]
        out: set = set()
        for vals in runtime.get(refs):
            out.update(vals.tolist())
        return sorted(out)

    def split_at_indices(self, indices: Sequence[int]) -> List["Dataset"]:
        """Split by global row offsets (reference:
        ``Dataset.split_at_indices``): ``[3, 7]`` -> rows [0,3), [3,7),
        [7,end) — order preserved, distributed via the offset exchange."""
        indices = sorted(int(i) for i in indices)
        if any(i < 0 for i in indices):
            raise ValueError("indices must be non-negative")
        n_out = len(indices) + 1

        def prepare(in_refs, n):
            return (self._global_offsets(in_refs),
                    np.asarray(indices, np.int64))

        def assign(npd, rows, idx, n, aux):
            offsets, bounds = aux
            global_rows = int(offsets[idx]) + np.arange(rows)
            return np.searchsorted(bounds, global_rows, side="right")

        parts = self._all_to_all(n_out, assign, "split_at_indices",
                                 prepare_fn=prepare)
        refs = list(parts._iter_block_refs())
        if not refs:  # empty upstream: still n_out (empty) datasets
            return [Dataset(lambda: iter(()), [],
                            name=f"{self._name}.split_at")
                    for _ in range(n_out)]
        return [Dataset(lambda r=ref: iter([r]), [],
                        name=f"{self._name}.split_at")
                for ref in refs]

    def take_batch(self, batch_size: int = 20,
                   batch_format: str = "numpy"):
        """First ``batch_size`` rows as one batch (reference:
        ``Dataset.take_batch`` — raises on an empty dataset)."""
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format):
            return batch
        raise ValueError(f"dataset {self._name!r} is empty")

    def groupby(self, key: str) -> "GroupedData":
        """Distributed group-by (reference: ``Dataset.groupby`` →
        ``GroupedData``): rows hash-partition to reducers on a
        deterministic key hash (every group lands whole on one reducer),
        aggregations/`map_groups` then run per-reducer with no driver
        materialization."""
        return GroupedData(self, key)

    def zip(self, other: "Dataset") -> "Dataset":
        """Row-aligned column zip (reference: ``Dataset.zip``): both sides
        are repartitioned to identical row offsets, then blocks merge
        columnwise in remote tasks. Column collisions raise."""
        left, right = self, other

        def source():
            n_l, n_r = left.count(), right.count()
            if n_l != n_r:
                raise ValueError(
                    f"zip requires equal row counts, got {n_l} vs {n_r}")
            blocks = max(1, -(-n_l // 4096))
            l_refs = list(left.repartition(blocks)._iter_block_refs())
            r_refs = list(right.repartition(blocks)._iter_block_refs())

            @runtime.remote(name="data::zip")
            def merge(a, b):
                na = BlockAccessor(a).to_numpy()
                nb = BlockAccessor(b).to_numpy()
                clash = set(na) & set(nb)
                if clash:
                    raise ValueError(f"zip column collision: {sorted(clash)}")
                return {**na, **nb}

            for a, b in zip(l_refs, r_refs):
                yield merge.remote(a, b)

        return Dataset(source, [], name=f"{self._name}.zip")

    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        """Split into ``n`` disjoint datasets (reference: ``Dataset.split``).
        ``equal=True`` repartitions first so row counts match to within
        one block."""
        src = self.repartition(n) if equal else self
        refs = list(src._iter_block_refs())
        shards: List[List] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)

        def make(shard):
            return Dataset(lambda s=tuple(shard): iter(s), [],
                           name=f"{self._name}.split")

        return [make(s) for s in shards]

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        """(train, test) row split by global offset (reference:
        ``Dataset.train_test_split``)."""
        if not 0.0 < test_size < 1.0:
            raise ValueError("test_size must be in (0, 1)")
        ds = self.random_shuffle(seed=seed) if shuffle else self

        def prepare(in_refs, n_out):
            offsets = self._global_offsets(in_refs)
            boundary = int(round(offsets[-1] * (1.0 - test_size)))
            return offsets, boundary

        def assign(npd, rows, idx, n_out, aux):
            offsets, boundary = aux
            return ((int(offsets[idx]) + np.arange(rows)) >= boundary
                    ).astype(np.int64)

        both = ds._all_to_all(2, assign, "train_test_split",
                              prepare_fn=prepare)
        refs = list(both._iter_block_refs())
        if not refs:  # empty upstream: two empty datasets, like split_at
            return (Dataset(lambda: iter(()), [],
                            name=f"{self._name}.train"),
                    Dataset(lambda: iter(()), [],
                            name=f"{self._name}.test"))
        train_ref, test_ref = refs[0], refs[1]
        return (Dataset(lambda r=train_ref: iter([r]), [],
                        name=f"{self._name}.train"),
                Dataset(lambda r=test_ref: iter([r]), [],
                        name=f"{self._name}.test"))

    # -- consumption ----------------------------------------------------------

    def _iter_block_refs(self) -> Iterator:
        return run_pipeline(self._source_fn(), self._ops)

    def iter_blocks(self) -> Iterator:
        # The consuming loop observes real block sizes and feeds them to
        # the executor's byte budget (reference: ResourceManager — memory
        # backpressure, not just a concurrency cap).
        from raytpu_torch.data.executor import ResourceBudget

        budget = ResourceBudget()
        self._last_budget = budget  # introspection/tests
        for ref in run_pipeline(self._source_fn(), self._ops,
                                budget=budget):
            block = runtime.get(ref)
            try:
                budget.record_block(BlockAccessor(block).size_bytes())
            except Exception:
                pass
            yield block

    def iter_rows(self) -> Iterator[dict]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).to_rows()

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator:
        """Re-chunk the block stream into fixed-size batches."""
        carry: List = []
        carry_rows = 0
        for block in self.iter_blocks():
            carry.append(block)
            carry_rows += BlockAccessor(block).num_rows()
            while carry_rows >= batch_size:
                whole = concat_blocks(carry)
                acc = BlockAccessor(whole)
                yield batch_format_view(acc.slice(0, batch_size),
                                        batch_format)
                rest = acc.slice(batch_size, acc.num_rows())
                carry = [rest]
                carry_rows = BlockAccessor(rest).num_rows()
        if carry_rows and not drop_last:
            whole = concat_blocks(carry)
            yield batch_format_view(whole, batch_format)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False, device=None,
                           dtypes=None) -> Iterator:
        """Batches as torch tensors (reference: ``iter_torch_batches``)
        on ``device``: the card unless ``device="cpu"``.
        ``dtypes``: a torch dtype (all columns) or {column: dtype}."""
        return _torch_batches(self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            drop_last=drop_last), device, dtypes)

    def take(self, n: int = 20) -> List[dict]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[dict]:
        return list(self.iter_rows())

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self.iter_blocks())

    def sum(self, col: str):
        return sum(float(np.asarray(BlockAccessor(b).to_numpy()[col]).sum())
                   for b in self.iter_blocks())

    def mean(self, col: str):
        total, n = 0.0, 0
        for b in self.iter_blocks():
            arr = np.asarray(BlockAccessor(b).to_numpy()[col])
            total += float(arr.sum())
            n += arr.size
        return total / max(n, 1)

    def min(self, col: str):
        # Skip zero-row blocks (exchanges can produce them).
        return min(float(np.asarray(arr).min()) for arr in (
            BlockAccessor(b).to_numpy()[col] for b in self.iter_blocks())
            if np.asarray(arr).size)

    def max(self, col: str):
        return max(float(np.asarray(arr).max()) for arr in (
            BlockAccessor(b).to_numpy()[col] for b in self.iter_blocks())
            if np.asarray(arr).size)

    def schema(self):
        for block in self.iter_blocks():
            return BlockAccessor(block).schema()
        return None

    def to_pandas(self):
        import pandas as pd

        frames = [BlockAccessor(b).to_pandas() for b in self.iter_blocks()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def materialize(self) -> "Dataset":
        refs = list(self._iter_block_refs())

        def source():
            yield from refs

        return Dataset(source, [], name=f"{self._name}.materialized")

    def stats(self) -> dict:
        blocks = 0
        rows = 0
        nbytes = 0
        for b in self.iter_blocks():
            acc = BlockAccessor(b)
            blocks += 1
            rows += acc.num_rows()
            nbytes += acc.size_bytes()
        return {"blocks": blocks, "rows": rows, "bytes": nbytes}

    # -- train ingest ---------------------------------------------------------

    def streaming_split(self, n: int, *, equal: bool = True,
                        locality_hints=None) -> List["DataIterator"]:
        """n coordinated iterators over one pass of the stream (reference:
        ``Dataset.streaming_split``, ``dataset.py:1141`` — powered by a
        coordinator actor + OutputSplitter)."""
        coordinator = runtime.remote(_SplitCoordinator).options(
            num_cpus=0).remote(self, n)
        return [DataIterator(coordinator, i) for i in range(n)]

    # -- writes ---------------------------------------------------------------

    def write_parquet(self, path: str, *,
                      partition_cols: Optional[Sequence[str]] = None
                      ) -> None:
        """Parquet sink; with ``partition_cols``, hive-style layout —
        ``path/col=value/.../part-N.parquet`` with the partition columns
        dropped from the files (reference: ``Dataset.write_parquet``
        partitioning; readable back via ``read_parquet`` which
        re-attaches them from the path)."""
        import os
        import urllib.parse

        import pyarrow.compute as pc
        import pyarrow.parquet as pq

        os.makedirs(path, exist_ok=True)
        if not partition_cols:
            for i, block in enumerate(self.iter_blocks()):
                pq.write_table(BlockAccessor(block).to_arrow(),
                               f"{path}/part-{i:05d}.parquet")
            return
        import math

        from raytpu_torch.data.read_api import HIVE_NULL

        _nan = object()  # NaN can't key a set (nan != nan): normalize

        def norm(v):
            return _nan if isinstance(v, float) and math.isnan(v) else v

        cols = list(partition_cols)
        for i, block in enumerate(self.iter_blocks()):
            table = BlockAccessor(block).to_arrow()
            missing = [c for c in cols if c not in table.column_names]
            if missing:
                raise KeyError(f"partition_cols {missing} not in "
                               f"columns {table.column_names}")
            combos = {tuple(norm(row[c]) for c in cols)
                      for row in table.select(cols).to_pylist()}
            for combo in sorted(combos, key=repr):
                mask = None
                for c, v in zip(cols, combo):
                    m = (pc.is_null(table[c]) if v is None
                         else pc.is_nan(table[c]) if v is _nan
                         else pc.equal(table[c], v))
                    mask = m if mask is None else pc.and_(mask, m)
                sub = table.filter(mask).drop_columns(cols)
                segs = "/".join(
                    f"{c}=" + (HIVE_NULL if v is None else "nan"
                               if v is _nan else
                               urllib.parse.quote(str(v), safe=""))
                    for c, v in zip(cols, combo))
                os.makedirs(f"{path}/{segs}", exist_ok=True)
                pq.write_table(sub,
                               f"{path}/{segs}/part-{i:05d}.parquet")

    def write_orc(self, path: str) -> None:
        """ORC sink, one file per block (reference analogue:
        ``Dataset.write_orc``; pyarrow.orc codec)."""
        import os

        from pyarrow import orc

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            orc.write_table(BlockAccessor(block).to_arrow(),
                            f"{path}/part-{i:05d}.orc")

    def write_csv(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            BlockAccessor(block).to_pandas().to_csv(
                f"{path}/part-{i:05d}.csv", index=False)

    def write_json(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            BlockAccessor(block).to_pandas().to_json(
                f"{path}/part-{i:05d}.json", orient="records", lines=True)

    def write_numpy(self, path: str, column: str) -> None:
        """One ``.npy`` per block of ``column`` (reference:
        ``Dataset.write_numpy``)."""
        import os

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            arr = BlockAccessor(block).to_numpy()[column]
            np.save(f"{path}/part-{i:05d}.npy", arr)

    def write_tfrecords(self, path: str) -> None:
        """One ``.tfrecord`` shard per block, rows encoded as
        ``tf.train.Example`` protos (reference:
        ``Dataset.write_tfrecords``; codec in
        :mod:`raytpu_torch.data.tfrecord` — interoperable with TensorFlow's
        TFRecordWriter framing)."""
        import os

        from raytpu_torch.data.tfrecord import encode_example, write_records

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            rows = BlockAccessor(block).to_rows()
            write_records(
                f"{path}/part-{i:05d}.tfrecord",
                [encode_example(r) for r in rows])

    def write_avro(self, path: str, *, schema: Optional[dict] = None,
                   codec: str = "null") -> None:
        """One ``.avro`` object container file per block (reference:
        ``Dataset.write_avro``; dependency-free OCF codec in
        :mod:`raytpu_torch.data.avro`). The record schema is inferred from the
        rows unless given; ``codec``: ``null`` or ``deflate``."""
        import os

        from raytpu_torch.data.avro import infer_schema, write_file

        os.makedirs(path, exist_ok=True)
        # One schema for the whole dataset (external directory readers
        # expect consistent part schemas): inferred over ALL rows when
        # not given, so a column that is null-free in one block but
        # nullable in another still unifies.
        parts: List[List[dict]] = []
        for block in self.iter_blocks():
            parts.append([_plain_row(r)
                          for r in BlockAccessor(block).to_rows()])
        sch = schema or infer_schema([r for rows in parts for r in rows])
        for i, rows in enumerate(parts):
            write_file(f"{path}/part-{i:05d}.avro", sch, rows,
                       codec=codec)

    def write_sql(self, sql: str, connection_factory: Callable) -> None:
        """Write rows through a DB-API connection (reference:
        ``Dataset.write_sql`` / ``sql_datasink.py`` — ``sql`` is the
        parameterized INSERT, e.g. ``INSERT INTO t VALUES (?, ?)``;
        rows go in ``executemany`` batches so one bad row can't grow an
        unbounded buffer)."""
        MAX_ROWS_PER_WRITE = 128
        conn = connection_factory()
        try:
            cursor = conn.cursor()
            # Bind by the FIRST row's key order, not each dict's insertion
            # order — blocks produced by different tasks may carry the
            # same columns in different order, which would silently write
            # values into the wrong columns.
            keys: Optional[List[str]] = None
            for block in self.iter_blocks():
                values = []
                for row in BlockAccessor(block).to_rows():
                    plain = _plain_row(row)
                    if keys is None:
                        keys = list(plain)
                    elif set(plain) != set(keys):
                        raise ValueError(
                            f"write_sql: row columns {sorted(plain)} do not "
                            f"match first row's columns {sorted(keys)}")
                    values.append(tuple(plain[k] for k in keys))
                    if len(values) == MAX_ROWS_PER_WRITE:
                        cursor.executemany(sql, values)
                        values = []
                if values:
                    cursor.executemany(sql, values)
            conn.commit()
        finally:
            conn.close()

    def write_images(self, path: str, column: str, *,
                     file_format: str = "png",
                     filename_column: Optional[str] = None) -> None:
        """One image file per row from an array column (reference:
        ``Dataset.write_images`` / ``image_datasink.py``). Filenames
        come from ``filename_column`` when given, else sequential;
        uint8 HxWxC (or HxW grayscale) arrays are expected — readable
        back via ``read_images``."""
        import os

        from PIL import Image

        os.makedirs(path, exist_ok=True)
        n = 0
        for block in self.iter_blocks():
            for row in BlockAccessor(block).to_rows():
                arr = np.asarray(row[column])
                if arr.dtype != np.uint8:
                    # read_images yields float32 0-255; PIL wants uint8.
                    arr = np.clip(arr, 0, 255).astype(np.uint8)
                if filename_column:
                    # Extension-less names give PIL nothing to infer the
                    # format from; pass it explicitly ("jpg" is the PIL
                    # format "JPEG").
                    name = str(row[filename_column])
                    fmt = {"jpg": "JPEG"}.get(file_format.lower(),
                                              file_format.upper())
                    Image.fromarray(arr).save(os.path.join(path, name),
                                              format=fmt)
                else:
                    name = f"{n:06d}.{file_format}"
                    Image.fromarray(arr).save(os.path.join(path, name))
                n += 1

    def write_webdataset(self, path: str) -> None:
        """One ``.tar`` shard per block in WebDataset layout (reference:
        ``Dataset.write_webdataset`` / ``webdataset_datasink.py``):
        each row becomes ``{__key__}.{ext}`` members, one per non-key
        column; str values encode utf-8, bytes pass through, everything
        else serializes as its ``str()``. Round-trips through
        ``read_webdataset``."""
        import io
        import os
        import tarfile

        os.makedirs(path, exist_ok=True)
        for i, block in enumerate(self.iter_blocks()):
            with tarfile.open(f"{path}/part-{i:05d}.tar", "w") as tf:
                for j, row in enumerate(BlockAccessor(block).to_rows()):
                    row = _plain_row(row)
                    key = str(row.pop("__key__", f"{i:05d}{j:05d}"))
                    for ext, value in row.items():
                        if value is None:
                            continue
                        data = (value if isinstance(value, bytes)
                                else str(value).encode("utf-8"))
                        info = tarfile.TarInfo(f"{key}.{ext}")
                        info.size = len(data)
                        tf.addfile(info, io.BytesIO(data))

    # -- internals ------------------------------------------------------------

    def _with_op(self, op: OpSpec) -> "Dataset":
        return Dataset(self._source_fn, [*self._ops, op], name=self._name)

    def _rechunk(self, rows_per_block: int) -> "Dataset":
        parent = self

        def source():
            for batch in parent.iter_batches(batch_size=rows_per_block):
                yield runtime.put(batch)

        return Dataset(source, [], name=f"{self._name}.rechunk")

    def __repr__(self):
        ops = " -> ".join(op.name for op in self._ops) or "source"
        return f"Dataset({self._name}: {ops})"


def _plain_row(row: dict) -> dict:
    """Numpy scalars -> native Python values (avro/json writers need
    plain types; ndarray cells become lists)."""
    out = {}
    for k, v in row.items():
        if isinstance(v, np.generic):
            v = v.item()
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[k] = v
    return out


class _SplitCoordinator:
    """Feeds n consumers from one pass (OutputSplitter analogue). Blocks
    are handed out round-robin; `equal=True` semantics approximated by
    per-consumer demand-driven pull. An actor process of its own
    (``num_cpus=0``): it submits the dataset's tasks and owns their
    blocks until each consumer's ref to one is gone."""

    def __init__(self, dataset: Dataset, n: int):
        self.iter = dataset._iter_block_refs()
        self.n = n
        self.buffers: List[List] = [[] for _ in range(n)]
        self.exhausted = False
        self.rr = 0

    def next_ref(self, split: int):
        """Next block ref for consumer `split`, or None at end of stream."""
        while not self.buffers[split] and not self.exhausted:
            try:
                ref = next(self.iter)
            except StopIteration:
                self.exhausted = True
                break
            self.buffers[self.rr].append(ref)
            self.rr = (self.rr + 1) % self.n
        if self.buffers[split]:
            return self.buffers[split].pop(0)
        return None


class DataIterator:
    """Per-worker streaming iterator (reference: ``DataIterator`` from
    ``streaming_split``; consumed in train loops via
    ``session.get_dataset_shard``). It pickles (to the coordinator's
    handle and its split), so a trainer hands one to each worker
    process, which then pulls from the coordinator directly."""

    def __init__(self, coordinator, split: int):
        self._coordinator = coordinator
        self._split = split

    def iter_blocks(self):
        while True:
            # get() resolves the returned block ref one level, so this
            # yields the block value directly.
            block = runtime.get(
                self._coordinator.next_ref.remote(self._split))
            if block is None:
                return
            yield block

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False):
        carry: List = []
        carry_rows = 0
        for block in self.iter_blocks():
            carry.append(block)
            carry_rows += BlockAccessor(block).num_rows()
            while carry_rows >= batch_size:
                whole = concat_blocks(carry)
                acc = BlockAccessor(whole)
                yield batch_format_view(acc.slice(0, batch_size),
                                        batch_format)
                rest = acc.slice(batch_size, acc.num_rows())
                carry = [rest]
                carry_rows = BlockAccessor(rest).num_rows()
        if carry_rows and not drop_last:
            yield batch_format_view(concat_blocks(carry), batch_format)

    def iter_rows(self):
        for block in self.iter_blocks():
            yield from BlockAccessor(block).to_rows()

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False, device=None,
                           dtypes=None) -> Iterator:
        """:meth:`Dataset.iter_torch_batches` over this split."""
        return _torch_batches(self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            drop_last=drop_last), device, dtypes)


def _torch_batches(batches, device, dtypes) -> Iterator:
    """numpy batches as torch tensors on ``device`` (the card unless
    ``"cpu"``), each column cast to its dtype in the same single copy."""
    import torch

    device = resolve_device(device)
    for batch in batches:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            want = dtypes.get(k) if isinstance(dtypes, dict) else dtypes
            # single .to(): one copy, not one per conversion
            out[k] = t.to(device=device, dtype=want)
        yield out


def _stable_hash(vals: np.ndarray) -> np.ndarray:
    """Deterministic per-row hash for exchange partitioning. Python's
    ``hash()`` is process-salted for str (PYTHONHASHSEED), which would
    scatter one group across reducers in different worker processes."""
    import zlib

    vals = np.asarray(vals)
    if vals.dtype.kind in "iub":
        v = vals.astype(np.uint64)
        v = (v ^ (v >> np.uint64(33))) * np.uint64(0xff51afd7ed558ccd)
        # Mask to a positive int64 range (2**62 - 1, NOT a single bit).
        return (v ^ (v >> np.uint64(33))).astype(np.int64) \
            & np.int64(2 ** 62 - 1)
    if vals.dtype.kind == "f":
        return _stable_hash(vals.view(np.uint64)
                            if vals.dtype == np.float64
                            else vals.astype(np.float64).view(np.uint64))
    return np.array([zlib.crc32(str(x).encode()) for x in vals],
                    dtype=np.int64)


class GroupedData:
    """Distributed group-by surface (reference: ``GroupedData`` in
    ``python/ray/data/grouped_data.py``): a hash exchange lands every
    group whole on one reducer; aggregations and ``map_groups`` run
    reducer-local."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _exchange(self, post, name: str) -> Dataset:
        key = self._key

        def assign(npd, rows, idx, n_out, aux):
            return _stable_hash(npd[key]) % n_out

        return self._ds._all_to_all(None, assign, name, post_fn=post)

    def map_groups(self, fn: Callable[[Dict[str, np.ndarray]], Any]
                   ) -> Dataset:
        """Apply ``fn(group_numpy_batch) -> batch`` per group."""
        key = self._key

        def post(block, j):
            npd = BlockAccessor(block).to_numpy()
            vals = np.asarray(npd[key])
            outs = []
            for g in np.unique(vals):
                mask = vals == g
                group = {k: np.asarray(v)[mask] for k, v in npd.items()}
                outs.append(normalize_batch_output(fn(group)))
            return concat_blocks(outs) if outs else npd
        return self._exchange(post, "map_groups")

    def _agg(self, col: Optional[str], reducer: Callable, out_col: str
             ) -> Dataset:
        key = self._key

        def post(block, j):
            npd = BlockAccessor(block).to_numpy()
            vals = np.asarray(npd[key])
            groups = np.unique(vals)
            out_keys, out_vals = [], []
            for g in groups:
                mask = vals == g
                out_keys.append(g)
                out_vals.append(reducer(
                    np.asarray(npd[col])[mask] if col else mask))
            return {key: np.asarray(out_keys),
                    out_col: np.asarray(out_vals)}
        return self._exchange(post, f"groupby-{out_col}")

    def count(self) -> Dataset:
        return self._agg(None, lambda mask: int(mask.sum()), "count()")

    def sum(self, col: str) -> Dataset:
        return self._agg(col, lambda v: v.sum(), f"sum({col})")

    def mean(self, col: str) -> Dataset:
        return self._agg(col, lambda v: v.mean(), f"mean({col})")

    def min(self, col: str) -> Dataset:
        return self._agg(col, lambda v: v.min(), f"min({col})")

    def max(self, col: str) -> Dataset:
        return self._agg(col, lambda v: v.max(), f"max({col})")

    def std(self, col: str) -> Dataset:
        return self._agg(col, lambda v: v.std(ddof=1) if v.size > 1
                         else 0.0, f"std({col})")
