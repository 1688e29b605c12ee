"""Blocks, the port of :mod:`raytpu.data.block`: the unit of data
movement. A block is a pyarrow Table (structured data) or a dict of
numpy arrays (tensor data); both cross the object store without a copy
(numpy buffers and arrow buffers ride out of band into the value's
shared-memory segment).

``pyarrow`` (and ``pandas``) are imported only where a block is a table
or one is asked for, as in the JAX package, so a dict-of-arrays pipeline
runs where they are not installed; a path that needs them raises
``ImportError`` naming the package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Union

import numpy as np

Block = Union["pyarrow.Table", Dict[str, np.ndarray]]  # noqa: F821


def _is_table(block) -> bool:
    """Whether ``block`` is a pyarrow Table, without importing pyarrow."""
    return type(block).__module__.startswith("pyarrow")


def _pyarrow():
    try:
        import pyarrow
    except ImportError as exc:
        raise ImportError("this Data path builds an arrow table and needs "
                          "the 'pyarrow' package") from exc
    return pyarrow


class BlockAccessor:
    """Uniform view over the two block kinds."""

    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        if _is_table(self.block):
            return self.block.num_rows
        if not self.block:
            return 0
        return len(next(iter(self.block.values())))

    def to_arrow(self):
        if _is_table(self.block):
            return self.block
        pa = _pyarrow()
        return pa.table({k: pa.array(np.asarray(v))
                         for k, v in self.block.items()})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        if _is_table(self.block):
            return {name: col.to_numpy(zero_copy_only=False)
                    for name, col in zip(self.block.column_names,
                                         self.block.columns)}
        return self.block

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_rows(self) -> List[dict]:
        npd = self.to_numpy()
        keys = list(npd.keys())
        n = self.num_rows()
        return [{k: npd[k][i] for k in keys} for i in range(n)]

    def slice(self, start: int, end: int) -> Block:
        if _is_table(self.block):
            return self.block.slice(start, end - start)
        return {k: v[start:end] for k, v in self.block.items()}

    def size_bytes(self) -> int:
        if _is_table(self.block):
            return self.block.nbytes
        return sum(np.asarray(v).nbytes for v in self.block.values())

    def schema(self):
        if _is_table(self.block):
            return self.block.schema
        return {k: np.asarray(v).dtype for k, v in self.block.items()}


def block_from_rows(rows: List[Any]) -> Block:
    """List of dicts (or scalars → {'item': ...}) to a block."""
    pa = _pyarrow()
    if not rows:
        return pa.table({})
    if isinstance(rows[0], dict):
        keys = rows[0].keys()
        return pa.table({k: [r[k] for r in rows] for k in keys})
    return pa.table({"item": list(rows)})


def concat_blocks(blocks: List[Block]) -> Block:
    # Empty blocks (an empty file/shard read) carry no schema — mixing
    # one in must not drop the real rows or fail the arrow concat.
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return _pyarrow().table({})
    if isinstance(blocks[0], dict):
        keys = blocks[0].keys()
        return {k: np.concatenate([np.asarray(b[k]) for b in blocks])
                for k in keys}
    # promote: blocks from different files may have different column
    # sets (e.g. webdataset shards with differing extensions) — absent
    # columns fill with nulls instead of ArrowInvalid.
    return _pyarrow().concat_tables(
        [BlockAccessor(b).to_arrow() for b in blocks],
        promote_options="default")


def batch_format_view(block: Block, batch_format: str):
    acc = BlockAccessor(block)
    if batch_format in ("numpy", "default"):
        return acc.to_numpy()
    if batch_format == "pandas":
        return acc.to_pandas()
    if batch_format in ("pyarrow", "arrow"):
        return acc.to_arrow()
    raise ValueError(f"unknown batch_format {batch_format!r}")


def normalize_batch_output(out: Any) -> Block:
    """Accept what user map_batches fns return: dict of arrays, arrow
    table, pandas frame, or list of rows."""
    if _is_table(out):
        return out
    if isinstance(out, dict):
        return {k: np.asarray(v) for k, v in out.items()}
    if type(out).__module__.startswith("pandas"):
        return _pyarrow().Table.from_pandas(out, preserve_index=False)
    if isinstance(out, list):
        return block_from_rows(out)
    raise TypeError(
        f"map_batches function returned {type(out)}; expected dict of "
        "arrays, pyarrow.Table, pandas.DataFrame, or list of rows")
