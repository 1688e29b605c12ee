"""raytpu_torch.data: lazy streaming datasets on the port's tasks, the
port of :mod:`raytpu.data` (its ``__all__`` but ``from_jax``, which takes
JAX arrays; ``Dataset.iter_jax_batches`` is left out for the same
reason)."""

from raytpu_torch.data.block import Block, BlockAccessor
from raytpu_torch.data.dataset import DataIterator, Dataset, GroupedData
from raytpu_torch.data.executor import ActorPoolStrategy, ResourceBudget
from raytpu_torch.data.read_api import (
    from_arrow,
    from_generator,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_torch,
    range,  # noqa: A004
    range_tensor,
    read_avro,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_orc,
    read_parquet,
    read_sql,
    read_tfrecords,
    read_text,
    read_webdataset,
)

__all__ = [
    "Dataset",
    "DataIterator",
    "GroupedData",
    "ActorPoolStrategy",
    "ResourceBudget",
    "Block",
    "BlockAccessor",
    "range",
    "range_tensor",
    "from_generator",
    "from_huggingface",
    "from_items",
    "from_numpy",
    "from_pandas",
    "from_arrow",
    "from_torch",
    "read_binary_files",
    "read_csv",
    "read_images",
    "read_json",
    "read_numpy",
    "read_orc",
    "read_parquet",
    "read_avro",
    "read_sql",
    "read_tfrecords",
    "read_text",
    "read_webdataset",
]

from raytpu_torch.util import usage_stats as _usage_stats

_usage_stats.record_library_usage("data")
