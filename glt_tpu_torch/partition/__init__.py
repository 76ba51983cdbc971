"""Offline partitioning and the on-disk partition layout (counterpart of
glt_tpu/partition). Not ported: ``FrequencyPartitioner``,
``cat_feature_cache`` and ``build_partition_feature`` (ROADMAP A12)."""
from .base import (PartitionerBase, load_meta, load_partition,
                   load_partition_graph)
from .partition_book import (PartitionBook, RangePartitionBook,
                             TablePartitionBook, dense_book,
                             infer_partition_book)
from .random_partitioner import RandomPartitioner

__all__ = ['PartitionBook', 'PartitionerBase', 'RandomPartitioner',
           'RangePartitionBook', 'TablePartitionBook', 'dense_book',
           'infer_partition_book', 'load_meta', 'load_partition',
           'load_partition_graph']
