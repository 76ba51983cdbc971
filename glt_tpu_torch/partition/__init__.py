"""Offline partitioning and the on-disk partition layout (counterpart of
glt_tpu/partition): the random and the frequency partitioner, hot-cache
rows (``cat_feature_cache``) and the two-stage feature build
(``build_partition_feature``)."""
from .base import (PartitionerBase, build_partition_feature,
                   cat_feature_cache, load_meta, load_partition,
                   load_partition_graph)
from .frequency_partitioner import FrequencyPartitioner
from .partition_book import (PartitionBook, RangePartitionBook,
                             TablePartitionBook, dense_book,
                             infer_partition_book)
from .random_partitioner import RandomPartitioner

__all__ = ['FrequencyPartitioner', 'PartitionBook', 'PartitionerBase',
           'RandomPartitioner', 'RangePartitionBook', 'TablePartitionBook',
           'build_partition_feature', 'cat_feature_cache', 'dense_book',
           'infer_partition_book', 'load_meta', 'load_partition',
           'load_partition_graph']
