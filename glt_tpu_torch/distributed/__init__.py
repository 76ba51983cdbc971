"""Partitioned graphs and features and the hetero trainer over them
(counterpart of glt_tpu/distributed): one partition a rank of a
``torch.distributed`` group, the rpc of the reference collapsed into the
exchanges of ``parallel/collectives.py``. Not ported (ROADMAP A12): the
homogeneous ``DistTrainStep``, ``DistLinkNeighborLoader``, the rpc and
producer stack, the spilled DistFeature, the multihost builders."""
from .dist_dataset import DistDataset
from .dist_feature import DistFeature
from .dist_graph import DistGraph
from .dist_hetero import (DistHeteroGraph, DistHeteroNeighborSampler,
                          DistHeteroTrainStep)
from .dist_neighbor_sampler import DistNeighborSampler, make_dist_one_hop

__all__ = ['DistDataset', 'DistFeature', 'DistGraph', 'DistHeteroGraph',
           'DistHeteroNeighborSampler', 'DistHeteroTrainStep',
           'DistNeighborSampler', 'make_dist_one_hop']
