"""Partitioned graphs and features and the trainers and loaders over them
(counterpart of glt_tpu/distributed): one partition a rank of a
``torch.distributed`` group, the rpc of the reference collapsed into the
exchanges of ``parallel/collectives.py``. Not ported (ROADMAP A12): the
rpc and producer stack (and with it a spilled DistFeature's host phase
and cold fetcher), the weighted and full-neighbourhood partitioned hops,
``FrequencyPartitioner`` and the multihost loaders
(``*_from_partitions_multihost``)."""
from .dist_dataset import DistDataset
from .dist_feature import DistFeature
from .dist_graph import DistGraph
from .dist_hetero import (DistHeteroGraph, DistHeteroNeighborSampler,
                          DistHeteroTrainStep)
from .dist_link_loader import DistLinkNeighborLoader
from .dist_loader import DistLoader, DistNeighborLoader
from .dist_negative import DistRandomNegativeSampler, make_dist_edge_membership
from .dist_neighbor_sampler import DistNeighborSampler, make_dist_one_hop
from .dist_subgraph_loader import DistSubGraphLoader
from .dist_train import DistTrainStep

__all__ = ['DistDataset', 'DistFeature', 'DistGraph', 'DistHeteroGraph',
           'DistHeteroNeighborSampler', 'DistHeteroTrainStep',
           'DistLinkNeighborLoader', 'DistLoader', 'DistNeighborLoader',
           'DistNeighborSampler', 'DistRandomNegativeSampler',
           'DistSubGraphLoader', 'DistTrainStep', 'make_dist_edge_membership',
           'make_dist_one_hop']
