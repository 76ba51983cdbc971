from .device_epoch import pad_seed_batch
from .link_loader import LinkLoader, LinkNeighborLoader, get_edge_label_index
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader
from .subgraph_loader import SubGraphLoader
from .transform import Batch, HeteroBatch, to_batch, to_hetero_batch

__all__ = ['Batch', 'HeteroBatch', 'LinkLoader', 'LinkNeighborLoader',
           'NeighborLoader', 'NodeLoader', 'SubGraphLoader',
           'get_edge_label_index', 'pad_seed_batch', 'to_batch',
           'to_hetero_batch']
