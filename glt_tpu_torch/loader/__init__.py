from .device_epoch import pad_seed_batch
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader
from .transform import Batch, HeteroBatch, to_batch, to_hetero_batch

__all__ = ['Batch', 'HeteroBatch', 'NeighborLoader', 'NodeLoader',
           'pad_seed_batch', 'to_batch', 'to_hetero_batch']
