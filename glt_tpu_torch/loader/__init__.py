from .device_epoch import (DeviceEpochLoader, SeedSuperstep, pad_seed_batch,
                           shard_n_valid, stack_epoch_batches)
from .link_loader import LinkLoader, LinkNeighborLoader, get_edge_label_index
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader
from .subgraph_loader import SubGraphLoader
from .transform import (Batch, EdgeIndex, HeteroBatch, to_batch,
                        to_hetero_batch, to_pyg_v1, to_torch_data)

__all__ = ['Batch', 'DeviceEpochLoader', 'EdgeIndex', 'HeteroBatch', 'LinkLoader',
           'LinkNeighborLoader', 'NeighborLoader', 'NodeLoader',
           'SeedSuperstep', 'SubGraphLoader', 'get_edge_label_index',
           'pad_seed_batch', 'shard_n_valid', 'stack_epoch_batches',
           'to_batch', 'to_hetero_batch', 'to_pyg_v1', 'to_torch_data']
