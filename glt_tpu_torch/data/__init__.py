from .dataset import Dataset
from .feature import Feature, gather_features
from .graph import Graph, hetero_node_counts
from .reorder import in_degrees, sort_by_in_degree
from .table_dataset import (TableDataset, csv_edge_reader, csv_node_reader,
                            odps_table_reader)
from .topology import Topology

__all__ = ['Dataset', 'Feature', 'Graph', 'TableDataset', 'Topology',
           'csv_edge_reader', 'csv_node_reader', 'gather_features',
           'hetero_node_counts', 'in_degrees', 'odps_table_reader',
           'sort_by_in_degree']
