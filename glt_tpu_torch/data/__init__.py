from .dataset import Dataset
from .feature import Feature, gather_features
from .graph import Graph, hetero_node_counts
from .reorder import in_degrees, sort_by_in_degree
from .topology import Topology

__all__ = ['Dataset', 'Feature', 'Graph', 'Topology', 'gather_features',
           'hetero_node_counts', 'in_degrees', 'sort_by_in_degree']
