from .dataset import Dataset
from .feature import Feature, gather_features
from .graph import Graph, hetero_node_counts
from .topology import Topology

__all__ = ['Dataset', 'Feature', 'Graph', 'Topology', 'gather_features',
           'hetero_node_counts']
