from .conv import GATConv, GCNConv, SAGEConv, segment_mean
from .convert import (dgcnn_params_from_flax, gat_conv_params_from_flax,
                      gcn_conv_params_from_flax, hgt_params_from_flax,
                      rgnn_params_from_flax, sage_conv_params_from_flax,
                      sage_params_from_flax)
from .dgcnn import DGCNN
from .hgt import HGT, HGTConv
from .rgnn import RGNN, HeteroConvLayer
from .sage import GraphSAGE

__all__ = ['DGCNN', 'GATConv', 'GCNConv', 'GraphSAGE', 'HGT', 'HGTConv',
           'HeteroConvLayer', 'RGNN', 'SAGEConv', 'dgcnn_params_from_flax',
           'gat_conv_params_from_flax', 'gcn_conv_params_from_flax',
           'hgt_params_from_flax', 'rgnn_params_from_flax',
           'sage_conv_params_from_flax', 'sage_params_from_flax',
           'segment_mean']
