from .conv import GATConv, SAGEConv, segment_mean
from .convert import (gat_conv_params_from_flax, rgnn_params_from_flax,
                      sage_conv_params_from_flax, sage_params_from_flax)
from .rgnn import RGNN, HeteroConvLayer
from .sage import GraphSAGE

__all__ = ['GATConv', 'GraphSAGE', 'HeteroConvLayer', 'RGNN', 'SAGEConv',
           'gat_conv_params_from_flax', 'rgnn_params_from_flax',
           'sage_conv_params_from_flax', 'sage_params_from_flax',
           'segment_mean']
