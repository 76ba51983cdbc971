from .conv import SAGEConv, segment_mean
from .convert import sage_conv_params_from_flax, sage_params_from_flax
from .sage import GraphSAGE

__all__ = ['GraphSAGE', 'SAGEConv', 'segment_mean',
           'sage_conv_params_from_flax', 'sage_params_from_flax']
