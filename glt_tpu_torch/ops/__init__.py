from .pipeline import edge_hop_offsets, multihop_sample, sample_budget
from .stitch import stitch_rows

__all__ = ['edge_hop_offsets', 'multihop_sample', 'sample_budget',
           'stitch_rows']
