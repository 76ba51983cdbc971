from .pipeline import edge_hop_offsets, multihop_sample, sample_budget

__all__ = ['edge_hop_offsets', 'multihop_sample', 'sample_budget']
