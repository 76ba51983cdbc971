from .transform import Batch, HeteroBatch, to_batch, to_hetero_batch

__all__ = ['Batch', 'HeteroBatch', 'to_batch', 'to_hetero_batch']
