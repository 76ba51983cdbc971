from .transform import Batch, to_batch

__all__ = ['Batch', 'to_batch']
