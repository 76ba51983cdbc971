from .common import (as_numpy, merge_dict, parse_size, resolve_device,
                     seed_everything)
from .rng import RandomSeedManager, make_generator
from .tensor import id2idx, index_select

__all__ = ['as_numpy', 'id2idx', 'index_select', 'merge_dict', 'parse_size',
           'resolve_device', 'seed_everything', 'RandomSeedManager',
           'make_generator']
