from .common import as_numpy, parse_size, resolve_device
from .rng import RandomSeedManager, make_generator

__all__ = ['as_numpy', 'parse_size', 'resolve_device', 'RandomSeedManager',
           'make_generator']
