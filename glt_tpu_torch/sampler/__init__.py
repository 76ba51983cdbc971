from .base import BaseSampler, NodeSamplerInput, SamplerOutput
from .neighbor_sampler import NeighborSampler

__all__ = ['BaseSampler', 'NeighborSampler', 'NodeSamplerInput',
           'SamplerOutput']
