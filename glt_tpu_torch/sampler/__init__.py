from .base import (BaseSampler, HeteroSamplerOutput, NodeSamplerInput,
                   SamplerOutput)
from .neighbor_sampler import NeighborSampler

__all__ = ['BaseSampler', 'HeteroSamplerOutput', 'NeighborSampler',
           'NodeSamplerInput', 'SamplerOutput']
