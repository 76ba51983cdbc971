from .base import (BaseSampler, EdgeSamplerInput, HeteroSamplerOutput,
                   NegativeSampling, NodeSamplerInput, SamplerOutput)
from .negative_sampler import RandomNegativeSampler
from .neighbor_sampler import NeighborSampler

__all__ = ['BaseSampler', 'EdgeSamplerInput', 'HeteroSamplerOutput',
           'NegativeSampling', 'NeighborSampler', 'NodeSamplerInput',
           'RandomNegativeSampler', 'SamplerOutput']
