from .base import (BaseSampler, EdgeSamplerInput, HeteroSamplerOutput,
                   NegativeSampling, NodeSamplerInput, SamplerOutput,
                   SamplingConfig, SamplingType)
from .negative_sampler import RandomNegativeSampler
from .neighbor_sampler import NeighborSampler

__all__ = ['BaseSampler', 'EdgeSamplerInput', 'HeteroSamplerOutput',
           'NegativeSampling', 'NeighborSampler', 'NodeSamplerInput',
           'RandomNegativeSampler', 'SamplerOutput', 'SamplingConfig',
           'SamplingType']
