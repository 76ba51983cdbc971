"""Online GNN inference (counterpart of glt_tpu/serving/): micro-batching,
bucketed sampling and an embedding cache over the sampler, feature and
model stack, behind an rpc front end and a sharded fleet router.

The request path is::

  ServingClient --rpc--> ServingServer --> MicroBatcher --> InferenceEngine
                                                              |-- EmbeddingCache (LRU, versioned)
                                                              |-- NeighborSampler (K1, one walk launch a bucket)
                                                              |-- Feature gather (K3)
                                                              `-- model forward

  FleetRouter --> FleetShard (local engines | remote ServingServers)
"""
from .batcher import EngineStalledError, MicroBatcher, ServingOverloaded
from .embedding_cache import EmbeddingCache
from .engine import InferenceEngine
from .fleet import (AdmissionClass, AdmissionController, FleetOverloaded,
                    FleetRouter, FleetShard, FleetUnavailable, ScalePolicy)
from .metrics import LatencyHistogram, ServingMetrics
from .server import ServingClient, ServingServer

__all__ = [
    'MicroBatcher', 'ServingOverloaded', 'EngineStalledError',
    'EmbeddingCache',
    'InferenceEngine', 'LatencyHistogram', 'ServingMetrics',
    'ServingClient', 'ServingServer',
    'AdmissionClass', 'AdmissionController', 'FleetOverloaded',
    'FleetRouter', 'FleetShard', 'FleetUnavailable', 'ScalePolicy',
]
