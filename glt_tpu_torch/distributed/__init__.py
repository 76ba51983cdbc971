"""Partitioned graphs and features, the trainers and loaders over them,
and the server-client mode (counterpart of glt_tpu/distributed).

A partitioned trainer keeps one partition a rank of a ``torch.distributed``
group and exchanges through ``parallel/collectives.py``. The server-client
mode runs over the rpc fabric (``rpc.py``): sampling servers
(``dist_server.py``) whose spawned workers sample on the card
(``dist_sampling_producer.py``) and stream batches through a shared-memory
ring, and training clients (``dist_client.py``) pulling them with prefetch
(``channel_loader.py``). A spilled DistFeature may serve its cold rows in
a host phase, over rpc from another process's partition. Traced requests
carry their trace context over the fabric (``glt_tpu_torch.obs``).

A sampling server takes live updates of its partition through
``apply_delta``. The partitioned samplers take weighted and
full-neighbourhood (``-1``) hops at the rows' owners, with edge ids, and a
partition may hold hot-cache rows of other partitions
(``FrequencyPartitioner``), which its rank's lookups answer locally.

Tables too large for one partitioner are partitioned online
(``DistRandomPartitioner``, ``DistTableRandomPartitioner``,
``DistTableDataset``): each rank pushes its slices to their owners over
the rpc fabric. The multihost builders load a rank's own partition into
the stores under ``parallel/multihost.py``'s process group."""
from .channel_loader import (MpNeighborLoader, RemoteNeighborLoader,
                             message_to_batch)
from .dist_client import (apply_delta, async_request_server, collect_obs,
                          export_fabric_trace, fabric_stats, init_client,
                          request_server, request_with_failover,
                          set_replicas, shutdown_client)
from .dist_context import (DistContext, DistRole, assign_server_by_order,
                           get_context, init_client_context,
                           init_server_context, init_worker_group, shutdown)
from .dist_dataset import DistDataset, DistTableDataset
from .dist_feature import (DistFeature, PartialFeature,
                           dist_feature_from_partitions_multihost,
                           resilient_cold_fetcher)
from .dist_graph import DistGraph, dist_graph_from_partitions_multihost
from .dist_hetero import (DistHeteroGraph, DistHeteroNeighborSampler,
                          DistHeteroTrainStep,
                          dist_hetero_graph_from_partitions_multihost)
from .dist_link_loader import DistLinkNeighborLoader
from .dist_loader import DistLoader, DistNeighborLoader
from .dist_negative import DistRandomNegativeSampler, make_dist_edge_membership
from .dist_neighbor_sampler import DistNeighborSampler, make_dist_one_hop
from .dist_random_partitioner import (DistRandomPartitioner,
                                      DistTableRandomPartitioner)
from .dist_options import (CollocatedDistSamplingWorkerOptions,
                           MpDistSamplingWorkerOptions,
                           RemoteDistSamplingWorkerOptions)
from .dist_sampling_producer import (DistCollocatedSamplingProducer,
                                     DistMpSamplingProducer,
                                     flatten_sampler_output)
from .dist_server import (DistServer, free_port_base, get_server, init_server,
                          server_port, shutdown_server,
                          wait_and_shutdown_server)
from .dist_subgraph_loader import DistSubGraphLoader
from .dist_train import DistTrainStep
from .event_loop import ConcurrentEventLoop
from .rpc import (RpcCalleeBase, RpcClient, RpcDataPartitionRouter,
                  RpcServer, all_gather, barrier, get_rpc_master_addr,
                  get_rpc_master_port, global_all_gather, global_barrier,
                  init_rpc, ping_endpoint, rpc_global_request,
                  rpc_global_request_async, rpc_is_initialized, rpc_register,
                  rpc_request, rpc_request_async, rpc_sync_data_partitions,
                  shutdown_rpc)

__all__ = [
    'DistDataset', 'DistFeature', 'DistGraph', 'DistHeteroGraph',
    'DistHeteroNeighborSampler', 'DistHeteroTrainStep',
    'DistLinkNeighborLoader', 'DistLoader', 'DistNeighborLoader',
    'DistNeighborSampler', 'DistRandomNegativeSampler', 'DistSubGraphLoader',
    'DistTrainStep', 'make_dist_edge_membership', 'make_dist_one_hop',
    'resilient_cold_fetcher',
    'DistRandomPartitioner', 'DistTableDataset', 'DistTableRandomPartitioner',
    'PartialFeature', 'dist_feature_from_partitions_multihost',
    'dist_graph_from_partitions_multihost',
    'dist_hetero_graph_from_partitions_multihost',
    'DistContext', 'DistRole', 'assign_server_by_order', 'get_context',
    'init_client_context', 'init_server_context', 'init_worker_group',
    'shutdown',
    'CollocatedDistSamplingWorkerOptions', 'MpDistSamplingWorkerOptions',
    'RemoteDistSamplingWorkerOptions',
    'DistCollocatedSamplingProducer', 'DistMpSamplingProducer',
    'flatten_sampler_output',
    'MpNeighborLoader', 'RemoteNeighborLoader', 'message_to_batch',
    'DistServer', 'free_port_base', 'get_server', 'init_server',
    'server_port',
    'shutdown_server', 'wait_and_shutdown_server',
    'apply_delta', 'async_request_server', 'collect_obs',
    'export_fabric_trace',
    'fabric_stats', 'init_client', 'request_server',
    'request_with_failover', 'set_replicas', 'shutdown_client',
    'ConcurrentEventLoop',
    'RpcCalleeBase', 'RpcClient', 'RpcDataPartitionRouter', 'RpcServer',
    'all_gather', 'barrier', 'get_rpc_master_addr', 'get_rpc_master_port',
    'global_all_gather', 'global_barrier', 'init_rpc', 'ping_endpoint',
    'rpc_global_request', 'rpc_global_request_async', 'rpc_is_initialized',
    'rpc_register', 'rpc_request', 'rpc_request_async',
    'rpc_sync_data_partitions', 'shutdown_rpc',
]
