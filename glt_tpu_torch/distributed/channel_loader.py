"""Channel-fed loaders: the mp mode (sampling worker processes of this
process) and the remote mode (the server-client mode's servers)
(counterpart of glt_tpu/distributed/channel_loader.py; the reference's
distributed/dist_loader.py mode dispatch, :130-262).

Both yield the port's :class:`~glt_tpu_torch.loader.transform.Batch`, as
the in-process loaders do, so a training loop is the same in every mode.
``message_to_batch`` is where a message reaches the card: each of its
tensors is copied there once.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

from ..channel import (MpChannel, RemoteReceivingChannel, ShmChannel,
                       pack_message, unpack_message)
from ..loader.transform import Batch
from ..ops.pipeline import edge_hop_offsets
from ..sampler.base import SamplingConfig
from ..utils import as_numpy, resolve_device
from .dist_options import (MpDistSamplingWorkerOptions,
                           RemoteDistSamplingWorkerOptions)
from .dist_sampling_producer import (DistMpSamplingProducer, END_KEY,
                                     EPOCH_KEY)


def message_to_batch(msg, config: SamplingConfig, device=None) -> Batch:
  """A flat SampleMessage as a Batch on ``device`` (None: the card; the
  reference's ``channel.recv`` then ``.to(device)``). The edge slices of
  the hops come with the message (``#hop_offsets``: a worker resolves a
  -1 fanout to its graph's window), else from ``config``."""
  device = resolve_device(device)

  def put(key):
    t = msg.get(key)
    return None if t is None else t.to(device)
  if '#hop_offsets' in msg:
    offs = [int(o) for o in msg['#hop_offsets']]
  else:
    offs = edge_hop_offsets(config.batch_size, config.num_neighbors)
  meta = {'n_valid': int(msg['n_valid'][0])} if 'n_valid' in msg else {}
  return Batch(
      x=put('nfeats'), y=put('nlabels'),
      row=put('row'), col=put('col'), edge_mask=put('edge_mask'),
      node=put('node'), node_count=msg['node_count'][0].to(device),
      edge=put('eids'), edge_attr=put('efeats'),
      num_sampled_nodes=put('num_sampled_nodes'),
      num_sampled_edges=put('num_sampled_edges'),
      metadata=meta, batch_size=config.batch_size,
      edge_hop_offsets=tuple(offs))


class MpNeighborLoader:
  """The mp mode: sampling worker processes (``worker_options.
  num_workers``, spawned) sample on ``device`` and feed this process
  through a shared-memory ring (reference DistLoader's mp branch).
  ``dataset_builder`` is a picklable function each worker calls to build
  its dataset on ``device`` (None: the card)."""

  def __init__(self, dataset_builder: Callable, num_neighbors,
               input_nodes, batch_size: int = 512,
               shuffle: bool = False, drop_last: bool = False,
               with_edge: bool = False, collect_features: bool = True,
               seed: Optional[int] = None,
               worker_options: Optional[MpDistSamplingWorkerOptions]
               = None, device=None):
    self.device = resolve_device(device)
    self.options = worker_options or MpDistSamplingWorkerOptions()
    self.config = SamplingConfig(
        num_neighbors=list(num_neighbors), batch_size=batch_size,
        shuffle=shuffle, drop_last=drop_last, with_edge=with_edge,
        collect_features=collect_features, seed=seed)
    if self.options.use_shm:
      try:
        self.channel = ShmChannel(
            capacity_bytes=self.options.channel_capacity_bytes)
      except Exception:
        self.channel = MpChannel(capacity=256)
    else:
      self.channel = MpChannel(capacity=256)
    self.producer = DistMpSamplingProducer(
        dataset_builder, self.config, as_numpy(input_nodes), self.channel,
        num_workers=self.options.num_workers, device=self.device)
    self.producer.init()
    self._epoch = 0

  def __iter__(self):
    epoch = self._epoch
    self.producer.produce_all(epoch)
    self._epoch += 1
    ends = 0
    while ends < self.producer.num_expected_ends:
      msg = self.channel.recv(
          timeout_ms=int(self.options.rpc_timeout * 1000))
      if EPOCH_KEY in msg and int(msg[EPOCH_KEY][0]) != epoch:
        continue  # a leftover of a partly consumed earlier epoch
      if END_KEY in msg:
        ends += 1
        continue
      yield message_to_batch(msg, self.config, self.device)

  def shutdown(self) -> None:
    """Stops the workers and removes the channel."""
    self.producer.shutdown()
    if hasattr(self.channel, 'close'):
      self.channel.close()


class RemoteNeighborLoader:
  """The remote mode: sampling runs in server processes and batches are
  pulled over rpc with prefetch (reference DistLoader's remote branch
  and RemoteReceivingChannel). ``input_nodes_per_server`` holds one seed
  array a server, or a split name each server resolves against its own
  dataset (``worker_options.server_rank`` then names the servers).
  Batches land on ``device`` (None: the card)."""

  def __init__(self, num_neighbors, input_nodes_per_server,
               batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False, with_edge: bool = False,
               collect_features: bool = True, seed: Optional[int] = None,
               worker_options: Optional[RemoteDistSamplingWorkerOptions]
               = None, num_workers_per_server: int = 1, device=None):
    from . import dist_client
    self.device = resolve_device(device)
    self.options = worker_options or RemoteDistSamplingWorkerOptions()
    ranks = self.options.server_rank
    if ranks is None:
      assert not isinstance(input_nodes_per_server, str), (
          'split-name seeding needs explicit server_rank in options')
      ranks = list(range(len(input_nodes_per_server)))
    if isinstance(ranks, int):
      ranks = [ranks]
    self.server_ranks = ranks
    cfg_kwargs = dict(
        num_neighbors=list(num_neighbors), batch_size=batch_size,
        shuffle=shuffle, drop_last=drop_last, with_edge=with_edge,
        collect_features=collect_features, seed=seed)
    self.config = SamplingConfig(**cfg_kwargs)
    self.worker_key = (f'{self.options.worker_key}'
                       f'@client{dist_client._client_rank}')
    if isinstance(input_nodes_per_server, str):
      payloads = [pack_message({'split': np.frombuffer(
          input_nodes_per_server.encode(), np.uint8)})] * len(ranks)
    else:
      payloads = [pack_message({'seeds': as_numpy(s).astype(np.int64)})
                  for s in input_nodes_per_server]
    for rank, payload in zip(ranks, payloads):
      dist_client.request_server(
          rank, 'create_sampling_producer', self.worker_key, payload,
          cfg_kwargs, num_workers_per_server,
          self.options.buffer_capacity_bytes)
    self._epoch = 0
    self._epoch_active = 0
    self.degraded_servers: set = set()

    def make_fetcher(rank):
      def fetch():
        # the epoch this iteration belongs to: a stale puller outliving
        # an abandoned epoch gets #STALE (the server's guard) instead of
        # a live batch; the request's deadline keeps a wedged (not dead)
        # server from holding the puller past the rpc budget
        try:
          out = dist_client.request_server(
              rank, 'fetch_one_sampled_message', self.worker_key,
              self._epoch_active,
              _rpc_timeout=self.options.rpc_timeout)
        except (ConnectionError, OSError) as e:
          # retries and the breaker have run their course: the server is
          # gone. Finish the epoch without it, or raise, by policy
          if not self.options.degrade_on_server_failure:
            raise
          if rank not in self.degraded_servers:
            self.degraded_servers.add(rank)
            dist_client.record_server_dropout(rank)
            logging.getLogger(__name__).warning(
                'server %d lost mid-epoch (%s); continuing with %d '
                'surviving server(s)', rank, e,
                len(self.server_ranks) - len(self.degraded_servers))
          raise StopIteration
        if out in (b'#EPOCH_END', b'#STALE'):
          raise StopIteration
        return unpack_message(out)
      return fetch

    self.channel = RemoteReceivingChannel(
        [make_fetcher(r) for r in ranks],
        prefetch_size=self.options.prefetch_size)

  def __iter__(self):
    from . import dist_client
    # in this order: stop the old pullers, then advance the epoch and
    # re-arm the servers, then the channel, so a stale fetch in flight
    # can only see old-epoch data or #STALE
    self.channel.stop()
    epoch = self._epoch
    self._epoch += 1
    self._epoch_active = epoch
    for rank in self.server_ranks:
      try:
        dist_client.request_server(rank, 'start_new_epoch_sampling',
                                   self.worker_key, epoch)
      except (ConnectionError, OSError):
        # a server that died between epochs: its fetcher sees the same
        # failure and degrades; a recovered one re-arms next epoch
        if not self.options.degrade_on_server_failure:
          raise
        if rank not in self.degraded_servers:
          self.degraded_servers.add(rank)
          dist_client.record_server_dropout(rank)
    self.channel.reset()
    while True:
      try:
        msg = self.channel.recv(
            timeout_ms=int(self.options.rpc_timeout * 1000))
      except StopIteration:
        return
      yield message_to_batch(msg, self.config, self.device)

  def stop(self) -> None:
    """Stops the pullers of the current epoch (an abandoned epoch's
    fetches end; the servers keep their workers until they exit)."""
    self.channel.stop()
