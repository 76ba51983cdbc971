"""Sampling producers: worker processes streaming sampled batches
(counterpart of glt_tpu/distributed/dist_sampling_producer.py; the
reference's DistMpSamplingProducer:206-294 spawns workers running
_sampling_worker_loop:54-163, commands over a task queue and batches over
the shm channel; DistCollocatedSamplingProducer:297-365 samples in
process).

A worker samples on the card (``device``, the card by default), as GLT's
workers do; the JAX package's sample on the host CPU, its TPU belonging
to the trainer. Its ``NeighborSampler`` runs the walk (K1) for positive
uniform fanouts, the feature rows come from ``gather_features`` (K3; K3
mixed over a split store), and each message's tensors are copied to the
host once and sent as one packed SampleMessage. Seed orders and the
sampler's seed come from the JAX package's streams:
``default_rng(epoch * num_workers + rank)`` and ``(config.seed or 0) +
rank``. Workers start with ``spawn`` (a forked child cannot use CUDA).
The epoch protocol: one ``#END`` message per worker closes an epoch, and
every message carries its epoch.
"""
from __future__ import annotations

import logging
import multiprocessing as mp
from typing import Callable, List, Optional

import numpy as np
import torch

from ..channel import ChannelBase, SampleMessage
from ..data.feature import gather_features
from ..sampler.base import SamplingConfig
from ..utils import as_numpy

_SAMPLE_ALL = 'SAMPLE_ALL'
_EXIT = 'EXIT'
END_KEY = '#END'
EPOCH_KEY = '#epoch'
MP_STATUS_CHECK_INTERVAL = 5.0  # reference dist_sampling_producer.py:41-44


def flatten_sampler_output(out, y=None, x=None,
                           edge_attr=None) -> SampleMessage:
  """A SamplerOutput (and the batch's labels, node and edge feature rows)
  as a flat SampleMessage of host tensors, each copied from its device
  once (the reference's _colloate_fn keys,
  dist_neighbor_sampler.py:689-807, with the ``efeats`` collate)."""
  def host(t):
    return t.detach().cpu() if isinstance(t, torch.Tensor) else \
        torch.as_tensor(np.asarray(t))
  msg = {
      'node': host(out.node),
      'node_count': host(out.node_count).reshape(1),
      'row': host(out.row),
      'col': host(out.col),
      'edge_mask': host(out.edge_mask),
      'batch': host(out.batch),
      'num_sampled_nodes': host(out.num_sampled_nodes),
      'num_sampled_edges': host(out.num_sampled_edges),
  }
  if out.edge is not None:
    msg['eids'] = host(out.edge)
  if y is not None:
    msg['nlabels'] = host(y)
  if x is not None:
    msg['nfeats'] = host(x)
  if edge_attr is not None:
    msg['efeats'] = host(edge_attr)
  return msg


def _sampling_worker_loop(rank: int, num_workers: int,
                          dataset_builder: Callable,
                          config: SamplingConfig, seeds: np.ndarray,
                          task_queue, channel: ChannelBase,
                          device: Optional[str] = None) -> None:
  """Reference _sampling_worker_loop (dist_sampling_producer.py:54-163):
  builds the dataset and the sampler on ``device``, then serves each
  epoch its command names."""
  from ..ops.pipeline import edge_hop_offsets
  from ..sampler import NeighborSampler

  ds = dataset_builder()
  if ds.is_hetero:
    raise NotImplementedError('sampling workers serve homogeneous graphs')
  sampler = NeighborSampler(
      ds.get_graph(), config.num_neighbors, device=device,
      with_edge=config.with_edge, with_weight=config.with_weight,
      edge_dir=config.edge_dir, seed=(config.seed or 0) + rank)
  # fanout -1 resolves here to a static window: the offsets travel with
  # every message so the consumer's Batch slices line up
  hop_offs = torch.tensor(edge_hop_offsets(config.batch_size,
                                           sampler.num_neighbors),
                          dtype=torch.int32)
  labels = ds.node_labels
  feats = ds.get_node_feature() if config.collect_features else None
  efeats = (ds.get_edge_feature()
            if config.with_edge and config.collect_features else None)

  parent = mp.parent_process()
  while True:
    try:
      cmd = task_queue.get(timeout=MP_STATUS_CHECK_INTERVAL)
    except Exception:
      if parent is not None and not parent.is_alive():
        break   # the producer's process died: nobody will send EXIT
      continue
    if cmd[0] == _EXIT:
      break
    epoch = cmd[1]
    order = np.arange(seeds.shape[0])
    if config.shuffle:
      order = np.random.default_rng(epoch * num_workers + rank) \
          .permutation(seeds.shape[0])
    bs = config.batch_size
    n = order.shape[0]
    for lo in range(0, n, bs):
      sel = order[lo:lo + bs]
      if sel.shape[0] < bs:
        if config.drop_last:
          break
        pad = np.full(bs - sel.shape[0], sel[-1] if sel.size else 0,
                      sel.dtype)
        sel = np.concatenate([sel, pad])
      batch_seeds = seeds[sel]
      n_valid = min(bs, n - lo)
      out = sampler.sample_from_nodes(batch_seeds, n_valid=n_valid)
      y = (torch.as_tensor(labels[batch_seeds]) if labels is not None
           else None)
      x = (gather_features(feats, out.node.clamp(min=0))
           if feats is not None else None)
      ea = (gather_features(efeats, out.edge.clamp(min=0))
            if efeats is not None and out.edge is not None else None)
      msg = flatten_sampler_output(out, y=y, x=x, edge_attr=ea)
      msg['n_valid'] = torch.tensor([n_valid], dtype=torch.int32)
      msg['#hop_offsets'] = hop_offs
      # every message carries its epoch, so a consumer can drop leftovers
      # of a partly consumed, abandoned epoch
      msg[EPOCH_KEY] = torch.tensor([epoch], dtype=torch.int32)
      channel.send(msg)
    channel.send({END_KEY: torch.tensor([rank], dtype=torch.int32),
                  EPOCH_KEY: torch.tensor([epoch], dtype=torch.int32)})


class DistMpSamplingProducer:
  """A pool of spawned sampling workers (reference :206-294), each
  sampling its slice of ``seeds`` on ``device`` (None: the card)."""

  def __init__(self, dataset_builder: Callable, config: SamplingConfig,
               seeds, channel: ChannelBase, num_workers: int = 1,
               device=None):
    self.dataset_builder = dataset_builder
    self.config = config
    self.seeds = as_numpy(seeds).astype(np.int64)
    self.channel = channel
    self.num_workers = int(num_workers)
    self.device = None if device is None else str(device)
    self._ctx = mp.get_context('spawn')
    self._task_queues = []
    self._workers: List[mp.Process] = []
    self._respawns: dict = {}
    self.max_respawns_per_rank = 3

  def _spawn(self, rank: int):
    splits = np.array_split(self.seeds, self.num_workers)
    tq = self._ctx.Queue()
    w = self._ctx.Process(
        target=_sampling_worker_loop,
        args=(rank, self.num_workers, self.dataset_builder, self.config,
              splits[rank], tq, self.channel, self.device),
        daemon=True)
    w.start()
    return tq, w

  def init(self) -> None:
    for rank in range(self.num_workers):
      tq, w = self._spawn(rank)
      self._task_queues.append(tq)
      self._workers.append(w)

  def respawn_dead(self) -> int:
    """Relaunches every worker that died, with its own seed slice, so the
    next epoch is complete again; returns how many. A death mid-epoch
    still surfaces as that epoch's recv timeout: the epoch is where a
    re-armed worker cannot duplicate batches. Each respawn is logged with
    the dead worker's exit code, and a rank respawned more than
    ``max_respawns_per_rank`` times raises instead."""
    n = 0
    for rank, w in enumerate(self._workers):
      if not w.is_alive():
        self._respawns[rank] = self._respawns.get(rank, 0) + 1
        logging.getLogger(__name__).warning(
            'sampling worker %d died (exitcode=%s); respawning '
            '(%d/%d)', rank, w.exitcode, self._respawns[rank],
            self.max_respawns_per_rank)
        if self._respawns[rank] > self.max_respawns_per_rank:
          raise RuntimeError(
              f'sampling worker {rank} crash-looped '
              f'{self._respawns[rank]} times (last exitcode '
              f'{w.exitcode}); check the dataset_builder in the '
              'subprocess')
        tq, w2 = self._spawn(rank)
        self._task_queues[rank] = tq
        self._workers[rank] = w2
        n += 1
    return n

  def produce_all(self, epoch: int = 0) -> None:
    self.respawn_dead()
    for tq in self._task_queues:
      tq.put((_SAMPLE_ALL, epoch))

  def shutdown(self) -> None:
    """Asks every worker to exit, joins each for up to 10 s and kills
    the ones still running."""
    for tq in self._task_queues:
      try:
        tq.put((_EXIT,))
      except Exception:
        pass
    for w in self._workers:
      w.join(timeout=10)
      if w.is_alive():
        w.terminate()
        w.join(timeout=10)
    self._workers = []

  @property
  def num_expected_ends(self) -> int:
    return self.num_workers


class DistCollocatedSamplingProducer:
  """The in-process producer (reference :297-365)."""

  def __init__(self, dataset, config: SamplingConfig, seeds, device=None):
    from ..sampler import NeighborSampler
    self.config = config
    self.seeds = as_numpy(seeds).astype(np.int64)
    self.sampler = NeighborSampler(
        dataset.get_graph(), config.num_neighbors, device=device,
        with_edge=config.with_edge, with_weight=config.with_weight,
        edge_dir=config.edge_dir, seed=config.seed)
    self.dataset = dataset

  def sample_batch(self, batch_seeds: np.ndarray, n_valid: int):
    out = self.sampler.sample_from_nodes(batch_seeds, n_valid=n_valid)
    labels = self.dataset.node_labels
    y = (torch.as_tensor(labels[batch_seeds], device=out.node.device)
         if labels is not None else None)
    return out, y
