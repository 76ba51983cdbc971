"""Bucketed online inference engine: k-hop sample -> feature gather ->
model forward (counterpart of glt_tpu/serving/engine.py).

A request for ``n`` embeddings runs in the smallest bucket ``B >= n``,
padded, so every bucket's walk, gather and forward see fixed shapes.
Results flow through the LRU :class:`EmbeddingCache` keyed
``(node_id, model_version)``: cached ids skip the pipeline and partial
hits shrink the computed batch to the missing unique ids.

A hetero graph (a dict of graphs keyed by edge type) is served the same
way: requests address one seed type (``input_type``), the sampler walks
every edge type, features are gathered per node type and the model reads
a :class:`~glt_tpu_torch.loader.HeteroBatch`.

Live-update serving plugs a :class:`~glt_tpu_torch.stream.StreamSampler`
in through ``sampler=``; ``update_snapshot`` then swaps the features of a
new stream snapshot in and drops the cache entries it staled.

``infer`` takes an internal lock, as the JAX engine does; put the
:class:`~glt_tpu_torch.serving.MicroBatcher` in front of it for
cross-request batching. The stages are spans of the process
:class:`~glt_tpu_torch.obs.Tracer` named as the JAX engine's
(``serve.bucket`` around ``sample.multihop``, ``gather.features`` and
``serve.forward``), which carry the request's trace id while tracing is
on; off, they stay ``torch.profiler`` ranges of those names, so a
profile of serving splits its device time by stage either way.

The port compiles nothing, so where the JAX engine counts traces
(``compile_stats``) this one counts its runs: ``forward_calls`` and
``bucket_runs`` (:meth:`run_stats`).
"""
from __future__ import annotations

import threading
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..data import Dataset
from ..data.feature import gather_features
from ..loader.transform import Batch, HeteroBatch, to_batch, to_hetero_batch
from ..obs import get_tracer
from ..sampler import NeighborSampler
from ..sampler.base import NodeSamplerInput
from ..utils import as_numpy, resolve_device
from ..utils.rng import seeded_state_dict
from .embedding_cache import EmbeddingCache


def _stage(tracer, name: str, **args):
  """A tracer span while tracing is on (it opens the profiler range
  itself), else the bare profiler range."""
  if tracer.enabled:
    return tracer.span(name, **args)
  return record_function(name)


class InferenceEngine:
  """Online embedding/logit server over a GNN.

  Args:
    data: Dataset (graph + node features on ``device``).
    model: ``nn.Module`` whose ``model(batch)`` returns ``[batch_size, D]``
      for the seed rows (GraphSAGE / RGNN style); moved to ``device``.
    params: a state_dict to load, or None to keep the model's weights.
    num_neighbors: serving fanout per hop, e.g. ``[15, 10, 5]``; hetero:
      one list for every edge type or a dict keyed by EdgeType.
    buckets: padded seed-batch sizes, ascending. A request larger than
      the biggest bucket is served in chunks of it.
    cache: an EmbeddingCache, or None to build one of ``cache_capacity``
      entries (0 disables caching).
    model_version: version tag for cache keys; ``set_params`` bumps it.
    seed: the sampler's generator seed.
    device: where serving runs (default: the card; raises when there is
      none).
    input_type: the seed node type requests address; required for a
      hetero graph, whose requests are ids of that type.
    sampler: a pre-built sampler on ``device`` instead of the default
      NeighborSampler over ``data.graph``: how live-update serving plugs
      in a StreamSampler (see :meth:`update_snapshot`).
  """

  def __init__(self, data: Dataset, model: nn.Module,
               params: Optional[Mapping[str, torch.Tensor]],
               num_neighbors: Sequence[int],
               buckets: Sequence[int] = (8, 64, 256),
               cache: Optional[EmbeddingCache] = None,
               cache_capacity: int = 100_000, model_version: int = 0,
               seed: Optional[int] = 0, device=None, input_type=None,
               sampler=None):
    self.device = resolve_device(device)
    self.hetero = data.is_hetero
    if self.hetero and input_type is None:
      raise ValueError('hetero serving needs input_type (the seed node '
                       'type requests address)')
    self.input_type = input_type
    self.data = data
    self.model = model.to(self.device).eval()
    if params is not None:
      self.model.load_state_dict(params)
    self.buckets = tuple(sorted({int(b) for b in buckets}))
    if not self.buckets or self.buckets[0] <= 0:
      raise ValueError(f'buckets must be positive, got {buckets}')
    self.model_version = int(model_version)
    self.cache = cache if cache is not None \
        else EmbeddingCache(cache_capacity)
    if sampler is not None and sampler.device != self.device:
      raise ValueError(f'sampler runs on {sampler.device}, the engine on '
                       f'{self.device}')
    self.sampler = sampler if sampler is not None else NeighborSampler(
        data.graph, dict(num_neighbors) if isinstance(num_neighbors, dict)
        else list(num_neighbors), device=self.device,
        edge_dir=data.edge_dir, seed=seed)
    self.bucket_runs = {b: 0 for b in self.buckets}   # executed runs
    self._snapshot_version = 0
    self._out_dim: Optional[int] = None
    self._lock = threading.Lock()
    #: guards bucket_runs alone and is never held across device work, so
    #: a stats read neither tears nor waits on a request in flight
    self._stats_lock = threading.Lock()

  def warmup(self) -> None:
    """Run every bucket once on distinct dummy seeds (builds the kernels
    on first use), through ``np.unique`` as ``infer`` does: its first call
    imports ``numpy.ma``, tens of ms where Python has no bytecode cache.
    The cache is left as it was; ``forward_calls`` and ``bucket_runs``
    restart at 0."""
    n = self.num_nodes
    with self._lock:
      for b in self.buckets:
        seeds = np.unique(np.arange(b) % n)
        self._run_bucket(seeds, seeds.size, b)
      with self._stats_lock:
        self.bucket_runs = {b: 0 for b in self.buckets}

  def run_stats(self) -> dict:
    """Execution counters (the port's stand-in for the JAX engine's
    ``compile_stats``, which counts traces: the port traces nothing).
    Read under the counters' own lock, not the engine lock: ``infer``
    holds that across the device work, and a stats scrape must not hang
    on a wedged request."""
    with self._stats_lock:
      runs = dict(self.bucket_runs)
    return {'forward_calls': sum(runs.values()), 'bucket_runs': runs}

  @property
  def forward_calls(self) -> int:
    """Executed bucket runs since the warm-up (not cached answers)."""
    with self._stats_lock:
      return sum(self.bucket_runs.values())

  @property
  def output_dim(self) -> Optional[int]:
    return self._out_dim

  @property
  def num_nodes(self) -> int:
    """Id space of requests: the seed type's node count on a hetero
    graph."""
    if self.hetero:
      return self.data.node_count(self.input_type)
    return self.data.get_graph().num_nodes

  def validate_ids(self, ids: np.ndarray) -> None:
    """Reject out-of-range node ids: past the request boundary they
    would be clamped by the gather paths — a wrong-but-valid-looking
    embedding, cached under the bogus id."""
    if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
      bad = ids[(ids < 0) | (ids >= self.num_nodes)][:8]
      raise ValueError(
          f'node ids out of range [0, {self.num_nodes}): {bad.tolist()}')

  def bucket_for(self, n: int) -> int:
    for b in self.buckets:
      if n <= b:
        return b
    return self.buckets[-1]

  def make_batch(self, seeds: np.ndarray, n_valid: int, bucket: int,
                 uniforms=None) -> Union[Batch, HeteroBatch]:
    """Sample + gather a bucket-shaped Batch (hetero: a HeteroBatch,
    features gathered per node type that has a store) exactly as serving
    runs it; ``uniforms`` injects the walk's draws (see
    :meth:`NeighborSampler.sample_from_nodes`)."""
    tracer = get_tracer()
    if self.hetero:
      with _stage(tracer, 'sample.multihop'):
        out = self.sampler.sample_from_nodes(
            NodeSamplerInput(seeds, self.input_type), n_valid=n_valid,
            uniforms=uniforms)
      with _stage(tracer, 'gather.features'):
        x_dict = {t: gather_features(self.data.get_node_feature(t), n)
                  for t, n in out.node.items()
                  if self.data.get_node_feature(t) is not None}
      return to_hetero_batch(out, x_dict=x_dict, batch_size=bucket)
    with _stage(tracer, 'sample.multihop'):
      out = self.sampler.sample_from_nodes(seeds, n_valid=n_valid,
                                           uniforms=uniforms)
    with _stage(tracer, 'gather.features'):
      x = gather_features(self.data.get_node_feature(), out.node)
    return to_batch(out, x=x, batch_size=bucket)

  def init_params(self, seed: int) -> Mapping[str, torch.Tensor]:
    """Install weights drawn from ``seed`` (uniform in +-1/sqrt(fan_in),
    nn.Linear's default range, drawn on the CPU so a seed gives the same
    weights on every device) -- fresh or benchmark weights without a
    training loop."""
    state = seeded_state_dict(self.model, seed)
    with self._lock:
      self.model.load_state_dict(state)
    return state

  def _run_bucket(self, seeds: np.ndarray, n_valid: int,
                  bucket: int) -> np.ndarray:
    """One padded pipeline pass; returns rows [:n_valid]."""
    padded = seeds
    if padded.shape[0] < bucket:
      padded = np.concatenate(
          [padded, np.full(bucket - padded.shape[0],
                           padded[0] if padded.size else 0, padded.dtype)])
    tracer = get_tracer()
    # the bucket span parents the sample, gather and forward spans; the
    # copy to the host inside serve.forward waits for the card, so the
    # spans carry the stage's device time, not its enqueue
    with torch.no_grad(), tracer.span('serve.bucket', bucket=bucket,
                                      n_valid=int(n_valid)):
      batch = self.make_batch(padded, n_valid, bucket)
      with _stage(tracer, 'serve.forward', bucket=bucket):
        emb = self.model(batch)
        rows = emb[:n_valid].cpu().numpy()
    with self._stats_lock:
      self.bucket_runs[bucket] = self.bucket_runs.get(bucket, 0) + 1
    if self._out_dim is None:
      self._out_dim = int(rows.shape[1])
    return rows

  def infer(self, ids) -> np.ndarray:
    """Embeddings/logits for ``ids`` (duplicates allowed), aligned with
    the input order: cache hits served directly, the missing unique ids
    computed through the smallest fitting bucket (chunked by the largest
    bucket) and inserted back into the cache."""
    ids_np = as_numpy(ids).astype(np.int64).reshape(-1)
    if ids_np.size == 0:
      return np.zeros((0, self._out_dim or 0), np.float32)
    with self._lock:
      version = self.model_version
      local = self.cache.lookup(ids_np, version)
      missing = np.unique(ids_np[~np.isin(
          ids_np, np.fromiter(local, np.int64, len(local)))]) \
          if local else np.unique(ids_np)
      lo = 0
      while lo < missing.size:
        chunk = missing[lo:lo + self.buckets[-1]]
        lo += chunk.size
        rows = self._run_bucket(chunk, chunk.size,
                                self.bucket_for(chunk.size))
        self.cache.insert(chunk, rows, version)
        for i, row in zip(chunk, rows):
          local[int(i)] = row
      return np.stack([local[int(i)] for i in ids_np])

  def set_params(self, params: Mapping[str, torch.Tensor],
                 bump_version: bool = True) -> int:
    """Hot-swap model parameters; with ``bump_version`` the cache
    version advances so stale embeddings stop hitting."""
    with self._lock:
      self.model.load_state_dict(params)
      if bump_version:
        self.model_version += 1
      return self.model_version

  def stale_serve(self, ids):
    """Degradation tier: answer from the versioned EmbeddingCache ONLY
    (any live version, newest first), zero-filling true misses — never
    touches the sampler or the forward, and deliberately does NOT take
    the engine lock (the lock is what a wedged infer is sitting on).
    Returns ``(rows [n, D], cached_mask [n])`` so the caller can count
    stale serves vs zero-fills.

    Raises RuntimeError when the output width is unknown (the engine
    never completed a forward) — there is nothing to degrade to."""
    ids_np = as_numpy(ids).astype(np.int64).reshape(-1)
    found = self.cache.lookup_stale(ids_np)
    dim = self._out_dim
    if dim is None and found:
      dim = int(next(iter(found.values())).shape[0])
    if dim is None:
      raise RuntimeError(
          'stale_serve before any completed forward: output dim '
          'unknown and the cache is empty')
    out = np.zeros((ids_np.size, dim), np.float32)
    mask = np.zeros(ids_np.size, bool)
    for k, i in enumerate(ids_np.tolist()):
      row = found.get(int(i))
      if row is not None:
        out[k] = row
        mask[k] = True
    return out, mask

  # -- invalidation hooks --------------------------------------------------

  def invalidate(self, ids=None, version=None) -> int:
    """Cache invalidation serialized against in-flight infer (the engine
    lock): without it, invalidating ids an infer is computing would drop
    nothing and the stale rows would be inserted right after. Returns the
    number of entries dropped."""
    with self._lock:
      if ids is not None:
        ids = as_numpy(ids).reshape(-1).tolist()
      return self.cache.invalidate(ids, version)

  def invalidate_nodes(self, ids) -> int:
    """Feature/graph update hook: drop the cached embeddings of ``ids``
    across all versions."""
    return self.invalidate(ids=ids)

  @property
  def snapshot_version(self) -> int:
    """The stream-snapshot version this engine last swapped onto (0: the
    construction-time graph), read under the engine lock: it is never the
    version of a swap whose invalidation has not landed."""
    with self._lock:
      return self._snapshot_version

  def update_snapshot(self, snapshot, touched_ids=None,
                      expand_in_neighbors: bool = False,
                      version: Optional[int] = None) -> int:
    """Swap serving onto a new stream snapshot: under the engine lock,
    install the snapshot's Feature as the gather source, stamp its version
    and drop the cache entries of ``touched_ids`` (None: the whole cache;
    with ``expand_in_neighbors`` also their in-neighbours, the nodes whose
    embeddings aggregate over them). ``version`` defaults to one past the
    last. Returns the number of cache entries dropped."""
    if self.hetero:
      raise NotImplementedError('update_snapshot is homogeneous-only: the '
                                'stream machinery serves one node type')
    with self._lock:
      if snapshot.feature is not None:
        self.data.node_features = snapshot.feature
      self._snapshot_version = (int(version) if version is not None
                                else self._snapshot_version + 1)
      if touched_ids is None:
        return self.cache.invalidate()
      ids = as_numpy(touched_ids).astype(np.int64).reshape(-1)
      if expand_in_neighbors and ids.size:
        ids = snapshot.expand_affected(ids)
      ids = ids[(ids >= 0) & (ids < self.num_nodes)]
      if ids.size == 0:
        return 0
      return self.cache.invalidate(ids=ids.tolist())
