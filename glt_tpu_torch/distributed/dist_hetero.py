"""Partitioned hetero stores, sampler and trainer: the IGBH deployment of
examples/igbh/dist_train_rgnn.py (counterpart of
glt_tpu/distributed/dist_hetero.py).

Each rank holds its partition of every edge type (:class:`DistHeteroGraph`:
one :class:`~glt_tpu_torch.distributed.dist_graph.DistGraph` block an edge
type, rows in the row type's id space, columns in the column type's, with
its edge weights when every partition has them), and
:class:`DistHeteroNeighborSampler` walks from a seed type with the
partitioned one-hop of every edge type (on each owner the ``sample_hop``
kernel, B2, for a uniform hop; B3's weight window, a Gumbel top-k and B2
for a weighted one; B3's windows for a ``-1`` hop) and one dedup a node
type a hop (``ops.pipeline.multihop_sample_hetero_sorted``), optionally
with each sampled edge's id. :class:`DistHeteroTrainStep` adds each type's
features through its :class:`~glt_tpu_torch.distributed.DistFeature` (K3
on each owner), the sampled edges' features when given edge stores, the
RGNN's masked cross-entropy, the gradients' mean over the mesh and Adam;
per batch, or a window of K batches as one CUDA graph on a card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..loader.transform import HeteroBatch
from ..ops.pipeline import multihop_sample_hetero_sorted
from ..ops.superstep import superstep_hetero
from ..parallel.dist_feature import require_device_resident
from ..parallel.mesh import Mesh
from ..parallel.train import CapturedWindows, mesh_update
from ..partition import load_meta, load_partition_graph
from ..typing import EdgeType, NodeType, reverse_edge_type
from ..utils import RandomSeedManager, as_numpy, make_generator
from ..utils.rng import seeded_state_dict
from .dist_graph import (_check_layout, _oriented, build_store, rank_entry,
                         store_tensors)
from .dist_neighbor_sampler import (check_fanouts, draw_hop_uniforms,
                                    hop_uniform_shape, make_dist_one_hop,
                                    own_block)


class DistHeteroGraph:
  """This rank's block of every edge type of a partitioned hetero graph.

  Args:
    mesh: the rank's mesh, one rank a partition.
    node_counts: global node count per type.
    parts_per_etype: per edge type, per partition (a sequence or a dict
      holding at least this rank's) GraphPartitionData already oriented
      (row, col): row the type sampling expands from.
    node_pbs: node partition book per type; an edge type's store routes by
      its row type's.
    edge_dir: ``'out'`` (rows are sources) or ``'in'`` (destinations).
  """

  def __init__(self, mesh: Mesh, node_counts: Dict[NodeType, int],
               parts_per_etype: Dict[EdgeType, Sequence], node_pbs,
               edge_dir: str = 'out'):
    self.mesh = mesh
    self.edge_dir = edge_dir
    self.node_counts = {t: int(n) for t, n in node_counts.items()}
    self.num_partitions = mesh.world
    self.graphs = {}
    for etype, parts in parts_per_etype.items():
      row_t, col_t = _row_col(etype, edge_dir)
      self.graphs[etype] = build_store(
          mesh, rank_entry(parts, mesh, f'parts of {etype}'),
          node_pbs[row_t], self.node_counts[row_t], self.node_counts[col_t])

  @classmethod
  def from_dataset_partitions(cls, mesh: Mesh, root_dir: str,
                              edge_dir: str = 'out') -> 'DistHeteroGraph':
    """This rank's blocks of a hetero partition layout on disk (a rank
    reads only its own partition's edges). Sampling routes by the
    expand-from type's book, so the edges must have been assigned by that
    endpoint (``edge_assign`` of the layout)."""
    _check_layout(load_meta(root_dir), mesh, edge_dir, 'hetero')
    _, graphs, node_pbs, _ = load_partition_graph(root_dir, mesh.rank)
    parts = {e: {mesh.rank: _oriented(g, edge_dir)}
             for e, g in graphs.items()}
    return cls(mesh, {t: pb.table.shape[0] for t, pb in node_pbs.items()},
               parts, node_pbs, edge_dir=edge_dir)


def dist_hetero_graph_from_partitions_multihost(
    mesh: Mesh, root_dir: str, edge_dir: str = 'out') -> DistHeteroGraph:
  """This rank's DistHeteroGraph under a multi-process group (glt_tpu/
  distributed/dist_hetero.py:156): the rank loads only its own partition
  and the ranks agree on each edge type's padding in
  :meth:`DistHeteroGraph.from_dataset_partitions`."""
  meta = load_meta(root_dir)
  if meta['data_cls'] != 'hetero':
    raise ValueError(f"a {meta['data_cls']} partition layout, expected "
                     'hetero')
  need = 'by_src' if edge_dir == 'out' else 'by_dst'
  got = meta.get('edge_assign', 'by_src')
  if got != need:
    raise ValueError(
        f'partition was edge-assigned {got!r} but edge_dir='
        f'{edge_dir!r} sampling requires {need!r}')
  if meta['num_parts'] != mesh.world:
    raise ValueError(
        f"mesh has {mesh.world} devices but the partition dir holds "
        f"{meta['num_parts']} partitions — they must match")
  return DistHeteroGraph.from_dataset_partitions(mesh, root_dir, edge_dir)


def _row_col(etype: EdgeType, edge_dir: str) -> Tuple[NodeType, NodeType]:
  src_t, _, dst_t = etype
  return (src_t, dst_t) if edge_dir == 'out' else (dst_t, src_t)


class DistHeteroNeighborSampler:
  """Hetero sampling over a :class:`DistHeteroGraph`, a seed block of one
  type a rank (dist_hetero.py:255).

  Args:
    graph: this rank's blocks.
    num_neighbors: per-hop fanouts, one list for every edge type or a dict
      of them keyed by edge type (0 skips the type at that hop, -1 takes
      every neighbour inside a window of ``full_neighbor_cap`` or the edge
      type's ``max_degree``).
    with_edge: also return each edge type's sampled edge ids (``edge``).
    with_weight: weight-proportional positive hops, when every edge type
      keeps weights (uniform otherwise, as in JAX).
    max_weighted_degree: a weighted hop's window (default: each edge
      type's ``max_degree``; never below the hop's fanout).
    seed: seed of the rank's generator (``seed + rank``; default the
      process-wide seed), which draws the uniforms a call is given none.
    full_neighbor_cap: the window of a ``-1`` hop.
  """

  def __init__(self, graph: DistHeteroGraph, num_neighbors,
               with_edge: bool = False, with_weight: bool = False,
               max_weighted_degree: Optional[int] = None,
               seed: Optional[int] = None,
               full_neighbor_cap: Optional[int] = None):
    self.g = graph
    self.mesh = graph.mesh
    self.edge_types = list(graph.graphs)
    self.with_edge = bool(with_edge)
    self.with_weight = bool(with_weight) and all(
        st.edge_weights is not None for st in graph.graphs.values())
    #: per edge type a weighted hop's window
    self.weight_windows = {
        e: int(max_weighted_degree or st.max_degree)
        for e, st in graph.graphs.items()}
    if not isinstance(num_neighbors, dict):
      num_neighbors = {e: num_neighbors for e in self.edge_types}
    self.num_neighbors = {
        e: check_fanouts(v, full_neighbor_cap, graph.graphs[e].max_degree)
        for e, v in num_neighbors.items()}
    hops = {len(v) for v in self.num_neighbors.values()}
    if len(hops) != 1:
      raise ValueError('every edge type needs the same number of hops')
    self.num_hops = hops.pop()
    base = (seed if seed is not None
            else RandomSeedManager.getInstance().getSeed())
    self.generator = make_generator(base + self.mesh.rank, self.mesh.device)
    self._one_hops = {
        e: make_dist_one_hop(
            store_tensors(st, with_edge=self.with_edge,
                          with_weight=self.with_weight),
            st.num_nodes, st.num_partitions, st.max_rows, self.mesh,
            with_weight=self.with_weight,
            max_weighted_degree=self.weight_windows[e])
        for e, st in graph.graphs.items()}

  def _trav(self) -> Dict[EdgeType, Tuple[NodeType, NodeType]]:
    return {e: _row_col(e, self.g.edge_dir) for e in self.edge_types}

  def _caps(self, batch_size: int, seed_type: NodeType):
    """Per hop and type the frontier capacity, and per type the node
    budget (dist_hetero.py:322)."""
    trav = self._trav()
    types = list(self.g.node_counts)
    caps = [{t: (batch_size if t == seed_type else 0) for t in types}]
    for h in range(self.num_hops):
      nxt = {t: 0 for t in types}
      for etype, (row_t, col_t) in trav.items():
        nxt[col_t] += caps[h][row_t] * abs(self.num_neighbors[etype][h])
      caps.append(nxt)
    budgets = {t: max(1, sum(c[t] for c in caps)) for t in types}
    return caps, budgets

  def _make_device_core(self, batch_size: int, seed_type: NodeType):
    """``(core, caps, budgets, etypes)``: ``core(seeds [B], n_valid,
    u_hops)`` runs this rank's walk (a collective) and returns the
    result dict in traversal orientation, ``batch`` and ``seed_labels``
    the seed type's; ``etypes`` the edge types that ever have a frontier
    (the rest sample nothing and are left out)."""
    trav = self._trav()
    caps, budgets = self._caps(batch_size, seed_type)
    etypes = [e for e in self.edge_types
              if any(caps[h][trav[e][0]] * abs(self.num_neighbors[e][h]) > 0
                     for h in range(self.num_hops))]
    active = {e: trav[e] for e in etypes}

    def core(seeds, n_valid, u_hops):
      out = multihop_sample_hetero_sorted(
          self._one_hops, active, self.num_neighbors, self.num_hops, caps,
          budgets, {seed_type: seeds}, {seed_type: n_valid}, u_hops,
          with_edge=self.with_edge)
      out['batch'] = out['batch'][seed_type]
      out['seed_labels'] = out['seed_labels'][seed_type]
      return out

    return core, caps, budgets, etypes

  def message_passing_types(self, batch_size: int, seed_type: NodeType
                            ) -> List[EdgeType]:
    """The keys a batch from ``seed_type`` carries: the reversed edge
    types that sample at some hop. An RGNN over a batch has a relation
    for each and a ``self_<type>`` layer for every type none of them
    reaches, as the flax model creates them for the batch it sees."""
    return [self.final_key(e)
            for e in self._make_device_core(batch_size, seed_type)[3]]

  def uniform_shapes(self, batch_size: int, seed_type: NodeType
                     ) -> List[List[Optional[Tuple[int, int]]]]:
    """Per hop, per segment (the active edge types whose row type has a
    frontier and whose fanout is not 0, in order), the draw a rank serves
    with: ``[world * F, fanout]``, ``[world * F, W]`` for a weighted hop
    (W its window), None for a full hop."""
    caps, _ = self._caps(batch_size, seed_type)
    trav = self._trav()
    shapes = []
    for h in range(self.num_hops):
      hop = []
      for e, (row_t, _) in trav.items():
        k = self.num_neighbors[e][h]
        if caps[h][row_t] and k:
          hop.append(hop_uniform_shape(
              self.mesh.world, caps[h][row_t], k,
              self.weight_windows[e] if self.with_weight else None))
      shapes.append(hop)
    return shapes

  def draw_uniforms(self, batch_size: int, seed_type: NodeType):
    """This rank's draws of one batch from its generator, per hop and
    segment (None for a full hop)."""
    return [[draw_hop_uniforms(self.generator, s, self.with_weight,
                               self.mesh.device) for s in hop]
            for hop in self.uniform_shapes(batch_size, seed_type)]

  def final_key(self, e: EdgeType) -> EdgeType:
    """The message-passing key of traversal edge type ``e``."""
    return reverse_edge_type(e) if self.g.edge_dir == 'out' else e

  def sample_from_nodes(self, seed_type: NodeType, seeds_per_device,
                        n_valid_per_device=None, uniforms=None) -> dict:
    """``seeds_per_device [world, B]`` (or shard-major ``[world * B]``)
    of ``seed_type`` and ``n_valid_per_device [world]``, the same on
    every rank; ``uniforms`` per hop and segment ``[world, *shape]``
    (rank r reads row r; :meth:`uniform_shapes`, None for a full hop) or
    None (drawn). Returns this rank's output in message-passing
    orientation (dist_hetero.py:474-485): ``row``/``col``/``edge_mask``/
    ``num_sampled_edges`` (and ``edge`` with ``with_edge``) keyed by the
    reversed edge types, ``row`` the child labels, plus ``input_type``."""
    mesh = self.mesh
    seeds = as_numpy(seeds_per_device).reshape(-1)
    b = seeds.shape[0] // mesh.world
    mine = torch.as_tensor(own_block(seeds, mesh, b).astype(np.int32),
                           device=mesh.device)
    n_valid = (b if n_valid_per_device is None
               else int(as_numpy(n_valid_per_device).reshape(-1)[mesh.rank]))
    if uniforms is None:
      u = self.draw_uniforms(b, seed_type)
    else:
      u = [[None if x is None else
            torch.as_tensor(x)[mesh.rank].to(mesh.device, torch.float32)
            for x in hop] for hop in uniforms]
    core = self._make_device_core(b, seed_type)[0]
    out = core(mine, n_valid, u)
    fk = self.final_key
    out['row'], out['col'] = ({fk(e): v for e, v in out['col'].items()},
                              {fk(e): v for e, v in out['row'].items()})
    for key in ('edge_mask', 'num_sampled_edges', 'edge'):
      if key in out:
        out[key] = {fk(e): v for e, v in out[key].items()}
    out['input_type'] = seed_type
    return out


class DistHeteroTrainStep(CapturedWindows):
  """Partitioned hetero training, the IGBH deployment (dist_hetero.py:487):
  each rank samples its seed block over the partitioned graph, reads every
  type's features through its DistFeature, runs the RGNN's masked
  cross-entropy, averages the gradients over the mesh and steps Adam.

  A batch a call (:meth:`__call__`), a window of T batches
  (:meth:`superstep`; on a card one CUDA graph, captured the first time a
  window length comes and replayed after) and forward-only accuracy
  (:meth:`eval_step`). Per-batch calls and windows share the optimizer
  (``capturable`` on a card).

  Args:
    graph: this rank's :class:`DistHeteroGraph`.
    features: per node type a DistFeature over the same mesh (every type
      of the graph).
    model: an RGNN over the message-passing keys, on the mesh's device;
      its parameters are broadcast from rank 0.
    labels: per type a label array (replicated); the seed type's is read.
    num_neighbors: as for :class:`DistHeteroNeighborSampler`.
    batch_size_per_device: seeds a rank a batch.
    seed_type: the node type of the seeds.
    lr: Adam's learning rate (optax ``adam`` defaults otherwise).
    seed: seed of the sampler's generators.
    edge_features: per *traversal* edge type an edge-id DistFeature; the
      sampler then emits edge ids and the batch carries ``edge_dict`` and
      ``edge_attr_dict`` (keyed by the message-passing keys) for the edge
      types that sample.
    with_weight / max_weighted_degree: weighted hops, as for
      :class:`DistHeteroNeighborSampler`.
  """

  def __init__(self, graph: DistHeteroGraph, features: Dict[NodeType, object],
               model: nn.Module, labels: Dict[NodeType, np.ndarray],
               num_neighbors, batch_size_per_device: int,
               seed_type: NodeType, lr: float = 1e-3, seed: int = 0,
               edge_features: Optional[Dict[EdgeType, object]] = None,
               with_weight: bool = False,
               max_weighted_degree: Optional[int] = None):
    for t, st in features.items():
      require_device_resident(st, f'DistHeteroTrainStep features[{t!r}]')
    edge_features = dict(edge_features or {})
    for e, st in edge_features.items():
      require_device_resident(st, f'DistHeteroTrainStep edge_features[{e!r}]')
    unknown = set(edge_features) - set(graph.graphs)
    if unknown:
      raise ValueError(f'edge_features keys {sorted(map(str, unknown))} are '
                       'not traversal edge types (pass the traversal type, '
                       'not the reversed key)')
    mesh = graph.mesh
    dev = mesh.device
    if next(model.parameters()).device != dev:
      raise ValueError(f'the model is not on the mesh\'s device {dev}')
    missing = set(graph.node_counts) - set(features)
    if missing:
      raise ValueError(f'no features for node types {sorted(missing)}')
    self.g, self.mesh, self.features, self.model = graph, mesh, features, model
    self.seed_type = seed_type
    self.bs = int(batch_size_per_device)
    self.sampler = DistHeteroNeighborSampler(
        graph, num_neighbors, with_edge=bool(edge_features),
        with_weight=with_weight, max_weighted_degree=max_weighted_degree,
        seed=seed)
    self.labels = {t: torch.as_tensor(as_numpy(v)).to(dev)
                   for t, v in labels.items()}
    (self._core, self._caps, self._budgets,
     self._etypes) = self.sampler._make_device_core(self.bs, seed_type)
    # an edge type no frontier reaches samples no edges
    self.edge_features = {e: st for e, st in edge_features.items()
                          if e in self._etypes}
    if mesh.world > 1:
      for p in model.parameters():
        dist.broadcast(p.data, 0, group=mesh.group)
    self.optimizer = torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=dev.type == 'cuda')
    self._init_windows(dev)

  def dummy_batch(self) -> HeteroBatch:
    """A batch of zeros with the step's shapes (dist_hetero.py:544)."""
    dev = self.mesh.device
    trav = self.sampler._trav()
    zeros = lambda n, dt: torch.zeros(n, dtype=dt, device=dev)
    ecaps = {e: max(1, sum(self._caps[h][trav[e][0]]
                           * abs(self.sampler.num_neighbors[e][h])
                           for h in range(self.sampler.num_hops)))
             for e in self._etypes}
    fk = self.sampler.final_key
    keys = {fk(e): ecaps[e] for e in self._etypes}
    return HeteroBatch(
        x_dict={t: torch.zeros((self._budgets[t], f.feature_dim),
                               dtype=f.dtype, device=dev)
                for t, f in self.features.items()},
        row_dict={k: zeros(n, torch.int32) for k, n in keys.items()},
        col_dict={k: zeros(n, torch.int32) for k, n in keys.items()},
        edge_mask_dict={k: zeros(n, torch.bool) for k, n in keys.items()},
        node_dict={t: zeros(self._budgets[t], torch.int32)
                   for t in self.features},
        node_count_dict={t: zeros((), torch.int32) for t in self.features},
        y_dict={self.seed_type: zeros(self.bs, torch.int32)},
        edge_dict=({k: zeros(n, torch.int32) for k, n in keys.items()}
                   if self.sampler.with_edge else None),
        edge_attr_dict=({fk(e): torch.zeros((ecaps[e], f.feature_dim),
                                            dtype=f.dtype, device=dev)
                         for e, f in self.edge_features.items()}
                        or None),
        input_type=self.seed_type, batch_size=self.bs,
        metadata={'n_valid': zeros((), torch.int32)})

  def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
    """Install weights drawn from ``seed`` (the same on every rank) and
    return them."""
    state = seeded_state_dict(self.model, seed)
    self.model.load_state_dict(state)
    return state

  # -- the batch body ----------------------------------------------------

  def make_batch(self, seeds: torch.Tensor, n_valid: torch.Tensor, u_hops,
                 static_rounds: bool = False) -> HeteroBatch:
    """This rank's batch (dist_hetero.py:583-695): the walk from
    ``seeds [B]`` (``n_valid`` a 0-dim tensor, ``u_hops`` this rank's
    draws per hop and segment), every type's features through its
    exchange, the sampled edges' ids and features given edge stores, the
    seed labels, the reversed keys."""
    dev = self.mesh.device
    out = self._core(seeds, n_valid, u_hops)
    x_dict = {}
    for t, node in out['node'].items():
      valid = torch.arange(node.numel(), device=dev) < out['node_count'][t]
      x_dict[t] = self.features[t].lookup_local(
          node.clamp(min=0), valid, static_rounds=static_rounds)
    y = self.labels[self.seed_type].index_select(
        0, out['batch'].clamp(min=0).long())
    fk = self.sampler.final_key
    edge_attr = {fk(e): f.lookup_local(
        out['edge'][e].clamp(min=0), out['edge_mask'][e],
        static_rounds=static_rounds)
        for e, f in self.edge_features.items()}
    return HeteroBatch(
        x_dict=x_dict,
        row_dict={fk(e): out['col'][e] for e in self._etypes},
        col_dict={fk(e): out['row'][e] for e in self._etypes},
        edge_mask_dict={fk(e): out['edge_mask'][e] for e in self._etypes},
        edge_dict=({fk(e): out['edge'][e] for e in self._etypes}
                   if 'edge' in out else None),
        edge_attr_dict=edge_attr or None,
        node_dict=out['node'], node_count_dict=out['node_count'],
        y_dict={self.seed_type: y}, input_type=self.seed_type,
        batch_size=self.bs, metadata={'n_valid': n_valid})

  def _update(self, batch: HeteroBatch) -> torch.Tensor:
    return mesh_update(self.model, self.optimizer, self.mesh, batch)

  def _own(self, seeds_stack, n_valid_stack, uniforms):
    """This rank's column of a window: seeds ``[T, B]`` and valid counts
    ``[T]`` int32 on its device, and per hop and segment uniforms ``[T,
    *shape]`` (the given ``[T, world, ...]`` at this rank, else drawn batch
    by batch from the generator; None for a full hop)."""
    dev, r, bs = self.mesh.device, self.mesh.rank, self.bs
    seeds = torch.as_tensor(as_numpy(seeds_stack)).reshape(
        len(seeds_stack), -1)[:, r * bs:(r + 1) * bs]
    n_valid = torch.as_tensor(as_numpy(n_valid_stack))[:, r]
    seeds = seeds.to(dev, torch.int32).contiguous()
    n_valid = n_valid.to(dev, torch.int32).contiguous()
    if uniforms is None:
      draws = [self.sampler.draw_uniforms(bs, self.seed_type)
               for _ in range(seeds.shape[0])]
      u = [[None if draws[0][h][i] is None
            else torch.stack([d[h][i] for d in draws])
            for i in range(len(draws[0][h]))]
           for h in range(len(draws[0]))]
    else:
      u = [[None if x is None else
            torch.as_tensor(x)[:, r].to(dev, torch.float32).contiguous()
            for x in hop] for hop in uniforms]
    return seeds, n_valid, u

  def _one(self, seeds, n_valid_per_device, uniforms):
    """A batch's own inputs (``[0]`` of a window of one)."""
    u = None if uniforms is None else [
        [None if x is None else torch.as_tensor(x)[None] for x in hop]
        for hop in uniforms]
    seeds, n_valid, u = self._own(as_numpy(seeds).reshape(1, -1),
                                  as_numpy(n_valid_per_device)[None], u)
    return seeds[0], n_valid[0], [[None if x is None else x[0] for x in hop]
                                  for hop in u]

  def __call__(self, seeds, n_valid_per_device, uniforms=None
               ) -> torch.Tensor:
    """One batch: ``seeds [world, B]`` (or ``[world * B]``),
    ``n_valid_per_device [world]``, ``uniforms`` per hop and segment
    ``[world, world * F, fanout]`` or None (drawn). Returns the mesh's
    mean loss, a 0-dim tensor."""
    return self._update(self.make_batch(*self._one(seeds, n_valid_per_device,
                                                   uniforms)))

  def superstep(self, seeds_stack, n_valid_stack, uniforms=None
                ) -> torch.Tensor:
    """T batches as one window (dist_hetero.py:748-851): ``seeds_stack
    [T, world * B]``, ``n_valid_stack [T, world]``, ``uniforms`` per hop
    and segment ``[T, world, world * F, fanout]`` or None. Equal to T
    per-batch calls on the same inputs. Returns the mesh's mean losses
    ``[T]``."""
    seeds, n_valid, u = self._own(seeds_stack, n_valid_stack, uniforms)
    w = self._window(('fused', seeds.shape[0]),
                     dict(seeds=seeds, n_valid=n_valid, u=u))
    run = superstep_hetero(lambda state, s, nv, uh: (state, self._update(
        self.make_batch(s, nv, uh, static_rounds=True))))
    return self._run(w, lambda: run(None, w.inputs['seeds'],
                                    w.inputs['n_valid'], w.inputs['u'])[1])

  def eval_step(self, seeds, n_valid_per_device, uniforms=None
                ) -> Tuple[int, int]:
    """Forward-only accuracy of one batch (dist_hetero.py:866-922): the
    correct predictions and the valid seeds, summed over the mesh."""
    seeds, n_valid, u = self._one(seeds, n_valid_per_device, uniforms)
    with torch.no_grad():
      batch = self.make_batch(seeds, n_valid, u)
      logits = self.model(batch)
      mask = torch.arange(self.bs, device=logits.device) < n_valid
      hit = (logits.argmax(-1) == batch.y_dict[self.seed_type].long()) & mask
      counts = torch.stack([hit.sum(), mask.sum()])
      if self.mesh.world > 1:
        dist.all_reduce(counts, group=self.mesh.group)
    correct, total = counts.tolist()
    return int(correct), int(total)
