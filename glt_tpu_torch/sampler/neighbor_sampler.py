"""NeighborSampler: multi-hop sampling on the device (counterpart of
glt_tpu/sampler/neighbor_sampler.py).

Uniform positive fanouts run the walk: homogeneous
``ops.pipeline.multihop_sample``, hetero one ``sample_hop_dedup`` per hop
(``ops.pipeline.multihop_sample_hetero``). Weighted sampling and ``-1``
(full-neighbourhood) fanouts run the per-hop loop
(``ops.pipeline.multihop_sample_sorted``, hetero
``ops.pipeline.multihop_sample_hetero_sorted`` over one in-memory one-hop
an edge type), as the JAX sampler demotes them from its fused engine to
the ``pallas`` per-hop engine: a weighted hop reads its weight window
and a full hop its neighbour window through ``gather_windows``, a
uniform hop of a mixed list reads through ``sample_hop``, each with its
edge ids when asked and, for a uniform hop, with replacement when asked.
Link sampling (:meth:`NeighborSampler.sample_from_edges`) sends the
endpoints of the positive and the sampled negative edges through the same
loops as seeds, on a hetero graph both endpoint types of an edge type in
one walk; :meth:`NeighborSampler.subgraph` induces the subgraph of a
sampled neighbourhood (homogeneous graphs).

Orientation contract (the reference's): ``row`` holds message-source
(child) labels and ``col`` message-destination (parent) labels. With
``edge_dir='out'`` (CSR graphs) a hop expands src into dst and the hetero
output keys are the reversed traversal types (the 'rev_' convention);
with ``'in'`` (CSC graphs) it expands dst into src and the keys are the
traversal types themselves. The homogeneous loops read either layout's
``indptr`` and ``indices`` alike.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..data import Graph, hetero_node_counts
from ..ops.cuda_kernels import walk_table_slots
from ..ops.pipeline import (edge_hop_offsets, hetero_edge_hop_offsets,
                            multihop_sample, multihop_sample_hetero,
                            multihop_sample_hetero_sorted,
                            multihop_sample_sorted, sample_budget)
from ..ops.sample import (FusedHopPlan, HeteroFusedPlan, hetero_hop_uniforms,
                          neighbor_probs, sample_full_neighbors,
                          sample_neighbors, sample_neighbors_weighted,
                          walk_hop_uniforms, weighted_hop_uniforms)
from ..ops.subgraph import SubGraph, induced_subgraph
from ..typing import EdgeType, NodeType, reverse_edge_type
from ..utils import as_numpy, make_generator, resolve_device
from ..utils.rng import RandomSeedManager
from .base import (BaseSampler, EdgeSamplerInput, HeteroSamplerOutput,
                   NodeSamplerInput, SamplerOutput)
from .negative_sampler import RandomNegativeSampler


class NeighborSampler(BaseSampler):
  """Uniform or weighted multi-hop neighbour sampling over device CSRs.

  Args:
    graph: a :class:`Graph`, or a dict of them keyed by EdgeType
      (hetero), on ``device``.
    num_neighbors: fanout per hop, e.g. ``[15, 10, 5]``; ``-1`` expands
      every neighbour inside a static window (``full_neighbor_cap``, by
      default the graph's max degree, which makes it exact; the frontier
      grows by the window per ``-1`` hop). Hetero: one list for every
      edge type or a dict keyed by EdgeType, every list of the same
      length.
    device: where sampling runs (default: the card; raises when there is
      none). The graph must already live there.
    with_edge: also emit the sampled edges' ids.
    with_weight: edge-weight-biased sampling of positive hops (Gumbel
      top-k over each row's neighbours, in a window of
      ``max_weighted_degree`` and never below the hop's fanout) on a
      graph (hetero: an edge type) with ``edge_weights``; without them
      the hops stay uniform, as in JAX.
    replace: sample uniform hops with replacement.
    edge_dir: ``'out'`` samples out-neighbours of CSR graphs, ``'in'``
      in-neighbours of CSC graphs (``Dataset.edge_dir``).
    seed: seed of the sampler's ``torch.Generator``; defaults to the
      process :class:`RandomSeedManager` seed.
    max_weighted_degree: a weighted hop's window (default: the graph's,
      hetero each edge type's, max degree).
    full_neighbor_cap: the window of a ``-1`` hop (default: the max
      degree).
  """

  def __init__(self, graph: Union[Graph, Dict[EdgeType, Graph]],
               num_neighbors, device=None, with_edge: bool = False,
               with_weight: bool = False, replace: bool = False,
               edge_dir: str = 'out', seed: Optional[int] = None,
               max_weighted_degree: Optional[int] = None,
               full_neighbor_cap: Optional[int] = None):
    self.device = resolve_device(device)
    self.is_hetero = isinstance(graph, dict)
    if edge_dir not in ('out', 'in'):
      raise ValueError(f"edge_dir must be 'out' or 'in', got {edge_dir!r}")
    self.edge_dir = edge_dir
    layout = 'CSR' if edge_dir == 'out' else 'CSC'
    graphs = graph.values() if self.is_hetero else (graph,)
    for g in graphs:
      if g.device != self.device:
        raise ValueError(f'graph lives on {g.device}, sampler runs on '
                         f'{self.device}')
      if g.layout != layout:
        raise ValueError(f'edge_dir={edge_dir!r} samples a {layout} graph, '
                         f'got a {g.layout}')
    self.graph = graph
    self.with_edge = with_edge
    self.replace = replace
    self.with_weight = with_weight
    self.max_weighted_degree = max_weighted_degree
    self.full_neighbor_cap = full_neighbor_cap
    #: each graph's max degree (one device read a graph), None: homogeneous
    self._max_degrees = {e: g.topo.max_degree for e, g in
                         (graph.items() if self.is_hetero
                          else ((None, graph),))}
    if self.is_hetero:
      self.edge_types = list(graph)
      if not isinstance(num_neighbors, dict):
        num_neighbors = {e: num_neighbors for e in self.edge_types}
      self.num_neighbors = {e: [self._resolve_fanout(f, e)
                                for f in num_neighbors[e]]
                            for e in self.edge_types}
      fanouts = sum(self.num_neighbors.values(), [])
      hops = {len(v) for v in self.num_neighbors.values()}
      if len(hops) != 1:
        raise ValueError('all edge types need the same hop count')
      self.num_hops = hops.pop()
      self.node_counts = hetero_node_counts(graph)
    else:
      self.num_neighbors = [self._resolve_fanout(f, None)
                            for f in num_neighbors]
      fanouts = self.num_neighbors
      self.num_hops = len(self.num_neighbors)
    #: weighted or full hops run the per-hop loop; uniform positive
    #: fanouts the walk
    self._per_hop = with_weight or any(f < 0 for f in fanouts)
    #: the weighted edge types (None: the homogeneous graph)
    self._weighted_types = {
        e for e, g in (graph.items() if self.is_hetero
                       else ((None, graph),))
        if self._per_hop and with_weight and g.edge_weights is not None}
    self._weighted = None in self._weighted_types
    #: the per-hop loop's int32 edge ids, one an edge type
    self._eids = ({e: g.edge_ids.to(torch.int32) for e, g in
                   (graph.items() if self.is_hetero else ((None, graph),))}
                  if self._per_hop and with_edge else {})
    self.generator = make_generator(
        seed if seed is not None
        else RandomSeedManager.getInstance().getSeed(), self.device)
    self._plans = {}
    #: link sampling's negatives, one sampler an edge type (None: the
    #: homogeneous graph), made at first use
    self._neg_samplers = {}
    if self.is_hetero and not self._per_hop:
      # the flat edge-type plane depends on the graph alone; only the
      # table size, capacities and budgets change with the batch shape
      self._hetero_plan = HeteroFusedPlan(
          self.edge_types, self._traversal_types(), self.node_counts, graph,
          with_eids=with_edge, replace=replace)

  # -- homogeneous --------------------------------------------------------

  def _resolve_fanout(self, fanout, etype: Optional[EdgeType]) -> int:
    """Positive fanouts stay; ``-1`` becomes ``-window``, the full hop's
    static window (``full_neighbor_cap`` or the graph's max degree;
    capacity math uses ``abs``), as the JAX sampler encodes it."""
    fanout = int(fanout)
    if fanout == -1:
      cap = int(self.full_neighbor_cap or self._max_degrees[etype])
      if cap <= 0:
        raise ValueError('graph has no edges; fanout -1 is meaningless')
      return -cap
    if fanout <= 0:
      raise ValueError(f'fanout must be positive or -1, got {fanout}')
    return fanout

  def _weight_window(self, fanout: int,
                     etype: Optional[EdgeType] = None) -> int:
    """A weighted hop's window: ``max_weighted_degree`` (default the
    graph's max degree), never below the hop's fanout."""
    return max(int(self.max_weighted_degree or self._max_degrees[etype]),
               fanout)

  def _hop(self, g: Graph, etype: Optional[EdgeType], fanout: int, ids,
           mask, u):
    """One hop of the per-hop loop on ``g``: full, weighted or uniform
    (the JAX sampler's ``_one_hop`` dispatch)."""
    eids = self._eids.get(etype)
    if fanout < 0:
      return sample_full_neighbors(g.indptr, g.indices, ids, -fanout,
                                   seed_mask=mask, edge_ids=eids)
    if etype in self._weighted_types:
      return sample_neighbors_weighted(
          g.indptr, g.indices, g.edge_weights, ids, fanout, u,
          self._weight_window(fanout, etype), seed_mask=mask, edge_ids=eids)
    return sample_neighbors(g.indptr, g.indices, ids, fanout, u,
                            seed_mask=mask, edge_ids=eids,
                            replace=self.replace)

  def _one_hop(self, h, ids, mask, u):
    """Hop ``h`` of the homogeneous per-hop loop."""
    return self._hop(self.graph, None, self.num_neighbors[h], ids, mask, u)

  def _fused_plan(self, batch_size: int) -> FusedHopPlan:
    if batch_size not in self._plans:
      g = self.graph
      self._plans[batch_size] = FusedHopPlan(
          g.indptr_pad, g.indices,
          walk_table_slots(sample_budget(batch_size, self.num_neighbors)),
          edge_ids=g.edge_ids if self.with_edge else None,
          replace=self.replace)
    return self._plans[batch_size]

  def hop_uniforms(self, batch_size, input_type: Optional[NodeType] = None):
    """The next per-hop uniforms of this sampler's stream; hetero: for
    ``batch_size`` seeds of ``input_type``, or a dict of batch sizes by
    seed type, per hop and per segment (:func:`hetero_hop_uniforms`)."""
    if self.is_hetero:
      sizes = (batch_size if isinstance(batch_size, dict)
               else {input_type: batch_size})
      caps = self._hetero_geometry(sizes)[1]
      return hetero_hop_uniforms(
          self.generator, self._traversal_types(), self.num_neighbors, caps,
          self.replace, self.device,
          {e: self._weight_window(0, e) for e in self._weighted_types})
    if not self._per_hop:
      return walk_hop_uniforms(self.generator, batch_size,
                               self.num_neighbors, self.replace, self.device)
    # the per-hop loop's draws, shaped as the JAX hops draw them from
    # their keys: a uniform hop (K, S_h) transposed ((S_h, K) with
    # replacement), a weighted hop (S_h, window); a full hop draws nothing
    us, s = [], batch_size
    for f in self.num_neighbors:
      if f < 0:
        us.append(None)
      elif self._weighted:
        us.append(weighted_hop_uniforms(self.generator, s,
                                        self._weight_window(f), self.device))
      elif self.replace:
        us.append(torch.rand((s, f), generator=self.generator,
                             device=self.device))
      else:
        us.append(torch.rand((f, s), generator=self.generator,
                             device=self.device).T.contiguous())
      s *= abs(f)
    return us

  def _seeds(self, x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
      return x.to(self.device, torch.int32)
    return torch.as_tensor(as_numpy(x).astype(np.int32), device=self.device)

  def sample_from_nodes(self, inputs, n_valid=None, uniforms=None,
                        seed_type: Optional[NodeType] = None):
    """Multi-hop sampling from seed nodes; seeds past ``n_valid`` are
    padding. ``uniforms`` injects the draws (default: the next ones of
    the sampler's generator, :meth:`hop_uniforms`). Hetero ``inputs``
    are a :class:`NodeSamplerInput` with its ``input_type``, a
    ``(node_type, seeds)`` pair, or a dict of seeds by node type (several
    seed types in one walk; ``seed_type`` names the output's
    ``input_type``, default the first), ``n_valid`` one count for every
    seed type or a dict of them; the result is a
    :class:`HeteroSamplerOutput` (glt_tpu/sampler/neighbor_sampler.py
    :619-634)."""
    if self.is_hetero:
      if isinstance(inputs, tuple) and len(inputs) == 2 and isinstance(
          inputs[0], str):
        inputs = NodeSamplerInput(inputs[1], inputs[0])
      if not isinstance(inputs, (NodeSamplerInput, dict)):
        raise ValueError('hetero sampling takes a NodeSamplerInput with the '
                         'seeds\' node type, a (node type, seeds) pair or a '
                         'dict of seeds by node type')
      return self._hetero_sample_from_nodes(inputs, n_valid, uniforms,
                                            seed_type=seed_type)
    if isinstance(inputs, NodeSamplerInput):
      inputs = inputs.node
    seeds = self._seeds(inputs)
    batch_size = seeds.numel()
    n_valid = batch_size if n_valid is None else int(n_valid)
    if uniforms is None:
      uniforms = self.hop_uniforms(batch_size)
    if self._per_hop:
      out = multihop_sample_sorted(self._one_hop, seeds, n_valid,
                                   self.num_neighbors, uniforms,
                                   with_edge=self.with_edge)
    else:
      out = multihop_sample(self._fused_plan(batch_size), seeds, n_valid,
                            self.num_neighbors, u_hops=uniforms,
                            with_edge=self.with_edge)
    return SamplerOutput(
        node=out['node'], node_count=out['node_count'], row=out['row'],
        col=out['col'], edge_mask=out['edge_mask'], edge=out.get('edge'),
        batch=out['batch'], num_sampled_nodes=out['num_sampled_nodes'],
        num_sampled_edges=out['num_sampled_edges'],
        edge_hop_offsets=edge_hop_offsets(batch_size, self.num_neighbors),
        metadata={'seed_labels': out['seed_labels'],
                  'seed_count': out['seed_count']})

  # -- heterogeneous ------------------------------------------------------

  def _traversal_types(self):
    """Per traversal edge type: (expand-from type, neighbour type); a CSR
    expands src into dst, a CSC dst into src."""
    if self.edge_dir == 'out':
      return {e: (e[0], e[2]) for e in self.edge_types}
    return {e: (e[2], e[0]) for e in self.edge_types}

  def _hetero_caps(self, batch_sizes: Dict[NodeType, int]):
    """Static per-type frontier capacities per hop and node budgets, for
    ``batch_sizes`` seeds of each seed type."""
    caps = [{t: batch_sizes.get(t, 0) for t in self.node_counts}]
    for h in range(self.num_hops):
      nxt = {t: 0 for t in self.node_counts}
      for e, (row_t, col_t) in self._traversal_types().items():
        nxt[col_t] += caps[h][row_t] * abs(self.num_neighbors[e][h])
      caps.append(nxt)
    budgets = {t: max(1, sum(c[t] for c in caps))
               for t in self.node_counts}
    return caps, budgets

  def _hetero_geometry(self, batch_sizes: Dict[NodeType, int]):
    """Per signature of seed types and batch sizes: the dedup-table size,
    capacities, budgets and per-edge-type hop offsets."""
    key = tuple(sorted(batch_sizes.items()))
    if key not in self._plans:
      caps, budgets = self._hetero_caps(batch_sizes)
      offs = hetero_edge_hop_offsets(caps, self._traversal_types(),
                                     self.num_neighbors, self.num_hops)
      self._plans[key] = (walk_table_slots(sum(budgets.values())), caps,
                          budgets, offs)
    return self._plans[key]

  def _hetero_one_hops(self):
    """Per edge type the in-memory one-hop of the per-hop loop,
    ``one_hop(ids, fanout, u, mask)`` (the JAX ``_build_hetero_fn``'s
    ``one_hops``)."""
    return {e: (lambda ids, fanout, u, mask, _e=e: self._hop(
        self.graph[_e], _e, fanout, ids, mask, u)) for e in self.edge_types}

  def _hetero_sample_from_nodes(self, inputs, n_valid, uniforms,
                                seed_type: Optional[NodeType] = None
                                ) -> HeteroSamplerOutput:
    """``inputs``: a :class:`NodeSamplerInput` with its node type, or a
    dict of seeds by node type (link sampling seeds both endpoint types)
    with ``seed_type`` the output's ``input_type``; ``n_valid`` an int
    for every seed type or a dict of them."""
    if isinstance(inputs, NodeSamplerInput) and inputs.input_type is not None:
      seed_type = inputs.input_type
      inputs = {seed_type: inputs.node}
    elif not isinstance(inputs, dict):
      raise ValueError('hetero sampling takes a NodeSamplerInput with the '
                       'seeds\' node type')
    if seed_type is None:
      seed_type = next(iter(inputs))
    seeds = {t: self._seeds(x) for t, x in inputs.items()}
    sizes = {t: x.numel() for t, x in seeds.items()}
    if not isinstance(n_valid, dict):
      n_valid = {t: sizes[t] if n_valid is None else int(n_valid)
                 for t in seeds}
    slots, caps, budgets, offs = self._hetero_geometry(sizes)
    if uniforms is None:   # one seed type: hop_uniforms(batch size, type)
      uniforms = (self.hop_uniforms(sizes[seed_type], seed_type)
                  if list(sizes) == [seed_type] else self.hop_uniforms(sizes))
    if self._per_hop:
      out = multihop_sample_hetero_sorted(
          self._hetero_one_hops(), self._traversal_types(),
          self.num_neighbors, self.num_hops, caps, budgets, seeds, n_valid,
          uniforms, with_edge=self.with_edge)
    else:
      out = multihop_sample_hetero(
          self._hetero_plan, slots, self.num_neighbors, self.num_hops, caps,
          budgets, seeds, n_valid, uniforms, with_edge=self.with_edge)
    # message-flow keys: row carries child labels (the walk's cols), col
    # parent labels (the walk's rows); 'out' reverses the traversal type
    rev = reverse_edge_type if self.edge_dir == 'out' else (lambda e: e)
    return HeteroSamplerOutput(
        node=out['node'], node_count=out['node_count'],
        row={rev(e): v for e, v in out['col'].items()},
        col={rev(e): v for e, v in out['row'].items()},
        edge_mask={rev(e): v for e, v in out['edge_mask'].items()},
        edge=({rev(e): v for e, v in out['edge'].items()}
              if self.with_edge else None),
        batch=out['batch'], num_sampled_nodes=out['num_sampled_nodes'],
        num_sampled_edges={rev(e): v for e, v in
                           out['num_sampled_edges'].items()},
        input_type=seed_type,
        metadata={'seed_labels': out['seed_labels'],
                  'edge_hop_offsets': {rev(e): tuple(v)
                                       for e, v in offs.items()
                                       if e in out['row']}})

  # -- link sampling --------------------------------------------------------

  def _neg_sampler(self, etype: Optional[EdgeType]
                   ) -> RandomNegativeSampler:
    """The negative sampler over ``etype``'s graph (the homogeneous graph
    for None), one an edge type (the JAX ``_get_neg_sampler``)."""
    if etype not in self._neg_samplers:
      g = self.graph[etype] if self.is_hetero else self.graph
      self._neg_samplers[etype] = RandomNegativeSampler(
          g, edge_dir=self.edge_dir)
    return self._neg_samplers[etype]

  def sample_from_edges(self, inputs: EdgeSamplerInput, uniforms=None,
                        proposals=None
                        ) -> Union[SamplerOutput, HeteroSamplerOutput]:
    """Link sampling: the endpoints of the positive edges (and of the
    sampled negatives) are the seeds, repeats included; the metadata
    labels the links by the seeds' labels, each slot its id's
    first-occurrence label.

    Binary negative sampling appends ``neg.sample_size(num_pos)`` pairs
    to the positives: ``edge_label_index`` [2, num_pos + num_neg] and
    ``edge_label`` (the given labels, else ones, then zeros). Triplet
    sampling appends the negatives' dst: ``src_index``, ``dst_pos_index``
    [num_pos] and ``dst_neg_index`` ([num_pos, amount] when amount > 1).
    Negatives are drawn with padding (always full), strict as
    ``neg.strict`` says, from five trial rounds, over the input's edge
    type.

    Homogeneous graphs seed ``concat([src, dst])``. On a hetero graph
    ``inputs.input_type`` names the edge type: when its two ends differ
    (``('user', 'to', 'item')``), src seeds its type and dst the other,
    in one walk, and the link labels index each type's node list; when
    they are the same, ``concat([src, dst])`` seeds that type. The
    output's ``input_type`` is then the edge type.

    ``proposals`` injects the negatives' draws (five rounds of
    ``ops.negative.negative_proposals``, in the stored orientation) and
    ``uniforms`` the walk's (:meth:`hop_uniforms` at the seed counts:
    ``2 * num_pos + num_neg`` seeds (binary: ``2 * (num_pos +
    num_neg)``), or by seed type ``{src type: num_pos (binary: + num_neg),
    dst type: num_pos + num_neg}``); by default both come from the
    sampler's generator, the negatives first, as the JAX sampler splits
    its key."""
    etype = inputs.input_type
    if etype is not None and not self.is_hetero:
      raise NotImplementedError('a homogeneous graph has no edge type to '
                                'seed links from')
    if self.is_hetero and etype not in self.graph:
      raise ValueError(f'hetero link sampling needs the edge type of the '
                       f'links, got {etype!r}')
    src, dst = self._seeds(inputs.row), self._seeds(inputs.col)
    num_pos, num_neg = src.numel(), 0
    edge_label = (None if inputs.label is None else torch.as_tensor(
        as_numpy(inputs.label), device=self.device))
    neg = inputs.neg_sampling
    if neg is not None:
      num_neg = neg.sample_size(num_pos)
      pair = self._neg_sampler(etype).sample(
          num_neg, padding=True, strict=neg.strict, proposals=proposals,
          generator=self.generator)
      if neg.is_binary():
        src = torch.cat([src, pair.rows])
        dst = torch.cat([dst, pair.cols])
        if edge_label is None:
          edge_label = torch.ones(num_pos, dtype=torch.float32,
                                  device=self.device)
        edge_label = torch.cat([edge_label, edge_label.new_zeros(
            (num_neg,) + tuple(edge_label.shape[1:]))])
      else:
        if num_neg % max(num_pos, 1):
          raise ValueError('triplet amount must be an integer multiple')
        if edge_label is not None:
          raise ValueError('triplet sampling takes no edge labels')
        dst = torch.cat([dst, pair.cols])
    if etype is not None and etype[0] != etype[-1]:
      out = self._hetero_sample_from_nodes(
          {etype[0]: src, etype[-1]: dst}, None, uniforms,
          seed_type=etype[0])
      labels = out.metadata['seed_labels']
      inv_src, inv_dst = labels[etype[0]], labels[etype[-1]]
    else:
      seeds = torch.cat([src, dst])
      if etype is None:
        out = self.sample_from_nodes(seeds, uniforms=uniforms)
        inverse = out.metadata['seed_labels']
      else:
        out = self._hetero_sample_from_nodes({etype[0]: seeds}, None,
                                             uniforms)
        inverse = out.metadata['seed_labels'][etype[0]]
      inv_src, inv_dst = inverse[:src.numel()], inverse[src.numel():]
    meta = dict(out.metadata, num_pos=num_pos, num_neg=num_neg)
    if neg is None or neg.is_binary():
      meta['edge_label_index'] = torch.stack([inv_src, inv_dst])
      meta['edge_label'] = edge_label
    else:
      meta['src_index'] = inv_src
      meta['dst_pos_index'] = inv_dst[:num_pos]
      dst_neg = inv_dst[num_pos:]
      if num_pos > 0 and num_neg // num_pos > 1:
        dst_neg = dst_neg.reshape(num_pos, -1)
      meta['dst_neg_index'] = dst_neg
    out.metadata = meta
    if etype is not None:
      out.input_type = etype
    return out

  # -- subgraph -------------------------------------------------------------

  def subgraph(self, seeds, node_capacity: Optional[int] = None,
               uniforms=None) -> SubGraph:
    """The subgraph induced on the multi-hop neighbourhood of ``seeds``:
    its nodes labelled in the node list's order (seeds first), every edge
    of the graph between two of them (``ops.subgraph.induced_subgraph``,
    each node's edges read in a window of the graph's max degree, so
    exact). ``node_capacity`` defaults to the
    sampled node budget; ``uniforms`` injects the walk's draws.
    Homogeneous graphs only."""
    if self.is_hetero:
      raise NotImplementedError('subgraph takes a homogeneous graph')
    out = self.sample_from_nodes(seeds, uniforms=uniforms)
    g = self.graph
    if not hasattr(self, '_max_degree'):   # one device read, then cached
      self._max_degree = g.topo.max_degree
    node_mask = torch.arange(out.node.numel(),
                             device=self.device) < out.node_count
    return induced_subgraph(
        g.indptr, g.indices, out.node, node_mask,
        node_capacity=node_capacity or out.node.numel(),
        max_degree=self._max_degree, edge_ids=g.edge_ids,
        with_edge=self.with_edge)

  # -- hotness -------------------------------------------------------------

  def sample_prob(self, train_idx, node_count=None):
    """Access probabilities from pre-sampling (glt_tpu/sampler/
    neighbor_sampler.py:817-853, the reference's hotness estimate for
    ``FrequencyPartitioner``): the seeds start at 1, then each hop pushes
    the last hop's probabilities through its fanout
    (:func:`~glt_tpu_torch.ops.sample.neighbor_probs`) and every node keeps
    the running sum, clipped to 1. Runs on the sampler's device.

    Homogeneous: ``train_idx`` ids and ``node_count`` the node count;
    returns ``[node_count]`` float32. Hetero: ``train_idx`` a
    ``(seed_type, ids)`` pair and ``node_count`` an optional dict of
    counts by type (default the graph's); returns a dict of them by type,
    each hop pushing across every traversal edge type."""
    dev = self.device

    def seeded(n, ids):
      p = torch.zeros(n, dtype=torch.float32, device=dev)
      p[torch.as_tensor(as_numpy(ids), device=dev).long()] = 1.0
      return p

    if self.is_hetero:
      seed_type, ids = train_idx
      counts = dict(node_count or self.node_counts)
      probs = {t: torch.zeros(n, dtype=torch.float32, device=dev)
               for t, n in counts.items()}
      probs[seed_type] = seeded(counts[seed_type], ids)
      acc = dict(probs)
      trav = self._traversal_types()
      for h in range(self.num_hops):
        nxt = {t: torch.zeros(n, dtype=torch.float32, device=dev)
               for t, n in counts.items()}
        for etype, (row_t, col_t) in trav.items():
          k = self.num_neighbors[etype][h]
          if k == 0:
            continue
          g = self.graph[etype]
          contrib = neighbor_probs(g.indptr, g.indices, acc[row_t], k,
                                   counts[col_t])
          nxt[col_t] = torch.clamp(nxt[col_t] + contrib, max=1.0)
        acc = nxt
        probs = {t: torch.clamp(probs[t] + acc[t], max=1.0) for t in counts}
      return probs
    if node_count is None:
      raise ValueError('sample_prob of a homogeneous graph needs node_count')
    g = self.graph
    probs = seeded(int(node_count), train_idx)
    acc = probs
    for fanout in self.num_neighbors:
      acc = neighbor_probs(g.indptr, g.indices, acc, fanout, int(node_count))
      probs = torch.clamp(probs + acc, max=1.0)
    return probs
