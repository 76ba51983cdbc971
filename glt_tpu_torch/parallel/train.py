"""Training steps (counterpart of glt_tpu/parallel/train.py, and of the
steps of examples/hetero/train_rgnn.py and, with ``loss=link_bce_loss``,
examples/graph_sage_unsup.py).

:class:`SageTrainStep` updates GraphSAGE over a Batch or RGNN over a
HeteroBatch on one device. :class:`SPMDSageTrainStep` is the JAX
package's data-parallel GraphSAGE trainer: one process a card, each rank
samples its own seed block against the replicated graph, reads its
features from a :class:`~glt_tpu_torch.parallel.ShardedFeature` through
the exchange lookup, and averages its gradients over the mesh (an
``all_reduce``, the JAX ``pmean``) before Adam. It runs a batch a call
(``__call__``) or a window of K batches (``superstep``, ``run_epoch``):
on the card a window is one CUDA graph, captured the first time a window
length comes and replayed after; on the CPU the same body runs K times.

The loss is the masked softmax cross-entropy of the seed rows, averaged
over the ``n_valid`` real seeds of the batch; autograd through the
model's ``index_add_`` and ``scatter_reduce`` aggregations carries the
gradient (no Pallas kernel of the JAX package has a backward);
``torch.optim.Adam`` applies it with
optax's ``adam`` defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0). The
three stages of :class:`SageTrainStep` carry ``torch.profiler`` ranges
(``train.forward``, ``train.backward``, ``train.optimizer``); with
``sync_stages`` each of them starts and ends in a device sync, so that a
trace can attribute the kernels that ran inside a range's host interval
to its stage, the backward's too (autograd launches those from its own
thread, outside the range's device-side extent).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..loader.device_epoch import DeviceEpochLoader
from ..loader.transform import Batch, HeteroBatch
from ..ops.cuda_kernels import walk_table_slots
from ..ops.pipeline import (edge_hop_offsets, multihop_sample,
                            multihop_sample_many, sample_budget)
from ..ops.sample import FusedHopPlan, walk_hop_uniforms
from ..ops.superstep import (capture_window, scan_consume, superstep,
                              tree_leaves, tree_map)
from ..utils import make_generator
from ..utils.prefetch import prefetch
from .dist_feature import ShardedFeature, require_device_resident
from .mesh import Mesh


def sage_loss(model: nn.Module,
              batch: Union[Batch, HeteroBatch]) -> torch.Tensor:
  """Mean cross-entropy of the logits against the seed labels (``batch.y``
  of a Batch, ``batch.y_dict[batch.input_type]`` of a HeteroBatch) over
  the first ``batch.metadata['n_valid']`` seeds (padded seeds weigh
  nothing)."""
  logits = model(batch)
  y = (batch.y_dict[batch.input_type] if isinstance(batch, HeteroBatch)
       else batch.y)
  n = logits.shape[0]
  mask = torch.arange(n, device=logits.device) < batch.metadata['n_valid']
  losses = F.cross_entropy(logits, y.long(), reduction='none')
  return (torch.where(mask, losses, torch.zeros_like(losses)).sum()
          / mask.sum().clamp(min=1))


def link_bce_loss(model: nn.Module,
                  batch: Union[Batch, HeteroBatch]) -> torch.Tensor:
  """The link-prediction loss of examples/graph_sage_unsup.py: every
  sampled node's embedding (``model.embed``), a dot product per labelled
  pair of ``metadata['edge_label_index']``, and the sigmoid binary
  cross-entropy against ``metadata['edge_label']``, averaged over every
  label slot (a padded ragged batch's repeated edges included, as the
  example averages them).

  A HeteroBatch of links of the edge type ``(src, rel, dst)`` (its
  ``input_type``) is examples/hetero/bipartite_sage_unsup.py's loss: the
  embeddings of every type (``model(batch, return_all=True)``, an RGNN),
  ``edge_label_index[0]`` indexing the src type's and ``[1]`` the dst
  type's."""
  eli = batch.metadata['edge_label_index'].long()
  if isinstance(batch, HeteroBatch):
    emb = model(batch, return_all=True)
    src_t, _, dst_t = batch.input_type
    z_src, z_dst = emb[src_t], emb[dst_t]
  else:
    z_src = z_dst = model.embed(batch)
  logit = (z_src.index_select(0, eli[0])
           * z_dst.index_select(0, eli[1])).sum(-1)
  label = batch.metadata['edge_label'].to(logit.dtype)
  return F.binary_cross_entropy_with_logits(logit, label)


class SageTrainStep:
  """One forward/backward/Adam update of ``model`` per call.

  Args:
    model: a module consuming a Batch (models.GraphSAGE) or a HeteroBatch
      (models.RGNN).
    lr: Adam's learning rate (the reference's 1e-3).
    sync_stages: synchronise the card around every stage (for profiling;
      a no-op for a model on the CPU).
    loss: ``loss(model, batch)`` -> scalar (default :func:`sage_loss`;
      :func:`link_bce_loss` for link prediction).
  """

  def __init__(self, model: nn.Module, lr: float = 1e-3,
               sync_stages: bool = False,
               loss: Callable[[nn.Module, Batch], torch.Tensor] = sage_loss):
    self.model = model
    self.loss = loss
    self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8)
    device = next(model.parameters()).device
    self._sync = (lambda: torch.cuda.synchronize(device)) if (
        sync_stages and device.type == 'cuda') else (lambda: None)

  def __call__(self, batch: Union[Batch, HeteroBatch]) -> torch.Tensor:
    """Returns the batch's loss (before the update), detached."""
    self.optimizer.zero_grad(set_to_none=True)
    self._sync()
    with record_function('train.forward'):
      loss = self.loss(self.model, batch)
      self._sync()
    with record_function('train.backward'):
      loss.backward()
      self._sync()
    with record_function('train.optimizer'):
      self.optimizer.step()
      self._sync()
    return loss.detach()


def mesh_update(model: nn.Module, optimizer: torch.optim.Optimizer,
                mesh: Mesh, batch: Union[Batch, HeteroBatch]) -> torch.Tensor:
  """One data-parallel update: :func:`sage_loss` of ``batch``, its
  backward, the mesh mean of the gradients and the loss (one
  ``all_reduce``, the JAX ``pmean``), the optimizer's step. Returns the
  mean loss (before the update), a 0-dim tensor."""
  optimizer.zero_grad(set_to_none=True)
  loss = sage_loss(model, batch)
  loss.backward()
  loss = loss.detach().reshape(1)
  for p in model.parameters():
    # a parameter the batch did not reach (a relation with no edges)
    # takes a zero gradient, as a JAX gradient has one, so that Adam
    # steps it as optax does
    if p.grad is None:
      p.grad = torch.zeros_like(p)
  world = mesh.world
  if world > 1:
    grads = [p.grad for p in model.parameters()]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss])
    dist.all_reduce(flat, group=mesh.group)
    flat = flat / world
    for g, v in zip(grads, flat[:-1].split([g.numel() for g in grads])):
      g.copy_(v.view_as(g))
    loss = flat[-1:]
  optimizer.step()
  return loss[0]


class _Window:
  """The static buffers of one window length, its CUDA graph once
  captured, the graph's output (the window's losses), the kernel
  launches recorded in it by wrapper name and how often it was
  replayed."""

  def __init__(self, inputs: Dict):
    self.inputs = inputs
    self.graph: Optional[torch.cuda.CUDAGraph] = None
    self.losses: Optional[torch.Tensor] = None
    self.recorded: Dict[str, int] = {}
    self.replays = 0


class CapturedWindows:
  """The windows of a superstep trainer: each window length's static
  buffers and, on a card, its CUDA graph, captured the first time the
  length comes and replayed after (``superstep_captures``,
  ``capture_seconds``, ``graph_replays``, ``windows`` by (kind, length),
  :meth:`graph_launches`). A trainer calls :meth:`_init_windows` and runs
  each window's body through :meth:`_run`."""

  def _init_windows(self, device: torch.device):
    self._window_device = device
    #: CUDA graphs captured (one per window length and kind); 0 on the CPU
    self.superstep_captures = 0
    #: seconds each capture took (the recording, after its eager window)
    self.capture_seconds: List[float] = []
    #: windows run by replaying a graph
    self.graph_replays = 0
    #: the windows by (kind, length): static buffers, graph, the launches
    #: recorded in it and its replays
    self.windows: Dict = {}
    # held by a capture and by a producer thread's device work, so that
    # no other thread touches the card while a graph records
    self._lock = threading.Lock()

  def _run(self, w: _Window, body: Callable[[], torch.Tensor]
           ) -> torch.Tensor:
    """A window's losses: eagerly on the CPU; on the card the first
    window of its length runs eagerly and is captured, later ones
    replay."""
    dev = self._window_device
    if dev.type != 'cuda':
      return body()
    if w.graph is None:
      with self._lock:
        losses, w.graph, w.losses, secs, w.recorded = capture_window(body,
                                                                     dev)
      self.superstep_captures += 1
      self.capture_seconds.append(secs)
      return losses
    w.graph.replay()
    w.replays += 1
    self.graph_replays += 1
    return w.losses.clone()

  def graph_launches(self) -> Dict[str, int]:
    """Kernel launches made by graph replays, by wrapper name: each
    window's recorded launches times its replays (the wrappers count
    only what ran eagerly)."""
    out: Dict[str, int] = {}
    for w in self.windows.values():
      for name, n in w.recorded.items():
        out[name] = out.get(name, 0) + n * w.replays
    return out

  def _window(self, key, inputs: Dict) -> _Window:
    """The window ``key``, its static buffers (shaped like ``inputs``, a
    tree of tensors on the card) filled with ``inputs``."""
    if key not in self.windows:
      self.windows[key] = _Window(tree_map(torch.empty_like, inputs))
    w = self.windows[key]
    for dst, src in zip(tree_leaves(w.inputs), tree_leaves(inputs)):
      dst.copy_(src)
    return w


class SPMDSageTrainStep(CapturedWindows):
  """The data-parallel GraphSAGE step over a mesh of ranks, one card each
  (counterpart of glt_tpu/parallel/train.py:76-568).

  Every engine runs one batch body: the walk (K1) from the rank's seed
  block -> :meth:`ShardedFeature.lookup_local` (the exchange; K3 serves
  the rows) -> seed labels -> :func:`sage_loss` -> backward -> the
  gradients' and the loss's mean over the mesh -> Adam. A window of K
  batches (:meth:`superstep`, :meth:`run_epoch`) is on the card one CUDA
  graph: the first window of each length runs eagerly and is then
  captured, later ones copy their seeds, valid counts and uniforms into
  the graph's static buffers and replay it (at most two captures an
  epoch: K and the tail). ``superstep_captures`` counts the captures;
  the kernel wrappers count the eager windows' launches, and
  :meth:`graph_launches` the ones the replays made.
  Per-batch calls and windows share the optimizer (``capturable`` on a
  card), so either engine may follow the other.

  Args:
    mesh: the rank's :class:`~glt_tpu_torch.parallel.mesh.Mesh`.
    model: a GraphSAGE on the mesh's device; its parameters are
      broadcast from rank 0.
    graph: the replicated :class:`~glt_tpu_torch.data.Graph` (uniform
      positive fanouts: the walk).
    feature: a :class:`ShardedFeature` over the same mesh.
    labels: ``[N]`` labels (replicated).
    fanouts: per-hop fanouts.
    batch_size_per_device: seeds a rank a batch.
    lr: Adam's learning rate.
    with_edge: also carry each sampled edge's CSR slot into
      ``Batch.edge``.
    cold_streaming: accept a spilled store without its pinned block
      (``host_offload=False``): each window samples first, stages its
      cold rows on the host, then trains (:meth:`run_epoch` prepares the
      next window on a prefetch thread while the card trains on this
      one). Per-batch calls raise on such a store.
    seed: seed of the rank's generator (``seed + rank``), which draws the
      uniforms when a call is given none.
  """

  def __init__(self, mesh: Mesh, model: nn.Module, graph, feature:
               ShardedFeature, labels, fanouts: Sequence[int],
               batch_size_per_device: int, lr: float = 1e-3,
               with_edge: bool = False, cold_streaming: bool = False,
               seed: int = 0):
    self._streaming = bool(cold_streaming)
    if not self._streaming:
      require_device_resident(feature, 'SPMDSageTrainStep')
    elif not feature.host_spilled:
      raise ValueError(
          'cold_streaming=True needs a host-spilled store without a pinned '
          'cold block (split_ratio < 1, host_offload=False)')
    if any(int(f) <= 0 for f in fanouts):
      raise ValueError(f'the walk takes positive fanouts, got {fanouts}')
    dev = mesh.device
    if next(model.parameters()).device != dev:
      raise ValueError(f'the model is not on the mesh\'s device {dev}')
    self.mesh, self.model, self.graph, self.feature = (mesh, model, graph,
                                                       feature)
    self.fanouts = [int(f) for f in fanouts]
    self.bs = int(batch_size_per_device)
    self.with_edge = bool(with_edge)
    self.labels = torch.as_tensor(labels).to(dev)
    self._budget = sample_budget(self.bs, self.fanouts)
    self._offs = tuple(edge_hop_offsets(self.bs, self.fanouts))
    # Batch.edge carries each pick's CSR slot, as the JAX trainer's
    # one-hop reads (no edge_ids given) return it
    self._plan = FusedHopPlan(
        graph.indptr_pad, graph.indices, walk_table_slots(self._budget),
        edge_ids=torch.arange(graph.num_edges, dtype=torch.int32,
                              device=dev) if self.with_edge else None)
    if mesh.world > 1:
      for p in model.parameters():
        dist.broadcast(p.data, 0, group=mesh.group)
    self.optimizer = torch.optim.Adam(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
        capturable=dev.type == 'cuda')
    self.generator = make_generator(seed + mesh.rank, dev)
    self._init_windows(dev)

  # -- the batch body ----------------------------------------------------

  def make_batch(self, seeds: torch.Tensor, n_valid: torch.Tensor, u_hops,
                 static_rounds: bool = False) -> Batch:
    """This rank's batch: the walk from ``seeds [B]`` (``n_valid`` a
    0-dim tensor, ``u_hops`` per hop ``[S_h, K_h]``), its features through
    the exchange and its seed labels."""
    out = multihop_sample(self._plan, seeds, n_valid, self.fanouts,
                          u_hops=u_hops, with_edge=self.with_edge)
    node_valid = torch.arange(self._budget, device=self.mesh.device) < \
        out['node_count']
    x = self.feature.lookup_local(out['node'].clamp(min=0), node_valid,
                                  static_rounds=static_rounds)
    return self._batch(out, x, n_valid)

  def _batch(self, out, x, n_valid) -> Batch:
    y = self.labels.index_select(0, out['node'][:self.bs].clamp(min=0).long())
    return Batch(x=x, row=out['row'], col=out['col'],
                 edge_mask=out['edge_mask'], node=out['node'],
                 node_count=out['node_count'], y=y, edge=out.get('edge'),
                 batch_size=self.bs, edge_hop_offsets=self._offs,
                 metadata={'n_valid': n_valid})

  def _update(self, batch: Batch) -> torch.Tensor:
    return mesh_update(self.model, self.optimizer, self.mesh, batch)

  # -- inputs of this rank -----------------------------------------------

  def _own(self, seeds_stack, n_valid_stack, uniforms):
    """This rank's column of a window: seeds ``[T, B]`` and valid counts
    ``[T]`` int32 on its device, and per hop uniforms ``[T, S_h, K_h]``
    (the given ``[T, world, S_h, K_h]`` at this rank, else drawn from the
    generator batch by batch, as per-batch calls draw them)."""
    dev, r, bs = self.mesh.device, self.mesh.rank, self.bs
    seeds = torch.as_tensor(seeds_stack)[:, r * bs:(r + 1) * bs]
    n_valid = torch.as_tensor(n_valid_stack)[:, r]
    seeds = seeds.to(dev, torch.int32).contiguous()
    n_valid = n_valid.to(dev, torch.int32).contiguous()
    if uniforms is None:
      draws = [walk_hop_uniforms(self.generator, bs, self.fanouts, False,
                                 dev) for _ in range(seeds.shape[0])]
      u = [torch.stack(h) for h in zip(*draws)]
    else:
      u = [torch.as_tensor(x)[:, r].to(dev, torch.float32).contiguous()
           for x in uniforms]
    return seeds, n_valid, u

  # -- per-batch ----------------------------------------------------------

  def __call__(self, seeds, n_valid_per_device, uniforms=None
               ) -> torch.Tensor:
    """One batch: ``seeds [world * B]`` shard-major, ``n_valid_per_device
    [world]``, ``uniforms`` per hop ``[world, S_h, K_h]`` or None (drawn).
    Returns the mesh's mean loss, a 0-dim tensor."""
    if self._streaming:
      raise NotImplementedError(
          'cold_streaming stores train through superstep() and '
          'run_epoch(); a per-batch step cannot read host-spilled rows')
    u = None if uniforms is None else [torch.as_tensor(x)[None]
                                      for x in uniforms]
    seeds, n_valid, u = self._own(torch.as_tensor(seeds)[None],
                                  torch.as_tensor(n_valid_per_device)[None],
                                  u)
    return self._update(self.make_batch(seeds[0], n_valid[0],
                                        [x[0] for x in u]))

  # -- windows ------------------------------------------------------------

  def superstep(self, seeds_stack, n_valid_stack, uniforms=None
                ) -> torch.Tensor:
    """T batches as one window: ``seeds_stack [T, world * B]``
    shard-major, ``n_valid_stack [T, world]``, ``uniforms`` per hop ``[T,
    world, S_h, K_h]`` or None (drawn). Equal to T per-batch calls on the
    same inputs. Returns the mesh's mean losses ``[T]``."""
    seeds, n_valid, u = self._own(seeds_stack, n_valid_stack, uniforms)
    if self._streaming:
      return self._consume(self._sample_and_stage(seeds, n_valid, u))
    w = self._window(('fused', seeds.shape[0]),
                     dict(seeds=seeds, n_valid=n_valid, u=u))
    step = superstep(lambda s, nv, uh: self._update(
        self.make_batch(s, nv, uh, static_rounds=True)))
    return self._run(w, lambda: step(w.inputs['seeds'], w.inputs['n_valid'],
                                     w.inputs['u']))

  # -- cold streaming: sample, stage on the host, consume ------------------

  def _sample_and_stage(self, seeds, n_valid, u):
    """The window's walks (one K1 launch each), then its cold rows
    gathered on the host and copied to the card (zero on every other
    lane)."""
    outs = multihop_sample_many(self._plan, seeds, n_valid, self.fanouts,
                                u_stack=u, with_edge=self.with_edge)
    keep = ('node', 'node_count', 'row', 'col', 'edge_mask') + (
        ('edge',) if self.with_edge else ())
    outs = {k: outs[k] for k in keep}
    # this rank's own block: one count a batch
    cold = self.feature.stage_cold_rows(outs['node'].cpu(),
                                        outs['node_count'].cpu()[:, None])
    cold = torch.as_tensor(cold).to(self.mesh.device, self.feature.dtype)
    return dict(outs=outs, cold=cold, n_valid=n_valid)

  def _consume(self, staged) -> torch.Tensor:
    """Train on a staged window: the hot rows through the exchange (cold
    lanes zero) plus the staged cold rows, then the update."""
    w = self._window(('consume', staged['n_valid'].shape[0]), staged)

    def one(carry, x):
      out = x['outs']
      node_valid = torch.arange(self._budget, device=self.mesh.device) < \
          out['node_count']
      xh = self.feature.lookup_local(out['node'].clamp(min=0), node_valid,
                                     static_rounds=True)
      batch = self._batch(out, xh + x['cold'].to(xh.dtype), x['n_valid'])
      return carry, self._update(batch)
    run = scan_consume(one)
    return self._run(w, lambda: run(None, w.inputs)[1])

  # -- epochs --------------------------------------------------------------

  def make_epoch_loader(self, seeds, superstep_len: int = 8,
                        shuffle: bool = True, drop_last: bool = False,
                        drop_last_superstep: bool = False, rng=None
                        ) -> DeviceEpochLoader:
    """A :class:`DeviceEpochLoader` of global batches ``world *
    batch_size_per_device`` on this rank's device (every rank stages the
    same stack; give each the same ``rng``)."""
    return DeviceEpochLoader(
        seeds, batch_size=self.mesh.world * self.bs,
        superstep_len=superstep_len, num_shards=self.mesh.world,
        shuffle=shuffle, drop_last=drop_last,
        drop_last_superstep=drop_last_superstep, rng=rng,
        device=self.mesh.device)

  def run_epoch(self, loader: DeviceEpochLoader, uniforms=None,
                stream_depth: int = 1) -> torch.Tensor:
    """One epoch of windows from ``loader``; ``uniforms`` (optional) gives
    each window's, in order. A streaming store double-buffers: a prefetch
    thread samples window N+1, gathers its cold rows on the host and
    copies them in, on a stream of its own, while the card trains on
    window N. Returns the mean losses ``[T_total]``."""
    u_iter = iter(uniforms) if uniforms is not None else None
    windows = ((ss, None if u_iter is None else next(u_iter))
               for ss in loader)
    losses = []
    if self._streaming:
      dev = self.mesh.device
      for staged, done in prefetch(self._staged(windows),
                                   depth=max(1, stream_depth)):
        if done is not None:
          main = torch.cuda.current_stream(dev)
          main.wait_event(done)
          for t in tree_leaves(staged):
            t.record_stream(main)
        losses.append(self._consume(staged))
    else:
      for ss, u in windows:
        losses.append(self.superstep(ss.seeds, ss.n_valid, u))
    if not losses:
      return torch.zeros(0, device=self.mesh.device)
    return torch.cat(losses)

  def _staged(self, windows):
    """The producer of the streaming epoch: each window sampled and
    staged under the capture lock, on a stream of its own on a card;
    yields ``(staged, event)``, the event recorded after its copies (None
    on the CPU)."""
    dev = self.mesh.device
    stream = torch.cuda.Stream(dev) if dev.type == 'cuda' else None
    it = iter(windows)
    while True:
      with self._lock, (torch.cuda.stream(stream) if stream is not None
                        else contextlib.nullcontext()):
        item = next(it, None)
        if item is None:
          return
        ss, u = item
        staged = self._sample_and_stage(*self._own(ss.seeds, ss.n_valid, u))
        done = None
        if stream is not None:
          done = torch.cuda.Event()
          done.record(stream)
      yield staged, done
