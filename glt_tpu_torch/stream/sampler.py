"""StreamSampler: delta-aware multi-hop sampling over versioned snapshots
(counterpart of glt_tpu/stream/sampler.py).

Same contract as the homogeneous
:class:`~glt_tpu_torch.sampler.NeighborSampler`, with every hop a
:func:`~glt_tpu_torch.ops.delta.delta_one_hop`: base sample + tombstone
mask + a fixed per-row insert window, so the effective hop width is
``abs(fanout) + delta_window`` and capacity math (node budgets, edge hop
offsets) uses the effective widths. Each positive base hop reads through
the ``sample_hop`` kernel; each hop dedups with ``sorted_hop_dedup_fused``
(ops/pipeline.py ``multihop_sample_sorted``).

Reads follow the manager's RCU protocol: each ``sample_from_nodes``
acquires the current snapshot, samples against its arrays and the
installed overlay, and releases it.

Over a CSC base (``edge_dir='in'``) every hop reads the destinations'
in-edges: the base, the inserts and the tombstones all compress on the
destination axis, so the same kernels read them; the output's ``row`` and
``col`` are oriented as over a CSR base, as in the JAX package.

The JAX sampler reads base hops through a W-wide window with a static
hub cap, and falls back to element reads when a snapshot's capacity slack
is below W; the port's kernel reads every slot directly, so it has no
window, no cap and no fallback (ROADMAP.md, section C). Not supported, as
in JAX: hetero graphs, weighted sampling and ``with_edge``; nor, unlike
JAX, sampling with replacement or a tombstone window other than
``delta_window`` (no caller uses either).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.delta import delta_one_hop
from ..ops.pipeline import edge_hop_offsets, multihop_sample_sorted
from ..sampler.base import BaseSampler, NodeSamplerInput, SamplerOutput
from ..utils import as_numpy, make_generator
from ..utils.rng import RandomSeedManager
from .snapshot import SnapshotManager

logger = logging.getLogger(__name__)


class StreamSampler(BaseSampler):
  """Multi-hop sampling over a :class:`SnapshotManager`, on its device.

  Args:
    manager: the snapshot chain, which also builds the overlays.
    num_neighbors: [K_1..K_h]; -1 = full neighbourhood inside
      ``full_neighbor_cap`` (default: the startup max degree plus
      ``delta_window``), resolved once at construction.
    delta_window: per-row insert window per hop. A frontier row with more
      pending inserts than this truncates until compaction.
    tombstone_window: per-row delete window per hop (default:
      ``delta_window``); a row with more pending deletes under-masks
      until compaction.
    edge_dir: must match the manager's layout ('out': CSR, 'in': CSC;
      default: the layout's).
    seed: seed of the sampler's ``torch.Generator`` (default: the process
      :class:`RandomSeedManager` seed).
  """

  def __init__(self, manager: SnapshotManager, num_neighbors: Sequence[int],
               *, delta_window: int = 8,
               tombstone_window: Optional[int] = None,
               edge_dir: Optional[str] = None,
               full_neighbor_cap: Optional[int] = None,
               seed: Optional[int] = None):
    self.manager = manager
    self.device = manager.device
    self.is_hetero = False
    self.with_edge = False
    self.delta_window = int(delta_window)
    self.tombstone_window = int(delta_window if tombstone_window is None
                                else tombstone_window)
    if self.delta_window < 0 or self.tombstone_window < 0:
      raise ValueError('the delta windows must be >= 0')
    layout_dir = 'out' if manager.layout == 'CSR' else 'in'
    if edge_dir is None:
      edge_dir = layout_dir
    if edge_dir != layout_dir:
      raise ValueError(
          f'edge_dir {edge_dir!r} needs a '
          f'{"CSR" if edge_dir == "out" else "CSC"} base, manager holds '
          f'{manager.layout}')
    self.edge_dir = edge_dir
    base = manager.current().topo
    self._base_fanouts: List[int] = []
    for f in num_neighbors:
      f = int(f)
      if f == -1:
        # one delta epoch's inserts land in the base at compaction, so the
        # startup max degree alone would truncate after the first swap
        cap = int(full_neighbor_cap or base.max_degree + self.delta_window)
        if cap <= 0:
          raise ValueError('graph has no edges; fanout -1 is meaningless')
        self._base_fanouts.append(-cap)
      elif f > 0:
        self._base_fanouts.append(f)
      else:
        raise ValueError(f'fanout must be positive or -1, got {f}')
    self._full_cap = min((-f for f in self._base_fanouts if f < 0),
                         default=None)
    self._trunc_warned_version = -1
    #: effective hop widths: every hop appends the insert window
    self.num_neighbors = [abs(f) + self.delta_window
                          for f in self._base_fanouts]
    self.num_hops = len(self._base_fanouts)
    self.generator = make_generator(
        seed if seed is not None
        else RandomSeedManager.getInstance().getSeed(), self.device)
    self._overlay = manager.empty_overlay()

  # -- live-update hooks ---------------------------------------------------

  def set_overlay(self, overlay: dict) -> None:
    """Install freshly built delta overlays (``manager.build_overlay``);
    the next sample call reads them, in-flight calls finish on the ones
    they captured."""
    self._overlay = overlay

  def refresh_overlay(self, buffer) -> None:
    """Install the overlays of ``buffer``'s pending set."""
    self.set_overlay(self.manager.build_overlay(buffer))

  def clear_overlay(self) -> None:
    self.set_overlay(self.manager.empty_overlay())

  # -- sampling --------------------------------------------------------------

  def hop_uniforms(self, batch_size: int) -> List[Optional[torch.Tensor]]:
    """The next per-hop uniforms of this sampler's stream: for hop h with
    a positive base fanout K an [S_h, K] float32 plane (drawn ``(K,
    S_h)`` and transposed, the shape of the JAX draw without
    replacement), None for a full-neighbourhood hop. ``S_h`` is
    the frontier of the effective widths: ``batch_size * prod(widths[:h])``.
    """
    us, s = [], batch_size
    for f, width in zip(self._base_fanouts, self.num_neighbors):
      if f < 0:
        us.append(None)
      else:
        us.append(torch.rand((f, s), generator=self.generator,
                             device=self.device).T.contiguous())
      s *= width
    return us

  def _seeds(self, x) -> torch.Tensor:
    if isinstance(x, NodeSamplerInput):
      x = x.node
    if isinstance(x, torch.Tensor):
      return x.to(self.device, torch.int32)
    return torch.as_tensor(as_numpy(x).astype(np.int32), device=self.device)

  def sample_from_nodes(self, inputs, n_valid=None,
                        uniforms=None) -> SamplerOutput:
    """Delta-merged multi-hop sampling from seed nodes; seeds past
    ``n_valid`` are padding. ``uniforms`` injects the draws (default: the
    next ones of the sampler's generator, :meth:`hop_uniforms`).
    ``metadata['snapshot_version']`` is the version sampled."""
    seeds = self._seeds(inputs)
    batch_size = seeds.numel()
    n_valid = batch_size if n_valid is None else int(n_valid)
    if uniforms is None:
      uniforms = self.hop_uniforms(batch_size)
    snap = self.manager.acquire()
    try:
      if (self._full_cap is not None and snap.max_degree > self._full_cap
          and snap.version != self._trunc_warned_version):
        self._trunc_warned_version = snap.version
        logger.warning(
            'snapshot v%d max degree %d exceeds the full-neighbourhood '
            'window %d: hub rows truncate. Rebuild the sampler with a '
            'larger full_neighbor_cap.', snap.version, snap.max_degree,
            self._full_cap)
      a = dict(snap.arrays)
      a.update(self._overlay)

      def one_hop(h, ids, mask, u):
        return delta_one_hop(
            a['indptr'], a['indices'], a['ins_indptr'], a['ins_indices'],
            a['del_indptr'], a['del_indices'], ids, self._base_fanouts[h],
            u, mask, ins_window=self.delta_window,
            del_window=self.tombstone_window)

      out = multihop_sample_sorted(one_hop, seeds, n_valid,
                                   self.num_neighbors, uniforms)
    finally:
      self.manager.release(snap)
    return SamplerOutput(
        node=out['node'], node_count=out['node_count'], row=out['row'],
        col=out['col'], edge_mask=out['edge_mask'], batch=out['batch'],
        num_sampled_nodes=out['num_sampled_nodes'],
        num_sampled_edges=out['num_sampled_edges'],
        edge_hop_offsets=edge_hop_offsets(batch_size, self.num_neighbors),
        metadata={'seed_labels': out['seed_labels'],
                  'seed_count': out['seed_count'],
                  'snapshot_version': snap.version})
