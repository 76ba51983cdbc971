"""Feature store with a device hot block and a host cold block
(counterpart of glt_tpu/data/feature.py).

Rows ``[0, hot_count)`` live on the card, rows ``[hot_count, N)`` in host
memory. A caller that first sorts the rows hottest-first
(:func:`~glt_tpu_torch.data.reorder.sort_by_in_degree`) gets the
reference's cache: most sampled rows resolve in device memory. The cold
block is, by default, pinned and mapped (``utils.offload.pin_host``, whose
``PinnedHost`` the store keeps), and
one launch of the ``gather_rows`` kernel reads the batch's hot rows from
device memory and its cold rows from host memory over the host link
(``gather_rows_mixed``); with ``host_offload=False`` the cold rows are
gathered on the host and copied in, between kernel launches. Nothing
copies the cold block to the card, and a refused pin raises. On the CPU
(``device='cpu'``) the cold block is a plain CPU tensor and the gathers
run their plain versions.

Padded ``-1`` lanes read row 0 on every path. The JAX package's default
split path (``gather_mixed``) reads row ``H - 1`` there instead
(``jnp.take`` wraps negative indices), and its host phase of a store
with no hot rows row ``N - 1`` (numpy indexing wraps); its other paths
clamp.

Not ported: ``fused_gather_fn`` (the ``pallas_fused`` engine, ROADMAP
A13).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import cuda_kernels
from ..utils import as_numpy, resolve_device
from ..utils.offload import PinnedHost, pin_host


def _host_numpy(t: torch.Tensor) -> np.ndarray:
  """A CPU tensor as numpy; bf16, which numpy lacks, widens to float32
  (exact)."""
  t = t.detach().cpu()
  return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Feature:
  """2-D feature table split into [hot | cold] rows.

  Args:
    feats: [N, D] array-like or tensor (1-D is one column).
    split_ratio: the share of rows on the card; 1.0 keeps the table
      whole on the card, 0.0 in host memory.
    id2index: optional dense id -> row map applied before every lookup
      (the old -> new map of a reordered table).
    device: the card (default; raises when there is none) or ``'cpu'``.
    dtype: optional cast of both blocks (e.g. ``torch.bfloat16``).
    host_offload: None (the JAX signature's default) or True pins and
      maps the cold block; False keeps it in ordinary host memory,
      gathered on the host.
  """

  def __init__(self, feats, split_ratio: float = 1.0, id2index=None,
               device=None, dtype: Optional[torch.dtype] = None,
               host_offload: Optional[bool] = None):
    self.device = resolve_device(device)
    if not isinstance(feats, torch.Tensor):
      feats = torch.as_tensor(np.asarray(feats))
    if feats.dim() == 1:
      feats = feats[:, None]
    self.dtype = dtype or feats.dtype
    n, d = feats.shape
    self.hot_count = int(round(n * float(split_ratio)))
    self._hot = feats[:self.hot_count].to(self.device,
                                          self.dtype).contiguous()
    self._cold = torch.empty((n - self.hot_count, d), dtype=self.dtype)
    self._cold.copy_(feats[self.hot_count:])
    self._id2index = (None if id2index is None
                      else as_numpy(id2index).astype(np.int64))
    self._id2index_dev = (None if id2index is None else torch.as_tensor(
        self._id2index, dtype=torch.int32, device=self.device))
    # the cold block is read in the kernel's launch (pinned and mapped on
    # a card, a plain tensor on the CPU) unless the caller chose the host
    # phase
    self._offload = host_offload is not False and self._cold.shape[0] > 0
    self._pinned = (pin_host(self._cold, self.device)
                    if self._offload and self.device.type == 'cuda' else None)

  # -- geometry ----------------------------------------------------------

  @property
  def shape(self):
    return (self.hot_count + self._cold.shape[0], self._hot.shape[1])

  @property
  def num_rows(self) -> int:
    return self.shape[0]

  @property
  def feature_dim(self) -> int:
    return self.shape[1]

  @property
  def id_space(self) -> int:
    """Ids lookups accept: the id map's length when there is one, else
    the row count."""
    return (self._id2index.shape[0] if self._id2index is not None
            else self.num_rows)

  @property
  def fully_device_resident(self) -> bool:
    return self.hot_count >= self.num_rows

  @property
  def device_part(self) -> torch.Tensor:
    """The hot block [hot_count, D] on the card."""
    return self._hot

  @property
  def cold_array(self) -> Optional[torch.Tensor]:
    """The cold block the kernel reads (pinned host memory on a card),
    or None: nothing spilled, or ``host_offload=False``."""
    return self._cold if self._offload else None

  @property
  def cold_pinned(self) -> Optional[PinnedHost]:
    """The mapping of the pinned cold block on a card, or None."""
    return self._pinned

  @property
  def id2index(self) -> Optional[torch.Tensor]:
    """The id -> row map on the card (int32), or None."""
    return self._id2index_dev

  @property
  def table(self) -> torch.Tensor:
    """The whole table on the device, for a store with nothing spilled."""
    if not self.fully_device_resident:
      raise ValueError(
          f'a split store has no single table: rows [0, {self.hot_count}) '
          f'are device_part, rows [{self.hot_count}, {self.num_rows}) live '
          'in host memory (cold_block_numpy)')
    return self._hot

  # -- lookup ------------------------------------------------------------

  def map_ids(self, ids):
    """Rows of ``ids`` (numpy or a tensor) through the id map, ids
    clipped into it as ``jnp.take(mode='clip')`` does; ``ids`` as they
    are when there is no map. A tensor maps on the store's device."""
    if self._id2index is None:
      return ids
    hi = self._id2index.shape[0] - 1
    if isinstance(ids, np.ndarray):
      return self._id2index[np.clip(ids, 0, hi)]
    flat = ids.reshape(-1).to(self.device).long().clamp(0, hi)
    return self._id2index_dev.index_select(0, flat).reshape(ids.shape)

  def device_gather(self, rows: torch.Tensor) -> torch.Tensor:
    """Rows of the hot block, ``rows`` clamped to ``[0, hot_count - 1]``
    (the whole table when nothing spilled)."""
    return cuda_kernels.gather_rows(self._hot, rows.reshape(-1)).reshape(
        rows.shape + (self.feature_dim,))

  def gather_mixed(self, rows: torch.Tensor) -> torch.Tensor:
    """Rows over both blocks in one kernel launch: hot rows from the
    card, cold ones from the pinned block over the host link; ``rows``
    clamped to ``[0, N - 1]``. Needs the pinned block (``cold_array``)."""
    if not self._offload:
      raise ValueError('gather_mixed needs the pinned cold block; this '
                       'store has host_offload=False or nothing spilled')
    cold = self._pinned if self._pinned is not None else self._cold
    return cuda_kernels.gather_rows_mixed(
        self._hot, cold, rows.reshape(-1)).reshape(
            rows.shape + (self.feature_dim,))

  def cold_block_numpy(self) -> np.ndarray:
    """The whole cold block as numpy, whichever memory holds it (bf16
    widened to float32)."""
    return _host_numpy(self._cold)

  def gather_cold_host(self, rows: np.ndarray) -> np.ndarray:
    """Cold rows gathered on the host, numpy (bf16 widened to float32);
    ``rows`` are absolute rows, clamped into the cold block."""
    idx = np.clip(np.asarray(rows, np.int64) - self.hot_count, 0,
                  max(self._cold.shape[0] - 1, 0))
    return _host_numpy(self._cold.index_select(
        0, torch.as_tensor(idx)))

  def stage_cold_rows(self, nodes, counts) -> np.ndarray:
    """Host gather of the cold rows of pre-sampled node stacks, for a
    pipeline that samples ahead and gathers on the host while the card
    computes (the one-store counterpart of
    ``parallel.ShardedFeature.stage_cold_rows``).

    Args:
      nodes: ``[..., B]`` rows after the id map (``map_ids`` first when
        the store has one).
      counts: ``[...]`` valid slots of each stack.

    Returns ``[..., B, D]`` numpy (bf16 widened to float32): cold rows on
    cold valid lanes, zeros elsewhere, so one add merges them with the
    hot gather."""
    nodes = as_numpy(nodes).astype(np.int64)
    counts = as_numpy(counts)
    valid = np.arange(nodes.shape[-1]) < counts[..., None]
    cold = valid & (nodes >= self.hot_count) & (nodes < self.num_rows)
    out = np.zeros(nodes.shape + (self.feature_dim,),
                   _host_numpy(self._cold[:0]).dtype)
    lanes = np.nonzero(cold)
    if lanes[0].size:
      out[lanes] = self.gather_cold_host(nodes[lanes])
    return out

  def with_updated_rows(self, ids, values) -> 'Feature':
    """A new Feature that shares every block with this one but those with
    updated rows: rows of ``ids`` (through the id map) set to ``values``
    [len(ids), D]. Readers of this Feature keep the old rows (the
    snapshot isolation of the live-update stream). A touched hot block
    costs one copy on the card; cold rows copy the host block under
    ``host_offload=False`` and are refused on a pinned block, whose
    re-pinning would cost what the offload saves."""
    ids = as_numpy(ids).astype(np.int64).reshape(-1)
    values = torch.as_tensor(values if isinstance(values, torch.Tensor)
                             else np.asarray(values))
    values = values.reshape(ids.shape[0], -1 if ids.size else
                            self.feature_dim)
    if values.shape[1] != self.feature_dim:
      raise ValueError(f'expected {(ids.shape[0], self.feature_dim)} update '
                       f'block, got {tuple(values.shape)}')
    if ids.size and (ids.min() < 0 or ids.max() >= self.id_space):
      raise ValueError(f'feature row out of range [0, {self.id_space})')
    rows = self.map_ids(ids).astype(np.int64)
    hot = rows < self.hot_count
    out = Feature.__new__(Feature)
    out.__dict__.update(self.__dict__)
    if hot.any():
      out._hot = self._hot.clone()
      out._hot[torch.as_tensor(rows[hot], device=self.device)] = values[
          torch.as_tensor(hot)].to(self.device, self.dtype)
    if (~hot).any():
      if self._offload:
        raise ValueError('cold-row updates are refused on a pinned cold '
                         'block; use host_offload=False or keep updated '
                         'rows in the hot split')
      out._cold = self._cold.clone()
      out._cold[torch.as_tensor(rows[~hot] - self.hot_count)] = values[
          torch.as_tensor(~hot)].to(self.dtype)
    return out

  def __getitem__(self, ids) -> np.ndarray:
    """Host-side lookup by id, numpy (bf16 widened to float32): the batch
    gather of :func:`gather_features`, copied to the host."""
    ids = torch.as_tensor(as_numpy(ids).astype(np.int64).reshape(-1))
    return _host_numpy(_gather_features(self, ids))


def gather_features(feat: Optional[Feature],
                    node: torch.Tensor) -> Optional[torch.Tensor]:
  """The batch's feature rows over both residency classes, on the
  store's device: ``map_ids``, then the hot block's gather (nothing
  spilled), one launch over both blocks (a pinned cold block), or the
  host phase (``host_offload=False``). Padded ``node`` lanes are -1 and
  read row 0."""
  if feat is None:
    return None
  return _gather_features(feat, node)


def _gather_features(feat: Feature, node: torch.Tensor) -> torch.Tensor:
  rows = feat.map_ids(node)
  if feat.fully_device_resident:
    return feat.device_gather(rows)
  if feat.cold_array is not None:
    return feat.gather_mixed(rows)
  # the host phase: hot rows gathered on the card; the cold rows by
  # index_select on the host, then one copy in and a scatter into the
  # kernel's result (whose cold lanes read row 0)
  dev, h, d = feat.device, feat.hot_count, feat.feature_dim
  r = rows.reshape(-1).to(dev).long().clamp(0, feat.num_rows - 1)
  if h:
    x = cuda_kernels.gather_rows(feat.device_part,
                                 torch.where(r < h, r, 0))
  else:
    x = torch.empty((r.numel(), d), dtype=feat.dtype, device=dev)
  r_host = r.cpu()
  lanes = torch.nonzero(r_host >= h).reshape(-1)
  if lanes.numel():
    vals = feat._cold.index_select(0, r_host[lanes] - h)
    x.index_copy_(0, lanes.to(dev), vals.to(dev))
  return x.reshape(tuple(rows.shape) + (d,))
