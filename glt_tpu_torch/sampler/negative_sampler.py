"""Random negative sampler over one graph (counterpart of
glt_tpu/sampler/negative_sampler.py): draws (src, dst) pairs that, in
strict mode, are not edges."""
from __future__ import annotations

from typing import Optional

import torch

from ..data import Graph
from ..ops.negative import NegativeOutput, random_negative_sample


class RandomNegativeSampler:
  """Samples (src, dst) non-edges of ``graph``. A CSC graph
  (``edge_dir='in'``) stores dst as its rows, so its pairs are swapped
  back to (src, dst)."""

  def __init__(self, graph: Graph, edge_dir: str = 'out'):
    self.graph = graph
    self.edge_dir = edge_dir

  def sample(self, req_num: int, trials_num: int = 5, padding: bool = False,
             strict: bool = True, proposals=None,
             generator: Optional[torch.Generator] = None
             ) -> NegativeOutput:
    """``strict`` rejects pairs that are edges; ``padding`` always
    returns a full batch. ``proposals`` (``(rows, cols)``,
    [max(trials_num, 1), req_num], in the stored orientation) inject the
    draws; by default they come from ``generator``."""
    g = self.graph
    out = random_negative_sample(
        g.indptr, g.indices, req_num=req_num, trials_num=trials_num,
        num_rows=g.topo.num_rows, num_cols=g.topo.num_cols, strict=strict,
        padding=padding, proposals=proposals, generator=generator)
    if self.edge_dir == 'in':
      return NegativeOutput(rows=out.cols, cols=out.rows, mask=out.mask)
    return out
