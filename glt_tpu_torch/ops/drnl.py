"""Double-Radius Node Labeling (DRNL) for SEAL link prediction
(counterpart of glt_tpu/ops/drnl.py).

Over a batch of padded enclosing subgraphs ([B, E] relabelled edge
slots over N node slots each), DRNL is a pair of edge-parallel BFS
relaxations: each round relaxes every edge slot at once (one
``scatter_reduce`` amin), and the rounds run to a fixpoint, so the
distances are exact for any diameter. The leading batch dimension takes
the place of the JAX package's ``vmap``; testing for the fixpoint reads
one flag back to the host a round.

z(v) = 1 + min(d_src, d_dst) + (d//2) * (d//2 + d%2 - 1), d = d_src +
d_dst, with d_src computed on the graph without dst (and vice versa),
z(src) = z(dst) = 1, unreachable nodes 0, clipped to ``max_z``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

INF = 1 << 29


def bfs_distances(row: torch.Tensor, col: torch.Tensor,
                  edge_mask: torch.Tensor, num_nodes: int, source,
                  stats: Optional[Dict] = None) -> torch.Tensor:
  """Unweighted shortest-path distances from ``source`` over masked,
  relabelled edge slots ``row -> col`` (directed: pass both directions
  of an undirected graph). ``row``, ``col``, ``edge_mask``: [E] or [B,
  E]; ``source``: a label or [B] labels. Returns int32 [N] or [B, N];
  unreachable nodes hold ``INF`` (1 << 29). ``stats['rounds']``, given a
  dict, counts the relaxation rounds run (the last one changed
  nothing)."""
  single = row.dim() == 1
  if single:
    row, col, edge_mask = row[None], col[None], edge_mask[None]
  dev = row.device
  b = row.shape[0]
  n = int(num_nodes)
  source = torch.as_tensor(source, device=dev).reshape(-1).expand(b)
  off = torch.arange(b, device=dev)[:, None] * n
  rows = (row.long().clamp(0, n - 1) + off).reshape(-1)
  seg = torch.where(edge_mask, col.long() + off,
                    torch.full_like(off, b * n)).reshape(-1)
  mask = edge_mask.reshape(-1)
  dist = torch.where(torch.arange(n, device=dev)[None, :]
                     == source.long()[:, None], 0, INF).to(
                         torch.int32).reshape(-1)
  inf = torch.full((b * n + 1,), INF, dtype=torch.int32, device=dev)
  rounds = 0
  while True:
    rounds += 1
    cand = torch.where(mask, dist[rows] + 1, INF).to(torch.int32)
    relaxed = inf.scatter_reduce(0, seg, cand, 'amin')[:b * n]
    new = torch.minimum(dist, relaxed)
    changed = bool((new < dist).any())
    dist = new
    if not changed:
      break
  if stats is not None:
    stats['rounds'] = stats.get('rounds', 0) + rounds
  dist = dist.reshape(b, n)
  return dist[0] if single else dist


def drnl_node_labeling(row: torch.Tensor, col: torch.Tensor,
                       edge_mask: torch.Tensor, num_nodes: int, src, dst,
                       max_z: int, stats: Optional[Dict] = None
                       ) -> torch.Tensor:
  """DRNL labels of padded enclosing subgraphs, [N] int32 (or [B, N]
  over a batch: ``row``, ``col``, ``edge_mask`` [B, E], ``src``/``dst``
  [B]). The target link must already be removed from ``edge_mask``, as
  the reference removes it. Both BFS passes run as one batch of 2B
  graphs."""
  single = row.dim() == 1
  if single:
    row, col, edge_mask = row[None], col[None], edge_mask[None]
  dev = row.device
  b = row.shape[0]
  src = torch.as_tensor(src, device=dev).reshape(-1).expand(b)[:, None]
  dst = torch.as_tensor(dst, device=dev).reshape(-1).expand(b)[:, None]
  keep_wo_dst = edge_mask & (row != dst) & (col != dst)
  keep_wo_src = edge_mask & (row != src) & (col != src)
  dist = bfs_distances(torch.cat([row, row]), torch.cat([col, col]),
                       torch.cat([keep_wo_dst, keep_wo_src]), num_nodes,
                       torch.cat([src, dst])[:, 0], stats=stats).long()
  d_src, d_dst = dist[:b], dist[b:]
  reachable = (d_src < INF) & (d_dst < INF)
  d = d_src + d_dst
  half, rem = d // 2, d % 2
  z = 1 + torch.minimum(d_src, d_dst) + half * (half + rem - 1)
  z = torch.where(reachable, z, torch.zeros_like(z))
  idx = torch.arange(int(num_nodes), device=dev)[None, :]
  z = torch.where((idx == src) | (idx == dst), torch.ones_like(z), z)
  z = z.clamp(0, max_z).to(torch.int32)
  return z[0] if single else z
