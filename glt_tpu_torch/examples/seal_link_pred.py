"""SEAL link prediction (counterpart of examples/seal_link_pred.py):
full-neighbourhood enclosing subgraphs through
``NeighborSampler([-1] * hops).subgraph``, the target link removed, DRNL
node labels one-hot encoded as the only features, a DGCNN (GCN stack ->
sort-pool -> Conv1d -> MLP) trained with BCE and Adam(1e-3), model
selection by validation ROC-AUC. The graph is the synthetic ring-plus-
chords graph of the JAX example, whose links are learnable from topology
alone.

Each link's subgraph is extracted alone, as the reference extracts it
(one two-hop walk and one induced subgraph a link); DRNL runs once a
split, batched over its links' padded subgraphs; the DGCNN is batched
over padded subgraphs.

    python -m glt_tpu_torch.examples.seal_link_pred [--epochs 10]
        [--nodes 200] [--hops 2] [--batch-size 32] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from glt_tpu_torch.data import Dataset
from glt_tpu_torch.models import DGCNN
from glt_tpu_torch.ops.drnl import drnl_node_labeling
from glt_tpu_torch.ops.pipeline import sample_budget
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.sampler import NeighborSampler
from glt_tpu_torch.utils import resolve_device

MAX_Z = 12  # DRNL vocabulary clip (2-hop labels are small)


def ring_chord_graph(n=200, chords=60, seed=0):
  """Undirected ring + random chords, as sorted (a, b) pairs with a < b."""
  rng = np.random.default_rng(seed)
  ring = {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)}
  while len(ring) < n + chords:
    a, b = rng.integers(0, n, 2)
    if a != b:
      ring.add((min(int(a), int(b)), max(int(a), int(b))))
  return sorted(ring)


def link_split(und_edges, rng, num_val=0.05, num_test=0.10, n=200):
  """RandomLinkSplit equivalent: held-out positives + sampled negatives."""
  und = list(und_edges)
  rng.shuffle(und)
  n_test = int(len(und) * num_test)
  n_val = int(len(und) * num_val)
  test_pos, val_pos = und[:n_test], und[n_test:n_test + n_val]
  train_pos = und[n_test + n_val:]
  edge_set = set(und_edges)
  negs = []
  while len(negs) < n_test + n_val + len(train_pos):
    a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
    if a != b and (min(a, b), max(a, b)) not in edge_set:
      negs.append((a, b))
  test_neg = negs[:n_test]
  val_neg = negs[n_test:n_test + n_val]
  train_neg = negs[n_test + n_val:]
  return train_pos, train_neg, val_pos, val_neg, test_pos, test_neg


def build_train_dataset(train_pos, n, device=None):
  """The training links in both directions, as a CSR on ``device``."""
  both = np.array(train_pos + [(b, a) for a, b in train_pos], np.int64)
  return Dataset(edge_dir='out').init_graph(both.T.copy(), num_nodes=n,
                                            device=device)


def make_drnl_fn(n_cap: int, stats: Optional[Dict] = None):
  """DRNL over a batch of enclosing subgraphs ([L, n_cap * D] edge slots):
  the target link (labels 0 and 1, the seeds' first-occurrence labels)
  removed, labels of the padded node slots zeroed. Returns ``(z, rows,
  cols, keep)``; ``stats['rounds']`` counts the BFS rounds."""
  def drnl_fn(rows, cols, emask, node_count):
    keep = emask & ~(((rows == 0) & (cols == 1)) |
                     ((rows == 1) & (cols == 0)))
    z = drnl_node_labeling(rows, cols, keep, n_cap, 0, 1, MAX_Z,
                           stats=stats)
    z = torch.where(torch.arange(n_cap, device=z.device)[None, :]
                    < node_count[:, None], z, torch.zeros_like(z))
    return z, rows, cols, keep
  return drnl_fn


def extract_enclosing(sampler, links, y, drnl_fn, n_cap):
  """Enclosing subgraph + DRNL labels per candidate link (reference
  SEALDataset.extract_enclosing_subgraphs): one ``subgraph`` call a link,
  then DRNL over all of them at once. Returns one ``(z, rows, cols,
  keep, node_mask, y)`` per link, tensors on the sampler's device."""
  if not links:
    return []
  subs = [sampler.subgraph(torch.tensor([src, dst]), node_capacity=n_cap)
          for src, dst in links]
  stack = lambda f: torch.stack([getattr(s, f) for s in subs])
  node_count = stack('node_count')
  z, rows, cols, keep = drnl_fn(stack('rows'), stack('cols'),
                                stack('edge_mask'), node_count)
  nmask = (torch.arange(n_cap, device=z.device)[None, :]
           < node_count[:, None])
  return [(z[i], rows[i], cols[i], keep[i], nmask[i], y)
          for i in range(len(links))]


def collate(items):
  """Stacks per-link items into ``(x, rows, cols, emask, nmask, y)``: x the
  one-hot DRNL features [L, n_cap, MAX_Z + 1]."""
  z = torch.stack([i[0] for i in items])
  rows = torch.stack([i[1] for i in items])
  cols = torch.stack([i[2] for i in items])
  emask = torch.stack([i[3] for i in items])
  nmask = torch.stack([i[4] for i in items])
  y = torch.tensor([i[5] for i in items], dtype=torch.float32,
                   device=z.device)
  x = F.one_hot(z.long(), MAX_Z + 1).to(torch.float32)
  return x, rows, cols, emask, nmask, y


def roc_auc(y_true, scores):
  """Rank-statistic ROC-AUC (no sklearn dependency)."""
  order = np.argsort(scores)
  ranks = np.empty_like(order, dtype=np.float64)
  ranks[order] = np.arange(1, len(scores) + 1)
  # average ranks over ties
  for s in np.unique(scores):
    m = scores == s
    ranks[m] = ranks[m].mean()
  pos = y_true > 0.5
  n_pos, n_neg = pos.sum(), (~pos).sum()
  if n_pos == 0 or n_neg == 0:
    return 0.5
  return (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def seal_loss(model, batch) -> torch.Tensor:
  """Mean sigmoid BCE of the DGCNN's logits over a collated batch."""
  x, rows, cols, emask, nmask, y = batch
  return F.binary_cross_entropy_with_logits(
      model(x, rows, cols, emask, nmask), y)


def sort_pool_k(node_mask: torch.Tensor) -> int:
  """The sort-pool size: the 60th percentile of the training subgraphs'
  sizes, at least 10 (the reference's k = 0.6)."""
  sizes = sorted(node_mask.sum(1).tolist())
  return max(10, int(sizes[int(np.ceil(0.6 * len(sizes))) - 1]))


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def run(nodes=200, chords=60, hops=2, epochs=10, batch_size=32, device=None,
        max_train=None, max_eval=None) -> Dict:
  """The example end to end; returns its numbers: ``test_auc`` (at the
  best validation epoch), ``val_auc`` and ``losses`` per epoch, the
  extraction and DRNL milliseconds a link, the BFS rounds, the train
  steps' milliseconds, ``k``, ``n_cap`` and the link counts; and, to
  extract more links as the run did, its ``sampler`` and its capped
  ``train_pos`` and ``train_neg`` links. ``max_train`` and ``max_eval``
  cap the positive (and as many negative) links of the training and of
  each held-out split."""
  device = resolve_device(device)
  rng = np.random.default_rng(0)
  und = ring_chord_graph(n=nodes, chords=chords, seed=0)
  train_pos, train_neg, val_pos, val_neg, test_pos, test_neg = \
      link_split(und, rng, n=nodes)
  ds = build_train_dataset(train_pos, nodes, device=device)
  sampler = NeighborSampler(ds.get_graph(), [-1] * hops, seed=0,
                            device=device)
  # 2 seeds expanded through the resolved full-neighbourhood windows
  n_cap = sample_budget(2, sampler.num_neighbors)
  stats = {'rounds': 0}
  drnl_fn = make_drnl_fn(n_cap, stats)
  cap = lambda links, m: links if m is None else links[:m]

  clock = {'drnl': 0.0}

  def timed_drnl(*a):
    _sync(device)
    t0 = time.perf_counter()
    out = drnl_fn(*a)
    _sync(device)
    clock['drnl'] += time.perf_counter() - t0
    return out

  print('extracting enclosing subgraphs...')
  splits, links, n_links, total_s = {}, {}, 0, 0.0
  for name, pos, neg, m in [('train', train_pos, train_neg, max_train),
                            ('val', val_pos, val_neg, max_eval),
                            ('test', test_pos, test_neg, max_eval)]:
    pos, neg = links[name] = cap(pos, m), cap(neg, m)
    _sync(device)
    t0 = time.perf_counter()
    items = (extract_enclosing(sampler, pos, 1.0, timed_drnl, n_cap)
             + extract_enclosing(sampler, neg, 0.0, timed_drnl, n_cap))
    _sync(device)
    total_s += time.perf_counter() - t0
    n_links += len(items)
    splits[name] = collate(items)
    print(f'  {name}: {len(items)} subgraphs')

  k = sort_pool_k(splits['train'][4])
  torch.manual_seed(0)
  model = DGCNN(MAX_Z + 1, hidden=32, num_layers=3, k=k).to(device)
  step = SageTrainStep(model, lr=1e-3, loss=seal_loss)

  def evaluate(split):
    with torch.no_grad():
      scores = model(*splits[split][:5]).cpu().numpy()
    return roc_auc(splits[split][5].cpu().numpy(), scores)

  x, rows, cols, emask, nmask, y = splits['train']
  n_train = y.shape[0]
  best_val = test_auc = 0.0
  val_aucs, losses, step_ms = [], [], []
  for epoch in range(1, epochs + 1):
    perm = torch.as_tensor(rng.permutation(n_train), device=device)
    epoch_losses = []
    for lo in range(0, n_train - batch_size + 1, batch_size):
      sel = perm[lo:lo + batch_size]
      batch = tuple(a[sel] for a in (x, rows, cols, emask, nmask, y))
      _sync(device)
      t0 = time.perf_counter()
      epoch_losses.append(step(batch))
      _sync(device)
      step_ms.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(torch.stack(epoch_losses).mean())
                  if epoch_losses else float('nan'))
    val_auc = evaluate('val')
    val_aucs.append(val_auc)
    if val_auc > best_val:
      best_val, test_auc = val_auc, evaluate('test')
    print(f'Epoch: {epoch:02d}, Loss: {losses[-1]:.4f}, '
          f'Val: {val_auc:.4f}, Test: {test_auc:.4f}')
  return dict(test_auc=test_auc, best_val_auc=best_val, val_auc=val_aucs,
              losses=losses, k=k, n_cap=n_cap, links=n_links,
              train_links=n_train, extract_ms_per_link=(
                  (total_s - clock['drnl']) * 1e3 / max(n_links, 1)),
              drnl_ms_per_link=clock['drnl'] * 1e3 / max(n_links, 1),
              bfs_rounds=stats['rounds'], step_ms=step_ms, sampler=sampler,
              train_pos=links['train'][0], train_neg=links['train'][1])


def main(argv: Optional[Sequence[str]] = None) -> float:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--epochs', type=int, default=10)
  ap.add_argument('--nodes', type=int, default=200)
  ap.add_argument('--hops', type=int, default=2)
  ap.add_argument('--batch-size', type=int, default=32)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  return run(nodes=args.nodes, hops=args.hops, epochs=args.epochs,
             batch_size=args.batch_size, device=args.device)['test_auc']


if __name__ == '__main__':
  main()
