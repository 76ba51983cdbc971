"""Bipartite unsupervised GraphSAGE on a Taobao-shaped user-item graph
(counterpart of examples/hetero/bipartite_sage_unsup.py, the reference's
Taobao link-prediction workload): the hetero LinkNeighborLoader over
``('user', 'to', 'item')`` seed edges with one binary negative each ->
RGNN rsage embeddings of every sampled node of both types -> dot-product
sigmoid BCE -> Adam(3e-3), then a test ROC-AUC each epoch.

``--scale toy`` is the JAX example's synthetic graph (users with a latent
group, 8 links a user inside it, item-item edges between items that
share two users), from the same numpy draws. ``--scale taobao`` is PyG's
Taobao at its counts: 987,994 users, 4,161,138 items in 9,439
categories, 101 links a user inside one category (99.8M against
Taobao's 100.2M), and 4 same-category item neighbours an item in place
of the two-shared-users rule, which cannot be enumerated at that scale;
drawn on ``device`` from ``--seed`` (:func:`taobao_graph`). Batch 64 is
the JAX example's CPU size; the reference's Taobao batch is 2048.

    python -m glt_tpu_torch.examples.hetero.bipartite_sage_unsup
        [--scale toy|taobao] [--epochs 3] [--batch-size 64] [--device cpu]
        [--max-steps N] [--eval-batches N]
"""
from __future__ import annotations

import argparse
import collections
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import LinkNeighborLoader
from glt_tpu_torch.models import RGNN
from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
from glt_tpu_torch.sampler import NegativeSampling
from glt_tpu_torch.typing import reverse_edge_type
from glt_tpu_torch.utils import resolve_device

U2I = ('user', 'to', 'item')
I2U = ('item', 'rev_to', 'user')
I2I = ('item', 'sim', 'item')
FANOUTS, HIDDEN, EMBED, FEAT, LR = [8, 4], 64, 32, 32, 3e-3
#: PyG's Taobao: users, items, item categories, links a user (100,150,807
#: links over 987,994 users, rounded down), item-item neighbours an item
TAOBAO = dict(num_users=987_994, num_items=4_161_138, num_groups=9_439,
              links_per_user=101, sim_per_item=4)


def synthetic_taobao(num_users=600, num_items=300, num_groups=6,
                     links_per_user=8, seed=0):
  """The JAX example's toy graph, from the same draws: ``(user-item
  [2, E], item-item [2, E'], users, items)``; an item pair is linked when
  at least two users link both."""
  rng = np.random.default_rng(seed)
  item_group = rng.integers(0, num_groups, num_items)
  user_pref = rng.integers(0, num_groups, num_users)
  src, dst = [], []
  for u in range(num_users):
    own = np.nonzero(item_group == user_pref[u])[0]
    picks = rng.choice(own, min(links_per_user, own.shape[0]),
                       replace=False)
    src += [u] * picks.shape[0]
    dst += picks.tolist()
  ui = np.stack([np.array(src), np.array(dst)])
  per_user = collections.defaultdict(list)
  for u, i in zip(ui[0], ui[1]):
    per_user[u].append(i)
  pair_count = collections.Counter()
  for items in per_user.values():
    for a in items:
      for b in items:
        if a != b:
          pair_count[(a, b)] += 1
  ii = np.array([[a, b] for (a, b), c in pair_count.items()
                 if c >= 2]).T
  if ii.size == 0:
    ii = np.zeros((2, 0), np.int64)
  return ui, ii, num_users, num_items


def taobao_graph(num_users, num_items, num_groups, links_per_user,
                 sim_per_item, seed=0, device=None):
  """A Taobao-sized user-item graph drawn on ``device``: every item in a
  uniform category, every user in the category of a uniform item (so no
  user's category is empty), ``links_per_user`` uniform items of it a
  user (with repeats), and ``sim_per_item`` uniform other items of its
  category an item (none for an item alone in its category). Returns
  ``(user-item [2, E], item-item [2, E'], users, items)`` int64 on
  ``device``."""
  dev = resolve_device(device)
  gen = torch.Generator(device=dev).manual_seed(seed)
  group = torch.randint(0, num_groups, (num_items,), generator=gen,
                        device=dev)
  members = torch.sort(group, stable=True).indices    # items by category
  size = torch.bincount(group, minlength=num_groups)
  start = torch.cumsum(size, 0) - size

  def draw(groups, n, skip=None):
    # n uniform members of each of ``groups``; ``skip``: a rank within
    # the category not to draw (the item itself)
    s, c = start[groups][:, None], size[groups][:, None]
    width = c - 1 if skip is not None else c
    u = torch.rand((groups.numel(), n), generator=gen, device=dev)
    j = (u * width).long().clamp(max=(width - 1).clamp(min=0))
    if skip is not None:
      j = j + (j >= skip[:, None]).long()
    # an item alone in its category draws past it (dropped by the caller)
    return members[(s + j).clamp(max=num_items - 1)]

  users = torch.arange(num_users, device=dev)
  pref = group[torch.randint(0, num_items, (num_users,), generator=gen,
                             device=dev)]
  ui = torch.stack([users.repeat_interleave(links_per_user),
                    draw(pref, links_per_user).reshape(-1)])
  rank = torch.empty_like(members)
  rank[members] = torch.arange(num_items, device=dev) - start[group[members]]
  items = torch.arange(num_items, device=dev)
  has_peer = size[group] > 1
  peers = draw(group, sim_per_item, skip=rank)
  keep = has_peer[:, None].expand(-1, sim_per_item).reshape(-1)
  ii = torch.stack([items.repeat_interleave(sim_per_item)[keep],
                    peers.reshape(-1)[keep]])
  return ui, ii, num_users, num_items


def link_split(ui, seed=1):
  """The 80/20 split of the user-item links (the example's
  RandomLinkSplit): ``(train [2, E - E // 5], test [2, E // 5])``; numpy
  links through ``default_rng(seed)``'s permutation, as the JAX example
  splits them, a tensor's on its device."""
  n_test = ui.shape[1] // 5
  if isinstance(ui, torch.Tensor):
    gen = torch.Generator(device=ui.device).manual_seed(seed)
    perm = torch.randperm(ui.shape[1], generator=gen, device=ui.device)
  else:
    perm = np.random.default_rng(seed).permutation(ui.shape[1])
  return ui[:, perm[n_test:]], ui[:, perm[:n_test]]


def build_dataset(train, ii, num_users, num_items, feats, device=None):
  """The hetero Dataset: the training links and their reverse, the
  item-item relation, and a feature table a type."""
  rev = (train.flip(0) if isinstance(train, torch.Tensor)
         else np.ascontiguousarray(train[::-1]))
  ds = Dataset(edge_dir='out')
  ds.init_graph({U2I: train, I2U: rev, I2I: ii},
                num_nodes={'user': num_users, 'item': num_items},
                device=device)
  ds.init_node_features(feats, device=device)
  return ds


def make_model(device=None) -> RGNN:
  """RGNN rsage 32 -> 64 -> 32 over the three relations' message-passing
  keys, untrimmed (every hop in both layers), as the example builds it."""
  return RGNN([reverse_edge_type(e) for e in (U2I, I2U, I2I)], FEAT, HIDDEN,
              EMBED, num_layers=len(FANOUTS), conv='rsage',
              trim=False).to(device)


def link_loader(ds, edges, batch_size, seed, device=None, shuffle=False):
  return LinkNeighborLoader(
      ds, FANOUTS, edge_label_index=(U2I, edges), batch_size=batch_size,
      shuffle=shuffle, seed=seed,
      neg_sampling=NegativeSampling('binary', amount=1), device=device)


@torch.no_grad()
def score(model, batch) -> torch.Tensor:
  """Each labelled pair's dot product of its user and item embeddings."""
  emb = model(batch, return_all=True)
  eli = batch.metadata['edge_label_index'].long()
  return (emb['user'][eli[0]] * emb['item'][eli[1]]).sum(-1)


def roc_auc(y, s):
  order = np.argsort(s)
  ranks = np.empty(len(s))
  ranks[order] = np.arange(1, len(s) + 1)
  pos = y > 0.5
  np_, nn = pos.sum(), (~pos).sum()
  if np_ == 0 or nn == 0:
    return 0.5
  return (ranks[pos].sum() - np_ * (np_ + 1) / 2) / (np_ * nn)


def evaluate(model, loader, max_batches=None) -> float:
  """ROC-AUC over the loader's labelled pairs (its first ``max_batches``
  batches)."""
  ys, ss = [], []
  for i, batch in enumerate(loader):
    if max_batches is not None and i == max_batches:
      break
    ss.append(score(model, batch).cpu().numpy())
    ys.append(batch.metadata['edge_label'].cpu().numpy())
  return float(roc_auc(np.concatenate(ys), np.concatenate(ss)))


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--scale', default='toy', choices=['toy', 'taobao'])
  ap.add_argument('--epochs', type=int, default=3)
  ap.add_argument('--batch-size', type=int, default=64)
  ap.add_argument('--users', type=int, default=600,
                  help='users of the toy graph (items: half as many)')
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  ap.add_argument('--max-steps', type=int, default=None,
                  help='training batches an epoch (default: all)')
  ap.add_argument('--eval-batches', type=int, default=None,
                  help='test batches an epoch (default: all)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  if args.scale == 'toy':
    ui, ii, nu, ni = synthetic_taobao(num_users=args.users,
                                      num_items=args.users // 2)
    rngf = np.random.default_rng(2)
    feats = {'user': rngf.normal(size=(nu, FEAT)).astype(np.float32),
             'item': rngf.normal(size=(ni, FEAT)).astype(np.float32)}
  else:
    ui, ii, nu, ni = taobao_graph(seed=args.seed, device=device, **TAOBAO)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    feats = {t: torch.randn((n, FEAT), generator=gen, device=device)
             for t, n in (('user', nu), ('item', ni))}
  train_edges, test_edges = link_split(ui)
  ds = build_dataset(train_edges, ii, nu, ni, feats, device=device)
  loader = link_loader(ds, train_edges, args.batch_size, seed=0,
                       device=device, shuffle=True)
  eval_loader = link_loader(ds, test_edges, args.batch_size, seed=3,
                            device=device)
  torch.manual_seed(args.seed)
  model = make_model(device)
  step = SageTrainStep(model, lr=LR, loss=link_bce_loss)
  loss, auc = float('nan'), float('nan')
  for epoch in range(args.epochs):
    for i, batch in enumerate(loader):
      if args.max_steps is not None and i == args.max_steps:
        break
      loss = float(step(batch))
    auc = evaluate(model, eval_loader, args.eval_batches)
    print(f'epoch {epoch}: loss={loss:.4f} test_auc={auc:.4f}')
  return dict(loss=loss, auc=auc)


if __name__ == '__main__':
  main()
