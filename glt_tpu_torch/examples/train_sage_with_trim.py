"""Hop-trimming A/B (counterpart of examples/train_sage_with_trim.py, the
reference's train_sage_prod_with_trim.py workload): the same GraphSAGE
trained twice from identically seeded loaders and weights, with
``trim=True`` (layer i reads only the edge slots of the hops later layers
still need, a static slice through ``edge_hop_offsets``) and without.

On deduplicated batches a deep hop can rediscover a shallow node, so
trimming is an approximation, as PyG's ``trim_to_layer`` is: the check
is accuracy within 0.15 of the untrimmed run's, at fewer edge slots a
layer.

    python -m glt_tpu_torch.examples.train_sage_with_trim [--nodes 4000]
        [--epochs 1] [--batch-size 256] [--fanout 15,10,5] [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from glt_tpu_torch.examples.common import synthetic_products
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.typing import Split
from glt_tpu_torch.utils import resolve_device

HIDDEN, LR, EVAL_NODES = 128, 1e-3, 1024


def example_loss(model, batch) -> torch.Tensor:
  """The JAX example's loss: the mean softmax cross-entropy over every
  seed row of the batch (a ragged last batch's repeated seeds
  included)."""
  return F.cross_entropy(model(batch), batch.y.long())


def layer_slots(offsets, num_slots: int, num_layers: int, trim: bool):
  """The edge slots each layer of a GraphSAGE processes: with ``trim``
  layer i reads up to ``offsets[max(min(hops, num_layers - i), 1)]``
  (``models.sage``'s slice), else every slot."""
  if not trim or offsets is None:
    return [num_slots] * num_layers
  hops = len(offsets) - 1
  return [int(offsets[max(min(hops, num_layers - i), 1)])
          for i in range(num_layers)]


def trim_ab(ds, num_classes: int, fanout, batch_size: int, device,
            hidden: int = HIDDEN, epochs: int = 1,
            max_steps: Optional[int] = None, eval_nodes: int = EVAL_NODES,
            seed: int = 0) -> dict:
  """Train GraphSAGE(trim=True) and GraphSAGE(trim=False) on ``ds`` from
  the same loader seeds (shuffle ``default_rng(seed)``, sampler seed
  ``seed``) and the same initial weights (``torch.manual_seed(seed)``),
  each for ``epochs`` epochs or ``max_steps`` steps; then each one's
  accuracy over the first ``eval_nodes`` test nodes (loader seed 1).

  Returns ``{'offsets', 'slots', True: run, False: run}``, a run being
  ``{'loss', 'acc', 'wall', 'step_ms', 'layer_slots'}`` (``step_ms``:
  each step's milliseconds, each ending in a read of its loss)."""
  train_idx = ds.get_split(Split.train)

  def make_loader():
    # a fresh loader a run: the shuffle order and the draws must be the
    # same for the two trajectories to compare
    return NeighborLoader(ds, fanout, train_idx, batch_size=batch_size,
                          shuffle=True, seed=seed,
                          rng=np.random.default_rng(seed), device=device)

  b0 = next(iter(make_loader()))
  offsets, num_slots = b0.edge_hop_offsets, int(b0.row.numel())
  feat_dim = ds.get_node_feature().feature_dim
  out = {'offsets': offsets, 'slots': num_slots}
  for trim in (True, False):
    torch.manual_seed(seed)
    model = GraphSAGE(feat_dim, hidden, num_classes, num_layers=len(fanout),
                      trim=trim).to(device)
    step = SageTrainStep(model, lr=LR, loss=example_loss)
    loader, steps, loss, step_ms = make_loader(), 0, float('nan'), []
    t0 = time.perf_counter()
    for _ in range(epochs):
      # islice: no batch is sampled past the last step
      for batch in itertools.islice(
          loader, None if max_steps is None else max_steps - steps):
        ts = time.perf_counter()
        loss = float(step(batch))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        steps += 1
    wall = time.perf_counter() - t0
    correct = total = 0
    ev = NeighborLoader(ds, fanout, ds.get_split(Split.test)[:eval_nodes],
                        batch_size=batch_size, seed=1,
                        rng=np.random.default_rng(1), device=device)
    with torch.no_grad():
      for batch in ev:
        nv = batch.metadata['n_valid']
        pred = model(batch).argmax(1)[:nv]
        correct += int((pred == batch.y[:nv].to(pred.dtype)).sum())
        total += int(nv)
    out[trim] = dict(loss=loss, acc=correct / max(total, 1), wall=wall,
                     step_ms=step_ms,
                     layer_slots=layer_slots(offsets, num_slots, len(fanout),
                                             trim))
  return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--nodes', type=int, default=4_000)
  ap.add_argument('--epochs', type=int, default=1)
  ap.add_argument('--batch-size', type=int, default=256)
  ap.add_argument('--fanout', default='15,10,5')
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, num_classes = synthetic_products(num_nodes=args.nodes, device=device)
  fanout = [int(x) for x in args.fanout.split(',')]
  res = trim_ab(ds, num_classes, fanout, args.batch_size, device,
                epochs=args.epochs)
  print(f'edge buffer {res["slots"]} slots; per-layer trim offsets '
        f'{res["offsets"]}')
  t, f = res[True], res[False]
  print(f'trim=True : loss={t["loss"]:.4f}  acc={t["acc"]:.4f}  '
        f'wall={t["wall"]:.1f}s')
  print(f'trim=False: loss={f["loss"]:.4f}  acc={f["acc"]:.4f}  '
        f'wall={f["wall"]:.1f}s')
  if not (np.isfinite(t['loss']) and np.isfinite(f['loss'])):
    raise AssertionError(f'non-finite loss: {t["loss"]}, {f["loss"]}')
  if not abs(t['acc'] - f['acc']) < 0.15:
    raise AssertionError((t['acc'], f['acc']))
  print('done')
  return res


if __name__ == '__main__':
  main()
