"""Train -> serve -> mutate: live graph and feature updates end to end
(counterpart of examples/stream_updates.py).

Phase 1 trains a small supervised GraphSAGE on the synthetic products
graph (as train_sage_products.py). Phase 2 serves it through an
InferenceEngine backed by a StreamSampler over a SnapshotManager. Phase 3
applies live updates through a StreamIngestor: edge inserts visible to
the next request through the delta overlay, feature rows landing at
compaction; the touched cache entries go and the updated nodes'
predictions change. Where the JAX example counts steady-state recompiles
across the swap, this one prints the engine's runs per bucket: the port
compiles nothing.

    python -m glt_tpu_torch.examples.stream_updates [--nodes 4000]
        [--device cpu] [--max-steps N]
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.common import synthetic_products
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.serving import InferenceEngine, ServingMetrics
from glt_tpu_torch.stream import (CompactionPolicy, SnapshotManager,
                                  StreamIngestor, StreamSampler)
from glt_tpu_torch.typing import Split
from glt_tpu_torch.utils import resolve_device


def train(ds, num_classes, fanout, args, device) -> dict:
  loader = NeighborLoader(ds, fanout, ds.get_split(Split.train),
                          batch_size=args.batch_size, shuffle=True, seed=0,
                          device=device)
  torch.manual_seed(0)
  model = GraphSAGE(ds.get_node_feature().feature_dim, args.hidden,
                    num_classes, num_layers=len(fanout)).to(device)
  step = SageTrainStep(model, lr=1e-3)
  done, loss = 0, float('nan')
  for batch in loader:
    loss = float(step(batch))
    done += 1
    if args.max_steps and done >= args.max_steps:
      break
  print(f'trained {done} steps: loss={loss:.4f}')
  return model.state_dict()


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--nodes', type=int, default=4_000)
  ap.add_argument('--max-steps', type=int, default=10)
  ap.add_argument('--batch-size', type=int, default=256)
  ap.add_argument('--fanout', default='10,5')
  ap.add_argument('--hidden', type=int, default=32)
  ap.add_argument('--buckets', default='8,32')
  ap.add_argument('--delta-window', type=int, default=8)
  ap.add_argument('--updates', type=int, default=64,
                  help='live edge inserts to stream in')
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, num_classes = synthetic_products(num_nodes=args.nodes, device=device)
  fanout = [int(x) for x in args.fanout.split(',')]

  # -- phase 1: train ------------------------------------------------------
  params = train(ds, num_classes, fanout, args, device)

  # -- phase 2: serve over a versioned snapshot chain ------------------------
  manager = SnapshotManager(ds.get_graph().topo, ds.get_node_feature(),
                            delta_capacity=max(args.updates * 4, 256),
                            device=device)
  sampler = StreamSampler(manager, fanout, delta_window=args.delta_window,
                          seed=0)
  model = GraphSAGE(ds.get_node_feature().feature_dim, args.hidden,
                    num_classes, num_layers=len(fanout))
  engine = InferenceEngine(ds, model, params, fanout, sampler=sampler,
                           buckets=[int(b) for b in args.buckets.split(',')],
                           device=device)
  engine.warmup()
  warm = dict(engine.run_stats()['bucket_runs'])
  print(f'warmed buckets {warm}; snapshot v{manager.current().version}')

  metrics = ServingMetrics()
  ingestor = StreamIngestor(
      manager, sampler=sampler, engine=engine, metrics=metrics,
      policy=CompactionPolicy(occupancy_threshold=0.5, max_staleness_s=5.0),
      expand_invalidation=True)

  rng = np.random.default_rng(0)
  probe = np.arange(8)
  before = engine.infer(probe)
  print('cache after first pass:', engine.cache.stats()['size'], 'entries')

  # -- phase 3: live updates -------------------------------------------------
  # edge inserts: visible to sampling at once through the delta overlay
  src = rng.integers(0, args.nodes, args.updates)
  dst = rng.integers(0, args.nodes, args.updates)
  ingestor.insert_edges(src, dst)
  # feature updates on the probe nodes: land at compaction
  new_rows = rng.normal(
      size=(4, ds.get_node_feature().feature_dim)).astype(np.float32)
  ingestor.update_features(probe[:4], new_rows)
  info = ingestor.flush()
  dropped = info['invalidated']
  print(f'compacted to snapshot v{info["version"]} in '
        f'{info["compaction_s"] * 1e3:.1f}ms; touched '
        f'{info["touched"].size} nodes, invalidated {dropped} cache entries')
  assert dropped > 0, 'the compaction must drop cache entries'

  after = engine.infer(probe)
  changed = [int(i) for i in probe[:4]
             if not np.allclose(before[i], after[i])]
  print(f'fresh predictions for updated nodes: {changed}')
  assert changed, 'feature updates must change served predictions'

  runs = engine.run_stats()['bucket_runs']
  print(f'bucket runs across the swap: '
        f'{ {b: runs[b] - warm[b] for b in runs} }')
  gauges = metrics.snapshot()['gauges']
  print('gauges:', {k: round(v, 3) for k, v in gauges.items()})
  edge_delta = ingestor.stats()['edge_delta']
  print('stream stats:', edge_delta)
  return dict(info=info, changed=changed, bucket_runs=runs, gauges=gauges,
              edge_delta=edge_delta)


if __name__ == '__main__':
  main()
