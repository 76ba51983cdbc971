"""Train -> checkpoint -> serve: GraphSAGE online inference end to end
(counterpart of examples/serve_sage_products.py).

Phase 1 trains a small supervised GraphSAGE on the synthetic products
graph (as train_sage_products.py) and saves its state_dict with
``glt_tpu_torch.utils.checkpoint``. Phase 2 restores the checkpoint into
an InferenceEngine, stands up a ServingServer (micro-batching, bucketed
sampling on the card, the embedding cache) and fires synthetic queries at
it through a ServingClient over the rpc fabric. Where the JAX example
counts steady-state recompiles, this one prints the engine's runs per
bucket: the port compiles nothing.

    python -m glt_tpu_torch.examples.serve_sage_products [--nodes 8000]
        [--device cpu] [--max-steps N]
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from glt_tpu_torch.examples.common import synthetic_products
from glt_tpu_torch.loader import NeighborLoader
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import SageTrainStep
from glt_tpu_torch.serving import (InferenceEngine, ServingClient,
                                   ServingServer)
from glt_tpu_torch.typing import Split
from glt_tpu_torch.utils import resolve_device
from glt_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                            save_checkpoint)


def train(ds, num_classes, fanout, args, device) -> dict:
  loader = NeighborLoader(ds, fanout, ds.get_split(Split.train),
                          batch_size=args.batch_size, shuffle=True, seed=0,
                          device=device)
  torch.manual_seed(0)
  model = GraphSAGE(ds.get_node_feature().feature_dim, args.hidden,
                    num_classes, num_layers=len(fanout)).to(device)
  step = SageTrainStep(model, lr=1e-3)
  done, loss = 0, float('nan')
  for epoch in range(args.epochs):
    for batch in loader:
      loss = float(step(batch))
      done += 1
      if args.max_steps and done >= args.max_steps:
        break
    print(f'epoch {epoch}: loss={loss:.4f}')
    if args.max_steps and done >= args.max_steps:
      break
  return model.state_dict()


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--nodes', type=int, default=8_000)
  ap.add_argument('--epochs', type=int, default=1)
  ap.add_argument('--max-steps', type=int, default=0,
                  help='cap total train steps (0 = full epochs)')
  ap.add_argument('--batch-size', type=int, default=512)
  ap.add_argument('--fanout', default='10,5')
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--buckets', default='8,32')
  ap.add_argument('--queries', type=int, default=32)
  ap.add_argument('--max-request', type=int, default=8)
  ap.add_argument('--ckpt-dir', default=None,
                  help='checkpoint location (default: a temporary dir)')
  ap.add_argument('--device', default=None,
                  help='default: the card (cpu runs the plain versions)')
  args = ap.parse_args(argv)
  device = resolve_device(args.device)

  ds, num_classes = synthetic_products(num_nodes=args.nodes, device=device)
  fanout = [int(x) for x in args.fanout.split(',')]
  tmp = None
  if args.ckpt_dir is None:
    tmp = tempfile.TemporaryDirectory(prefix='glt_serve_')
  ckpt_dir = args.ckpt_dir or os.path.join(tmp.name, 'ckpt')
  try:
    # -- phase 1: train + checkpoint ------------------------------------
    params = train(ds, num_classes, fanout, args, device)
    save_checkpoint(ckpt_dir, step=0, params=params)
    print(f'checkpoint saved: {ckpt_dir}')

    # -- phase 2: restore + serve ---------------------------------------
    step, payload = restore_checkpoint(ckpt_dir, template={'params': params})
    print(f'restored step {step}')
    model = GraphSAGE(ds.get_node_feature().feature_dim, args.hidden,
                      num_classes, num_layers=len(fanout))
    engine = InferenceEngine(ds, model, payload['params'], fanout,
                             buckets=[int(b) for b in
                                      args.buckets.split(',')],
                             device=device)
    with ServingServer(engine, max_wait_ms=2.0,
                       request_timeout_ms=60_000.0) as srv:
      print(f'serving on {srv.address}; warmed buckets {engine.buckets}')
      cli = ServingClient(*srv.address)
      rng = np.random.default_rng(0)
      for _ in range(args.queries):
        n = int(rng.integers(1, args.max_request + 1))
        ids = ((rng.random(n) ** 2) * args.nodes).astype(np.int64)
        logits = cli.infer(ids)
        assert logits.shape == (n, num_classes)
      pred = int(np.argmax(cli.infer([0])[0]))
      print('sample prediction:', pred)
      report = srv.metrics.report(cache=engine.cache)
      print('serving stats:', report)
      runs = engine.run_stats()['bucket_runs']
      print(f'bucket runs: {runs}')
      stats = cli.stats()
      cli.close()
  finally:
    if tmp is not None:
      tmp.cleanup()
  return dict(step=step, prediction=pred, bucket_runs=runs,
              requests=stats['requests'], report=report)


if __name__ == '__main__':
  main()
