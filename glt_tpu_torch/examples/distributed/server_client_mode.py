"""Server-client training (counterpart of
examples/distributed/server_client_mode.py, the reference's
examples/distributed/server_client_mode/): sampling servers hold the
graph, each server's sampling worker samples on the card (the walk, K1)
and gathers the batch's feature rows (K3), batches cross a shared-memory
ring to the server and TCP to the training client, which prefetches them
(RemoteNeighborLoader) and trains GraphSAGE with Adam. One host: the
servers are spawned processes, and every process uses the same card.

    python -m glt_tpu_torch.examples.distributed.server_client_mode \
        [--device cpu]

The defaults are the JAX example's (4,000 nodes, two servers, [10, 5],
batch 128, hidden 64, two layers, two epochs); products-sage's width is
``--num-nodes 2450000 --hidden 256 --num-layers 3 --fanout 15,10,5
--batch-size 1024``.
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing as mp
import time
from typing import Optional, Sequence

import numpy as np
import torch


def build_dataset(num_nodes: int, seed: int, device: Optional[str]):
  """The products-shaped graph of ``synthetic_products`` on ``device``:
  a server's own copy (on the host) and each sampling worker's (on the
  card, through this builder)."""
  from glt_tpu_torch.examples.common import synthetic_products
  return synthetic_products(num_nodes=num_nodes, seed=seed,
                            device=device)[0]


def run_server(rank: int, num_servers: int, port: int, num_nodes: int,
               seed: int, device: Optional[str], ready) -> None:
  """A sampling server: its dataset on the host for the data plane, its
  workers building theirs on ``device``; serves until the client's
  exit."""
  from glt_tpu_torch.distributed import init_server, wait_and_shutdown_server
  init_server(num_servers=num_servers, num_clients=1, server_rank=rank,
              dataset=build_dataset(num_nodes, seed, 'cpu'),
              master_port=port,
              dataset_builder=functools.partial(build_dataset, num_nodes,
                                                seed, device),
              device=device)
  ready.set()
  wait_and_shutdown_server(poll_s=0.05)


def main(argv: Optional[Sequence[str]] = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--num-servers', type=int, default=2)
  ap.add_argument('--port', type=int, default=0,
                  help='the first server\'s port (server r at port + r); '
                       '0: free ports the OS picks')
  ap.add_argument('--num-nodes', type=int, default=4_000)
  ap.add_argument('--classes', type=int, default=47)
  ap.add_argument('--hidden', type=int, default=64)
  ap.add_argument('--num-layers', type=int, default=2)
  ap.add_argument('--fanout', default='10,5')
  ap.add_argument('--batch-size', type=int, default=128)
  ap.add_argument('--epochs', type=int, default=2)
  ap.add_argument('--max-steps', type=int, default=None,
                  help='stop each epoch after this many steps')
  ap.add_argument('--prefetch', type=int, default=4)
  ap.add_argument('--lr', type=float, default=1e-3)
  ap.add_argument('--seed', type=int, default=0)
  ap.add_argument('--device', default=None,
                  help='default: the card; "cpu" for the CPU')
  args = ap.parse_args(argv)

  from glt_tpu_torch.distributed import (RemoteDistSamplingWorkerOptions,
                                         RemoteNeighborLoader,
                                         free_port_base, init_client,
                                         shutdown_client)
  from glt_tpu_torch.models import GraphSAGE
  from glt_tpu_torch.parallel import SageTrainStep
  from glt_tpu_torch.utils import resolve_device

  device = resolve_device(args.device)
  port = args.port or free_port_base(args.num_servers)
  ctx = mp.get_context('spawn')
  readies = [ctx.Event() for _ in range(args.num_servers)]
  # not daemonic: a server spawns its sampling workers
  servers = [ctx.Process(target=run_server, args=(
      r, args.num_servers, port, args.num_nodes, args.seed, str(device),
      readies[r])) for r in range(args.num_servers)]
  for s in servers:
    s.start()
  losses, t0 = [], time.perf_counter()
  try:
    for r, e in enumerate(readies):
      if not e.wait(timeout=300):
        raise RuntimeError(f'server {r} did not come up')
    init_client(args.num_servers, 1, 0, master_port=port)
    try:
      per_server = np.array_split(np.arange(args.num_nodes),
                                  args.num_servers)
      loader = RemoteNeighborLoader(
          [int(f) for f in args.fanout.split(',')], per_server,
          batch_size=args.batch_size, shuffle=True, collect_features=True,
          seed=args.seed, device=device,
          worker_options=RemoteDistSamplingWorkerOptions(
              server_rank=list(range(args.num_servers)),
              prefetch_size=args.prefetch))
      torch.manual_seed(args.seed)
      model = GraphSAGE(100, args.hidden, args.classes,
                        num_layers=args.num_layers).to(device)
      step = SageTrainStep(model, lr=args.lr)
      for epoch in range(args.epochs):
        for i, batch in enumerate(loader):
          if args.max_steps is not None and i >= args.max_steps:
            loader.stop()
            break
          losses.append(float(step(batch)))
        print(f'epoch {epoch}: loss={losses[-1]:.4f}')
    finally:
      shutdown_client()
  finally:
    for s in servers:
      s.join(timeout=60)
      if s.is_alive():
        s.terminate()
        s.join(timeout=10)
  print(f'done: {len(losses)} steps in {time.perf_counter() - t0:.1f} s')
  return dict(losses=losses, port=port,
              exitcodes=[s.exitcode for s in servers])


if __name__ == '__main__':
  main()
