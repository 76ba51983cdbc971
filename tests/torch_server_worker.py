"""The port's side of the server-client tests
(tests/test_torch_server_client.py, tests/test_torch_channel.py): the ring
fixture built by the port, the picklable dataset builder sampling workers
call, and the entry points of spawned port servers and channel peers.
Imports no JAX, so a spawned process starts without it."""
import numpy as np
import torch


def ring_dataset(num_nodes: int = 40, feat_dim: int = 4,
                 edge_feat_dim: int = 4, device='cpu'):
  """tests/fixtures.py's ring (node v -> (v+1) % n and (v+2) % n, edge
  id 2v + k - 1, feature row i == [i] * dim, edge row e == [e] * dim,
  labels i % 4) built by the port, with the JAX test's node split."""
  from glt_tpu_torch.data import Dataset
  v = np.arange(num_nodes, dtype=np.int64)
  rows = np.repeat(v, 2)
  cols = np.stack([(v + 1) % num_nodes, (v + 2) % num_nodes],
                  1).reshape(-1)
  eids = np.stack([2 * v, 2 * v + 1], 1).reshape(-1)
  ds = Dataset(edge_dir='out')
  ds.init_graph(np.stack([rows, cols]), edge_ids=eids, num_nodes=num_nodes,
                device=device)
  ds.init_node_features(np.tile(np.arange(num_nodes, dtype=np.float32)[
      :, None], (1, feat_dim)), device=device)
  ds.init_edge_features(np.tile(np.arange(2 * num_nodes, dtype=np.float32)[
      :, None], (1, edge_feat_dim)), device=device)
  ds.init_node_labels(np.arange(num_nodes, dtype=np.int32) % 4)
  ds.random_node_split(num_val=0.25, num_test=0.25, seed=3)
  return ds


def build_ring_dataset():
  """The dataset builder a sampling worker calls (module level, so it
  pickles by name)."""
  torch.set_num_threads(1)
  return ring_dataset()


def held_ring_dataset(hold_s: float):
  """``build_ring_dataset`` after ``hold_s`` seconds: a sampling worker
  that starts late, as a freshly spawned one does on a loaded machine."""
  import time
  time.sleep(hold_s)
  return build_ring_dataset()


def server_main(rank, num_servers, port, ready, done, hold_s=0.0):
  """A spawned port server over the ring: serves until a client's exit.
  With ``hold_s`` its sampling workers start that many seconds late."""
  import functools
  from glt_tpu_torch.distributed import init_server, wait_and_shutdown_server
  torch.set_num_threads(1)
  builder = (functools.partial(held_ring_dataset, hold_s) if hold_s
             else build_ring_dataset)
  init_server(num_servers=num_servers, num_clients=1, server_rank=rank,
              dataset=ring_dataset(), master_port=port,
              dataset_builder=builder, device='cpu')
  ready.set()
  wait_and_shutdown_server(poll_s=0.05)
  done.set()


def producer_main(chan, n):
  """Sends ``n`` numbered messages over ``chan`` (a ShmChannel)."""
  for i in range(n):
    chan.send({'i': torch.tensor([i]),
               'payload': torch.full((8,), float(i))})
