"""The port's side of the data-parallel parity tests
(tests/test_torch_spmd.py): the ShardedFeature lookups and the
SPMDSageTrainStep runs of one rank, and the entry point of a spawned
rank of a gloo group. Imports no JAX, so a spawned rank starts without
it."""
import numpy as np
import torch
import torch.distributed as dist

from glt_tpu_torch.data import Dataset
from glt_tpu_torch.models import GraphSAGE
from glt_tpu_torch.parallel import (ShardedFeature, SPMDSageTrainStep,
                                    make_mesh)

STORE_KW = ('split_ratio', 'bucket_cap', 'host_offload')


def lookup_case(mesh, case):
  """This rank's block of ``ShardedFeature.lookup``."""
  sf = ShardedFeature(case['feats'], mesh,
                      **{k: case[k] for k in STORE_KW if k in case})
  return sf.lookup(case['ids'], case['valid']).numpy()


def train_case(mesh, case):
  """Two supersteps and, unless the store streams, one per-batch step
  from the case's carried-over weights; returns the losses of each call
  and the final parameters."""
  g = Dataset().init_graph(case['edge_index'], num_nodes=case['num_nodes'],
                           device='cpu').get_graph()
  model = GraphSAGE(case['feats'].shape[1], case['hidden'],
                    case['classes'], num_layers=len(case['fanouts']))
  model.load_state_dict({k: torch.as_tensor(v)
                         for k, v in case['params'].items()})
  sf = ShardedFeature(case['feats'], mesh,
                      **{k: case[k] for k in STORE_KW if k in case})
  step = SPMDSageTrainStep(
      mesh, model, g, sf, case['labels'], case['fanouts'], case['bs'],
      lr=case['lr'], with_edge=case['with_edge'],
      cold_streaming=case['cold_streaming'])
  out = {}
  for i, call in enumerate(case['calls']):
    if call['kind'] == 'superstep':
      loss = step.superstep(call['seeds'], call['n_valid'], call['u'])
    else:
      loss = step(call['seeds'], call['n_valid'], call['u'])
    out[f'loss{i}'] = loss.numpy()
  for k, v in model.state_dict().items():
    out[f'param:{k}'] = v.numpy()
  return out


def stage_case(mesh, case):
  """``ShardedFeature.stage_cold_rows`` of the case's node stacks."""
  sf = ShardedFeature(case['feats'], mesh,
                      **{k: case[k] for k in STORE_KW if k in case})
  return sf.stage_cold_rows(case['nodes'], case['counts'])


def run_cases(mesh, cases):
  """Every case for this rank: ``{name: result}``."""
  fns = dict(lookup=lookup_case, stage=stage_case, train=train_case)
  return {name: fns[case['kind']](mesh, case)
          for name, case in cases.items()}


def run_rank(run, rank, world, store_path, in_path, out_path):
  """A spawned rank: joins the gloo group over the FileStore, runs
  ``run(mesh, cases)`` on the cases of ``in_path`` (a pickled dict) and
  pickles its results to ``out_path % rank``."""
  import pickle
  dist.init_process_group('gloo', store=dist.FileStore(store_path, world),
                          rank=rank, world_size=world)
  try:
    with open(in_path, 'rb') as f:
      cases = pickle.load(f)
    torch.set_num_threads(1)
    res = run(make_mesh(device='cpu'), cases)
    with open(out_path % rank, 'wb') as f:
      pickle.dump(res, f)
  finally:
    dist.destroy_process_group()


def main(rank, world, store_path, in_path, out_path):
  """A spawned rank of this module's cases (:func:`run_rank`)."""
  run_rank(run_cases, rank, world, store_path, in_path, out_path)


def spawn_ranks(target, world, cases, tmp, join_s):
  """Run ``target(rank, world, store, cases_path, out_path)`` in
  ``world`` spawned ranks; their results by rank. A rank that hangs is
  killed at ``join_s`` seconds and fails the caller."""
  import os
  import pickle
  inp = os.path.join(tmp, 'cases.pkl')
  with open(inp, 'wb') as f:
    pickle.dump(cases, f)
  out = os.path.join(tmp, 'rank%d.pkl')
  ctx = torch.multiprocessing.get_context('spawn')
  procs = [ctx.Process(target=target,
                       args=(r, world, os.path.join(tmp, 'store'), inp, out))
           for r in range(world)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(join_s)
  hung = [p for p in procs if p.is_alive()]
  for p in hung:
    p.kill()
    p.join(10)
  assert not hung, f'{len(hung)} ranks still running after {join_s} s'
  assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
  res = []
  for r in range(world):
    with open(out % r, 'rb') as f:
      res.append(pickle.load(f))
  return res


def card_windows(mesh, n=2000, e=30_000, seed=5, **kw):
  """On the rank's card: two windows of K = 4 through one trainer's
  superstep over the store ``kw`` names (the first runs eagerly and is
  captured, the second replays), and the same eight batches through the
  per-batch calls of a twin over the resident store, on the same
  uniforms. Returns both losses, the largest parameter difference, and
  the first trainer's captures, replays and the launches its replays
  made."""
  dev, world, bs, fanouts, k = mesh.device, mesh.world, 32, [5, 3], 4
  rng = np.random.default_rng(seed)
  ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
  feats = rng.normal(size=(n, 16)).astype(np.float32)
  labels = rng.integers(0, 5, n).astype(np.int32)
  g = Dataset().init_graph(ei, num_nodes=n, device=dev).get_graph()
  skw = {k_: v for k_, v in kw.items() if k_ in STORE_KW}
  tkw = {k_: v for k_, v in kw.items() if k_ not in STORE_KW}
  steps = []
  for store, train in ((skw, tkw), ({}, {})):
    torch.manual_seed(0)
    model = GraphSAGE(16, 32, 5, num_layers=2).to(dev)
    steps.append(SPMDSageTrainStep(
        mesh, model, g, ShardedFeature(feats, mesh, **store), labels,
        fanouts, bs, **train))
  a, b = steps
  gen = torch.Generator().manual_seed(seed)
  got, want = [], []
  for _ in range(2):
    seeds = rng.integers(0, n, (k, world * bs))
    nv = np.full((k, world), bs)
    nv[-1, -1] = bs - 3
    u = [torch.rand((k, world, s, f), generator=gen)
         for s, f in ((bs, 5), (bs * 5, 3))]
    got.append(a.superstep(seeds, nv, u).cpu())
    want.append(torch.stack([b(seeds[t], nv[t], [x[t] for x in u])
                             for t in range(k)]).cpu())
  diff = max(float((p - q).detach().abs().max()) for p, q in
             zip(a.model.parameters(), b.model.parameters()))
  return dict(got=torch.cat(got).numpy(), want=torch.cat(want).numpy(),
              param_diff=diff, captures=a.superstep_captures,
              replays=a.graph_replays, replayed=a.graph_launches())


def nccl_main(rank, world, store_path, out_path):
  """A spawned rank on card ``rank`` of an NCCL group: :func:`card_windows`
  resident, then with a capped exchange; results pickled to ``out_path %
  rank``."""
  import pickle
  torch.cuda.set_device(rank)
  dist.init_process_group('nccl', store=dist.FileStore(store_path, world),
                          rank=rank, world_size=world)
  try:
    mesh = make_mesh(device=torch.device('cuda', rank))
    res = dict(resident=card_windows(mesh),
               capped=card_windows(mesh, bucket_cap=100))
    with open(out_path % rank, 'wb') as f:
      pickle.dump(res, f)
  finally:
    dist.destroy_process_group()
