"""The port's side of the partitioned parity tests
(tests/test_torch_dist_hetero.py): the stores, the one-hop, both samplers,
DistFeature lookups, DistHeteroTrainStep runs and gradients of one rank over a
partition layout on disk, and the entry point of a spawned rank of a gloo
group. Imports no JAX, so a spawned rank starts without it."""
import torch

import torch_spmd_worker
from glt_tpu_torch.distributed import (DistDataset, DistFeature, DistGraph,
                                       DistHeteroGraph,
                                       DistHeteroNeighborSampler,
                                       DistHeteroTrainStep,
                                       DistNeighborSampler, make_dist_one_hop)
from glt_tpu_torch.distributed.dist_graph import store_tensors
from glt_tpu_torch.models import RGNN
from glt_tpu_torch.parallel.train import mesh_update

STORE_FIELDS = ('indptr', 'indices', 'edge_ids', 'local_row', 'node_pb')


def _np(x):
  """Tensors (in dicts, lists) as numpy copies (a parameter is updated in
  place later); bf16 widened to float32."""
  if isinstance(x, torch.Tensor):
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy().copy()
  if isinstance(x, dict):
    return {k: _np(v) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return [_np(v) for v in x]
  return x


def _store(st):
  out = {f: _np(getattr(st, f)) for f in STORE_FIELDS}
  out.update(max_rows=st.max_rows, max_edges=st.max_edges,
             max_degree=st.max_degree, num_nodes=st.num_nodes)
  return out


def stores_case(mesh, case):
  """This rank's block of every store: the hetero layout's edge types and
  the homogeneous layout's graph."""
  dg = DistHeteroGraph.from_dataset_partitions(mesh, case['hetero'])
  out = {e: _store(st) for e, st in dg.graphs.items()}
  out['homo'] = _store(DistGraph.from_dataset_partitions(mesh, case['homo']))
  return out


def one_hop_case(mesh, case):
  """One partitioned one-hop over the homogeneous layout, with edge ids."""
  g = DistGraph.from_dataset_partitions(mesh, case['homo'])
  hop = make_dist_one_hop(store_tensors(g, with_edge=True), g.num_nodes,
                          g.num_partitions, g.max_rows, mesh)
  r = mesh.rank
  out = hop(torch.as_tensor(case['ids'][r]), case['fanout'],
            torch.as_tensor(case['u'][r]), torch.as_tensor(case['mask'][r]))
  return _np(out._asdict())


def sample_homo_case(mesh, case):
  g = DistGraph.from_dataset_partitions(mesh, case['homo'])
  s = DistNeighborSampler(g, case['fanouts'])
  return _np(s.sample_from_nodes(case['seeds'], case['n_valid'],
                                 case['u']))


def sample_hetero_case(mesh, case):
  dg = DistHeteroGraph.from_dataset_partitions(mesh, case['hetero'])
  s = DistHeteroNeighborSampler(dg, case['fanouts'])
  out = s.sample_from_nodes(case['seed_type'], case['seeds'],
                            case['n_valid'], case['u'])
  out.pop('input_type')
  return dict(_np(out), shapes=s.uniform_shapes(case['seeds'].shape[1],
                                                case['seed_type']))


def _features(mesh, root, dtype=None, bucket_cap=0):
  ds = {mesh.rank: DistDataset.load(root, mesh.rank, device='cpu')}
  types = ds[mesh.rank].node_features
  return {t: DistFeature.from_dist_datasets(mesh, ds, ntype=t, dtype=dtype,
                                            bucket_cap=bucket_cap)
          for t in types}


def lookup_case(mesh, case):
  dtype = getattr(torch, case['dtype'])
  feats = _features(mesh, case['hetero'], dtype, case['bucket_cap'])
  return {t: _np(f.lookup(case['ids'][t], case['valid'][t]))
          for t, f in feats.items()}


def _trainer(mesh, case):
  """The case's RGNN (its weights if the case gives them) and a
  DistHeteroTrainStep over the case's layout."""
  root = case['hetero']
  dg = DistHeteroGraph.from_dataset_partitions(mesh, root)
  feats = _features(mesh, root)
  keys = DistHeteroNeighborSampler(dg, case['fanouts']).message_passing_types(
      case['bs'], 'paper')
  model = RGNN(keys, case['in_dim'], case['hidden'], case['classes'],
               num_layers=len(case['fanouts']), conv=case['conv'],
               heads=case['heads'], node_types=list(dg.node_counts))
  if 'params' in case:
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in case['params'].items()})
  step = DistHeteroTrainStep(dg, feats, model, {'paper': case['labels']},
                             case['fanouts'], case['bs'], 'paper',
                             lr=case['lr'])
  return model, step


def train_case(mesh, case):
  """Per-batch steps, an eval step and a superstep, in the case's order,
  from the case's weights; the losses, the eval counts and the parameters
  after each call."""
  model, step = _trainer(mesh, case)
  out = []
  for call in case['calls']:
    args = (call['seeds'], call['n_valid'], call['u'])
    if call['kind'] == 'eval':
      res = step.eval_step(*args)
    elif call['kind'] == 'superstep':
      res = _np(step.superstep(*args))
    else:
      res = _np(step(*args))
    out.append(dict(result=res, params=_np(model.state_dict())))
  return out


def grads_case(mesh, case):
  """Per call, the mesh's mean gradient of the call's batch at the call's
  weights: the step's own update with an optimizer that moves nothing."""
  model, step = _trainer(mesh, case)
  still = torch.optim.SGD(model.parameters(), lr=0.0)
  out = []
  for call in case['calls']:
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in call['params'].items()})
    batch = step.make_batch(*step._one(call['seeds'], call['n_valid'],
                                       call['u']))
    mesh_update(model, still, mesh, batch)
    out.append({n: _np(p.grad) for n, p in model.named_parameters()})
  return out


def run_cases(mesh, cases):
  """Every case for this rank: ``{name: result}``."""
  fns = dict(stores=stores_case, one_hop=one_hop_case,
             sample_homo=sample_homo_case, sample_hetero=sample_hetero_case,
             lookup=lookup_case, train=train_case,
             grads=grads_case)
  return {name: fns[case['kind']](mesh, case)
          for name, case in cases.items()}


def main(rank, world, store_path, in_path, out_path):
  """A spawned rank of this module's cases."""
  torch_spmd_worker.run_rank(run_cases, rank, world, store_path, in_path,
                             out_path)



# -- on a card ---------------------------------------------------------------

CARD_DIM, CARD_CLASSES = 24, 5


def card_layout(root, world, seed=4):
  """A small IGBH-shaped layout of ``world`` parts at ``root`` (the port's
  partitioner) and its paper labels."""
  import numpy as np
  from glt_tpu_torch.partition import RandomPartitioner
  rng = np.random.default_rng(seed)
  p, a, i = 4000, 2000, 80
  ei = {('paper', 'cites', 'paper'): np.stack(
            [rng.integers(0, p, 10 * p), rng.integers(0, p, 10 * p)]),
        ('author', 'writes', 'paper'): np.stack(
            [rng.integers(0, a, 3 * p), rng.integers(0, p, 3 * p)]),
        ('author', 'affiliated', 'institute'): np.stack(
            [np.arange(a), rng.integers(0, i, a)])}
  for (s, r, d), e in list(ei.items()):
    if s != d:
      ei[(d, f'rev_{r}', s)] = e[::-1].copy()
  nodes = {'paper': p, 'author': a, 'institute': i}
  feats = {t: rng.normal(size=(n, CARD_DIM)).astype('float32')
           for t, n in nodes.items()}
  RandomPartitioner(root, num_parts=world, num_nodes=nodes, edge_index=ei,
                    node_feat=feats, seed=seed).partition()
  return rng.integers(0, CARD_CLASSES, p).astype('int32')


def card_dist_windows(mesh, root, labels, bs=16, fanouts=(4, 3, 2), k=3,
                      seed=0):
  """On the rank's card over ``root``: one batch through the kernels and
  through their plain versions (the fields that differ, and how many of
  its requests an other rank served), then two windows of ``k`` through
  one trainer's superstep (the first captured, the second a replay) and
  through a twin's per-batch calls on the same uniforms. Returns both
  losses, the largest parameter difference, the captures, replays, the
  launches the replays made and the per-batch launches."""
  import numpy as np
  from glt_tpu_torch.ops import cuda_kernels as K
  dev = mesh.device
  dg = DistHeteroGraph.from_dataset_partitions(mesh, root)
  ds = {mesh.rank: DistDataset.load(root, mesh.rank, device=dev,
                                      feature_dtype=torch.bfloat16)}
  feats = {t: DistFeature.from_dist_datasets(mesh, ds, ntype=t)
           for t in dg.node_counts}
  sampler = DistHeteroNeighborSampler(dg, list(fanouts))
  keys = sampler.message_passing_types(bs, 'paper')
  shapes = sampler.uniform_shapes(bs, 'paper')
  steps = []
  for _ in range(2):
    torch.manual_seed(0)
    model = RGNN(keys, CARD_DIM, 16, CARD_CLASSES, num_layers=len(fanouts),
                 conv='rgat', heads=2, node_types=list(dg.node_counts))
    steps.append(DistHeteroTrainStep(dg, feats, model.to(dev),
                                     {'paper': labels}, list(fanouts), bs,
                                     'paper', lr=1e-3))
  a, b = steps
  rng = np.random.default_rng(seed)
  gen = torch.Generator().manual_seed(seed)
  n, world = dg.node_counts['paper'], mesh.world

  def draw(lead):
    return [[torch.rand(lead + s, generator=gen) for s in hop]
            for hop in shapes]
  seeds = rng.integers(0, n, (world, bs))
  args = a._one(seeds, np.full(world, bs), draw((world,)))
  K.reset_launch_counts()
  with torch.no_grad():
    bk = a.make_batch(*args)
    launches = {fn.__name__: fn.launches for fn in K.KERNELS}
    plain = {name: getattr(K, name) for name in ('sample_hop', 'gather_rows')}
    try:
      for name in plain:
        setattr(K, name, getattr(K, name + '_plain'))
      bp = a.make_batch(*args)
    finally:
      for name, fn in plain.items():
        setattr(K, name, fn)
  differ = [f for f in ('node_dict', 'node_count_dict', 'row_dict',
                        'col_dict', 'edge_mask_dict', 'x_dict', 'y_dict')
            if any(not torch.equal(getattr(bk, f)[t], getattr(bp, f)[t])
                   for t in getattr(bk, f))]
  remote = sum(int(((feats[t].feat_pb[node.clamp(min=0).long()] != mesh.rank)
                    & (torch.arange(node.numel(), device=dev)
                       < bk.node_count_dict[t])).sum())
               for t, node in bk.node_dict.items())
  got, want = [], []
  for _ in range(2):
    seeds = rng.integers(0, n, (k, world * bs))
    nv = np.full((k, world), bs)
    nv[-1, -1] = bs - 3
    u = draw((k, world))
    got.append(a.superstep(seeds, nv, u).cpu())
    want.append(torch.stack([b(seeds[t], nv[t], [[x[t] for x in hop]
                                                for hop in u])
                             for t in range(k)]).cpu())
  diff = max(float((p - q).detach().abs().max()) for p, q in
             zip(a.model.parameters(), b.model.parameters()))
  return dict(got=torch.cat(got).numpy(), want=torch.cat(want).numpy(),
              param_diff=diff, captures=a.superstep_captures,
              replays=a.graph_replays, replayed=a.graph_launches(),
              batch_launches=launches, differ=differ, remote=remote,
              segments=sum(len(h) for h in shapes))


def dist_nccl_main(rank, world, store_path, root, labels_path, out_path):
  """A spawned rank on card ``rank`` of an NCCL group: card_dist_windows
  over the layout at ``root``; results pickled to ``out_path % rank``."""
  import pickle
  import numpy as np
  import torch.distributed as dist
  from glt_tpu_torch.parallel import make_mesh
  torch.cuda.set_device(rank)
  dist.init_process_group('nccl', store=dist.FileStore(store_path, world),
                          rank=rank, world_size=world)
  try:
    res = card_dist_windows(make_mesh(device=torch.device('cuda', rank)),
                            root, np.load(labels_path))
    with open(out_path % rank, 'wb') as f:
      pickle.dump(res, f)
  finally:
    dist.destroy_process_group()
