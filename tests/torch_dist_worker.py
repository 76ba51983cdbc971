"""The port's side of the partitioned parity tests
(tests/test_torch_dist_hetero.py, tests/test_torch_dist_homo.py,
tests/test_torch_dist_link.py, tests/test_torch_dist_host_phase.py,
tests/test_torch_dist_weighted.py and tests/test_torch_hot_cache.py):
the stores, the one-hop, both samplers, DistFeature lookups (node, edge
and spilled stores, and the host phase over the rpc fabric), the loaders,
DistHeteroTrainStep and DistTrainStep runs and gradients of one rank over a
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


def _features(mesh, root, dtype=None, bucket_cap=0, split_ratio=None):
  ds = {mesh.rank: DistDataset.load(root, mesh.rank, device='cpu')}
  types = ds[mesh.rank].node_features
  return {t: DistFeature.from_dist_datasets(mesh, ds, ntype=t, dtype=dtype,
                                            bucket_cap=bucket_cap,
                                            split_ratio=split_ratio)
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
  feats = _features(mesh, root, split_ratio=case.get('split_ratio'))
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


def split_super_case(mesh, case):
  """Over the case's spilled stores: a window as one superstep, an eval
  step, and each per-batch step's loss and parameters; over resident
  twins the same batches a batch a step and the eval."""
  a = _trainer(mesh, case)[1]
  b = _trainer(mesh, dict(case, split_ratio=None))[1]
  c = _trainer(mesh, case)[1]
  w = case['window']
  calls = [(w['seeds'][t], w['n_valid'][t],
            [[x[t] for x in hop] for hop in w['u']])
           for t in range(w['seeds'].shape[0])]
  super_losses = _np(a.superstep(w['seeds'], w['n_valid'], w['u']))
  split_losses = [_np(c(*call)) for call in calls]
  resident_losses = [_np(b(*call)) for call in calls]
  ev = case['eval']
  evals = [s.eval_step(ev['seeds'], ev['n_valid'], ev['u'])
           for s in (a, b)]
  return dict(spilled={t: f.cold_array is not None
                       for t, f in a.features.items()},
              super=super_losses, split=split_losses,
              resident=resident_losses, evals=evals,
              params=[_np(s.model.state_dict()) for s in (a, c, b)])


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


# -- the homogeneous slice (tests/test_torch_dist_homo.py and
# tests/test_torch_dist_link.py) ----------------------------------------------

def _homo_stores(mesh, case, kind='node', split_ratio=None, bucket_cap=0,
                 host_offload=None):
  ds = {mesh.rank: DistDataset.load(case['root'], mesh.rank, device='cpu')}
  return DistFeature.from_dist_datasets(mesh, ds, kind=kind,
                                        split_ratio=split_ratio,
                                        bucket_cap=bucket_cap,
                                        host_offload=host_offload)


def host_phase_case(mesh, case):
  """Host-phase stores (``host_offload=False``) of this rank's partition
  at each of the case's ``(split_ratio, bucket_cap)``, the other rank's
  cold rows fetched over the port's rpc fabric (``init_rpc`` at the
  case's master port, the owner's ``cold_get`` registered): this rank's
  block of each lookup, and what the fabric's collectives returned."""
  from glt_tpu_torch.distributed import (RpcDataPartitionRouter, barrier,
                                         global_all_gather, init_rpc,
                                         rpc_register, rpc_request,
                                         rpc_sync_data_partitions,
                                         shutdown_rpc)
  init_rpc('127.0.0.1', case['master_port'], rank=mesh.rank,
           world_size=mesh.world)
  try:
    stores = {name: _homo_stores(mesh, case, 'node', split, cap,
                                 host_offload=False)
              for name, (split, cap) in case['stores'].items()}
    fetched = {name: 0 for name in stores}

    def fetcher(name):
      def fetch(p, ids):
        fetched[name] += len(ids)
        return rpc_request(p, f'cold_get:{name}', p, ids)
      return fetch
    for name, st in stores.items():
      rpc_register(f'cold_get:{name}', st.cold_get)
      st.set_cold_fetcher(fetcher(name))
    barrier()       # every rank's callees are registered
    out = {name: dict(rows=_np(st.lookup(case['ids'], case['valid'])),
                      host_spilled=st.host_spilled, hot=st.hot_count,
                      fetched=fetched[name])
           for name, st in stores.items()}
    p2w = rpc_sync_data_partitions([mesh.rank])
    router = RpcDataPartitionRouter(p2w)
    out['fabric'] = dict(
        p2w=p2w, gathered=global_all_gather(mesh.rank * 10),
        routed=[router.get_to_worker(p) for p in range(mesh.world)])
  finally:
    shutdown_rpc()   # a global barrier first: no rank leaves early
  return out


def _inject(sampler, draws):
  """Feed ``sampler.sample_from_nodes`` the recorded draws of its calls,
  in order (the JAX sampler's, one a call)."""
  it = iter(draws)
  real = sampler.sample_from_nodes
  sampler.sample_from_nodes = lambda seeds, n_valid=None, uniforms=None: \
      real(seeds, n_valid, next(it))


def edge_sample_case(mesh, case):
  """The homogeneous sampler with edge ids."""
  g = DistGraph.from_dataset_partitions(mesh, case['root'])
  s = DistNeighborSampler(g, case['fanouts'], with_edge=True)
  return _batch_np(s.sample_from_nodes(case['seeds'], case['n_valid'],
                                       case['u']))


def store_lookup_case(mesh, case):
  """A lookup through each store the case names: ``(kind, split_ratio,
  bucket_cap)``; each result and, for a spilled store, whether its cold
  block is the CPU tensor its serve reads."""
  out = {}
  for name, (kind, split, cap) in case['stores'].items():
    st = _homo_stores(mesh, case, kind, split, cap)
    out[name] = dict(rows=_np(st.lookup(case['ids'][kind],
                                        case['valid'][kind])),
                     spilled=st.cold_array is not None,
                     hot=st.hot_count)
  return out


def _batch_np(out):
  return {k: _np(v) for k, v in out.items() if k != 'edge_hop_offsets'}


def dist_loader_case(mesh, case):
  """Two epochs of a DistNeighborLoader with node and edge stores and
  labels, its sampler fed the recorded draws."""
  import numpy as np
  from glt_tpu_torch.distributed import DistNeighborLoader
  g = DistGraph.from_dataset_partitions(mesh, case['root'])
  loader = DistNeighborLoader(
      g, case['fanouts'], case['input_nodes'],
      dist_feature=_homo_stores(mesh, case),
      labels=case['labels'], batch_size=case['bs'], shuffle=True,
      rng=np.random.default_rng(case['rng']),
      edge_feature=_homo_stores(mesh, case, 'edge'))
  _inject(loader.sampler, case['u'])
  return [_batch_np(b) for _ in range(case['epochs']) for b in loader]


def subgraph_case(mesh, case):
  """A DistSubGraphLoader epoch, both samplers fed the recorded draws."""
  import numpy as np
  from glt_tpu_torch.distributed import DistSubGraphLoader
  g = DistGraph.from_dataset_partitions(mesh, case['root'])
  loader = DistSubGraphLoader(
      g, case['hops'], case['input_nodes'], max_degree=case['max_degree'],
      dist_feature=_homo_stores(mesh, case), batch_size=case['bs'],
      shuffle=True, rng=np.random.default_rng(case['rng']),
      edge_feature=_homo_stores(mesh, case, 'edge'))
  _inject(loader.sampler, case['u'])
  _inject(loader.extractor, case['u_extract'])
  return [_batch_np(b) for b in loader]


def link_case(mesh, case):
  """A DistLinkNeighborLoader epoch, its sampler fed the recorded draws and
  its strict negatives the recorded proposals (this rank's)."""
  import numpy as np
  from glt_tpu_torch.distributed import DistLinkNeighborLoader
  from glt_tpu_torch.sampler import NegativeSampling
  g = DistGraph.from_dataset_partitions(mesh, case['root'])
  loader = DistLinkNeighborLoader(
      g, case['fanouts'], case['pools'],
      dist_feature=_homo_stores(mesh, case),
      neg_sampling=NegativeSampling(*case['neg']),
      batch_size=case['bs'], shuffle=True, seed=case['seed'],
      edge_feature=_homo_stores(mesh, case, 'edge'))
  _inject(loader.sampler, case['u'])
  if loader.strict_neg is not None:
    props = iter(case['props'])
    neg = loader.strict_neg
    real_sample, real_dst = neg.sample, neg.sample_dst
    neg.sample = lambda n, proposals=None: real_sample(
        n, [p[mesh.rank] for p in next(props)])
    neg.sample_dst = lambda src, proposals=None: real_dst(
        src, next(props)[1][mesh.rank])
  return [_batch_np(b) for b in loader]


def negative_case(mesh, case):
  """DistRandomNegativeSampler.sample and sample_dst on given proposals."""
  from glt_tpu_torch.distributed import DistRandomNegativeSampler
  g = DistGraph.from_dataset_partitions(mesh, case['root'],
                                        edge_dir=case['edge_dir'])
  s = DistRandomNegativeSampler(g, trials_num=case['trials'],
                                padding=case['padding'])
  r = mesh.rank
  free = s.sample(case['req'], [p[r] for p in case['props']])
  dst = s.sample_dst(case['src'][r], case['dst_props'][r])
  return dict(free=_np(free._asdict()), dst=_np(dst._asdict()))


class EdgeSumProbe(torch.nn.Module):
  """Logits from the node features and the sum of each node's incoming
  edge features (the JAX suite's ``_EdgeSumModel``): its gradients reach
  the edge-feature weights only if ``edge_attr`` arrives."""

  def __init__(self, in_dim, edge_dim, classes):
    super().__init__()
    self.lin = torch.nn.Linear(in_dim + edge_dim, classes)

  def forward(self, batch):
    n = batch.node.numel()
    m = batch.edge_mask
    seg = torch.where(m, batch.col.long().clamp(0, n - 1), n)
    ea = torch.where(m[:, None], batch.edge_attr,
                     torch.zeros_like(batch.edge_attr))
    agg = ea.new_zeros((n + 1, ea.shape[1])).index_add_(0, seg, ea)[:n]
    return self.lin(torch.cat([batch.x, agg], -1))[:batch.batch_size]


def homo_model(case):
  from glt_tpu_torch.models import GraphSAGE
  if case['model'] == 'probe':
    return EdgeSumProbe(case['in_dim'], case['edge_dim'], case['classes'])
  return GraphSAGE(case['in_dim'], case['hidden'], case['classes'],
                   num_layers=len(case['fanouts']))


def dist_train_case(mesh, case):
  """DistTrainStep from the case's weights over its calls: the losses and
  the parameters after each."""
  from glt_tpu_torch.distributed import DistTrainStep
  g = DistGraph.from_dataset_partitions(mesh, case['root'])
  model = homo_model(case)
  model.load_state_dict({k: torch.as_tensor(v)
                         for k, v in case['params'].items()})
  ef = (_homo_stores(mesh, case, 'edge') if case['model'] == 'probe'
        else None)
  step = DistTrainStep(g, _homo_stores(mesh, case,
                                       split_ratio=case['split_ratio']),
                       model, case['labels'], case['fanouts'], case['bs'],
                       lr=case['lr'], edge_feature=ef)
  out = []
  for call in case['calls']:
    loss = _np(step(call['seeds'], call['n_valid'], call['u']))
    out.append(dict(result=loss, params=_np(model.state_dict())))
  return out


# every node has DET_DEGREE out-edges (at most), no more than the smallest
# fanout, so every hop takes each row whole and a batch's sample does not
# depend on the draws: two ranks over two parts train as one rank over one
# part on the two seed blocks together
DET_NODES, DET_DEGREE, DET_DIM, DET_CLASSES = 400, 3, 12, 4
DET_FANOUTS, DET_BS, DET_STEPS = [3, 3], 16, 3


def run_on_threads(fns, join_s=60):
  """``fns[r]()`` for each rank r on a thread of this process, each joined
  within ``join_s``; their results, or a RuntimeError if a rank raised or
  did not finish."""
  import threading
  out, errs = [None] * len(fns), []

  def run(r):
    try:
      out[r] = fns[r]()
    except Exception as e:  # noqa: BLE001 -- raised below
      errs.append(e)
  threads = [threading.Thread(target=run, args=(r,), daemon=True)
             for r in range(len(fns))]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=join_s)
  if errs or any(t.is_alive() for t in threads):
    raise RuntimeError(f'a rank failed or did not finish: {errs}')
  return out


def partition_on_threads(makers, join_s=60):
  """One partitioner a rank (``makers[r]()`` builds rank r's), each
  partitioning on a thread of this process (``run_on_threads``); every
  server is stopped after. Returns the partitioners."""
  parts = [None] * len(makers)

  def run(r):
    parts[r] = makers[r]()
    parts[r].partition()
  try:
    run_on_threads([lambda r=r: run(r) for r in range(len(makers))], join_s)
  finally:
    for p in parts:
      if p is not None:
        p.shutdown()
  return parts


def online_partition(root, world, ei, feats, seed=0, join_s=60):
  """``ei`` and ``feats`` partitioned at ``root`` by ``world``
  DistTableRandomPartitioner ranks over loopback rpc
  (``partition_on_threads``), rank r reading the r-th contiguous block of
  the edge table (its edge ids their positions) and of the node table."""
  import numpy as np
  from glt_tpu_torch.distributed import (DistTableRandomPartitioner,
                                         free_port_base)
  base = free_port_base(world)
  e_sl = np.array_split(np.arange(ei.shape[1]), world)
  n_sl = np.array_split(np.arange(feats.shape[0]), world)
  partition_on_threads([
      (lambda r=r: DistTableRandomPartitioner(
          root, rank=r, world_size=world, num_nodes=feats.shape[0],
          edge_reader=[(ei[0][e_sl[r]], ei[1][e_sl[r]])],
          node_reader=[(n_sl[r], feats[n_sl[r]])],
          edge_id_offset=int(e_sl[r][0]), master_port=base, seed=seed))
      for r in range(world)], join_s)


def det_layout(root, world, seed=3, cache_ratio=None, online=False):
  """The draw-independent graph at ``root`` in ``world`` parts (the
  port's RandomPartitioner; given ``cache_ratio``, its
  FrequencyPartitioner over each part's share of the nodes pushed through
  ``sample_prob``; with ``online``, ``world`` DistTableRandomPartitioner
  ranks over rpc); returns its labels."""
  import numpy as np
  from glt_tpu_torch.partition import FrequencyPartitioner, RandomPartitioner
  rng = np.random.default_rng(seed)
  n = DET_NODES
  src = np.repeat(np.arange(n), DET_DEGREE)
  dst = np.stack([(np.arange(n) + 1) % n] + [rng.integers(0, n, n)
                                             for _ in range(DET_DEGREE - 1)],
                 1).reshape(-1)
  feats = rng.normal(size=(n, DET_DIM)).astype('float32')
  ei = np.stack([src, dst])
  if online:
    online_partition(root, world, ei, feats, seed=seed)
  elif cache_ratio is None:
    RandomPartitioner(root, num_parts=world, num_nodes=n, edge_index=ei,
                      node_feat=feats, seed=seed).partition()
  else:
    from glt_tpu_torch.data import Dataset
    from glt_tpu_torch.sampler import NeighborSampler
    s = NeighborSampler(Dataset().init_graph(ei, num_nodes=n,
                                             device='cpu').graph,
                        DET_FANOUTS, device='cpu')
    probs = np.stack([s.sample_prob(part, n).numpy() for part in
                      np.array_split(np.random.default_rng(seed + 1)
                                     .permutation(n), world)])
    FrequencyPartitioner(root, num_parts=world, num_nodes=n, edge_index=ei,
                         node_feat=feats, probs=probs,
                         cache_ratio=cache_ratio).partition()
  return rng.integers(0, DET_CLASSES, n).astype('int32')


def det_seeds(world, seed=4):
  """Per step ``[world, DET_BS]`` seeds, distinct within a step (a batch
  dedups its seeds, so a seed in both blocks would leave the one-rank
  batch one seed short)."""
  import numpy as np
  rng = np.random.default_rng(seed)
  return np.stack([rng.permutation(DET_NODES)[:world * DET_BS].reshape(
      world, DET_BS) for _ in range(DET_STEPS)])


def det_train(mesh, root, labels, seeds, count=False):
  """DistTrainStep over the layout at ``root`` on ``seeds [T, world, B]``
  (every rank passes all of them): the losses and the final weights and,
  with ``count``, the ids this rank's feature exchanges asked for
  (``asked``) and sent to another rank (``sent``), this rank's cached ids
  and its feature and graph books."""
  import numpy as np
  from glt_tpu_torch.distributed import DistTrainStep, dist_feature
  from glt_tpu_torch.models import GraphSAGE
  g = DistGraph.from_dataset_partitions(mesh, root)
  dset = DistDataset.load(root, mesh.rank, device=mesh.device)
  df = DistFeature.from_dist_datasets(mesh, {mesh.rank: dset})
  torch.manual_seed(0)
  model = GraphSAGE(DET_DIM, 16, DET_CLASSES, num_layers=2).to(mesh.device)
  bs = seeds.shape[-1]
  step = DistTrainStep(g, df, model, labels, DET_FANOUTS, bs)
  asked, sent = [], []
  real = dist_feature.exchange_lookup

  def counting(ids, owner, mesh_, *a, **k):
    asked.append(_np(ids[owner < mesh_.world]))
    sent.append(_np(ids[(owner != mesh_.rank) & (owner < mesh_.world)]))
    return real(ids, owner, mesh_, *a, **k)
  if count:
    dist_feature.exchange_lookup = counting
  try:
    losses = [float(step(s, np.full(mesh.world, bs))) for s in seeds]
  finally:
    dist_feature.exchange_lookup = real
  out = dict(losses=losses, params=_np(model.state_dict()))
  if count:
    book, graph_book = dset.get_node_feat_pb().table, dset.get_node_pb().table
    out.update(asked=np.concatenate(asked), sent=np.concatenate(sent),
               cached=np.nonzero(book != graph_book)[0], book=book,
               graph_book=graph_book)
  return out


def det_case(mesh, case):
  return det_train(mesh, case['root'], case['labels'], case['seeds'])


def dist_homo_nccl_main(rank, world, store_path, root, labels_path,
                        seeds_path, out_path, count=False):
  """A spawned rank on card ``rank`` of an NCCL group: det_train over the
  layout at ``root`` (counting its exchanges' ids with ``count``);
  results pickled to ``out_path % rank``."""
  import pickle
  import numpy as np
  import torch.distributed as dist
  from glt_tpu_torch.parallel import make_mesh
  torch.cuda.set_device(rank)
  dist.init_process_group('nccl', store=dist.FileStore(store_path, world),
                          rank=rank, world_size=world)
  try:
    res = det_train(make_mesh(device=torch.device('cuda', rank)), root,
                    np.load(labels_path), np.load(seeds_path), count=count)
    with open(out_path % rank, 'wb') as f:
      pickle.dump(res, f)
  finally:
    dist.destroy_process_group()


def run_cases(mesh, cases):
  """Every case for this rank: ``{name: result}``."""
  fns = dict(stores=stores_case, one_hop=one_hop_case,
             sample_homo=sample_homo_case, sample_hetero=sample_hetero_case,
             lookup=lookup_case, train=train_case,
             grads=grads_case, edge_sample=edge_sample_case,
             store_lookup=store_lookup_case, dist_loader=dist_loader_case,
             subgraph=subgraph_case, link=link_case, negative=negative_case,
             dist_train=dist_train_case, det=det_case,
             host_phase=host_phase_case, wsample_homo=wsample_homo_case,
             wsample_hetero=wsample_hetero_case, wtrain=wtrain_case,
             wsuper=wsuper_case, cache_lookup=cache_lookup_case,
             split_super=split_super_case)
  return {name: fns[case['kind']](mesh, case)
          for name, case in cases.items()}


def main(rank, world, store_path, in_path, out_path):
  """A spawned rank of this module's cases."""
  torch_spmd_worker.run_rank(run_cases, rank, world, store_path, in_path,
                             out_path)



# -- weighted, full and cached partitions (tests/test_torch_dist_weighted.py,
# tests/test_torch_hot_cache.py) ------------------------------------------------

def wsample_homo_case(mesh, case):
  """The homogeneous sampler with the case's fanouts (``-1`` full hops),
  weights and edge ids."""
  g = DistGraph.from_dataset_partitions(mesh, case['root'])
  s = DistNeighborSampler(g, case['fanouts'], with_edge=case['with_edge'],
                          with_weight=True)
  out = _batch_np(s.sample_from_nodes(case['seeds'], case['n_valid'],
                                      case['u']))
  return dict(out, shapes=s.uniform_shapes(case['seeds'].shape[1]),
              fanouts=s.num_neighbors)


def wsample_hetero_case(mesh, case):
  """The hetero sampler with the case's fanouts, weights and edge ids."""
  dg = DistHeteroGraph.from_dataset_partitions(mesh, case['root'])
  s = DistHeteroNeighborSampler(dg, case['fanouts'],
                                with_edge=case['with_edge'],
                                with_weight=case['with_weight'])
  out = s.sample_from_nodes('paper', case['seeds'], case['n_valid'],
                            case['u'])
  out.pop('input_type')
  return dict(_np(out), shapes=s.uniform_shapes(case['seeds'].shape[1],
                                                'paper'))


def _wtrainer(mesh, case):
  """An RSAGE over the case's weighted hetero layout and a weighted
  DistHeteroTrainStep with the case's edge stores, from its weights."""
  root = case['root']
  dg = DistHeteroGraph.from_dataset_partitions(mesh, root)
  ds = {mesh.rank: DistDataset.load(root, mesh.rank, device='cpu')}
  feats = {t: DistFeature.from_dist_datasets(mesh, ds, ntype=t)
           for t in dg.node_counts}
  efeats = {e: DistFeature.from_dist_datasets(mesh, ds, ntype=e, kind='edge')
            for e in case['edge_types']}
  keys = DistHeteroNeighborSampler(dg, case['fanouts']).message_passing_types(
      case['bs'], 'paper')
  model = RGNN(keys, case['in_dim'], case['hidden'], case['classes'],
               num_layers=len(case['fanouts']), conv='rsage',
               node_types=list(dg.node_counts))
  model.load_state_dict({k: torch.as_tensor(v)
                         for k, v in case['params'].items()})
  step = DistHeteroTrainStep(dg, feats, model, {'paper': case['labels']},
                             case['fanouts'], case['bs'], 'paper',
                             lr=case['lr'], edge_features=efeats,
                             with_weight=True)
  return model, step


def wtrain_case(mesh, case):
  """Per call: the batch's edge ids and edge features, then the step's
  loss and the parameters after it."""
  model, step = _wtrainer(mesh, case)
  out = []
  for call in case['calls']:
    args = (call['seeds'], call['n_valid'], call['u'])
    with torch.no_grad():
      batch = step.make_batch(*step._one(*args))
    res = _np(step(*args))
    out.append(dict(result=res, params=_np(model.state_dict()),
                    edge=_np(batch.edge_dict),
                    edge_attr=_np(batch.edge_attr_dict),
                    edge_mask=_np(batch.edge_mask_dict)))
  return out


def wsuper_case(mesh, case):
  """A weighted superstep of the case's window against the same batches
  through a twin's per-batch calls, both from the case's weights."""
  a, b = _wtrainer(mesh, case)[1], _wtrainer(mesh, case)[1]
  w = case['window']
  got = _np(a.superstep(w['seeds'], w['n_valid'], w['u']))
  want = [_np(b(w['seeds'][t], w['n_valid'][t],
                [[None if x is None else x[t] for x in hop]
                 for hop in w['u']]))
          for t in range(w['seeds'].shape[0])]
  return dict(got=got, want=want, a=_np(a.model.state_dict()),
              b=_np(b.model.state_dict()))


def cache_lookup_case(mesh, case):
  """This rank's partition of a cached layout (its table, id map and
  rewritten book) and a DistFeature lookup over it, with the ids this
  rank sent to another rank's exchange."""
  from glt_tpu_torch.distributed import dist_feature
  ds = DistDataset.load(case['root'], mesh.rank, device='cpu')
  feat = ds.get_node_feature()
  sent = []
  real = dist_feature.exchange_lookup

  def counting(ids, owner, mesh_, *a, **k):
    away = (owner != mesh_.rank) & (owner < mesh_.world)
    sent.append(ids[away].numpy().copy())
    return real(ids, owner, mesh_, *a, **k)
  dist_feature.exchange_lookup = counting
  try:
    st = DistFeature.from_dist_datasets(mesh, {mesh.rank: ds})
    rows = st.lookup(case['ids'], case['valid'])
  finally:
    dist_feature.exchange_lookup = real
  import numpy as np
  return dict(table=_np(feat.table), id2index=_np(feat._id2index),
              book=ds.get_node_feat_pb().table.copy(),
              graph_book=ds.get_node_pb().table.copy(), rows=_np(rows),
              sent=np.concatenate(sent))


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


# -- the IGBH example's modes (tests/test_torch_igbh_flags.py, and on two
# cards tests/test_torch_cuda.py) ----------------------------------------------

def igbh_tree(tmp_path, papers=600, parts=None, device='cpu'):
  """A synthesised IGBH tree with bf16 features and its split, and a
  partition layout of ``parts`` parts when asked."""
  from glt_tpu_torch.examples.igbh.compress_graph import compress
  from glt_tpu_torch.examples.igbh import dist_train_rgnn
  from glt_tpu_torch.examples.igbh.data import split_seeds, synthesize
  data = str(tmp_path / 'data')
  synthesize(data, papers, seed=0)
  compress(data, layout='CSC', bf16=True, topology=False, device=device)
  split_seeds(data)
  part = str(tmp_path / 'parts')
  if parts:
    dist_train_rgnn.partition(data, part, parts)
  return data, part


_RANK = r'''
import builtins, json, sys
sys.path.insert(0, sys.argv[1])
opened = []
real_open = builtins.open
def counting(file, *a, **k):
  opened.append(str(file))
  return real_open(file, *a, **k)
builtins.open = counting
from glt_tpu_torch.examples.igbh import dist_train_rgnn
res = dist_train_rgnn.main(json.loads(sys.argv[2]))
with real_open(sys.argv[3], 'w') as f:
  json.dump(dict(opened=opened, steps=res['steps'],
                 losses=res['losses']), f)
'''


def free_port():
  import socket
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def run_multihost(data, part, tmp_path, device_args, world=2, timeout=240):
  """The example's multihost mode in ``world`` processes; per rank the
  files it opened, its steps and losses."""
  import json
  import os
  import subprocess
  import sys
  port = free_port()
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  procs, outs = [], []
  for r in range(world):
    out = str(tmp_path / f'rank{r}.json')
    argv = device_args + ['--steps-per-epoch', '2', '--batch-size', '8',
                          '--fanout', '3,2', '--hidden', '16',
                          '--val-batches', '1', '--data-root', data,
                          '--part-root', part, '--coordinator',
                          f'127.0.0.1:{port}', '--nprocs', str(world),
                          '--rank', str(r)]
    procs.append(subprocess.Popen(
        [sys.executable, '-c', _RANK, repo, json.dumps(argv), out],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    outs.append(out)
  errs = []
  for p in procs:
    try:
      errs.append(p.communicate(timeout=timeout)[1])
    finally:
      p.kill()
  assert all(p.returncode == 0 for p in procs), [e.decode()[-2000:]
                                                   for e in errs]
  res = []
  for out in outs:
    with open(out) as f:
      res.append(json.load(f))
  return res


def check_own_blocks(res, data, part):
  """Each rank opened its own partition's blocks and none of another's,
  and neither a feature table nor an edge payload of the tree."""
  import os
  import re
  import numpy as np
  for r, got in enumerate(res):
    blocks = [os.path.relpath(p, part).split(os.sep)[0]
              for p in got['opened'] if p.startswith(part + os.sep)]
    blocks = {b for b in blocks if re.fullmatch(r'part\d+', b)}
    assert blocks == {f'part{r}'}, (r, blocks)
    tree = [p for p in got['opened'] if p.startswith(data)]
    assert not [p for p in tree
                if 'node_feat' in p or 'edge_index' in p], (r, tree)
    assert got['steps'] == 2 and all(np.isfinite(got['losses']))


