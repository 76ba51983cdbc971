"""The link and subgraph loaders' options in the port against the JAX
package on the same numpy inputs, the JAX draws injected:
``LinkNeighborLoader(with_weight=, with_edge=, replace=)`` over a
homogeneous graph (binary and triplet negatives) and over a hetero edge
type whose two ends are different node types, one weighted link step of
examples/graph_sage_unsup.py, and ``SubGraphLoader(with_edge=)``.

The JAX side runs as on its TPU path (``to_tpu_path`` of
tests/test_torch_weighted_sampling.py): weight windows through its
interpret-mode Pallas ``gather_windows`` (counted while its program
traces), the sort inducer with fused hops, uniform hops on its ``pallas``
one-hop engine. The port takes JAX's draws: the negatives' proposals and
the hops' uniforms, from the key the JAX sampler split for the batch.

Tolerances: batches bit for bit on every field and label; edge ids on the
valid lanes (a masked lane's edge id is -1 in the port, ROADMAP's
deliberate difference); the link step's loss to rtol 1e-5 and every
parameter to atol 1e-5 (float32 sums in another order).
"""
import jax
import numpy as np
import optax
import pytest
import torch

from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.loader import LinkNeighborLoader as JaxLinkNeighborLoader
from glt_tpu.loader import SubGraphLoader as JaxSubGraphLoader
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.sampler import NegativeSampling as JaxNegativeSampling
from glt_tpu_torch.data import Dataset
from glt_tpu_torch.loader import LinkNeighborLoader, SubGraphLoader
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.parallel import SageTrainStep, link_bce_loss
from glt_tpu_torch.sampler import NegativeSampling
from glt_tpu_torch.typing import reverse_edge_type
from test_torch_link import _proposals
from test_torch_sampler_options import (NODES, WRITES, _hetero_graph,
                                        hetero_uniforms_from_key,
                                        homo_uniforms_from_key)
from test_torch_seal import _recording
from test_torch_weighted_sampling import to_tpu_path

N, E, F, FANOUTS, BATCH = 80, 700, 12, [3, 2], 128
PARAM_ATOL = LOSS_RTOL = 1e-5
BATCH_FIELDS = ('node', 'node_count', 'row', 'col', 'edge_mask', 'x',
                'num_sampled_nodes', 'num_sampled_edges')
LINK_KEYS = ('edge_label_index', 'edge_label', 'src_index', 'dst_pos_index',
             'dst_neg_index')


def _np(x):
  return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _graph(seed=0):
  """A CSR with degrees 0 to ~20 (rows 70.. have none), a few zero
  weights among weights in (0, 1], features of width F."""
  rng = np.random.default_rng(seed)
  src = (rng.random(E) ** 2 * 70).astype(np.int64)
  ei = np.stack([src, rng.integers(0, N, E)])
  w = (1.0 - rng.random(E)).astype(np.float32)
  w[::17] = 0.0
  x = rng.standard_normal((N, F)).astype(np.float32)
  return ei, w, x


def _datasets(seed=0):
  ei, w, x = _graph(seed)
  jds = JaxDataset().init_graph(edge_index=ei, edge_weights=w, num_nodes=N)
  jds.init_node_features(x)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  return jds, ds


def _seed_count(neg: NegativeSampling, num_pos: int) -> int:
  num_neg = neg.sample_size(num_pos)
  return (2 * (num_pos + num_neg) if neg.is_binary()
          else 2 * num_pos + num_neg)


#: JAX samplers by option set, so that the binary and the triplet case of
#: one option set (both 4 * BATCH seeds a batch) share one compiled walk
_JAX_SAMPLERS = {}


def _loaders(jds, ds, neg, monkeypatch, draws, eli=None, shared=False,
             tpu_path=True, **kw):
  """The JAX LinkNeighborLoader on its TPU path and the port's, whose
  sampler takes the proposals and uniforms ``draws(key, inputs, ps)``
  makes of the key the JAX sampler used for the same batch (zip pulls
  the JAX batch first). ``shared``: the JAX loader samples with the
  sampler an earlier case of the same options built, if any;
  ``tpu_path=False``: the JAX sampler reads its windows with its plain
  gathers."""
  jl = JaxLinkNeighborLoader(jds, FANOUTS, edge_label_index=eli,
                             batch_size=BATCH, shuffle=True, seed=0,
                             neg_sampling=JaxNegativeSampling(*neg), **kw)
  reads = []
  if shared:
    jl.sampler = _JAX_SAMPLERS.setdefault(tuple(sorted(kw.items())),
                                          jl.sampler)
    jl.sampler.__dict__.pop('sample_from_edges', None)
    reads = getattr(jl.sampler, 'window_reads', [])
  if tpu_path:
    js = to_tpu_path(jl.sampler, monkeypatch)
    js.window_reads[:0] = reads     # the reads of an earlier case's trace
  else:
    js = jl.sampler
    monkeypatch.setenv('GLT_DEDUP', 'sort')
    monkeypatch.setenv('GLT_FUSED_HOP', '1')
  keys, jax_sample = [], js.sample_from_edges

  def record_key(inputs):
    keys.append(js._next_key())
    return jax_sample(inputs, key=keys[-1])
  js.sample_from_edges = record_key
  pl = LinkNeighborLoader(ds, FANOUTS, edge_label_index=eli,
                          batch_size=BATCH, shuffle=True, seed=0,
                          neg_sampling=NegativeSampling(*neg), device='cpu',
                          **kw)
  ps = pl.sampler
  real = ps.sample_from_edges

  def sample_from_edges(inputs):
    props, u = draws(keys[-1], inputs, ps)
    return real(inputs, proposals=props, uniforms=u)
  ps.sample_from_edges = sample_from_edges
  return jl, pl


def _homo_draws(neg):
  neg = NegativeSampling(*neg)

  def draws(key, inputs, ps):
    kneg, kwalk = jax.random.split(key)
    return (_proposals(kneg, neg.sample_size(len(inputs)), ps.graph),
            homo_uniforms_from_key(kwalk, _seed_count(neg, len(inputs)),
                                   ps))
  return draws


def _assert_edges(got, want, mask, per_hop, what=''):
  """Edge ids equal on the valid lanes; -1 on the masked lanes of a
  window hop."""
  got, want, mask = _np(got), np.asarray(want), np.asarray(mask, bool)
  np.testing.assert_array_equal(got[mask], want[mask], err_msg=what)
  if per_hop:
    assert (got[~mask] == -1).all(), what


@pytest.mark.parametrize('neg', [('binary', 1), ('triplet', 2)])
@pytest.mark.parametrize('kw', [
    dict(with_weight=True), dict(with_edge=True),
    dict(with_weight=True, with_edge=True), dict(replace=True)],
    ids=['weight', 'edge', 'weight_edge', 'replace'])
def test_link_loader_options_match_jax(kw, neg, monkeypatch):
  jds, ds = _datasets()
  jl, pl = _loaders(jds, ds, neg, monkeypatch, _homo_draws(neg), shared=True,
                    **kw)
  ps, js = pl.sampler, jl.sampler
  per_hop = bool(kw.get('with_weight'))
  assert ps._per_hop == per_hop and ps.replace == js.replace
  assert len(pl) == len(jl) == 6
  n_valid = []
  for jb, pb in zip(jl, pl):
    for f in BATCH_FIELDS:
      np.testing.assert_array_equal(_np(getattr(pb, f)),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    for f in LINK_KEYS:
      assert (f in pb.metadata) == (f in jb.metadata), f
      if f in jb.metadata and jb.metadata[f] is not None:
        np.testing.assert_array_equal(_np(pb.metadata[f]),
                                      np.asarray(jb.metadata[f]), err_msg=f)
    assert pb.edge_hop_offsets == jb.edge_hop_offsets
    if kw.get('with_edge'):
      _assert_edges(pb.edge, jb.edge, jb.edge_mask, per_hop)
      # every valid lane's edge id (its position in the input edge list)
      # names an edge between its endpoints
      ei = _graph()[0]
      node, m = pb.node.numpy(), pb.edge_mask.numpy()
      eids = pb.edge.numpy()[m]
      np.testing.assert_array_equal(ei[0][eids], node[pb.col.numpy()[m]])
      np.testing.assert_array_equal(ei[1][eids], node[pb.row.numpy()[m]])
    else:
      assert pb.edge is None and jb.edge is None
    n_valid.append(pb.metadata['n_valid'])
  assert n_valid == [BATCH] * 5 + [E - 5 * BATCH]
  # every weighted hop of the JAX program read its window through the
  # interpret-mode kernel
  if per_hop:
    assert js.window_reads and len(js.window_reads) % len(FANOUTS) == 0


def test_weighted_link_step_matches_the_example(monkeypatch):
  # examples/graph_sage_unsup.py's step (embed -> dot product -> sigmoid
  # BCE -> adam(3e-3)) on one weighted batch with edge ids
  jds, ds = _datasets()
  neg = ('binary', 1)
  jl, pl = _loaders(jds, ds, neg, monkeypatch, _homo_draws(neg), shared=True,
                    with_weight=True, with_edge=True)
  jb, pb = next(zip(jl, pl))
  hidden, embed = 16, 8
  jmodel = JaxGraphSAGE(hidden_features=hidden, out_features=embed,
                        num_layers=len(FANOUTS))
  tx = optax.adam(3e-3)
  jb = jb.replace(metadata={k: jb.metadata[k] for k in
                            ('edge_label_index', 'edge_label')})

  def loss_fn(p, batch):
    emb = jmodel.apply(p, batch, method=JaxGraphSAGE.embed)
    eli = batch.metadata['edge_label_index']
    logit = (emb[eli[0]] * emb[eli[1]]).sum(-1)
    return optax.sigmoid_binary_cross_entropy(
        logit, batch.metadata['edge_label']).mean()

  params = jax.jit(jmodel.init)(jax.random.key(0), jb)
  opt = tx.init(params)
  jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, jb)
  up, opt = tx.update(grads, opt)
  params_after = optax.apply_updates(params, up)

  model = GraphSAGE(F, hidden, embed, num_layers=len(FANOUTS))
  model.load_state_dict(sage_params_from_flax(
      jax.tree.map(np.asarray, params)))
  step = SageTrainStep(model, lr=3e-3, loss=link_bce_loss)
  loss = step(pb)
  np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
  want = sage_params_from_flax(jax.tree.map(np.asarray, params_after))
  got = model.state_dict()
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                               atol=PARAM_ATOL, err_msg=k)


# -- the hetero loader over a two-type edge type ------------------------------

def _hetero_datasets():
  ei, w = _hetero_graph()
  rng = np.random.default_rng(7)
  x = {t: rng.standard_normal((n, 4)).astype(np.float32)
       for t, n in NODES.items()}
  jds = JaxDataset().init_graph(edge_index=ei, edge_weights=w,
                                num_nodes=NODES)
  jds.init_node_features(x)
  ds = Dataset().init_graph(ei, edge_weights=w, num_nodes=NODES,
                            device='cpu')
  ds.init_node_features(x, device='cpu')
  return jds, ds


def test_hetero_weighted_link_loader_matches_jax(monkeypatch):
  jds, ds = _hetero_datasets()
  neg = ('binary', 1)
  pneg = NegativeSampling(*neg)

  def draws(key, inputs, ps):
    # author seeds: the positives' and negatives' src; paper seeds: dst
    n = len(inputs)
    sizes = {WRITES[0]: n + pneg.sample_size(n),
             WRITES[-1]: n + pneg.sample_size(n)}
    kneg, kwalk = jax.random.split(key)
    return (_proposals(kneg, pneg.sample_size(n), ps.graph[WRITES]),
            hetero_uniforms_from_key(kwalk, ps, sizes))
  jl, pl = _loaders(jds, ds, neg, monkeypatch, draws, eli=(WRITES, None),
                    tpu_path=False, with_weight=True, with_edge=True)
  ps = pl.sampler
  assert ps._per_hop and WRITES in ps._weighted_types
  writes = set(zip(*(_hetero_graph()[0][WRITES].tolist())))
  n = 0
  for jb, pb in zip(jl, pl):
    assert pb.input_type == jb.input_type == WRITES
    for f in ('x_dict', 'row_dict', 'col_dict', 'edge_mask_dict',
              'node_dict', 'node_count_dict', 'num_sampled_nodes',
              'num_sampled_edges'):
      want, got = getattr(jb, f), getattr(pb, f)
      assert set(got) == set(want), f
      for k, v in want.items():
        np.testing.assert_array_equal(_np(got[k]), np.asarray(v),
                                      err_msg=f'{f}[{k}]')
    assert set(pb.edge_dict) == set(jb.edge_dict)
    for k, m in jb.edge_mask_dict.items():
      # a weighted edge type's masked lanes hold -1; the uniform AFF hop's
      # (B2 picks) hold what each side's clip read
      _assert_edges(pb.edge_dict[k], jb.edge_dict[k], m,
                    reverse_edge_type(k) in ps._weighted_types, str(k))
    assert pb.edge_hop_offsets_dict == jb.edge_hop_offsets_dict
    for f in ('edge_label_index', 'edge_label'):
      np.testing.assert_array_equal(_np(pb.metadata[f]),
                                    np.asarray(jb.metadata[f]), err_msg=f)
    # the labels index each endpoint type's node list: a positive's pair
    # is an author-writes-paper edge
    eli = pb.metadata['edge_label_index'].numpy()[:, :pb.metadata['n_valid']]
    pairs = zip(pb.node_dict['author'].numpy()[eli[0]].tolist(),
                pb.node_dict['paper'].numpy()[eli[1]].tolist())
    assert all(p in writes for p in pairs)
    n += 1
  assert n == len(jl) == len(pl) > 1


# -- the subgraph loader ---------------------------------------------------------

def test_subgraph_loader_with_edge_matches_jax(monkeypatch):
  monkeypatch.setenv('GLT_DEDUP', 'sort')
  monkeypatch.setenv('GLT_FUSED_HOP', '1')
  ei, _, x = _graph(4)
  y = np.random.default_rng(4).integers(0, 3, N).astype(np.int32)
  jds = JaxDataset().init_graph(edge_index=ei, num_nodes=N)
  jds.init_node_features(x)
  jds.init_node_labels(y)
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, device='cpu')
  ds.init_node_labels(y)
  seeds = np.arange(0, N, 3)
  jl = JaxSubGraphLoader(jds, [3, 2], seeds, batch_size=8, shuffle=True,
                         seed=1, with_edge=True)
  pl = SubGraphLoader(ds, [3, 2], seeds, batch_size=8, shuffle=True, seed=1,
                      with_edge=True, device='cpu')
  keys = _recording(jl.sampler)
  real = pl.sampler.subgraph
  pl.sampler.subgraph = lambda s: real(s, uniforms=homo_uniforms_from_key(
      keys[-1], 8, pl.sampler))
  n = 0
  for jb, pb in zip(jl, pl):
    for f in ('x', 'row', 'col', 'edge_mask', 'node', 'node_count', 'y',
              'edge'):
      np.testing.assert_array_equal(_np(getattr(pb, f)),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    node, m = pb.node.numpy(), pb.edge_mask.numpy()
    eids = pb.edge.numpy()
    assert (eids[~m] == -1).all() and (eids[m] >= 0).all() and m.any()
    # an induced edge's id names the input edge (col -> row)
    np.testing.assert_array_equal(ei[0][eids[m]], node[pb.col.numpy()[m]])
    np.testing.assert_array_equal(ei[1][eids[m]], node[pb.row.numpy()[m]])
    n += 1
  assert n == 4
  # without the option the loader emits no ids (-1 throughout)
  plain = SubGraphLoader(ds, [3, 2], seeds, batch_size=8, device='cpu')
  assert (next(iter(plain)).edge.numpy() == -1).all()
