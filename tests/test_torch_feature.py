"""The hot/cold feature tier in the port (``Feature(split_ratio=...)``,
``gather_features``, ``sort_by_in_degree``,
``Dataset.init_node_features(sort_func=, split_ratio=)``, a
``NeighborLoader`` over a sorted split store, the products example and
the feature bench) against the JAX package on the same numpy inputs.

On the CPU the port's cold block is a plain CPU tensor and the gathers
run their plain versions (tests/test_torch_cuda.py holds the kernel to
them on a card). The JAX stores run on their CPU paths: the default one
reads its pinned-host cold block through ``gather_mixed``, and
``host_offload=False`` gathers on the host.

The one difference is padded ``-1`` lanes without an id map: the port
reads row 0 on every path. JAX's ``gather_mixed`` reads row ``H - 1``
there (``jnp.take`` wraps negative indices), and its host phase at split
0.0 reads row ``N - 1`` (numpy indexing wraps);
``test_padded_lanes_read_row_zero`` pins both.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from examples.common import synthetic_products as jax_synthetic_products
from glt_tpu.data import Dataset as JaxDataset
from glt_tpu.data import Feature as JaxFeature
from glt_tpu.data import Topology as JaxTopology
from glt_tpu.data import sort_by_in_degree as jax_sort_by_in_degree
from glt_tpu.data.feature import gather_features as jax_gather_features
from glt_tpu.models.sage import GraphSAGE as JaxGraphSAGE
from glt_tpu.parallel.train import _sage_update
from glt_tpu_torch.benchmarks import bench_feature
from glt_tpu_torch.data import (Dataset, Feature, Topology, gather_features,
                                sort_by_in_degree)
from glt_tpu_torch.examples import common, train_sage_products
from glt_tpu_torch.models import GraphSAGE, sage_params_from_flax
from glt_tpu_torch.parallel import SageTrainStep, sage_loss
from glt_tpu_torch.typing import Split
from test_torch_training import (B, BATCH_KEYS, C, E, F, FANOUTS, HIDDEN,
                                 LOSS_RTOL, N, PARAM_ATOL, _loaders)

NF, DF = 40, 6     # the stores' rows and width


def _bits(x):
  """Exact bits of a JAX array, numpy array or tensor (bf16 as uint16)."""
  if isinstance(x, torch.Tensor):
    if x.dtype == torch.bfloat16:
      return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()
  x = np.asarray(x)
  return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def _stores(split, dtype, with_map, host_offload=None):
  """The same table, split and id map in the JAX package and the port."""
  rng = np.random.default_rng(7)
  table = rng.standard_normal((NF, DF)).astype(np.float32)
  id2index = rng.permutation(NF) if with_map else None
  jdt, pdt = ((jnp.bfloat16, torch.bfloat16) if dtype == 'bfloat16'
              else (None, None))
  jf = JaxFeature(table, split_ratio=split, id2index=id2index, dtype=jdt,
                  host_offload=host_offload)
  jf.lazy_init()
  pf = Feature(table, split_ratio=split, id2index=id2index, dtype=pdt,
               device='cpu', host_offload=host_offload)
  return jf, pf


def _ids(with_map):
  rng = np.random.default_rng(8)
  ids = rng.integers(0, NF, 50)
  # padded lanes (-1), both ends; past the ends where an id map clips
  tail = [-1, 0, NF - 1, -1] + ([NF, NF + 3, -5] if with_map else [])
  return np.concatenate([ids, tail]).astype(np.int32)


CASES = [(s, d, m) for s in (0.0, 0.3, 1.0) for d in ('float32', 'bfloat16')
         for m in (False, True)]


@pytest.mark.parametrize('split,dtype,with_map', CASES)
def test_gather_features_matches_jax(split, dtype, with_map):
  ids = _ids(with_map)
  pad = (ids == -1) & (not with_map)
  jhost, phost = _stores(split, dtype, with_map, host_offload=False)
  jmixed, pf = _stores(split, dtype, with_map)
  assert pf.hot_count == jmixed.hot_count and pf.shape == jmixed.shape
  assert pf.id_space == jmixed.id_space
  assert pf.fully_device_resident == jmixed.fully_device_resident
  assert (pf.cold_array is None) == (jmixed.cold_array is None)
  want_host = _bits(jax_gather_features(jhost, jnp.asarray(ids)))
  want_mixed = _bits(jax_gather_features(jmixed, jnp.asarray(ids)))
  for store in (pf, phost):
    got = _bits(gather_features(store, torch.as_tensor(ids)))
    assert got.shape == (ids.size, DF)
    # JAX's host phase wraps -1 at split 0.0 (numpy indexing)
    keep = ~pad if split == 0.0 else slice(None)
    np.testing.assert_array_equal(got[keep], want_host[keep])
    # JAX's gather_mixed wraps -1 in its hot block
    np.testing.assert_array_equal(got[~pad], want_mixed[~pad])
  # the hot block and the cold block, whichever memory holds it
  np.testing.assert_array_equal(_bits(pf.device_part),
                                _bits(jmixed.device_part))
  np.testing.assert_array_equal(
      pf.cold_block_numpy(),
      np.asarray(jmixed.cold_block_numpy()).astype(np.float32))


@pytest.mark.parametrize('split,dtype,with_map', CASES)
def test_getitem_cold_rows_and_map_ids_match_jax(split, dtype, with_map):
  jf, pf = _stores(split, dtype, with_map)
  ids = np.random.default_rng(9).integers(0, NF, 30)
  got = pf[ids]
  assert isinstance(got, np.ndarray) and got.dtype == np.float32
  np.testing.assert_array_equal(got, np.asarray(jf[ids]).astype(np.float32))
  cold_rows = np.arange(pf.hot_count, NF)
  if cold_rows.size:
    np.testing.assert_array_equal(
        pf.gather_cold_host(cold_rows),
        np.asarray(jf.gather_cold_host(cold_rows)).astype(np.float32))
  if with_map:
    probe = np.array([-5, -1, 0, 3, NF - 1, NF, NF + 9], np.int32)
    want = np.asarray(jf.map_ids(jnp.asarray(probe)))
    np.testing.assert_array_equal(pf.map_ids(torch.as_tensor(probe)).numpy(),
                                  want)
    np.testing.assert_array_equal(pf.map_ids(ids), jf.map_ids(ids))
    np.testing.assert_array_equal(pf.id2index.numpy(),
                                  np.asarray(jf.id2index))
  else:
    assert pf.map_ids(ids) is ids and pf.id2index is None


@pytest.mark.parametrize('split,dtype,with_map', CASES)
def test_with_updated_rows_matches_jax(split, dtype, with_map):
  rng = np.random.default_rng(10)
  ids = rng.choice(NF, 8, replace=False)
  values = rng.standard_normal((8, DF)).astype(np.float32)
  every = np.arange(NF, dtype=np.int32)
  for host_offload in (False, None):
    jf, pf = _stores(split, dtype, with_map, host_offload=host_offload)
    rows = pf.map_ids(ids)
    if host_offload is None and (rows >= pf.hot_count).any():
      # a pinned cold block refuses cold-row updates, as JAX's does
      with pytest.raises(AssertionError):
        jf.with_updated_rows(ids, values)
      with pytest.raises(ValueError, match='pinned'):
        pf.with_updated_rows(ids, values)
      ids_ok = ids[rows < pf.hot_count]
    else:
      ids_ok = ids
    sel = np.isin(ids, ids_ok)
    jnew = jf.with_updated_rows(ids_ok, values[sel])
    pnew = pf.with_updated_rows(ids_ok, values[sel])
    np.testing.assert_array_equal(
        _bits(gather_features(pnew, torch.as_tensor(every))),
        _bits(jax_gather_features(jnew, jnp.asarray(every))))
    # the old store keeps its rows
    np.testing.assert_array_equal(
        _bits(gather_features(pf, torch.as_tensor(every))),
        _bits(jax_gather_features(jf, jnp.asarray(every))))
  with pytest.raises(ValueError, match='out of range'):
    pf.with_updated_rows([NF], values[:1])


def test_padded_lanes_read_row_zero():
  # the documented difference: JAX's default split path reads the hot
  # block's last row at -1, its split-0.0 host phase the table's last
  # row; the port reads row 0 on every path
  table = np.arange(40, dtype=np.float32).reshape(10, 4)
  ids = np.array([0, 5, 9, -1], np.int32)
  for kw, jax_pad_row in ((dict(split_ratio=0.3), 2),
                          (dict(split_ratio=0.0, host_offload=False), 9),
                          (dict(split_ratio=0.3, host_offload=False), 0),
                          (dict(split_ratio=0.0), 0),
                          (dict(split_ratio=1.0), 0)):
    want = np.asarray(jax_gather_features(JaxFeature(table, **kw),
                                          jnp.asarray(ids)))
    got = gather_features(Feature(table, device='cpu', **kw),
                          torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(want[:3], got[:3])
    np.testing.assert_array_equal(want[3], table[jax_pad_row])
    np.testing.assert_array_equal(got[3], table[0])


def test_split_store_has_no_single_table():
  f = Feature(np.ones((10, 3), np.float32), split_ratio=0.5, device='cpu')
  with pytest.raises(ValueError, match='no single table'):
    f.table
  with pytest.raises(ValueError, match='pinned cold block'):
    Feature(np.ones((10, 3), np.float32), split_ratio=0.5, device='cpu',
            host_offload=False).gather_mixed(torch.arange(3))
  whole = Feature(np.ones((10, 3), np.float32), device='cpu')
  assert whole.table.shape == (10, 3) and whole.fully_device_resident


@pytest.mark.parametrize('layout', ['CSR', 'CSC'])
@pytest.mark.parametrize('shuffle_ratio', [0.0, 0.1])
def test_sort_by_in_degree_matches_jax(layout, shuffle_ratio):
  rng = np.random.default_rng(11)
  n = 200
  ei = np.stack([rng.integers(0, n, 3000),
                 (rng.random(3000) ** 2 * n).astype(np.int64)])
  feats = rng.standard_normal((n + 5, 4)).astype(np.float32)  # 5 unseen
  jt = JaxTopology(edge_index=ei, layout=layout, num_nodes=n)
  pt = Topology(ei, layout=layout, num_nodes=n, device='cpu')
  want = jax_sort_by_in_degree(feats, 0.2, jt, shuffle_ratio=shuffle_ratio,
                               rng=np.random.default_rng(4))
  got = sort_by_in_degree(feats, 0.2, pt, shuffle_ratio=shuffle_ratio,
                          rng=np.random.default_rng(4))
  for a, b in zip(got, want):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_init_node_features_sorts_and_splits_as_jax():
  jds, _ = jax_synthetic_products(num_nodes=400, split_ratio=0.2,
                                  sort_features=True)
  ds, classes = common.synthetic_products(num_nodes=400, split_ratio=0.2,
                                          sort_features=True, device='cpu')
  jf, pf = jds.get_node_feature(), ds.get_node_feature()
  assert pf.hot_count == jf.hot_count == 80 and classes == 47
  np.testing.assert_array_equal(pf.id2index.numpy(), np.asarray(jf.id2index))
  every = np.arange(400, dtype=np.int32)
  np.testing.assert_array_equal(
      gather_features(pf, torch.as_tensor(every)).numpy(),
      np.asarray(jax_gather_features(jf, jnp.asarray(every))))
  # the example's graph, labels and split are examples/common.py's
  jt, pt = jds.get_graph().topo, ds.get_graph().topo
  np.testing.assert_array_equal(pt.indptr.numpy(), jt.indptr)
  np.testing.assert_array_equal(pt.indices.numpy(), jt.indices)
  np.testing.assert_array_equal(ds.get_node_label(), jds.get_node_label())
  for s in Split:
    np.testing.assert_array_equal(ds.get_split(s), jds.get_split(s.value))
  # hetero tables split without a sort, and sort over the topology of the
  # first edge type they are the pointer type of (JAX's
  # _topo_for_node_type; tests/test_torch_sampler_options.py holds it)
  hds = Dataset().init_graph({('a', 'to', 'b'): np.array([[0, 1], [1, 2]])},
                             device='cpu')
  hds.init_node_features({'a': np.ones((4, 2), np.float32)}, split_ratio=0.5,
                         device='cpu')
  assert hds.get_node_feature('a').hot_count == 2
  hds.init_node_features({'a': np.ones((4, 2), np.float32)},
                         sort_func=sort_by_in_degree, split_ratio=0.5,
                         device='cpu')
  assert hds.get_node_feature('a').id2index is not None


def _split_data():
  """test_torch_training's toy with its features sorted by in-degree and
  split 0.2."""
  rng = np.random.default_rng(0)
  ei = np.stack([rng.integers(0, N, E),
                 (rng.random(E) ** 2 * N).astype(np.int64)])
  rng.random(E)     # the training toy's edge weights, not used here
  x = rng.standard_normal((N, F)).astype(np.float32)
  y = np.argmax(x @ rng.standard_normal((F, C)).astype(np.float32),
                1).astype(np.int32)
  jds = JaxDataset(edge_dir='out')
  jds.init_graph(edge_index=ei, num_nodes=N)
  jds.init_node_features(x, sort_func=jax_sort_by_in_degree, split_ratio=0.2)
  jds.init_node_labels(y)
  jds.random_node_split(num_val=0.1, num_test=0.1)
  ds = Dataset().init_graph(ei, num_nodes=N, device='cpu')
  ds.init_node_features(x, sort_func=sort_by_in_degree, split_ratio=0.2,
                        device='cpu')
  ds.init_node_labels(y)
  ds.random_node_split(num_val=0.1, num_test=0.1)
  assert ds.get_node_feature().cold_array is not None
  return jds, ds


def test_loader_batches_over_a_split_store_match_jax(monkeypatch):
  jds, ds = _split_data()
  jl, pl = _loaders(jds, ds, False, monkeypatch)
  for jb, pb in zip(jl, pl):
    for f in BATCH_KEYS:
      np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                    np.asarray(getattr(jb, f)), err_msg=f)
    assert pb.metadata['n_valid'] == jb.metadata['n_valid']


def test_train_steps_over_a_split_store_match_sage_update(monkeypatch):
  jds, ds = _split_data()
  jl, pl = _loaders(jds, ds, False, monkeypatch)
  jmodel = JaxGraphSAGE(hidden_features=HIDDEN, out_features=C,
                        num_layers=len(FANOUTS))
  tx = optax.adam(1e-3)

  @jax.jit
  def jstep(params, opt, batch, n_valid):
    # _sage_update pmeans over its axis: one member here
    f = lambda _: _sage_update(jmodel, tx, 'd', B, params, opt, batch,
                               n_valid)
    return jax.tree.map(lambda a: a[0],
                        jax.vmap(f, axis_name='d')(jnp.zeros(1)))

  model = GraphSAGE(F, HIDDEN, C, num_layers=len(FANOUTS))
  step = SageTrainStep(model)
  params = opt = None
  for i, (jb, pb) in enumerate(zip(jl, pl)):
    if i == 3:
      break
    if params is None:
      params = jax.jit(jmodel.init)(jax.random.key(0), jb)
      opt = tx.init(params)
      model.load_state_dict(sage_params_from_flax(
          jax.tree.map(np.asarray, params)))
    with torch.no_grad():
      before = float(sage_loss(model, pb))
    params, opt, jloss = jstep(params, opt, jb.replace(metadata=None),
                               jnp.asarray(jb.metadata['n_valid']))
    loss = step(pb)
    assert float(loss) == before
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    want = sage_params_from_flax(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    for k in want:
      np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                 atol=PARAM_ATOL, err_msg=f'step {i} {k}')


def test_products_example_trains_from_a_split_store(monkeypatch, capsys):
  # main() end to end on the CPU, its graph cut from 24,000 nodes to 300
  build = train_sage_products.synthetic_products
  monkeypatch.setattr(train_sage_products, 'synthetic_products',
                      lambda num_nodes, **kw: build(300, **kw))
  out = train_sage_products.main([
      '--batch-size', '64', '--fanout', '4,3',
      '--hidden', '16', '--epochs', '2', '--max-steps', '3',
      '--split-ratio', '0.2', '--device', 'cpu'])
  assert out['steps'] == 3 and np.isfinite(out['loss'])
  assert (out['hot_rows'], out['rows']) == (60, 300)
  assert 0.0 <= out['test_acc'] <= 1.0
  assert 'test acc:' in capsys.readouterr().out


def test_feature_bench_runs_on_the_cpu(capsys):
  rates = bench_feature.main(['--num-rows', '2000', '--dim', '8', '--batch',
                              '500', '--iters', '2', '--device', 'cpu'])
  lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
  assert [ln['metric'] for ln in lines] == [
      'feature_gather_rows_per_sec_device',
      'feature_gather_rows_per_sec_split']
  assert all(ln['unit'] == 'rows/s' and ln['device'] == 'cpu'
             and ln['value'] > 0 for ln in lines)
  assert set(rates) == {ln['metric'] for ln in lines}
